"""``harness/spans.py`` on synthetic profiler events, the span metrics'
``read`` on records, and the older metrics and ``trace.reduce`` unmoved by
the program's spans."""

import math

import pytest
import torch

from benchmark.harness import spans, spec, trace

MS = 1_000_000  # ns


class Event:
    """The part of a profiler event that trace.reduce and spans.events read."""

    def __init__(self, name, start, end, *, device=False, annotation=False, tid=1, corr=0,
                 linked=0):
        self._v = (name, start, end, device, annotation, tid, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


class Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: list(evs))})()})()


def span(name, a, b, corr, tid=1):
    return Event(name, a * MS, b * MS, annotation=True, tid=tid, corr=corr)


def kernel(name, a, b, *, linked=0, corr=0):
    return Event(name, a * MS, b * MS, device=True, linked=linked, corr=corr)


# one step in a 100 ms window: the harness's update_many holds the
# program's step, which holds its force; an aten op (id 20) inside the
# step outside the force; runtime calls (correlation 501, 502) by time
WINDOW = [Event("bench.window", 0, 100 * MS, corr=1)]
HOST = [span("bench.update_many", 10, 80, 2), span("nbody.step", 12, 70, 3),
        span("nbody.force", 15, 40, 4), Event("aten::copy_", 50 * MS, 55 * MS, corr=20),
        Event("cudaLaunchKernel", 16 * MS, 17 * MS, corr=501),
        Event("cudaLaunchKernel", 75 * MS, 76 * MS, corr=502),
        span("bench.positions", 85, 95, 5)]
DEVICE = [kernel("force_kernel", 20, 45, linked=4),       # launched straight under the force
          kernel("sum_kernel", 45, 48, corr=501),          # its runtime call at 16: the force
          kernel("copy_kernel", 52, 60, linked=20),        # under the step, outside the force
          kernel("late_kernel", 76, 78, corr=502),         # under update_many only
          kernel("lost_kernel", 90, 92),                   # no link: unattributed
          Event("nbody.force", 20 * MS, 48 * MS, device=True, annotation=True)]  # a mirror


def _rec():
    return spans.reduce(Prof(WINDOW + HOST + DEVICE))


def test_attribution_by_correlation_id_to_the_innermost_span():
    rec = _rec()
    t = rec["spans"]
    assert rec["routes"] == {"host_op": 2, "runtime": 2, "none": 1}
    assert t["nbody.force"]["launches"] == 2
    assert t["nbody.force"]["device_s"] == pytest.approx(0.028)
    # inclusive: the step holds the force's ops and its own copy
    assert t["nbody.step"]["launches"] == 3
    assert t["nbody.step"]["device_s"] == pytest.approx(0.028 + 0.008)
    assert t["bench.update_many"]["launches"] == 4
    assert t["unattributed"]["launches"] == 1
    assert rec["unattributed_s"] == pytest.approx(0.002)
    assert rec["program_launches"] == 3
    assert t["nbody.step"]["host_s"] == pytest.approx(0.058)
    # the device mirror of a span is no op, as trace.reduce has it
    assert rec["busy_s"] == pytest.approx(trace.reduce(Prof(WINDOW + HOST + DEVICE))["busy_s"])


def test_idle_split_by_the_innermost_span():
    rec = _rec()
    idle = {k: v["idle_s"] for k, v in rec["spans"].items() if v["idle_s"]}
    # busy 20-48, 52-60, 76-78, 90-92: idle 0-20, 48-52, 60-76, 78-90, 92-100
    assert idle == pytest.approx({"host idle": 0.010 + 0.005 + 0.005,
                                  "bench.update_many": 0.002 + 0.006 + 0.002,
                                  "nbody.step": 0.003 + 0.004 + 0.010, "nbody.force": 0.005,
                                  "bench.positions": 0.005 + 0.003})
    assert sum(idle.values()) == pytest.approx(rec["window_s"] - rec["busy_s"])
    assert rec["program_idle_s"] == pytest.approx(0.017 + 0.005)


def test_nested_spans_of_one_name_and_other_threads():
    evs = WINDOW + [span("nbody.p3m.refresh", 10, 50, 2), span("nbody.p3m.refresh", 20, 30, 3),
                    span("nbody.host_read", 22, 28, 4),
                    span("nbody.force", 10, 60, 6, tid=2),  # another thread's span
                    kernel("k", 24, 26, linked=4), kernel("k2", 40, 45, linked=2)]
    t = spans.reduce(Prof(evs))["spans"]
    assert t["nbody.p3m.refresh"]["host_s"] == pytest.approx(0.040)
    assert t["nbody.p3m.refresh"]["launches"] == 2
    assert t["nbody.host_read"]["launches"] == 1
    assert t["nbody.force"]["launches"] == 0


def test_exposed_communication():
    evs = WINDOW + [span("nbody.force", 0, 60, 2), span("nbody.ring.exchange", 5, 6, 3),
                    span("nbody.readback", 60, 100, 4), span("nbody.allgather", 61, 62, 5),
                    kernel("accel_kernel", 10, 50, linked=2),
                    kernel("ncclDevKernel_SendRecv", 30, 60, linked=3),
                    kernel("ncclDevKernel_AllGather", 62, 66, linked=5),
                    kernel("ncclDevKernel_Broadcast", 70, 80)]  # the harness's: no span
    rec = spans.reduce(Prof(evs))
    assert rec["comm_exposed_s"] == pytest.approx(0.010 + 0.004)
    assert rec["comm_exposed_by"] == pytest.approx({"nbody.ring.exchange": 0.010,
                                                    "nbody.allgather": 0.004})
    assert rec["spans"]["nbody.force"]["compute_s"] == pytest.approx(0.040)
    assert rec["spans"]["nbody.force"]["device_s"] == pytest.approx(0.050)
    no_comm = spans.reduce(Prof(evs[:5] + evs[-1:]))
    assert no_comm["comm_exposed_s"] is None and no_comm["comm_exposed_by"] == {}


def test_mean_over_ranks():
    a, b = _rec(), spans.reduce(Prof(WINDOW + HOST + DEVICE[:1]))
    m = spans.mean([a, b])
    assert m["busy_s"] == pytest.approx((a["busy_s"] + b["busy_s"]) / 2)
    assert m["spans"]["nbody.force"]["launches"] == pytest.approx(1.5)
    assert m["spans"]["unattributed"]["launches"] == pytest.approx(0.5)
    assert m["comm_exposed_s"] is None and m["comm_exposed_by"] == {}
    assert spans.top(m, 2)[0][0] == "bench.update_many"
    assert len(spans.top(m, 2)) == 2 and len(spans.top(m)[0]) == 5


def test_no_window_no_record():
    with pytest.raises(RuntimeError):
        spans.reduce(Prof(HOST + DEVICE))


SPAN_METRICS = ["force_ms_per_step", "launches_per_step", "program_idle_ms_per_step",
                "p3m_tables_host_ms_per_step", "host_wait_ms_per_step",
                "comm_exposed_ms_per_step"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_a_record(name):
    rec = {"steps": 4, "spans": spans.mean([_rec()])}
    rec["spans"]["spans"].setdefault("nbody.p3m.tables", dict.fromkeys(
        ("device_s", "compute_s", "host_s", "idle_s", "launches"), 0.002))
    rec["spans"]["spans"].setdefault("nbody.host_read", dict.fromkeys(
        ("device_s", "compute_s", "host_s", "idle_s", "launches"), 0.004))
    rec["spans"]["comm_exposed_s"] = 0.008
    want = {"force_ms_per_step": 28 / 4, "launches_per_step": 3 / 4,
            "program_idle_ms_per_step": 22 / 4, "p3m_tables_host_ms_per_step": 2 / 4,
            "host_wait_ms_per_step": 4 / 4, "comm_exposed_ms_per_step": 8 / 4}
    read = spec.load_module("metrics", name).read
    assert read(rec) == pytest.approx(want[name])
    # a record without spans (an untraced run, or a program without them)
    assert read({"steps": 4}) is None


def _old_record():
    return {"window_s": 20.0, "steps": 2000, "segments": 2000, "segment_s": [0.01] * 2000,
            "read_s": [0.001] * 2000, "host_s": 2.0, "replays": 20, "p3m_refreshes": 20,
            "setup_s": 9.0, "first_step_s": 0.1, "bound_s_per_step": 0.004,
            "trace": {"window_s": 20.0, "busy_s": 18.0, "nccl_s": 1.0, "ops": {}, "gaps": []}}


@pytest.mark.parametrize("name", [m["name"] for m in spec.load_json(spec.ROOT / "BENCHMARK.json")
                                  ["end_to_end"] + spec.load_json(spec.ROOT / "BENCHMARK.json")
                                  ["per_layer"]])
def test_older_metrics_read_the_same_with_spans(name):
    read = spec.load_module("metrics", name).read
    rec = _old_record()
    with_spans = dict(rec, spans=spans.mean([_rec()]))
    a, b = read(rec), read(with_spans)
    assert a == b or (math.isnan(a) and math.isnan(b))


def test_trace_reduce_unmoved_by_program_spans():
    """The program's spans (and their device mirrors) change no number of
    trace.reduce but the labels of the idle gaps."""
    bare = [e for e in WINDOW + HOST + DEVICE if not e.name().startswith("nbody.")]
    a, b = trace.reduce(Prof(bare)), trace.reduce(Prof(WINDOW + HOST + DEVICE))
    for key in ("window_s", "busy_s", "ops", "nccl_s"):
        assert a[key] == b[key]
    assert [g[1] for g in a["gaps"]] == [g[1] for g in b["gaps"]]
