"""The program's spans (``nbody_tpu_torch.utils.profiling.annotate``): a
shared no-op with no profiler active; under a CPU ``torch.profiler`` the
names of ``profiling.SPANS``, nested as each path steps (a step holds its
force, which holds the P3M and PM stages and a mesh's exchanges); the P3M
probe's one counted read a call; the rollouts' segment in the span's args.
"""

from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.utils import profiling, timing


def span_paths(prof, prefix: str = "nbody.") -> set:
    """The nesting of the profiled `prefix` spans: for each span, the names
    of the spans open around it, outermost first, and its own."""
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.start_ns(), -(e.start_ns() + e.duration_ns()), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cpu and e.name().startswith(prefix))
    out, stack = set(), []
    for start, neg_end, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        stack.append((-neg_end, name))
        out.add(tuple(n for _, n in stack))
    return out


def _system(n, **kw):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=5)
    return BodySystem(n, DEMO_PARAMS[0], device="cpu", state=(pos, vel), **kw)


def test_annotate_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.annotate("nbody.step"), profiling.annotate("nbody.force", "x=1")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        span = profiling.annotate("nbody.step")
        assert span is not a and isinstance(span, torch.profiler.record_function)


STEP = ("nbody.step",)
FORCE = STEP + ("nbody.force",)
PM = {FORCE + ("nbody.pm.deposit",), FORCE + ("nbody.pm.solve",), FORCE + ("nbody.pm.gather",)}
PROBE = {("nbody.p3m.probe",), ("nbody.p3m.probe", "nbody.host_read")}
PATHS = {
    "sym-euler": (dict(variant="sym"), {STEP, FORCE, STEP + ("nbody.integrate",)}),
    "sym-hermite": (dict(variant="sym", integrator="hermite"),
                    {STEP, FORCE, STEP + ("nbody.integrate",)}),
    # the plain short range has no pair tables
    "p3m-plain": (dict(kernel="p3m", backend="torch", p3m_auto_refresh=True),
                  {STEP, FORCE, FORCE + ("nbody.p3m.pairs",), STEP + ("nbody.integrate",)}
                  | PM | PROBE),
    "p3m-cell-list": (dict(kernel="p3m", p3m_short_range="xla"),
                      {STEP, FORCE, FORCE + ("nbody.p3m.tables",), FORCE + ("nbody.p3m.pairs",),
                       FORCE + ("nbody.p3m.pairs", "nbody.host_read"),
                       STEP + ("nbody.integrate",)} | PM | PROBE),
    "pm": (dict(kernel="pm"), {STEP, FORCE, STEP + ("nbody.integrate",)} | PM),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_update_many_spans(path):
    kw, want = PATHS[path]
    s = _system(2048 if "kernel" in kw else 256, **kw)
    s.update_many(1)  # the influence table is made once a process
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.update_many(1)
    got = span_paths(prof)
    assert got == want
    assert {n for p in got for n in p} <= set(profiling.SPANS)


def test_readback_spans_the_copy():
    s = _system(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ = s.positions, s.velocities
    assert span_paths(prof) == {("nbody.readback",)}


def test_ring_euler_spans_on_two_ranks(tmp_path):
    """Ring Euler on a two-rank gloo mesh: the hop's exchange inside the
    force, the gathers of the readback inside it."""
    from test_torch_sharded_ranks import RankPool

    pos, vel = ic.generate(NBodyConfig.SHELL, 512, 1.54, 8.0, seed=5)
    pool = RankPool(2, str(tmp_path / "store"))
    try:
        got = pool.run("step_span_paths", "ring", DEMO_PARAMS[0], (pos, vel), 1)
    finally:
        pool.close()
    want = {STEP, FORCE, FORCE + ("nbody.ring.exchange",), STEP + ("nbody.integrate",),
            ("nbody.readback",), ("nbody.readback", "nbody.allgather")}
    for paths in got:
        assert set(paths) == want


@pytest.mark.parametrize("steps", [1, 3])
def test_p3m_probe_read_is_counted_once_a_call(steps):
    s = _system(2048, kernel="p3m", p3m_auto_refresh=True)
    before = timing.HOST_READS["p3m_probe"]
    s.update_many(steps)
    s.update_many(steps)
    assert timing.HOST_READS["p3m_probe"] == before + 2


def test_host_read_span_names_what_it_reads():
    seen = []
    with profile(activities=[ProfilerActivity.CPU]), \
            mock.patch.object(torch.profiler, "record_function",
                              lambda name, args=None: seen.append((name, args))
                              or profiling._NO_SPAN):
        assert timing.host_read(torch.tensor([1, 2]), "test_what") == [1, 2]
    assert seen == [("nbody.host_read", "what=test_what")]


@pytest.mark.parametrize("rollout", ["adaptive", "block", "ds_adaptive"])
def test_rollout_spans_carry_the_segment_in_args(rollout):
    seen = []

    def record(name, args=None):
        seen.append((name, args))
        return profiling._NO_SPAN

    if rollout == "ds_adaptive":
        pos, vel = ic.generate(NBodyConfig.SHELL, 256, 1.54, 8.0, seed=5)
        s = DSBodySystem(256, DEMO_PARAMS[0], device="cpu", state=(pos, vel))
    else:
        s = _system(256)
    with profile(activities=[ProfilerActivity.CPU]), \
            mock.patch.object(torch.profiler, "record_function", record):
        if rollout == "block":
            s.update_many_block(3)
        else:
            s.update_many_adaptive(3)
    name = f"nbody.{rollout}_rollout"
    assert (name, "seg=3") in seen
    assert {n for n, _ in seen} <= set(profiling.SPANS)
    assert not any("[" in n for n in profiling.SPANS)
