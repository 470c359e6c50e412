#!/usr/bin/env python3
"""One traced run of a cell, attributed by span: the run's window as
``run.py --trace 1`` drives it, its device time, launches and idle time by
the program's and the harness's spans (``harness/spans.py``), and the
per-layer metrics that read them.

    python3 benchmark/span_run.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on as many cards as the cell asks for. It
prints one JSON line last: ``step_ms`` of the traced window, ``metrics``
(the cell's per-layer metrics of BENCHMARK.json and the span metrics of
``SPAN_METRICS``, each where it reads something), ``spans`` (the 12 spans
with the most device time: name, device s, host s, idle s, launches),
``unattributed_share`` (of the busy time), ``routes`` (how the device ops
found their launch), ``comm_exposed_by`` (the exposed communication by
span) and ``device``. It checks nothing against the
reference: ``run.py`` decides ``correct``.
"""

import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

SPAN_METRICS = {"force_ms_per_step": "ms", "launches_per_step": "count",
                "program_idle_ms_per_step": "ms", "p3m_tables_host_ms_per_step": "ms",
                "host_wait_ms_per_step": "ms", "comm_exposed_ms_per_step": "ms"}


def _window(cell: dict, seed: int, seconds: float, rank, n=None) -> dict:
    """Set-up and warm-up as ``session.run`` makes them, then the window
    under the profiler; this rank's records with "trace" and "spans"."""
    import torch

    from benchmark.harness import session, spans, spec, trace

    compute, ic = session.build(cell, seed, rank, n=n)
    system = compute.system
    wl = cell["workload"]
    k = int(wl["steps_per_segment"])
    dt = cell["config"]["params"]["time_step"]
    t = time.perf_counter()
    system.update_many(1, dt)
    system.synchronize()
    first_step_s = time.perf_counter() - t
    system.update_many(k, dt)
    system.synchronize()
    _ = system.positions
    if wl.get("replay_steps"):
        session.restart(system, ic)
    else:
        system.set_state(*ic)
    system.synchronize()
    prof = trace.profiler()
    prof.__enter__()
    try:
        rec, _, _ = session.window(system, ic, cell, seconds, rank, [])
    finally:
        prof.__exit__(None, None, None)
    rec["first_step_s"] = first_step_s
    rec["trace"] = trace.reduce(prof)
    rec["spans"] = spans.reduce(prof)
    gathered = rank.gather({"trace": rec["trace"], "spans": rec["spans"]})
    traces = [g["trace"] for g in gathered]
    for key in ("busy_s", "window_s", "nccl_s"):
        rec["trace"][key] = sum(tr[key] for tr in traces) / len(traces)
    rec["spans"] = spans.mean([g["spans"] for g in gathered])
    rec["bound_s_per_step"] = spec.load_module("rooflines", cell["config"]["name"]) \
        .bound_s_per_step(wl if n is None else dict(wl, n=n), cell["config"],
                          torch.as_tensor(ic[0], device=rank.device))
    return rec


def main(argv=None, *, device: str = "cuda", n=None) -> int:
    args = run._args(argv)
    from benchmark.harness import session, spans, spec

    cell = spec.cell(args.workload)
    chips = cell["chips"]
    if args.rank == 0:
        os.environ["XDG_CACHE_HOME"] = run._empty_cache_home()
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"the cell {args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    workers, port = [], args.port
    if chips > 1 and args.rank == 0:
        workers, port = run.spawn_ranks("span_run", argv, chips, device, n)
    try:
        rank = session.Rank(args.rank, chips, device, port)
        rec = _window(cell, args.seed, args.seconds, rank, n=n)
        rank.close()
    except BaseException:
        for w in workers:
            w.kill()
        raise
    finally:
        codes = [w.wait(timeout=300) for w in workers]
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"a rank failed: exit codes {codes}", file=sys.stderr)
        return 4
    metrics = session.metrics(cell, rec, True)
    for name, unit in SPAN_METRICS.items():
        value = spec.load_module("metrics", name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    sp = rec["spans"]
    result = {
        "cell": cell["name"], "steps": rec["steps"],
        "step_ms": rec["window_s"] * 1e3 / rec["steps"],
        "metrics": metrics, "spans": spans.top(sp),
        "unattributed_share": sp["unattributed_s"] / sp["busy_s"] if sp["busy_s"] else None,
        "routes": sp["routes"], "comm_exposed_by": sp["comm_exposed_by"],
        "program_ops_in_trace": sorted(k for k in rec["trace"]["ops"] if k.startswith("nbody.")),
        "device": {"kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": chips, "busy_s": rec["trace"]["busy_s"],
                   "window_s": rec["trace"]["window_s"]},
    }
    print(json.dumps(run._finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
