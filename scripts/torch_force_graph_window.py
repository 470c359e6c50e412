#!/usr/bin/env python3
"""The P3M cell's traced window with its force calls counted by kind: how
many of the window's force evaluations replay a CUDA graph
(``nbody_tpu_torch/ops/force_graph.py``), and what the graphs hold in
device memory.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_force_graph_window.py --seed <n> [--seconds 20]

It runs ``benchmark/span_run.py``'s window of the cell (``--workload``,
default ``p3m-euler-1m``): set-up and warm-up as ``benchmark/run.py`` makes
them, then the window under torch.profiler. It prints one JSON line:
``step_ms`` of the window, the cell's per-layer metrics and the span
metrics, ``force_calls`` in the window (``BodySystem.force_calls``: eager,
capture, replay) and ``replay_share`` (replays over force evaluations,
eager and replayed); then the graphs the system holds and the bytes they
reserve (the allocator's reserved bytes with the graphs, less without them,
each after ``empty_cache``); ``peak_bytes``; the card's name and power
limit. It checks nothing against the reference: ``benchmark/run.py``
decides ``correct``.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="p3m-euler-1m")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import span_run
    from benchmark.harness import session, spec
    from nbody_tpu_torch.utils.timing import card_line

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # span_run's window, with the system kept and its force calls read
    # around session.window
    held = {}
    build, window = session.build, session.window

    def build_and_keep(*a, **kw):
        compute, ic = build(*a, **kw)
        held["system"] = compute.system
        return compute, ic

    def counted_window(system, *a, **kw):
        before = dict(system.force_calls)
        out = window(system, *a, **kw)
        held["calls"] = {k: v - before[k] for k, v in system.force_calls.items()}
        return out

    session.build, session.window = build_and_keep, counted_window
    cell = spec.cell(args.workload)
    rec = span_run._window(cell, args.seed, args.seconds, session.Rank(0, 1, "cuda", 0))
    session.build, session.window = build, window
    metrics = session.metrics(cell, rec, True)
    for name, unit in span_run.SPAN_METRICS.items():
        value = spec.load_module("metrics", name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    calls = held["calls"]
    out = {"cell": cell["name"], "seed": args.seed, "steps": rec["steps"],
           "step_ms": rec["window_s"] * 1e3 / rec["steps"], "metrics": metrics,
           "force_calls": calls,
           "replay_share": calls["replay"] / max(1, calls["eager"] + calls["replay"]),
           "p3m_refreshes": rec["p3m_refreshes"], "replays": rec["replays"]}
    system = held["system"]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    with_graphs = torch.cuda.memory_reserved()
    graphs = system._force_graphs._graphs
    out["graphs"] = len(graphs)
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["graph_bytes"] = with_graphs - torch.cuda.memory_reserved()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["card"] = card_line()
    out["at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
