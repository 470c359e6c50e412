#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... --control C1 C2 C3

In one process (one a card for a four-card cell) it builds the cell's system
once, and for each seed sets the seed's initial state and runs the window
up to the last segment the check samples, then compares the sampled
snapshots with the float64 reference as a run does (``harness/check.py``):
the program's readings. For each --control seed it also puts the control in
the program's place, the reference in TF32 (``reference.allpairs``), from
the same start states, and reads the same number: the control's readings.
Rank 0 prints a JSON line per seed and a summary: the largest program
reading (the lower one) and the smallest control reading (the upper one).
"""

import argparse
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.run import _empty_cache_home, spawn_ranks  # noqa: E402


def main(argv=None, *, device: str = "cuda", n=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from benchmark import reference
    from benchmark.harness import check, inputs, session, spec

    cell = spec.cell(args.workload)
    wl, cfg = cell["workload"], cell["config"]
    chips, k = cell["chips"], int(wl["steps_per_segment"])
    if args.rank == 0:
        os.environ["XDG_CACHE_HOME"] = _empty_cache_home()
    workers, port = [], args.port
    if chips > 1 and args.rank == 0:
        workers, port = spawn_ranks("calibrate", argv, chips, device, n)
    rank = session.Rank(args.rank, chips, device, port)
    compute, _ = session.build(cell, args.seeds[0], rank, n=n)
    system = compute.system
    par = cfg["params"]
    size = wl["n"] if n is None else n
    rows = group = None
    if chips > 1:
        nloc = -(-size // chips)
        rows = slice(rank.rank * nloc, min(size, (rank.rank + 1) * nloc))
        group = rank.mesh.group
    lower, upper = 0.0, math.inf
    for seed in list(args.seeds) + [s for s in args.control if s not in args.seeds]:
        ic = inputs.shell(size, par["cluster_scale"], par["velocity_scale"], seed)
        session.restart(system, ic)
        samples = check.sample_segments(seed, wl["check"])
        t0 = time.perf_counter()
        rec, kept, snaps = session.window(system, ic, cell, math.inf, rank, samples,
                                          max_segments=max(samples) + 1)
        line = {"seed": seed, "segments": rec["segments"], "window_s": rec["window_s"]}
        if seed in args.seeds:
            v = check.judge(kept, snaps, ic, steps=k, config=cfg, integrator=wl["integrator"],
                            limits=wl["check"]["limits"], rows=rows, group=group)
            line["program"] = v["readings"]
            line["start_exact"] = v["numbers"]["start_exact"][0]
            lower = max([lower] + v["readings"])
        if seed in args.control:
            def tf32(p, vel):
                out = reference.advance(p, vel, k, config=cfg, integrator=wl["integrator"],
                                        precision="tf32", rows=rows)
                return out if rows is not None else out[0]
            readings = []
            for s in sorted(kept):
                gap, moved = check.segment_gap(kept[s], None, steps=k, config=cfg,
                                               integrator=wl["integrator"], candidate=tf32,
                                               rows=rows, group=group)
                readings.append(gap / moved if moved > 0 else math.inf)
            line["control"] = readings
            upper = min([upper] + readings)
        line["seconds"] = time.perf_counter() - t0
        if rank.rank == 0:
            print(json.dumps(line), flush=True)
    rank.close()
    codes = [w.wait(timeout=600) for w in workers]
    if rank.rank == 0:
        print(json.dumps({"cell": args.workload, "lower": lower, "upper": upper,
                          "ratio": upper / lower if lower else None, "ranks": codes,
                          "device": (__import__("torch").cuda.get_device_name(0)
                                     if device == "cuda" else "cpu")}), flush=True)
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
