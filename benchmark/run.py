#!/usr/bin/env python3
"""The benchmark of nbody_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for. It makes the cell's initial state from --seed, builds the
system, warms up the cell's own shapes, drives the measured window for
--seconds (``harness/session.py``), checks the snapshots the window read
against the plain reference (``harness/check.py``), and prints one JSON line
last: ``correct``, ``attempted`` (segments), ``failed`` (compared segments
over their limit), ``metrics`` (the end-to-end ones; with --trace 1 the
per-layer ones, read from torch.profiler's trace of the window), ``device``,
``breakdown`` (traced), and ``checks``, each compared number beside its
limit, which also end standard error.

A four-card cell runs four ranks: this process is rank 0 and starts the
other three, each a process of its own on its own card.

The kernels build into build/nbody_tpu_torch/ of the checkout (the P3M
influence tables too), so only a checkout's first run builds them. The
program's tuner cache is pointed at an empty directory under $TMPDIR, so no
tuned cache decides what ``variant="auto"`` runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank the first process starts (four-card cells)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _empty_cache_home() -> str:
    """An empty directory at a fixed path under $TMPDIR for the program's
    XDG cache (its tuner reads $XDG_CACHE_HOME/nbody_tpu_torch)."""
    path = pathlib.Path(tempfile.gettempdir()) / "nbody_benchmark_xdg"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finite(x):
    """`x` with every non-finite number as null: the line stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def spawn_ranks(entry: str, argv, chips: int, device: str, n=None):
    """Start ranks 1 .. chips-1 of benchmark/<entry>.py's main, each a
    process of its own; returns (processes, the rendezvous port)."""
    port = _free_port()
    boot = ("import sys; sys.path.insert(0, sys.argv[1]); import importlib; "
            "m = importlib.import_module('benchmark.' + sys.argv[2]); "
            "sys.exit(m.main(sys.argv[5:], device=sys.argv[3], "
            "n=int(sys.argv[4]) if sys.argv[4] else None))")
    base = list(argv) if argv is not None else sys.argv[1:]
    procs = [subprocess.Popen([sys.executable, "-c", boot, str(ROOT), entry, device,
                               "" if n is None else str(n), *base,
                               "--rank", str(r), "--port", str(port)])
             for r in range(1, chips)]
    return procs, port


def main(argv=None, *, device: str = "cuda", n=None) -> int:
    """Run the cell; `device` "cpu" (with a small `n`) is for the tests,
    which skip the look for a card and drive the rest of a run."""
    args = _args(argv)
    from benchmark.harness import guard, session, spec

    cell = spec.cell(args.workload)
    chips = cell["chips"]
    if args.rank == 0:
        os.environ["XDG_CACHE_HOME"] = _empty_cache_home()
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"the cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    workers, port = [], args.port
    if chips > 1 and args.rank == 0:
        workers, port = spawn_ranks("run", argv, chips, device, n)
    try:
        rank = session.Rank(args.rank, chips, device, port)
        rec = session.run(cell, args.seed, args.seconds, bool(args.trace), rank, T_START, n=n)
        rank.close()
    except BaseException:
        for w in workers:
            w.kill()
        raise
    finally:
        codes = [w.wait(timeout=300) for w in workers]
    found = guard.forbidden_modules()
    if found:
        print(f"modules of the JAX package or JAX are loaded: {found}", file=sys.stderr)
        return 3
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"a rank failed: exit codes {codes}", file=sys.stderr)
        return 4
    verdict = rec["check"]
    result = {
        "correct": verdict["correct"],
        "attempted": rec["segments"],
        "failed": verdict["failed"],
        "metrics": session.metrics(cell, rec, bool(args.trace)),
        "device": {
            "platform": "gpu" if device == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
            "count": chips,
            "memory_peak_bytes": rec["memory_peak_bytes"],
        },
    }
    if args.trace:
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = session.breakdown(rec)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in verdict["numbers"].items()}
    for k, (v, lim) in verdict["numbers"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(_finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
