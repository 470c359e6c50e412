#!/usr/bin/env python3
"""Count the torchrun CLI runs that end abnormally, for one or more checkouts
of nbody_tpu_torch, in the same rounds.

Run from anywhere, on the CPU:

    python3 scripts/torch_exit_abort_count.py DIR [DIR ...] [--rounds 24] [--pairs 3]

Each DIR holds a ``nbody_tpu_torch`` package (a checkout, or a copy of the
package with a variant of its code). A round takes each DIR in turn, the
first DIR rotating from round to round, and starts `pairs` pairs of the two
torchrun commands of ``tests/test_torch_sharded.py::
test_cli_under_torchrun_on_two_gloo_ranks`` at once (two gloo ranks each,
``--cpu --devices 2 --qatest``, fp32 ring and ds allgather), with DIR on
PYTHONPATH and as the working directory. A run counts as an abort when its
exit code is not 0; the line says whether its standard error holds
"terminate called" (the SIGABRT of ROADMAP.md, Queue 3). Prints each abort
and the counts (aborts, runs) of every DIR after every round.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

RUNS = (["--qatest", "--numbodies", "250", "--strategy", "ring"],
        ["--precision", "ds", "--qatest", "--numbodies", "99", "--strategy", "allgather"])


def one_round(checkout: pathlib.Path, pairs: int) -> list:
    """(exit code, stderr) of `pairs` pairs of the test's torchrun commands,
    all started at once, from `checkout`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(checkout)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", "2", *args],
        cwd=checkout, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(pairs) for args in RUNS]
    results = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        results.append((p.returncode, err))
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", type=pathlib.Path, nargs="+",
                    help="directories that hold a nbody_tpu_torch package")
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--pairs", type=int, default=3, help="pairs of commands started at once")
    args = ap.parse_args()
    dirs = [d.resolve() for d in args.checkouts]
    for d in dirs:
        if not (d / "nbody_tpu_torch").is_dir():
            print(f"{d} holds no nbody_tpu_torch package", file=sys.stderr)
            return 2
    counts = {str(d): [0, 0] for d in dirs}
    for r in range(args.rounds):
        for d in dirs[r % len(dirs):] + dirs[:r % len(dirs)]:
            for rc, err in one_round(d, args.pairs):
                counts[str(d)][1] += 1
                if rc != 0:
                    counts[str(d)][0] += 1
                    print(f"round {r} {d}: exit {rc}, terminate called: "
                          f"{'terminate called' in err}", flush=True)
        print(f"after round {r}: {json.dumps(counts)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
