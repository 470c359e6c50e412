"""Running the benchmark on the CPU at a small size, as the tests do: the
look for a card is skipped, the rest of a run is the run's own."""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
SITE = pathlib.Path(__file__).resolve().parent / "fault_site"


def run_cell(cell: str, *, n: int, seconds: float = 1.0, seed: int = 7, trace: int = 0,
             fault: str | None = None, timeout: float = 240):
    """(exit code, the last stdout line as a dict or None, stderr) of
    ``run.main`` on the CPU in a process of its own, with `fault` planted."""
    env = dict(os.environ, BENCHMARK_TEST_ROOT=str(ROOT), PYTHONPATH=str(ROOT))
    if fault:
        env["BENCHMARK_TEST_FAULT"] = fault
        env["PYTHONPATH"] = os.pathsep.join([str(SITE), str(ROOT)])
    code = ("import sys; from benchmark import run; "
            f"sys.exit(run.main(sys.argv[1:], device='cpu', n={n}))")
    p = subprocess.run([sys.executable, "-c", code, "--workload", cell, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
