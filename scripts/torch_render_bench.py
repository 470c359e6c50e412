#!/usr/bin/env python3
"""Measure nbody_tpu_torch's rasterizer (render/rasterizer.py) on the card,
each case in a fresh process, so that a process's first calls show.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_render_bench.py

1. The first and the second frame of a process (host clock, the uint8
   frame on the host) at N = 65536, 1024x768, sprites_color, splat 16
   (the demo's), by scatter and by conv.
2. The first and the second call of a process of the deposit's scatter-add
   (16,777,216 values into a 1024x768x3 buffer, the scatter frame's chunk)
   and of 1000 values: ``index_add_`` in deterministic mode (the
   rasterizer's and the P3M deposit's), a stable ``torch.sort`` of the
   indices alone, and ``index_add_`` with atomics (nondeterministic).
Prints one line per case and nvidia-smi's name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

FRAME = r'''
import sys, time, torch
from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu_torch.render import Camera, FrameRenderer
method = sys.argv[1]
p = DEMO_PARAMS[0]
pos = torch.tensor(ic.generate(NBodyConfig.SHELL, 65536, p.cluster_scale, p.velocity_scale,
                               seed=42)[0], device="cuda")
r = FrameRenderer(1024, 768, splat=16, method=method)
times = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(pos, Camera(p.camera_origin))
    times.append(1e3 * (time.perf_counter() - t0))
print(f"frame, {method}, N=65536, 1024x768, splat 16: first {times[0]:.1f} ms, "
      f"second {times[1]:.3f} ms")
'''

DEPOSIT = r'''
import sys, time, torch
from nbody_tpu_torch.utils.ordered import index_add_ordered
how, n = sys.argv[1], int(sys.argv[2])
torch.zeros(1, device="cuda")
g = torch.Generator(device="cuda").manual_seed(1)
buf = torch.zeros(3 * 1024 * 768 + 1, device="cuda")
idx = torch.randint(0, buf.numel(), (n,), device="cuda", generator=g)
val = torch.rand(n, device="cuda", generator=g)
run = {"deterministic": lambda: index_add_ordered(buf, idx, val),
       "sort": lambda: torch.sort(idx, stable=True),
       "atomic": lambda: buf.index_add_(0, idx, val)}[how]
times = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
print(f"scatter-add {how}, {n} values: first {times[0]:.1f} ms, second {times[1]:.3f} ms")
'''


def fresh(code: str, *args: str) -> None:
    """`code` with `args` in a new interpreter; prints its line."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        raise SystemExit(f"case {args} failed")
    print(proc.stdout.strip())


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import torch

    if not torch.cuda.is_available():
        print("torch_render_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    for method in ("scatter", "conv"):
        fresh(FRAME, method)
    for how in ("deterministic", "sort", "atomic"):
        for n in (1000, 16777216):
            fresh(DEPOSIT, how, str(n))
    sys.path.insert(0, str(ROOT))
    from nbody_tpu_torch.utils.timing import card_line

    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
