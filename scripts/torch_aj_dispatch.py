#!/usr/bin/env python3
"""Measure the accel + jerk kernels of nbody_tpu_torch on the card, to fix
``aj_sym_default_dispatch`` (ops/cuda_kernel.py) and the Hermite row of
``AUTO_VARIANT_CUDA`` (models/body_system.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_aj_dispatch.py [--quick]

First it prints what ptxas says of every kernel of
csrc/symmetric_aj_kernels.cu and csrc/nbody_kernels.cu (registers, spills,
shared memory), then it holds the accel + jerk kernels (one-sided, triangle,
rectangle) and the potential kernel to their plain versions at small ragged
shapes for every tile, with masses from [0.5, 2] and a random vel.w:
acceleration and jerk each within 1e-4 * max + 1e-4, the bound of
tests/test_pallas.py:76. --quick stops there. Then it times, at N = 65536,
135168 and 262144 (shell ICs, demo-0 softening), the one-sided accel + jerk
kernel per block size and the each-pair-once composition per tile and block
cap, beside the potential kernel: CUDA events over `reps` calls after one
warm-up call, two rounds taken in turns. Prints one line per measurement and
the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ptxas_report() -> None:
    """Compile each source once more with -Xptxas -v and print what ptxas
    says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("symmetric_aj_kernels.cu", "nbody_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def main() -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import energy, reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    ptxas_report()
    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    soft = demo.softening

    def state(n, seed=42, masses=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
        if masses:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)

    ok = True

    def held(what, got, want, names=("acc", "jerk", "react acc", "react jerk")):
        nonlocal ok
        for name, g, w in zip(names, got, want):
            tol = 1e-4 * w.abs().max().item() + 1e-4
            e = (g - w).abs().max().item()
            ok &= bool(e <= tol and torch.isfinite(g).all())
            print(f"check {what} {name}: max|d|={e:.3e} tol={tol:.3e}")

    for tile in ck.SYM_TILES:
        for n in (1, 33, 1000, 4099):
            p, v = state(n, masses=True)
            got = ck.aj_sym_cuda(p, v, soft, tile=tile)
            same = all(torch.equal(a, b) for a, b in zip(got, ck.aj_sym_cuda(p, v, soft, tile=tile)))
            ok &= same
            held(f"tri tile={tile} N={n} (repeat bit-equal {same})", got,
                 reference.compute_accel_jerk_symmetric(p, v, soft))
        for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777)):
            (pi, vi), (pj, vj) = state(bi, seed=3, masses=True), state(bj, masses=True)
            held(f"cross tile={tile} ({bi},{bj})", ck.aj_sym_cross_cuda(pi, vi, pj, vj, soft, tile=tile),
                 reference.aj_sym_cross(pi, vi, pj, vj, soft))
    for bs in (128, 256):
        for m, n in ((1000, 1000), (777, 4099), (4099, 777)):
            pi, vi = state(m, seed=3, masses=True)
            pj, vj = state(n, masses=True)
            held(f"one-sided block={bs} ({m},{n})",
                 ck.compute_accel_jerk_cuda(pi, vi, pj, vj, soft, block_size=bs),
                 reference.compute_accel_jerk_vs(pi, vi, pj, vj, soft))
        for n in (1, 1000, 4099):
            p, _ = state(n, masses=True)
            got = ck.potential_energy_per_row_cuda(p, soft, block_size=bs)
            held(f"potential block={bs} N={n}", (got,),
                 (energy.potential_energy_per_row(p, soft),), names=("per-row sums",))
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if "--quick" in sys.argv:
        return 0

    reps = 5
    for n in (65536, 135168, 262144):
        p, v = state(n)
        runs = {}
        for bs in (128, 256, 512):
            if n <= 135168 or bs == 256:
                runs[f"one-sided accel+jerk block={bs}"] = (
                    lambda bs=bs: ck.compute_accel_jerk_cuda(p, v, p, v, soft, block_size=bs))
        caps = sorted({n, n // 2, 131072, 98304, 65536, 32768})
        for tile in ck.SYM_TILES:
            for cap in caps:
                if cap > n or (tile < 512 and n > 135168):
                    continue
                runs[f"sym accel+jerk tile={tile} cap={cap}"] = (
                    lambda tile=tile, cap=cap: ck.compute_accel_jerk_symmetric_blocked_cuda(
                        p, v, soft, block_cap=cap, tile=tile))
        if n == 65536:
            for bs in (128, 256, 512):
                runs[f"potential block={bs}"] = (
                    lambda bs=bs: ck.potential_energy_per_row_cuda(p, soft, block_size=bs))
        times = {k: [] for k in runs}
        for fn in runs.values():
            fn()
        for _ in range(2):  # two rounds, in turns
            for k, fn in runs.items():
                times[k].append(elapsed_ms(lambda fn=fn: [fn() for _ in range(reps)], dev) / reps)
        for k, ts in times.items():
            print(f"N={n} {k}: {min(ts):.4f} ms per call (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f") [{smi}]")
        del p, v, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
