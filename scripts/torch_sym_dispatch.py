#!/usr/bin/env python3
"""Measure the each-pair-once force of nbody_tpu_torch on the card, to fix
``sym_default_dispatch`` (ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_sym_dispatch.py [--quick]

First it holds the triangle and rectangle kernels to their plain versions
at small ragged shapes for every tile (1e-4 * max|a| + 1e-4, the bound of
tests/test_pallas.py:76), then it times the force at N = 65536, 135168 and
262144 (shell ICs, demo-0 softening) for each tile and block cap, beside the
one-sided force and step kernels: CUDA events over `reps` calls after one
warm-up call, taken in turns. --quick stops after the checks. Prints one
line per measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import elapsed_ms

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    soft = demo.softening

    def state(n, seed=42, masses=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, _ = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
        if masses:
            pos[:, 3] = np.random.default_rng(7).uniform(0.5, 2.0, n)
        return torch.tensor(pos, device=dev)

    def err(a, b):
        tol = 1e-4 * b.abs().max().item() + 1e-4
        return (a - b).abs().max().item(), tol

    ok = True
    for tile in ck.SYM_TILES:
        for n in (1, 33, 1000, 4099):
            p = state(n, masses=True)
            a = ck.sym_accel_cuda(p, soft, tile=tile)
            e, tol = err(a, reference.compute_accel_symmetric(p, soft))
            same = torch.equal(a, ck.sym_accel_cuda(p, soft, tile=tile))
            ok &= e <= tol and same
            print(f"check tri tile={tile} N={n}: max|da|={e:.3e} tol={tol:.3e} "
                  f"repeat bit-equal={same}")
        for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777)):
            pi, pj = state(bi, seed=3, masses=True), state(bj, masses=True)
            a_k, r_k = ck.sym_cross_cuda(pi, pj, soft, tile=tile)
            a_r, r_r = reference.sym_cross(pi, pj, soft)
            e1, t1 = err(a_k, a_r)
            e2, t2 = err(r_k, r_r)
            ok &= e1 <= t1 and e2 <= t2
            print(f"check cross tile={tile} ({bi},{bj}): acc {e1:.3e}/{t1:.3e} "
                  f"react {e2:.3e}/{t2:.3e}")
    p = state(65536)
    a_k = ck.compute_accel_symmetric_blocked_cuda(p, soft, block_cap=32768, tile=256)
    e, tol = err(a_k, reference.compute_accel(p, soft))
    ok &= e <= tol
    print(f"check blocked N=65536 cap=32768 vs one-sided plain: {e:.3e} tol {tol:.3e}")
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if "--quick" in sys.argv:
        return 0

    reps = 10
    for n in (65536, 135168, 262144):
        p = state(n)
        v = torch.zeros_like(p)
        out = (torch.empty_like(p), torch.empty_like(v))
        runs = {
            "one-sided accel": lambda: ck.compute_accel_cuda(p, p, soft),
            "one-sided step": lambda: ck.nbody_step_cuda(p, v, 0.016, soft, 1.0, out=out),
        }
        caps = sorted({n, n // 2, 131072, 65536, 32768})
        for tile in ck.SYM_TILES:
            for cap in caps:
                if cap > n or (tile < 512 and n > 135168):
                    continue
                runs[f"sym tile={tile} cap={cap}"] = (
                    lambda tile=tile, cap=cap: ck.compute_accel_symmetric_blocked_cuda(
                        p, soft, block_cap=cap, tile=tile))
        times = {k: [] for k in runs}
        for fn in runs.values():
            fn()
        for _ in range(2):  # two rounds, in turns
            for k, fn in runs.items():
                times[k].append(elapsed_ms(lambda fn=fn: [fn() for _ in range(reps)], dev) / reps)
        for k, ts in times.items():
            print(f"N={n} {k}: {min(ts):.4f} ms per call (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f") [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
