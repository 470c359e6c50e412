#!/usr/bin/env python3
"""Measure the double-single kernels of nbody_tpu_torch on the card, to fix
``ds_sym_default_dispatch`` and the ds block size (ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ds_dispatch.py [--quick]

First it prints what ptxas says of every kernel of csrc/ds_kernels.cu and
csrc/ds_symmetric_kernels.cu (registers, spills, shared memory). Then it
holds the ds kernels to their plain versions (ops/ds.py) at small ragged
shapes, for every tile and two block sizes, with shell ICs, masses drawn in
float64 from [0.5, 2] (so with a lo part), a random vel.w and damping 0.5:
each output, as hi + lo in float64, within 1e-12 * max + 1e-14, repeat
calls bit-equal, and each force within 1e-10 * max|a| of the float64
oracle's. --quick stops there. Then it times, at N = 16384, 32768, 65536
and 131072 (shell ICs, demo-0 softening), the one-sided ds step per block size,
the ds leapfrog step, and the each-pair-once ds force per tile and block
cap, beside the fp32 one-sided step and sym force at the same N: CUDA events
over `reps` calls after one warm-up call, two rounds taken in turns. Prints
one line per measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ptxas_report() -> None:
    """Compile each ds source once more with -Xptxas -v and print what
    ptxas says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("ds_kernels.cu", "ds_symmetric_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def main() -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds
    from nbody_tpu_torch.oracle.native import accel_native, native_available
    from nbody_tpu_torch.oracle.numpy_oracle import accel_numpy
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
    oracle_accel = accel_native if native_available() else accel_numpy

    def state64(n, seed=42, masses=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed, dtype=np.float64)
        if masses:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        return pos, vel

    def planes(n, seed=42, masses=False):
        pos, vel = state64(n, seed, masses)
        return tuple(t.to(dev) for t in (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel)))

    ok = True

    def held(what, got, want):
        """Pairs of (hi, lo) tensors, compared as float64."""
        nonlocal ok
        for k, (g, w) in enumerate(zip(got, want)):
            g64, w64 = ds.ds_to_f64(*g), ds.ds_to_f64(*w)
            tol = 1e-12 * np.abs(w64).max() + 1e-14
            e = float(np.abs(g64 - w64).max()) if g64.size else 0.0
            ok &= bool(e <= tol and np.isfinite(g64).all())
            print(f"check {what} [{k}]: max|d|={e:.3e} tol={tol:.3e}")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    scal = ds.scal_ds(demo.time_step, soft, 0.5)
    lscal = ds.scal_ds_leapfrog(demo.time_step, soft, 0.5)
    for tile in ck.SYM_TILES:
        for n in (1, 33, 1000, 4099):
            ph, pl, _, _ = planes(n, masses=True)
            got = ck.ds_sym_accel_cuda(ph, pl, scal, tile=tile)
            rep = same(got, ck.ds_sym_accel_cuda(ph, pl, scal, tile=tile))
            ok &= rep
            held(f"ds tri tile={tile} N={n} (repeat bit-equal {rep})", [got],
                 [ds.ds_accel_symmetric(ph, pl, scal)])
        for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777)):
            ih, il, _, _ = planes(bi, seed=3, masses=True)
            jh, jl, _, _ = planes(bj, masses=True)
            got = ck.ds_sym_cross_cuda(ih, il, jh, jl, scal, tile=tile)
            want = ds.ds_sym_cross(ih, il, jh, jl, scal)
            held(f"ds cross tile={tile} ({bi},{bj})", [got[:2], got[2:]], [want[:2], want[2:]])
    for bs in (128, 256):
        for m, n in ((1000, 1000), (777, 4099), (4099, 777)):
            pi = planes(m, seed=3, masses=True)
            pj = planes(n, masses=True)
            got = ck.nbody_step_ds_cuda_vs(*pi, pj[0], pj[1], scal, block_size=bs)
            rep = same(got, ck.nbody_step_ds_cuda_vs(*pi, pj[0], pj[1], scal, block_size=bs))
            ok &= rep
            want = ds.nbody_step_ds_vs(*pi, pj[0], pj[1], scal)
            held(f"ds step block={bs} ({m},{n}) (repeat bit-equal {rep})",
                 [got[:2], got[2:]], [want[:2], want[2:]])
            got = ck.nbody_step_ds_leapfrog_cuda_vs(*pi, *pj, lscal, block_size=bs)
            want = ds.nbody_step_ds_leapfrog_vs(*pi, *pj, lscal)
            held(f"ds leapfrog block={bs} ({m},{n})", [got[:2], got[2:]], [want[:2], want[2:]])
    # the ds force against the float64 oracle's, which a float32-grade
    # force misses by three orders
    pos, _ = state64(4099, masses=True)
    ph, pl = (t.to(dev) for t in ds.ds_from_f64(pos))
    ref = oracle_accel(pos, soft)
    for what, acc in (("sym", ck.ds_sym_accel_cuda(ph, pl, scal)),
                      ("blocked cap 2048", ck.compute_accel_ds_symmetric_blocked_cuda(
                          ph, pl, scal, block_cap=2048, tile=256))):
        e = float(np.abs(ds.ds_to_f64(*acc) - ref).max()) / float(np.abs(ref).max())
        ok &= e <= 1e-10
        print(f"check ds {what} force N=4099 vs float64 oracle: max|da|/max|a| = {e:.3e} "
              "(bound 1e-10)")
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if "--quick" in sys.argv:
        return 0

    reps = 3
    for n in (16384, 32768, 65536, 131072):
        p4 = planes(n)
        p32, v32 = (torch.tensor(a.astype(np.float32), device=dev) for a in state64(n))
        out = tuple(torch.empty_like(p4[0]) for _ in range(4))
        out32 = (torch.empty_like(p32), torch.empty_like(v32))
        runs = {
            "fp32 one-sided step": lambda: ck.nbody_step_cuda(p32, v32, 0.016, soft, 1.0,
                                                              out=out32),
            "fp32 sym force": lambda: ck.compute_accel_symmetric_blocked_cuda(p32, soft),
            "ds leapfrog block=256": lambda: ck.nbody_step_ds_leapfrog_cuda(*p4, lscal, out=out),
        }
        for bs in (64, 128, 256):
            runs[f"ds step block={bs}"] = (
                lambda bs=bs: ck.nbody_step_ds_cuda(*p4, scal, block_size=bs, out=out))
        caps = sorted({n, n // 2, 65536, 32768, 16384})
        for tile in ck.SYM_TILES:
            for cap in caps:
                if cap > n or (tile == 128 and n > 65536):
                    continue
                runs[f"ds sym tile={tile} cap={cap}"] = (
                    lambda tile=tile, cap=cap: ck.compute_accel_ds_symmetric_blocked_cuda(
                        p4[0], p4[1], scal, block_cap=cap, tile=tile))
        times = {k: [] for k in runs}
        for fn in runs.values():
            fn()
        for _ in range(2):  # two rounds, in turns
            for k, fn in runs.items():
                times[k].append(elapsed_ms(lambda fn=fn: [fn() for _ in range(reps)], dev) / reps)
        for k, ts in times.items():
            print(f"N={n} {k}: {min(ts):.4f} ms per call (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f") [{smi}]")
        del p4, p32, v32, out, out32, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
