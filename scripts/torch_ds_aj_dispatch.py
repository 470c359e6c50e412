#!/usr/bin/env python3
"""Measure the double-single accel + jerk kernels of nbody_tpu_torch on the
card, to fix ``ds_aj_sym_default_dispatch`` and to check that the one-sided
kernel fits the ds step's ``ds_default_block_size`` (ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ds_aj_dispatch.py [--quick]

First it prints what ptxas says of every kernel of csrc/ds_aj_kernels.cu
and csrc/ds_symmetric_aj_kernels.cu (registers, spills, shared memory).
Then it holds the kernels to their plain versions (ops/ds.py) at small
ragged shapes, for every tile and two block sizes, with shell ICs, masses
drawn in float64 from [0.5, 2] (so with a lo part) and a random vel.w:
each output, as hi + lo in float64, within 1e-12 * max + 1e-14, repeat
calls bit-equal, the Hermite predictor and corrector kernels against
theirs, and each force and jerk within 1e-10 * max of the float64
oracle's. --quick stops there. Then it times, at N = 16384, 32768, 36864
and 65536 (shell ICs, demo-0 softening), the one-sided ds accel + jerk per
block size and the each-pair-once one per tile and block cap (at N above
32768, cap 32768 composes triangles and rectangles of N/2), beside the
ds force triangle at the same N: CUDA events over `reps` calls after one
warm-up call, two rounds taken in turns. Prints one line per measurement
and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ptxas_report() -> None:
    """Compile each ds accel + jerk source once more with -Xptxas -v and
    print what ptxas says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("ds_aj_kernels.cu", "ds_symmetric_aj_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def main() -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import ds
    from nbody_tpu_torch.oracle.native import accel_jerk_native, native_available
    from nbody_tpu_torch.oracle.numpy_oracle import accel_jerk_numpy
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
    oracle = accel_jerk_native if native_available() else accel_jerk_numpy

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
        """Tuples of tensors, taken as (hi, lo) pairs and compared as float64."""
        nonlocal ok
        for k in range(0, len(got), 2):
            g64, w64 = ds.ds_to_f64(*got[k:k + 2]), ds.ds_to_f64(*want[k:k + 2])
            tol = 1e-12 * np.abs(w64).max() + 1e-14 if w64.size else 0.0
            e = float(np.abs(g64 - w64).max()) if g64.size else 0.0
            ok &= bool(e <= tol and np.isfinite(g64).all())
            print(f"check {what} [{k // 2}]: max|d|={e:.3e} tol={tol:.3e}")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    scal = ds.scal_ds_hermite(demo.time_step, soft, 0.5)
    for tile in ck.DS_AJ_TILES:
        for n in (1, 33, 1000, 4099):
            p = planes(n, masses=True)
            got = ck.ds_aj_sym_cuda(*p, scal, tile=tile)
            rep = same(got, ck.ds_aj_sym_cuda(*p, scal, tile=tile))
            ok &= rep
            held(f"ds aj tri tile={tile} N={n} (repeat bit-equal {rep})", got,
                 ds.ds_accel_jerk_symmetric(*p, scal))
        for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777)):
            pi = planes(bi, seed=3, masses=True)
            pj = planes(bj, masses=True)
            held(f"ds aj cross tile={tile} ({bi},{bj})", ck.ds_aj_sym_cross_cuda(
                *pi, *pj, scal, tile=tile), ds.ds_aj_sym_cross(*pi, *pj, scal))
    for bs in (128, 256):
        for m, n in ((1000, 1000), (777, 4099), (4099, 777)):
            pi = planes(m, seed=3, masses=True)
            pj = planes(n, masses=True)
            got = ck.compute_accel_jerk_ds_cuda_vs(*pi, *pj, scal, block_size=bs)
            rep = same(got, ck.compute_accel_jerk_ds_cuda_vs(*pi, *pj, scal, block_size=bs))
            ok &= rep
            held(f"ds aj one-sided block={bs} ({m},{n}) (repeat bit-equal {rep})", got,
                 ds.ds_accel_jerk_vs(*pi, *pj, scal))
    # the glue, from the kernels' own fields: the (N,4) one-sided and the
    # (N,3) composition
    p = planes(4099, masses=True)
    for what, aj in (("one-sided", lambda s: ck.compute_accel_jerk_ds_cuda_vs(*s, *s, scal)),
                     ("sym", lambda s: ck.compute_accel_jerk_ds_symmetric_blocked_cuda(*s, scal))):
        f0 = aj(p)
        pred = ck.ds_hermite_predict_cuda(*p, *f0, scal)
        want = ds.ds_hermite_predict(*p, f0[:2], f0[2:], scal)
        held(f"ds Hermite predict ({what} fields; bit-equal {same(pred, want)})", pred, want)
        f1 = aj(pred)
        new = ck.ds_hermite_correct_cuda(*p, *f0, *f1[:2], *f1[2:], scal)
        want = ds.ds_hermite_correct(*p, f0[:2], f0[2:], f1[:2], f1[2:], scal)
        held(f"ds Hermite correct ({what} fields; bit-equal {same(new, want)})", new, want)
        kept = all(torch.equal(a[:, 3], b[:, 3]) for a, b in zip((*pred, *new), (*p, *p)))
        ok &= kept
        print(f"check ds Hermite glue ({what}): mass and vel.w kept in both planes: {kept}")
    # the ds force and jerk against the float64 oracle's, which a
    # float32-grade one misses by three orders
    pos, vel = state64(4099, masses=True)
    ref = oracle(pos, vel, soft)
    for what, fields in (("one-sided", ck.compute_accel_jerk_ds_cuda_vs(*p, *p, scal)),
                         ("sym", ck.ds_aj_sym_cuda(*p, scal)),
                         ("blocked cap 2048", ck.compute_accel_jerk_ds_symmetric_blocked_cuda(
                             *p, scal, block_cap=2048, tile=256))):
        for k, name in ((0, "acc"), (2, "jerk")):
            e = float(np.abs(ds.ds_to_f64(*fields[k:k + 2])[:, :3] - ref[k // 2]).max()
                      / np.abs(ref[k // 2]).max())
            ok &= e <= 1e-10
            print(f"check ds {what} {name} N=4099 vs float64 oracle: max|d|/max = {e:.3e} "
                  "(bound 1e-10)")
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if "--quick" in sys.argv:
        return 0

    reps = 3
    for n in (16384, 32768, 36864, 65536):
        p4 = planes(n)
        out = tuple(torch.empty_like(p4[0]) for _ in range(4))
        fscal = ds.scal_ds(demo.time_step, soft, 1.0)
        runs = {"ds force triangle (dispatch)": (
            lambda: ck.compute_accel_ds_symmetric_blocked_cuda(p4[0], p4[1], fscal))}
        for bs in (64, 128, 256):
            runs[f"ds aj one-sided block={bs}"] = (
                lambda bs=bs: ck.compute_accel_jerk_ds_cuda_vs(*p4, *p4, scal, block_size=bs,
                                                               out=out))
        caps = sorted({n, n // 2, 32768, 16384})
        for tile in ck.DS_AJ_TILES:
            for cap in caps:
                if cap > n:
                    continue
                runs[f"ds aj sym tile={tile} cap={cap}"] = (
                    lambda tile=tile, cap=cap: ck.compute_accel_jerk_ds_symmetric_blocked_cuda(
                        *p4, scal, block_cap=cap, tile=tile))
            if n > 32768:  # the composition's rectangle alone
                h = n // 2
                runs[f"ds aj cross tile={tile} ({h},{n - h})"] = (
                    lambda tile=tile, h=h: ck.ds_aj_sym_cross_cuda(
                        *(t[:h] for t in p4), *(t[h:] for t in p4), scal, tile=tile))
        times = {k: [] for k in runs}
        for fn in runs.values():
            fn()
        for _ in range(2):  # two rounds, in turns
            for k, fn in runs.items():
                times[k].append(elapsed_ms(lambda fn=fn: [fn() for _ in range(reps)], dev) / reps)
        for k, ts in times.items():
            print(f"N={n} {k}: {min(ts):.4f} ms per call (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f") [{smi}]")
        del p4, out, runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
