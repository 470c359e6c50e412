#!/usr/bin/env python3
"""Measure the double-single accel + jerk kernels of nbody_tpu_torch on the
card, to fix ``ds_aj_sym_default_dispatch`` and the one-sided kernel's
j-split (``ds_aj_splits``) and block size (it shares the ds step's
``ds_default_block_size``; ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ds_aj_dispatch.py [--quick] [--against DIR] [--no-sweep]

First it prints what ptxas says of every kernel of csrc/ds_aj_kernels.cu
and csrc/ds_symmetric_aj_kernels.cu (registers, spills, shared memory) and
the SASS count a pair of the one-sided kernel's walk (the innermost loop
that holds the rsqrt, over its MUFU.RSQ). Then it holds the kernels to
their plain versions (ops/ds.py) at small ragged shapes, for every tile
and two block sizes, with shell ICs, masses drawn in float64 from [0.5, 2]
(so with a lo part) and a random vel.w: each output, as hi + lo in
float64, within 1e-12 * max + 1e-14, repeat calls bit-equal, the Hermite
predictor and corrector kernels against theirs, and each force and jerk
within 1e-10 * max of the float64 oracle's. The one-sided kernel is held
at odd M and N, N below a stage and not a multiple of it, with one
j-chunk and several, at blocks 32 to 1024, its repeats and its blocks
bit-equal. --quick stops there.

--against DIR builds DIR/csrc/ds_aj_kernels.cu (another checkout's, with
its shared headers, whose kernels read their scalar block from device
memory as this one's do: the wrappers pass a device pointer) with the
library's nvcc flags into a library of its own, launched through the port's wrapper (``cuda_kernel._ds_accel_jerk(...,
lib=)``; a build without the j-split entry point runs one chunk, as it was
written), prints its ptxas lines and SASS count, holds it to plain and the
oracle, and times it in turns with this checkout's kernel (DIR, this,
this, DIR) at (M, N) = (16384, 16384), (65536, 65536), (4096, 16384) and
(4096, 4096) (a four-card allgather and ring hop at N = 16384) and
(36864, 36864), each at ``ds_default_block_size(M)``, and a ds one-sided
Hermite step at N = 16384 and 65536.

Then, unless --no-sweep, it times the one-sided kernel's j-split at those
shapes per fill and block size, and at N = 16384, 32768, 36864 and 65536
(shell ICs, demo-0 softening) the one-sided ds accel + jerk per block size
and the each-pair-once one per tile and block cap (at N above 32768, cap
32768 composes triangles and rectangles of N/2), beside the ds force
triangle at the same N: CUDA events over `reps` calls after one warm-up
call, two rounds taken in turns. Prints one line per measurement and the
nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def ptxas_report() -> None:
    """Compile each ds accel + jerk source once more with -Xptxas -v and
    print what ptxas says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("ds_aj_kernels.cu", "ds_symmetric_aj_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


ONE_SIDED_SOURCE = "ds_aj_kernels.cu"
# the one-sided kernel's timed shapes (M, N): one card at the ds default N
# and at 65536, a four-card allgather or ring hop at N = 16384, and the ds
# Hermite composition's benchmark N
ONE_SIDED_SHAPES = ((16384, 16384), (65536, 65536), (4096, 16384), (4096, 4096),
                    (36864, 36864))


def walk_count(label: str, source) -> float | None:
    """Print the ptxas lines of `source` and the SASS count a pair of its
    one-sided kernel's walk; returns the cheapest walk's count."""
    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    for line in _build.ptxas_lines(source, label=label, usage=usage):
        print(line)
    best = None
    for loop in _build.sass_loops(sass, "20ds_accel_jerk_kernel"):
        pairs = loop["pairs"]
        per = loop["instructions"] / pairs
        mix = ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(loop["mix"].items()))
        print(f"sass {label}: ds_accel_jerk_kernel: walk loop of {loop['instructions']} "
              f"instructions over {pairs} pairs = {per:.2f} a pair; per pair: {mix}")
        best = per if best is None else min(best, per)
    return best


def against_library(source: pathlib.Path, tmp: pathlib.Path):
    """Another checkout's csrc/ds_aj_kernels.cu, built on its own with the
    library's flags, with the C signatures the port's wrapper calls."""
    import ctypes

    from nbody_tpu_torch.ops import _build

    out = tmp / "libds_aj_against.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(source)], check=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    _build.declare_accel_jerk(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="a checkout whose csrc/ds_aj_kernels.cu is timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the split and block sweep")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:
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
    per_pair = {"this": walk_count("this", ONE_SIDED_SOURCE)}
    other = None
    if args.against is not None:
        csrc = args.against.resolve() / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = args.against.resolve() / "csrc"
        per_pair["against"] = walk_count("against", csrc / ONE_SIDED_SOURCE)
        other = against_library(csrc / ONE_SIDED_SOURCE, tmp)
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
    # the one-sided kernel: odd M and N, N below a stage and not a multiple
    # of it, one j-chunk (1), the rule's (None) and three, at every block
    # size class; the same S gives the same bits at every block and on a
    # repeat
    libs = {"this": None, **({"against": other} if other else {})}
    for label, lib in libs.items():
        split = lib is None or hasattr(lib, "nbody_ds_accel_jerk_split")
        for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 127)):
            pi = planes(m, seed=3, masses=True)
            pj = planes(n, masses=True)
            want = ds.ds_accel_jerk_vs(*pi, *pj, scal)
            for sp in ((None, 1, 3) if split else (1,)):
                first = None
                # the one-chunk design stages block_size bodies in dynamic
                # shared memory, 64 KB at 1024 threads: over the 48 KB a
                # launch takes without opting in
                for bs in ((32, 128, 256, 1024) if split else (32, 128, 256)):
                    got = ck._ds_accel_jerk(*pi, *pj, scal, bs, None, splits=sp, lib=lib)
                    again = ck._ds_accel_jerk(*pi, *pj, scal, bs, None, splits=sp, lib=lib)
                    first = got if first is None else first
                    rep = same(got, again) and same(got, first)
                    ok &= rep
                    held(f"{label} ds aj one-sided ({m},{n}) splits="
                         f"{ck.ds_aj_splits(m, n) if sp is None else sp} block={bs} (repeat and "
                         f"block 32 bit-equal {rep})", got, want)
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
    if other is not None:
        fields = ck._ds_accel_jerk(*p, *p, scal, None, None, splits=1, lib=other)
        for k, name in ((0, "acc"), (2, "jerk")):
            e = float(np.abs(ds.ds_to_f64(*fields[k:k + 2])[:, :3] - ref[k // 2]).max()
                      / np.abs(ref[k // 2]).max())
            ok &= e <= 1e-10
            print(f"check against one-sided {name} N=4099 vs float64 oracle: max|d|/max = "
                  f"{e:.3e} (bound 1e-10)")
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    def turns(runs: dict, pairs: dict, rounds: int = 2) -> None:
        """Time each run in turns (A B B A for two rounds), print ms and the
        issue-bound time of its SASS count at the sampled SM clock."""
        from torch_aj_dispatch import Clocks

        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(3)],
                                               dev) / 3)
        mhz = clocks.median_mhz()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for k, ts in times.items():
            extra = ""
            if pairs.get(k) and pairs[k][1] and mhz:
                issue = pairs[k][0] * pairs[k][1] / 32 / (sms * 4 * mhz * 1e6) * 1e3
                extra = f"; issue bound {issue:.3f} ms at {pairs[k][1]:.2f} a pair, {mhz:.0f} MHz"
            print(f"{k}: {min(ts):.4f} ms per call (rounds: " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    states = {n: planes(n) for n in sorted({n for _, n in ONE_SIDED_SHAPES})}

    def one_sided_runs(label, lib, bs_of=ck.ds_default_block_size):
        sp = None if lib is None or hasattr(lib, "nbody_ds_accel_jerk_split") else 1
        runs, pairs = {}, {}
        for m, n in ONE_SIDED_SHAPES:
            pj = states[n]
            pi = tuple(t[:m] for t in pj)
            out = tuple(torch.empty_like(pi[0]) for _ in range(4))
            key = f"{label} ds one-sided ({m},{n}) block={bs_of(m)}"
            runs[key] = (lambda pi=pi, pj=pj, out=out, bs=bs_of(m): ck._ds_accel_jerk(
                *pi, *pj, scal, bs, out, splits=sp, lib=lib))
            pairs[key] = (m * n, per_pair.get(label))
        def hermite_step(st):
            # DSBodySystem's one-sided Hermite step: accel + jerk, the
            # predictor kernel, accel + jerk, the corrector kernel
            def aj(q):
                return ck._ds_accel_jerk(*q, *q, scal, None, None, splits=sp, lib=lib)

            f0 = aj(st)
            pred = ck.ds_hermite_predict_cuda(*st, *f0, scal)
            return ck.ds_hermite_correct_cuda(*st, *f0, *aj(pred), scal)

        for n in (16384, 65536):
            runs[f"{label} ds one-sided Hermite step N={n}"] = (
                lambda st=states[n]: hermite_step(st))
        return runs, pairs

    if other is not None:
        groups = [one_sided_runs("against", other), one_sided_runs("this", None)]
        for idx in range(len(groups[0][0])):
            runs, pairs = {}, {}
            for g_runs, g_pairs in groups:
                k = list(g_runs)[idx]
                runs[k] = g_runs[k]
                pairs[k] = g_pairs.get(k)
            turns(runs, pairs)
    if args.no_sweep:
        return 0
    # the one-sided kernel's j-split: S by the rule at each fill, per block
    for m, n in ONE_SIDED_SHAPES:
        pj = states[n]
        pi = tuple(t[:m] for t in pj)
        out = tuple(torch.empty_like(pi[0]) for _ in range(4))
        runs, pairs = {}, {}
        for bs in (64, 128, 256):
            for fill in (264, 528, 1056, 2112, 4224):
                sp = ck.one_sided_splits(m, n, tile_i=ck.DS_AJ_TILE_I, stage=ck.DS_AJ_STAGE,
                                         fill=fill)
                key = f"ds one-sided ({m},{n}) block={bs} splits={sp}"
                runs.setdefault(key, lambda bs=bs, sp=sp: ck._ds_accel_jerk(
                    *pi, *pj, scal, bs, out, splits=sp))
                pairs[key] = (m * n, per_pair["this"])
        turns(runs, pairs, rounds=1)
    del states

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
