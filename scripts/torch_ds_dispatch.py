#!/usr/bin/env python3
"""Measure the double-single kernels of nbody_tpu_torch on the card, to fix
``ds_sym_default_dispatch``, the ds block size and the one-sided ds step,
force and leapfrog kernels' j-split (``ds_splits``; ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ds_dispatch.py [--quick] [--against DIR] [--no-sweep]

First it prints what ptxas says of every kernel of csrc/ds_kernels.cu and
csrc/ds_symmetric_kernels.cu (registers, spills, shared memory) and the
SASS count a pair of the one-sided kernels' walks (the innermost loop that
holds the rsqrt, over its MUFU.RSQ). Then it holds the ds kernels to their
plain versions (ops/ds.py) at small ragged shapes, for every tile and two
block sizes, with shell ICs, masses drawn in float64 from [0.5, 2] (so with
a lo part), a random vel.w and damping 0.5: each output, as hi + lo in
float64, within 1e-12 * max + 1e-14, repeat calls bit-equal, and each force
within 1e-10 * max|a| of the float64 oracle's. The split step, force and
leapfrog kernels are held at odd M and N, N below a stage and not a multiple
of it, in one j-chunk, the rule's and three, at blocks 32 to 1024, their
repeats and blocks bit-equal, the force followed by the ds Euler update
bit-equal to the step, and a leapfrog step from zero velocity (dt = 1,
damping 1) bit-equal to the force. --quick stops there.

--against DIR builds DIR/csrc/ds_kernels.cu (another checkout's, with its
shared headers, whose kernels read their scalar block from device memory as
this one's do: the wrappers pass a device pointer) with the library's nvcc
flags into a library of its own,
launched through the port's wrappers (``cuda_kernel._ds_step``,
``_ds_accel``, ``_ds_leapfrog`` with ``lib=``; a build without a j-split
entry point runs that kernel in one chunk, as it was written), prints its
ptxas lines and SASS counts, and checks that this checkout's kernels in one
chunk give DIR's bits at every checked and timed shape. Then it times DIR's
kernels in turns with this checkout's (DIR, this, this, DIR, six rounds;
the median and every round printed) at (M, N) = (16384, 16384), (65536,
65536), (4096, 16384), (4096, 4096) and (16384, 65536) (one card at the ds
default N and at 65536, a four-card allgather rank or ring hop at N =
16384, and a four-card ring hop at N = 65536), each at
``ds_default_block_size(M)``, with nvidia-smi's SM clock sampled beside and
the issue bound of each walk's SASS count, and a ds ``one_sided`` Euler
step, a ds ring Euler step on a one-rank NCCL mesh (D = 1) and a ds
``one_sided`` leapfrog step at N = 16384 and 65536, DIR's kernels routed
into the systems.

Then, unless --no-sweep, it times the split force and leapfrog kernels per
fill and block size at those shapes, and at N = 16384, 32768, 65536 and
131072
(shell ICs, demo-0 softening) the one-sided ds step per block size, the ds
leapfrog step, and the each-pair-once ds force per tile and block cap,
beside the fp32 one-sided step and sym force at the same N: CUDA events
over `reps` calls after one warm-up call, two rounds taken in turns.
Prints one line per measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import contextlib
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

SOURCE = "ds_kernels.cu"
# the split kernels' timed shapes (M, N)
SHAPES = ((16384, 16384), (65536, 65536), (4096, 16384), (4096, 4096), (16384, 65536))
# the one-sided kernels by a piece of their mangled names
WALKS = {"ds_step_kernel": "14ds_step_kernel", "ds_accel_kernel": "15ds_accel_kernel",
         "ds_leapfrog_kernel": "18ds_leapfrog_kernel"}


def ptxas_report() -> None:
    """Compile each ds source once more with -Xptxas -v and print what
    ptxas says of each kernel."""
    from nbody_tpu_torch.ops import _build

    for src in ("ds_kernels.cu", "ds_symmetric_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def walk_counts(label: str, source) -> dict:
    """Print the ptxas lines of `source` and the SASS count a pair of each
    one-sided kernel's walk; returns {kernel: the cheapest walk's count}."""
    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    for line in _build.ptxas_lines(source, label=label, usage=usage):
        print(line)
    best = {}
    for kernel, key in WALKS.items():
        for loop in _build.sass_loops(sass, key):
            pairs = loop["pairs"]
            per = loop["instructions"] / pairs
            mix = ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(loop["mix"].items()))
            print(f"sass {label}: {kernel}: walk loop of {loop['instructions']} instructions "
                  f"over {pairs} pairs = {per:.2f} a pair; per pair: {mix}")
            best[kernel] = min(best.get(kernel, per), per)
    return best


def against_library(source: pathlib.Path, tmp: pathlib.Path):
    """Another checkout's csrc/ds_kernels.cu, built on its own with the
    library's flags, with the C signatures the port's wrappers call."""
    import ctypes

    from nbody_tpu_torch.ops import _build

    out = tmp / "libds_against.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(source)], check=True, timeout=900)
    lib = ctypes.CDLL(str(out))
    _build.declare_ds_force(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


@contextlib.contextmanager
def routed(ck, lib):
    """The systems' ds step, force and leapfrog calls through `lib` in one
    j-chunk (the unsplit kernels' form), uncounted, while the block runs."""
    saved = (ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs,
             ck.nbody_step_ds_leapfrog_cuda_vs)

    def step(ph, pl, vh, vl, jh, jl, scal, *, block_size=ck.DEFAULT_BLOCK_SIZE, out=None):
        return ck._ds_step(ph, pl, vh, vl, jh, jl, scal, block_size, out, splits=1, lib=lib)

    def accel(ph, pl, jh, jl, scal, *, block_size=None, out=None, splits=None):
        return ck._ds_accel(ph, pl, jh, jl, scal, block_size, out, splits=1, lib=lib)

    def leapfrog(*planes, block_size=ck.DEFAULT_BLOCK_SIZE, out=None):
        return ck._ds_leapfrog(*planes, block_size, out, splits=1, lib=lib)

    ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs = step, accel
    ck.nbody_step_ds_leapfrog_cuda_vs = leapfrog
    try:
        yield
    finally:
        (ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs,
         ck.nbody_step_ds_leapfrog_cuda_vs) = saved


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="a checkout whose csrc/ds_kernels.cu is timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the split, block and tile "
                    "sweeps")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:
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
    per_pair = {"this": walk_counts("this", SOURCE)}
    other = None
    if args.against is not None:
        csrc = args.against.resolve() / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = args.against.resolve() / "csrc"
        per_pair["against"] = walk_counts("against", csrc / SOURCE)
        other = against_library(csrc / SOURCE, tmp)
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
            tol = 1e-12 * np.abs(w64).max() + 1e-14 if w64.size else 0.0
            e = float(np.abs(g64 - w64).max()) if g64.size else 0.0
            ok &= bool(e <= tol and np.isfinite(g64).all())
            print(f"check {what} [{k}]: max|d|={e:.3e} tol={tol:.3e}")

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def bits(what, a, b):
        nonlocal ok
        eq = same(a, b)
        ok &= eq
        print(f"check {what}: bit-equal {eq}")

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
            got = ck.nbody_step_ds_leapfrog_cuda_vs(*pi, *pj, lscal, block_size=bs)
            want = ds.nbody_step_ds_leapfrog_vs(*pi, *pj, lscal)
            held(f"ds leapfrog block={bs} ({m},{n})", [got[:2], got[2:]], [want[:2], want[2:]])
    # the split step, force and leapfrog: odd M and N, N below a stage and
    # not a multiple of it, one j-chunk (1), the rule's (None) and three, at
    # every block size class; the same S gives the same bits at every block
    # and on a repeat, the force then the update gives the step's bits, and
    # a leapfrog step from zero velocity (dt = 1, damping 1) the force's
    unit_l = ds.scal_ds_leapfrog(1.0, soft, 1.0)
    for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 127)):
        pi = planes(m, seed=3, masses=True)
        pj = planes(n, masses=True)
        want_acc = ds.ds_accel_vs(pi[0], pi[1], pj[0], pj[1], scal)
        want = ds.ds_integrate(*pi, want_acc, scal)
        want_lf = ds.nbody_step_ds_leapfrog_vs(*pi, *pj, lscal)
        rest_i = (pi[0], pi[1], torch.zeros_like(pi[2]), torch.zeros_like(pi[3]))
        rest_j = (pj[0], pj[1], torch.zeros_like(pj[2]), torch.zeros_like(pj[3]))
        for sp in (None, 1, 3):
            s = ck.ds_splits(m, n) if sp is None else sp
            first = None
            for bs in (32, 128, 256, 1024):
                def calls(bs=bs, sp=sp):
                    return (*ck._ds_step(*pi, pj[0], pj[1], scal, bs, None, splits=sp),
                            *ck._ds_accel(pi[0], pi[1], pj[0], pj[1], scal, bs, None,
                                          splits=sp),
                            *ck._ds_leapfrog(*pi, *pj, lscal, bs, None, splits=sp))
                got = calls()
                step, acc, lf = got[:4], got[4:6], got[6:]
                first = got if first is None else first
                rep = same(got, calls()) and same(got, first)
                ok &= rep
                what = f"({m},{n}) splits={s} block={bs} (repeat and block 32 bit-equal {rep})"
                held(f"ds step {what}", [step[:2], step[2:]], [want[:2], want[2:]])
                held(f"ds accel {what}", [acc], [want_acc])
                held(f"ds leapfrog {what}", [lf[:2], lf[2:]], [want_lf[:2], want_lf[2:]])
                bits(f"ds accel + ds_integrate = ds step ({m},{n}) splits={s} block={bs}",
                     ck.ds_integrate_cuda(*pi, *acc, scal), step)
                rest = ck._ds_leapfrog(*rest_i, *rest_j, unit_l, bs, None, splits=sp)[2:]
                bits(f"ds leapfrog from rest = ds accel ({m},{n}) splits={s} block={bs}",
                     [t[:, :3] for t in rest], acc)
    # the ds force against the float64 oracle's, which a float32-grade
    # force misses by three orders
    pos, _ = state64(4099, masses=True)
    ph, pl = (t.to(dev) for t in ds.ds_from_f64(pos))
    ref = oracle_accel(pos, soft)
    for what, acc in (("sym", ck.ds_sym_accel_cuda(ph, pl, scal)),
                      ("blocked cap 2048", ck.compute_accel_ds_symmetric_blocked_cuda(
                          ph, pl, scal, block_cap=2048, tile=256)),
                      *((f"accel splits={sp}", ck._ds_accel(ph, pl, ph, pl, scal, None, None,
                                                            splits=sp))
                        for sp in (None, 1))):
        e = float(np.abs(ds.ds_to_f64(*acc) - ref).max()) / float(np.abs(ref).max())
        ok &= e <= 1e-10
        print(f"check ds {what} force N=4099 vs float64 oracle: max|da|/max|a| = {e:.3e} "
              "(bound 1e-10)")
    states = {n: planes(n) for n in sorted({n for _, n in SHAPES})}
    if other is not None:
        # this checkout's kernels in one chunk give DIR's bits: at the
        # ragged shapes and at every timed one
        cases = [((m, n), planes(m, seed=3, masses=True), planes(n, masses=True))
                 for m, n in ((1000, 1000), (777, 4099), (4099, 777), (33, 1))]
        cases += [((m, n), tuple(t[:m] for t in states[n]), states[n]) for m, n in SHAPES]
        for (m, n), pi, pj in cases:
            bs = ck.ds_default_block_size(m)
            for kind, fn in (
                    ("step", lambda lib: ck._ds_step(*pi, pj[0], pj[1], scal, bs, None,
                                                     splits=1, lib=lib)),
                    ("accel", lambda lib: ck._ds_accel(pi[0], pi[1], pj[0], pj[1], scal, bs,
                                                       None, splits=1, lib=lib)),
                    ("leapfrog", lambda lib: ck._ds_leapfrog(*pi, *pj, lscal, bs, None,
                                                             splits=1, lib=lib))):
                bits(f"this {kind} at one chunk = against ({m},{n}) block={bs}", fn(None),
                     fn(other))
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    def turns(runs: dict, pairs: dict, rounds: int = 2) -> None:
        """Time each run in turns (A B, then B A, for `rounds` rounds), print
        ms and the issue-bound time of its SASS count at the sampled SM
        clock."""
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
                extra = (f"; issue bound {issue:.3f} ms at {pairs[k][1]:.2f} a pair, {mhz:.0f} "
                         f"MHz ({100 * issue / statistics.median(ts):.1f} %)")
            print(f"{k}: {min(ts):.4f} ms per call, median {statistics.median(ts):.4f} (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    def kernel_runs(label, lib):
        split = lib is None or hasattr(lib, "nbody_ds_step_split")
        sp = None if split else 1
        lf_split = lib is None or hasattr(lib, "nbody_ds_leapfrog_split")
        walks = per_pair.get(label, {})
        runs, pairs = {}, {}
        for m, n in SHAPES:
            pj = states[n]
            pi = tuple(t[:m] for t in pj)
            out = tuple(torch.empty_like(pi[0]) for _ in range(4))
            bs = ck.ds_default_block_size(m)
            s = ck.ds_splits(m, n) if split else 1
            key = f"{label} ds_accel ({m},{n}) block={bs} splits={s}"
            runs[key] = (lambda pi=pi, pj=pj, out=out, bs=bs: ck._ds_accel(
                pi[0], pi[1], pj[0], pj[1], scal, bs, out[:2], splits=sp, lib=lib))
            pairs[key] = (m * n, walks.get("ds_accel_kernel"))
            key = f"{label} ds_step ({m},{n}) block={bs} splits={s}"
            runs[key] = (lambda pi=pi, pj=pj, out=out, bs=bs: ck._ds_step(
                *pi, pj[0], pj[1], scal, bs, out, splits=sp, lib=lib))
            pairs[key] = (m * n, walks.get("ds_step_kernel"))
            key = (f"{label} ds_leapfrog ({m},{n}) block={bs} splits="
                   f"{ck.ds_splits(m, n) if lf_split else 1}")
            runs[key] = (lambda pi=pi, pj=pj, out=out, bs=bs: ck._ds_leapfrog(
                *pi, *pj, lscal, bs, out, splits=None if lf_split else 1, lib=lib))
            pairs[key] = (m * n, walks.get("ds_leapfrog_kernel"))
        return runs, pairs

    if other is not None:
        groups = [kernel_runs("against", other), kernel_runs("this", None)]
        for idx in range(len(groups[0][0])):
            runs, pairs = {}, {}
            for g_runs, g_pairs in groups:
                k = list(g_runs)[idx]
                runs[k] = g_runs[k]
                pairs[k] = g_pairs.get(k)
            turns(runs, pairs, rounds=6)
        system_steps(torch, ck, other, smi, dev)
    if args.no_sweep:
        return 0
    # the split force and leapfrog kernels: S by the rule at each fill, per
    # block
    for m, n in SHAPES:
        pj = states[n]
        pi = tuple(t[:m] for t in pj)
        out = tuple(torch.empty_like(pi[0]) for _ in range(4))
        print(f"sweep ({m},{n}): the rule's S = {ck.ds_splits(m, n)}")
        for kind, blocks in (("ds_accel", (64, 128, 256)),
                             ("ds_leapfrog", (64, 128, 256, 512, 1024))):
            runs, pairs = {}, {}
            for bs in blocks:
                for fill in (264, 528, 1056, 2112, 4224, 8448):
                    sp = ck.one_sided_splits(m, n, tile_i=ck.DS_AJ_TILE_I, stage=ck.DS_STAGE,
                                             fill=fill)
                    key = f"{kind} ({m},{n}) block={bs} splits={sp}"
                    if kind == "ds_accel":
                        fn = (lambda bs=bs, sp=sp: ck._ds_accel(
                            pi[0], pi[1], pj[0], pj[1], scal, bs, out[:2], splits=sp))
                    else:
                        fn = (lambda bs=bs, sp=sp: ck._ds_leapfrog(
                            *pi, *pj, lscal, bs, out, splits=sp))
                    runs.setdefault(key, fn)
                    pairs[key] = (m * n, per_pair["this"].get(f"{kind}_kernel"))
            turns(runs, pairs)
    del states

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


def system_steps(torch, ck, other, smi: str, dev) -> None:
    """A ds one_sided Euler step, a ds ring Euler step on a one-rank NCCL
    mesh and a ds one_sided leapfrog step at N = 16384 and 65536, DIR's
    kernels (routed, one chunk) in turns with this checkout's: ms a step
    over `steps` steps after one, six rounds (DIR, this, this, DIR, ...)."""
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import DSBodySystem
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.utils.timing import elapsed_ms

    mesh = make_mesh(1)
    try:
        for n, steps in ((16384, 10), (65536, 3)):
            systems = {"one_sided Euler": DSBodySystem(n, DEMO_PARAMS[0], device=dev,
                                                       variant="one_sided"),
                       "ring D=1 Euler": DSBodySystem(n, DEMO_PARAMS[0], device=dev, mesh=mesh,
                                                      strategy="ring"),
                       "one_sided leapfrog": DSBodySystem(n, DEMO_PARAMS[0], device=dev,
                                                          variant="one_sided",
                                                          integrator="leapfrog")}
            for name, system in systems.items():
                ms = {"against": [], "this": []}
                for label in ("against", "this", "this", "against") * 3:
                    ctx = routed(ck, other) if label == "against" else contextlib.nullcontext()
                    with ctx:
                        system.update_many(1)
                        ms[label].append(elapsed_ms(lambda: system.update_many(steps), dev)
                                         / steps)
                print(f"ds {name} step N={n}: against median "
                      f"{statistics.median(ms['against']):.4f} ("
                      + ", ".join(f"{t:.4f}" for t in ms["against"]) + ") / this median "
                      f"{statistics.median(ms['this']):.4f} ("
                      + ", ".join(f"{t:.4f}" for t in ms["this"]) + f") ms a step [{smi}]")
            del systems
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
