#!/usr/bin/env python3
"""Measure the double-single kernels of nbody_tpu_torch on the card, to fix
``ds_sym_default_dispatch``, the ds block size and the one-sided ds step and
force kernels' j-split (``ds_splits``; ops/cuda_kernel.py).

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
within 1e-10 * max|a| of the float64 oracle's. The split step and force
kernels are held at odd M and N, N below a stage and not a multiple of it,
in one j-chunk, the rule's and three, at blocks 32 to 1024, their repeats
and blocks bit-equal, and the force followed by the ds Euler update
bit-equal to the step. --quick stops there.

--against DIR builds DIR/csrc/ds_kernels.cu (another checkout's, with its
shared headers) with the library's nvcc flags into a library of its own,
launched through the port's wrappers (``cuda_kernel._ds_step``,
``_ds_accel``, ``_ds_leapfrog`` with ``lib=``; a build without the j-split
entry points runs one chunk, as it was written), prints its ptxas lines
and SASS counts, checks that this checkout's kernels in one chunk, and
its leapfrog kernel, give DIR's bits at every checked and timed shape, and
prints whether the two leapfrog kernels' whole SASS is the same. Then it
times DIR's kernels in turns with this checkout's (DIR, this, this, DIR,
six rounds) at (M, N) = (16384, 16384), (65536, 65536), (4096, 16384), (4096,
4096) and (16384, 65536) (one card at the ds default N and at 65536, a
four-card allgather rank or ring hop at N = 16384, and a four-card ring
hop at N = 65536), each at ``ds_default_block_size(M)``, with nvidia-smi's
SM clock sampled beside and the issue bound of each walk's SASS count, and
a ds ``one_sided`` Euler step and a ds ring Euler step on a one-rank NCCL
mesh (D = 1) at N = 16384 and 65536, DIR's kernels routed into the systems.

Then, unless --no-sweep, it times the split force kernel per fill and
block size at those shapes, and at N = 16384, 32768, 65536 and 131072
(shell ICs, demo-0 softening) the one-sided ds step per block size, the ds
leapfrog step, and the each-pair-once ds force per tile and block cap,
beside the fp32 one-sided step and sym force at the same N: CUDA events
over `reps` calls after one warm-up call, two rounds taken in turns.
Prints one line per measurement and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import contextlib
import pathlib
import re
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


def function_sass(sass: str, key: str) -> list:
    """The SASS lines of the functions of `sass` whose mangled names contain
    `key`, as cuobjdump prints them (addresses relative to each function),
    without the name line, and with the source's hash that nvcc puts in
    the names of an anonymous namespace's symbols taken out."""
    lines, keep = [], False
    for line in sass.splitlines():
        if "Function : " in line:
            keep = key in line
        elif keep:
            lines.append(re.sub(r"_INTERNAL_[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "_INTERNAL_", line))
    return lines


def walk_counts(label: str, source, sass_of: dict) -> dict:
    """Print the ptxas lines of `source` and the SASS count a pair of each
    one-sided kernel's walk; returns {kernel: the cheapest walk's count}.
    Keeps the SASS in `sass_of[label]`."""
    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    sass_of[label] = sass
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
    """The systems' ds step and force calls through `lib` in one j-chunk
    (the unsplit kernels' form), uncounted, while the block runs."""
    saved = ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs

    def step(ph, pl, vh, vl, jh, jl, scal, *, block_size=ck.DEFAULT_BLOCK_SIZE, out=None):
        return ck._ds_step(ph, pl, vh, vl, jh, jl, scal, block_size, out, splits=1, lib=lib)

    def accel(ph, pl, jh, jl, scal, *, block_size=None, out=None, splits=None):
        return ck._ds_accel(ph, pl, jh, jl, scal, block_size, out, splits=1, lib=lib)

    ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs = step, accel
    try:
        yield
    finally:
        ck.nbody_step_ds_cuda_vs, ck.compute_accel_ds_cuda_vs = saved


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
    sass_of = {}
    per_pair = {"this": walk_counts("this", SOURCE, sass_of)}
    other = None
    if args.against is not None:
        csrc = args.against.resolve() / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = args.against.resolve() / "csrc"
        per_pair["against"] = walk_counts("against", csrc / SOURCE, sass_of)
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
    # the split step and force: odd M and N, N below a stage and not a
    # multiple of it, one j-chunk (1), the rule's (None) and three, at every
    # block size class; the same S gives the same bits at every block and
    # on a repeat, and the force then the update gives the step's bits
    for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 127)):
        pi = planes(m, seed=3, masses=True)
        pj = planes(n, masses=True)
        want_acc = ds.ds_accel_vs(pi[0], pi[1], pj[0], pj[1], scal)
        want = ds.ds_integrate(*pi, want_acc, scal)
        for sp in (None, 1, 3):
            s = ck.ds_splits(m, n) if sp is None else sp
            first = None
            for bs in (32, 128, 256, 1024):
                step = ck._ds_step(*pi, pj[0], pj[1], scal, bs, None, splits=sp)
                acc = ck._ds_accel(pi[0], pi[1], pj[0], pj[1], scal, bs, None, splits=sp)
                got = (*step, *acc)
                again = (*ck._ds_step(*pi, pj[0], pj[1], scal, bs, None, splits=sp),
                         *ck._ds_accel(pi[0], pi[1], pj[0], pj[1], scal, bs, None, splits=sp))
                first = got if first is None else first
                rep = same(got, again) and same(got, first)
                ok &= rep
                what = f"({m},{n}) splits={s} block={bs} (repeat and block 32 bit-equal {rep})"
                held(f"ds step {what}", [step[:2], step[2:]], [want[:2], want[2:]])
                held(f"ds accel {what}", [acc], [want_acc])
                bits(f"ds accel + ds_integrate = ds step ({m},{n}) splits={s} block={bs}",
                     ck.ds_integrate_cuda(*pi, *acc, scal), step)
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
        # this checkout's kernels in one chunk, and its leapfrog kernel, give
        # DIR's bits: at the ragged shapes and at every timed one
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
                                                             lib=lib))):
                bits(f"this {kind} at one chunk = against ({m},{n}) block={bs}", fn(None),
                     fn(other))
        # the leapfrog kernel's whole SASS, not its walk alone
        lf = [function_sass(sass_of[k], WALKS["ds_leapfrog_kernel"]) for k in ("this", "against")]
        differ = [(a, b) for a, b in zip(*lf) if a != b]
        print(f"sass ds_leapfrog_kernel: {len(lf[0])} lines this, {len(lf[1])} against, "
              f"{len(differ)} differ; identical {bool(lf[0]) and lf[0] == lf[1]}")
        for a, b in differ[:8]:
            print(f"  this    {a.strip()}\n  against {b.strip()}")
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
                extra = f"; issue bound {issue:.3f} ms at {pairs[k][1]:.2f} a pair, {mhz:.0f} MHz"
            print(f"{k}: {min(ts):.4f} ms per call (rounds: " + ", ".join(f"{t:.4f}" for t in ts)
                  + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    def kernel_runs(label, lib):
        split = lib is None or hasattr(lib, "nbody_ds_step_split")
        sp = None if split else 1
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
            if m == n:
                key = f"{label} ds_leapfrog ({m},{n}) block={bs}"
                runs[key] = (lambda pi=pi, pj=pj, out=out, bs=bs: ck._ds_leapfrog(
                    *pi, *pj, lscal, bs, out, lib=lib))
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
    # the split force kernel: S by the rule at each fill, per block
    for m, n in SHAPES:
        pj = states[n]
        pi = tuple(t[:m] for t in pj)
        out = tuple(torch.empty_like(pi[0]) for _ in range(2))
        runs, pairs = {}, {}
        for bs in (64, 128, 256):
            for fill in (264, 528, 1056, 2112, 4224, 8448):
                sp = ck.one_sided_splits(m, n, tile_i=ck.DS_AJ_TILE_I, stage=ck.DS_STAGE,
                                         fill=fill)
                key = f"ds_accel ({m},{n}) block={bs} splits={sp}"
                runs.setdefault(key, lambda bs=bs, sp=sp: ck._ds_accel(
                    pi[0], pi[1], pj[0], pj[1], scal, bs, out, splits=sp))
                pairs[key] = (m * n, per_pair["this"].get("ds_accel_kernel"))
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
    """A ds one_sided Euler step and a ds ring Euler step on a one-rank NCCL
    mesh at N = 16384 and 65536, DIR's kernels (routed, one chunk) in turns
    with this checkout's: ms a step over `steps` steps after one."""
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import DSBodySystem
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.utils.timing import elapsed_ms

    mesh = make_mesh(1)
    try:
        for n, steps in ((16384, 10), (65536, 3)):
            systems = {"one_sided": DSBodySystem(n, DEMO_PARAMS[0], device=dev,
                                                 variant="one_sided"),
                       "ring D=1": DSBodySystem(n, DEMO_PARAMS[0], device=dev, mesh=mesh,
                                                strategy="ring")}
            for name, system in systems.items():
                ms = {"against": [], "this": []}
                for label in ("against", "this", "this", "against"):
                    ctx = routed(ck, other) if label == "against" else contextlib.nullcontext()
                    with ctx:
                        system.update_many(1)
                        ms[label].append(elapsed_ms(lambda: system.update_many(steps), dev)
                                         / steps)
                print(f"ds {name} Euler step N={n}: against "
                      + ", ".join(f"{t:.4f}" for t in ms["against"]) + " / this "
                      + ", ".join(f"{t:.4f}" for t in ms["this"]) + f" ms a step [{smi}]")
            del systems
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
