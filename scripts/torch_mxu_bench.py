#!/usr/bin/env python3
"""Check and measure the tensor-core step kernels (csrc/mxu_kernels.cu:
mxu_step_kernel<Tf32x3> / <Bf16> and mxu_finish_kernel) and the potential
kernel (csrc/nbody_kernels.cu: potential_kernel, potential_finish_kernel) of
nbody_tpu_torch on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_mxu_bench.py [--quick] [--against DIR]

First it prints what ptxas says of the three walks' kernels (registers,
spills, shared memory) and the SASS of each walk a pair by opcode: the
innermost loop that holds the rsqrt, over its MUFU.RSQ (``_build.sass_loops``;
the cheapest loop of each kernel, its ragged or masked twin beside it). Then
it holds both mxu kernels to their plain version (``reference.nbody_step_mxu_vs``)
under the mxu error model (``reference.mxu_step_tolerance``) at ragged
shapes, M != N and the four-card hop (16384, 65536), with masses from
[0.5, 2], a random vel.w and damping 0.5, in the rule's j-chunks
(``mxu_splits``), one and three: repeats bit-equal, w lanes kept. And the
potential to its plain version (``energy.potential_energy_per_row``, within
1e-4 * max + 1e-4) at N = 1, 1000, 4099 and 65537, blocks 128, 256 and 1024
bit-equal, S the rule's, 1 and 3, at eps = 0 (the self pair dropped by its
index) and with two bodies at one position. --quick stops there.

Then it times with CUDA events, in turns (six rounds, this build and DIR's,
then the reverse; the median and every round, nvidia-smi's SM clock sampled
beside): the mxu and mxu_bf16 kernels at (M, N) = (16384, 16384), (65536,
65536), (135168, 135168) and (16384, 65536), and this build's at other S at
65536 and (16384, 65536); the potential at N = 65536 and 2^20 at blocks 128,
256 and 1024. Each line gives the bound read from the work (for mxu
``chip_smoke.mxu_bound_ms``: 12 fp32 flops a pair beside its mma flops and
bytes; 12 flops for the potential, pallas_kernel.py:784-786), the SFU floor
(one MUFU.RSQ a pair, 16 a clock an SM) and the issue bound of the walk's SASS count at the
sampled clock. Then device time a call by torch.profiler at 65536, and an
Euler step through ``Compute`` at 65536 of ``vpu``, ``sym``, ``mxu`` and
``mxu_bf16``, DIR's mxu kernels routed in beside this build's. --against DIR
builds DIR's csrc/mxu_kernels.cu and csrc/nbody_kernels.cu (another
checkout's, e.g. the parent's unpacked under compare/) with the library's
flags and calls them through the port's wrappers (``cuda_kernel._mxu_step``
and ``_potential``, ``lib=``; one j-chunk where the build has no ``_split``
entry point, else the port's rule). --against may be given more than once
(the parent, and copies with other constants). Prints one line per result
and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import statistics
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# the bounds' one definition: the card's rates and the mxu step's work
from chip_smoke import NOMINAL_MHZ, SFU_PER_CLOCK, bound_ms, mxu_bound_ms  # noqa: E402

# the walks: (label, source, a piece of the kernel's mangled name)
WALKS = (("mxu", "mxu_kernels.cu", "6Tf32x3"), ("mxu_bf16", "mxu_kernels.cu", "4Bf16"),
         ("potential", "nbody_kernels.cu", "16potential_kernel"))
MXU_SHAPES = ((16384, 16384), (65536, 65536), (135168, 135168), (16384, 65536))
POTENTIAL_NS = (65536, 1 << 20)
BLOCKS = (128, 256, 1024)


def walk_counts(label: str, csrc: pathlib.Path) -> dict:
    """Print the registers, spills and shared memory of the walks' kernels
    of `csrc` and each walk's SASS a pair by opcode (every loop that holds
    an rsqrt); returns {walk: the cheapest loop's count a pair}."""
    from nbody_tpu_torch.ops import _build

    best = {}
    for src in sorted({s for _, s, _ in WALKS}):
        usage, sass = _build.sass_of(csrc / src)
        names = _build.demangle(usage)
        for walk, source, key in WALKS:
            if source != src:
                continue
            for mangled, u in usage.items():
                if key in mangled:
                    print(f"ptxas {label}: {names[mangled]}: {u['registers']} registers, "
                          f"{u['spill_stores']} / {u['spill_loads']} bytes spill stores / loads, "
                          f"{u['smem']} bytes smem, {u['stack']} bytes stack")
            for loop in sorted(_build.sass_loops(sass, key),
                               key=lambda lp: lp["instructions"] / lp["pairs"]):
                pairs = loop["pairs"]
                per = loop["instructions"] / pairs
                ops = ", ".join(f"{op} {k / pairs:.3f}" for op, k in
                                sorted(loop["ops"].items(), key=lambda kv: -kv[1]))
                fname = names.get(loop["function"], loop["function"])
                print(f"sass {label}: {fname}: loop of {loop['instructions']} instructions over "
                      f"{pairs} pairs = {per:.2f} a pair; by opcode a pair: {ops}")
                best[walk] = min(best.get(walk, per), per)
    return best


def against_library(csrc: pathlib.Path, tmp: pathlib.Path):
    """DIR's csrc/mxu_kernels.cu and csrc/nbody_kernels.cu, each built on its
    own with the library's flags: (mxu lib, potential lib)."""
    from nbody_tpu_torch.ops import _build
    from torch_aj_dispatch import build_so

    libs = []
    for src, declare in (("mxu_kernels.cu", _build.declare_mxu),
                         ("nbody_kernels.cu", _build.declare_potential)):
        where = tmp / src.split(".")[0]
        where.mkdir(parents=True)
        lib = build_so(csrc / src, where)
        declare(lib)
        # the library's error text comes from another source: name the code only
        lib.nbody_error_string = lambda err: f"code {err}".encode()
        libs.append(lib)
    return tuple(libs)


def state(torch, n, dev, *, seed=42, random_w=False):
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
    if random_w:
        rng = np.random.default_rng(7)
        pos[:, 3] = rng.uniform(0.5, 2.0, n)
        vel[:, 3] = rng.standard_normal(n)
    return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)


def own_splits(lib, kind: str):
    """The j-chunks to time a build's kernel in: the port's rule (None) for
    this build and for a build with the split entry point, else one."""
    entry = {"mxu": "nbody_mxu_step_split_f32", "potential": "nbody_potential_split_f32"}[kind]
    return None if lib is None or hasattr(lib, entry) else 1


def checks(torch, dev, others: dict) -> bool:
    """This build's mxu and potential kernels against their plain versions
    (and each DIR's in one chunk, against the same): see the module's
    docstring."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import energy, reference

    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    ok = True
    for m, n in ((1, 33), (33, 1), (100, 100), (333, 1000), (1000, 333), (777, 4099),
                 (4099, 777), (4099, 4099), (16384, 65536)):
        pj, vj = state(torch, n, dev, random_w=True)
        pi, vi = (pj, vj) if m == n else state(torch, m, dev, seed=3, random_w=True)
        for variant in reference.MXU_VARIANTS:
            want = reference.nbody_step_mxu_vs(pi, vi, pj, dt, soft, 0.5,
                                               mxu_dtype=reference.MXU_DTYPES[variant])
            tol_p, tol_v = reference.mxu_step_tolerance(pi, vi, pj, want, dt, soft, 0.5,
                                                        variant=variant)
            runs = [(f"this S={ck.mxu_splits(m, n) if s is None else s}", s, None)
                    for s in (None, 1, 3)]
            runs += [(f"{label} S=1", 1, libs[0]) for label, libs in others.items()]
            for tag, s, lib in runs:
                got = ck._mxu_step(pi, vi, pj, dt, soft, 0.5, variant, None, splits=s, lib=lib)
                again = ck._mxu_step(pi, vi, pj, dt, soft, 0.5, variant, None, splits=s,
                                     lib=lib)
                ratio = max(((got[0][:, :3] - want[0][:, :3]).abs() / tol_p).max().item(),
                            ((got[1][:, :3] - want[1][:, :3]).abs() / tol_v).max().item())
                same = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
                kept = bool(torch.equal(got[0][:, 3], pi[:, 3])
                            and torch.equal(got[1][:, 3], vi[:, 3]))
                ok &= ratio <= 1.0 and same and kept
                print(f"check {variant} {tag} M={m} N={n}: max error / bound {ratio:.3e}, "
                      f"repeat bit-equal {same}, w lanes kept {kept}")
    for n in (1, 1000, 4099, 65537):
        p, _ = state(torch, n, dev, random_w=True)
        want = energy.potential_energy_per_row(p, soft)
        tol = 1e-4 * want.abs().max().item() + 1e-4
        for s in (None, 1, 3):
            first = None
            for bs in BLOCKS:
                got = ck._potential(p, soft, bs, splits=s)
                err = (got - want).abs().max().item()
                first = got if first is None else first
                same = bool(torch.equal(got, first)
                            and torch.equal(got, ck._potential(p, soft, bs, splits=s)))
                ok &= err <= tol and same
                print(f"check potential N={n} S={ck.step_splits(n, n) if s is None else s} "
                      f"block={bs}: max|d|={err:.3e} (tol {tol:.3e}), bit-equal to block "
                      f"{BLOCKS[0]} and a repeat {same}")
        for label, libs in others.items():
            err = (ck._potential(p, soft, 256, splits=1, lib=libs[1]) - want).abs().max().item()
            ok &= err <= tol
            print(f"check potential {label} N={n}: max|d|={err:.3e} (tol {tol:.3e})")
    # eps = 0: the self pair (inf) dropped by its index; two bodies at one
    # position at eps > 0 count m_i m_j / eps
    p, _ = state(torch, 4099, dev, random_w=True)
    twin = p.clone()
    twin[17] = twin[4000]
    for tag, q, eps in (("eps=0", p, 0.0), ("two bodies at one position", twin, soft)):
        want = energy.potential_energy_per_row(q, eps)
        tol = 1e-4 * want.abs().max().item() + 1e-4
        for bs in BLOCKS:
            got = ck._potential(q, eps, bs)
            err = (got - want).abs().max().item()
            ok &= bool(torch.isfinite(got).all()) and err <= tol
            print(f"check potential {tag} N=4099 block={bs}: finite "
                  f"{bool(torch.isfinite(got).all())}, max|d|={err:.3e} (tol {tol:.3e})")
    torch.cuda.synchronize()
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, action="append", default=[],
                    help="a checkout whose mxu and potential kernels are timed in turns")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:
    import torch

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.utils.timing import card_line

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    assert not torch.backends.cuda.matmul.allow_tf32
    smi = card_line()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    per_pair = {"this": walk_counts("this", _build.CSRC)}
    others = {}  # label: (mxu lib, potential lib)
    for k, d in enumerate(args.against):
        d = d.resolve()
        csrc = d / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = d / "csrc"
        label = f"against{k}" if len(args.against) > 1 else "against"
        print(f"{label}: {d}")
        per_pair[label] = walk_counts(label, csrc)
        others[label] = against_library(csrc, tmp / label)
    ok = checks(torch, dev, others)
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if not args.quick:
        timings(torch, dev, smi, others, per_pair)
        device_times(torch, dev, smi, others)
        compute_steps(torch, dev, smi, others)
    print(f"card: {smi}")
    return 0


def timings(torch, dev, smi: str, others: dict, per_pair: dict) -> None:
    """The kernels in turns, six rounds, medians: see the module's docstring."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.utils.timing import elapsed_ms
    from torch_aj_dispatch import Clocks

    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def turns(runs: dict, work: dict, rounds: int = 6, reps: int = 5) -> None:
        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(reps)],
                                               dev) / reps)
        mhz = clocks.median_mhz() or NOMINAL_MHZ
        for k, ts in times.items():
            med = statistics.median(ts)
            pairs, bound, per = work[k]
            sfu = pairs / (SFU_PER_CLOCK * sms * mhz * 1e6) * 1e3
            extra = (f"; bound {bound[0]:.3f} ms ({bound[1]}, {100 * bound[0] / med:.1f} %); "
                     f"SFU floor {sfu:.3f} ms ({100 * sfu / med:.1f} %)")
            if per:
                issue = pairs * per / 32 / (sms * 4 * mhz * 1e6) * 1e3
                extra += (f"; issue bound {issue:.3f} ms at {per:.2f} a pair "
                          f"({100 * issue / med:.1f} %)")
            print(f"{k}: median {med:.4f} ms, min {min(ts):.4f} (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f"){extra}, {mhz:.0f} MHz [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    labels = ["this", *others]
    for m, n in MXU_SHAPES:
        pj, vj = state(torch, n, dev)
        pi, vi = pj[:m].contiguous(), vj[:m].contiguous()
        out = (torch.empty_like(pi), torch.empty_like(vi))
        pairs = float(m) * n
        for variant in ("mxu", "mxu_bf16"):
            bound = mxu_bound_ms(ck.MXU_KERNELS[variant][1], pairs,
                                 (2 * m + n) * 16 + 2 * m * 16)
            runs, work = {}, {}
            splits = [None]
            if m == n or m * 4 == n:
                s0 = ck.mxu_splits(m, n)
                splits += sorted({1, max(1, s0 // 2), 2 * s0, 4 * s0} - {s0})
            for label in labels:
                lib = others[label][0] if label in others else None
                for sp in (splits if lib is None else [own_splits(lib, "mxu")]):
                    s = ck.mxu_splits(m, n) if sp is None else sp
                    key = f"{label} {variant} ({m},{n}) S={s}"
                    runs[key] = lambda lib=lib, sp=sp, v=variant: ck._mxu_step(
                        pi, vi, pj, dt, soft, 1.0, v, out, splits=sp, lib=lib)
                    work[key] = (pairs, bound, per_pair[label].get(variant))
            turns(runs, work)
        del pj, vj, pi, vi, out
    for n in POTENTIAL_NS:
        p, _ = state(torch, n, dev)
        pairs = float(n) * n
        bound = bound_ms(12.0 * n * (n - 1), n * 16 + n * 4)
        runs, work = {}, {}
        for label in labels:
            lib = others[label][1] if label in others else None
            for bs in BLOCKS:
                key = f"{label} potential N={n} block={bs}"
                runs[key] = lambda lib=lib, bs=bs: ck._potential(
                    p, soft, bs, splits=own_splits(lib, "potential"), lib=lib)
                work[key] = (pairs, bound, per_pair[label].get("potential"))
        turns(runs, work, reps=5 if n <= 65536 else 1)
        del p
    torch.cuda.empty_cache()


def device_times(torch, dev, smi: str, others: dict) -> None:
    """Device time a call of each kernel by torch.profiler over 10 calls
    after one, beside the host wall a call, at N = 65536."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.ops import cuda_kernel as ck

    dt, soft = DEMO_PARAMS[0].time_step, DEMO_PARAMS[0].softening
    p, v = state(torch, 65536, dev)
    out = (torch.empty_like(p), torch.empty_like(v))
    calls = {}
    for label in ["this", *others]:
        libs = others.get(label, (None, None))
        for variant in ("mxu", "mxu_bf16"):
            calls[f"{label} {variant} 65536"] = (
                lambda lib=libs[0], variant=variant: ck._mxu_step(
                    p, v, p, dt, soft, 1.0, variant, out, splits=own_splits(lib, "mxu"),
                    lib=lib))
        calls[f"{label} potential 65536 block=256"] = (
            lambda lib=libs[1]: ck._potential(p, soft, 256, splits=own_splits(lib, "potential"),
                                              lib=lib))
    for tag, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 10
        kernels = []
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(evt, "device_time_total", None)
                us = evt.cuda_time_total if us is None else us
                kernels.append((us / 10 / 1e3, evt.count, evt.key))
        busy = sum(ms for ms, _, _ in kernels)
        print(f"device {tag}: host wall {wall:.4f} ms a call, device busy {busy:.4f} ms a call; "
              + "; ".join(f"{key[:60]} {ms:.4f} ms ({count} launches)"
                          for ms, count, key in sorted(kernels, reverse=True)) + f" [{smi}]")


@contextlib.contextmanager
def routed(mxu_lib):
    """BodySystem's mxu step through `mxu_lib` (uncounted; one j-chunk where
    it has no split entry point) while the block runs."""
    from nbody_tpu_torch.models import body_system
    from nbody_tpu_torch.ops import cuda_kernel as ck

    def step(pos, vel, dt, softening, damping, *, variant, out=None):
        return ck._mxu_step(pos, vel, pos, dt, softening, damping, variant, out,
                            splits=own_splits(mxu_lib, "mxu"), lib=mxu_lib)

    saved = body_system.nbody_step_mxu_cuda
    body_system.nbody_step_mxu_cuda = step
    try:
        yield
    finally:
        body_system.nbody_step_mxu_cuda = saved


def compute_steps(torch, dev, smi: str, others: dict) -> None:
    """An Euler step through Compute at N = 65536 of vpu, sym, mxu and
    mxu_bf16, and of mxu and mxu_bf16 with each DIR's kernels routed in, in
    turns: the median of six rounds, ms a step over 10 steps after one."""
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.utils.timing import elapsed_ms

    n, steps = 65536, 10
    runs = {}
    for variant in ("vpu", "sym", "mxu", "mxu_bf16"):
        c = Compute(num_bodies=n, device=dev, variant=variant, log=lambda s: None)
        runs[f"this {variant}"] = (c, contextlib.nullcontext)
        if variant.startswith("mxu"):
            for label, libs in others.items():
                runs[f"{label} {variant}"] = (c, lambda lib=libs[0]: routed(lib))
    ms = {k: [] for k in runs}
    for r in range(6):
        for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
            c, ctx = runs[k]
            with ctx():
                c.system.update_many(1)
                ms[k].append(elapsed_ms(lambda c=c: c.system.update_many(steps), dev) / steps)
    for k, ts in ms.items():
        print(f"Compute Euler step N={n} {k}: median {statistics.median(ts):.4f} ms a step "
              f"(rounds: {', '.join(f'{t:.4f}' for t in ts)}) [{smi}]")


if __name__ == "__main__":
    sys.exit(main())
