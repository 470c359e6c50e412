#!/usr/bin/env python3
"""Check and measure the each-pair-once force kernels of nbody_tpu_torch
(csrc/symmetric_kernels.cu: sym_tri_kernel, sym_cross_kernel and
sym_ablate_kernel, all on one walk, sym_walk) on the card, to fix
``sym_default_dispatch`` (ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_sym_dispatch.py [--quick] [--against DIR]... [--no-sweep]

First it prints what ptxas says of every kernel of csrc/symmetric_kernels.cu
(registers, spills, shared memory) and the SASS count a pair of each
instantiation's walk (``_build.sass_loops``: the innermost loop that holds
the rsqrt, over its MUFU.RSQ; a triangle or an ablation has two, the
diagonal's and the off-diagonal one). Then it holds the kernels to their
plain versions (ops/reference.py) within 1e-4 * max|a| + 1e-4, the bound of
tests/test_pallas.py:76, at every tile: the triangle at N = 1, 33, 1000 and
4099 with masses from [0.5, 2] and the last 7 bodies zero-mass at the
origin, repeats bit-equal; the rectangle at (777, 4099), (33, 1), (1, 33),
(4099, 777) and (1025, 2048), both outputs; the ablations at N = 1000 and
4099: the action of each within the bound, the full reaction within it, the
full variant's total bit-equal to the triangle and the none and tree_small
actions bit-equal to the full one; the blocked composition at N = 65536, cap
32768, against the one-sided plain force. --quick stops there.

Then it times with CUDA events, in turns (six rounds, this build and each
DIR's in order, then the reverse; the median and every round printed,
nvidia-smi's SM clock sampled beside, the bound at 28 flops a pair and the
issue bound of the walk's SASS count): the triangle at N = 65536 and the
default tile, the rectangle (67584, 67584) (the blocks of N = 135168), the
force at N = 135168 at the default dispatch, and the three ablations at
65536; the device time a call of the triangle and of the force at 135168 by
torch.profiler; and a sym Euler step against a one-sided ``vpu`` Euler step
through Compute at N = 65536 and 135168 (DIR's kernels routed into the
sym step). --against DIR builds DIR's csrc/symmetric_kernels.cu (another
checkout's, e.g. the parent's unpacked under compare/, with its shared
header) with the library's flags into a library of its own and routes it
through the port's wrappers (``cuda_kernel._sym``, ``_sym_cross``,
``_sym_ablated``, ``_sym_blocked`` with ``lib=``); it may be given more
than once (the parent, and copies with other constants such as the walk's
unroll). Last, unless --no-sweep, the sweep behind the dispatch table: this
build's force at N = 65536, 135168 and 262144 for each tile and block cap,
two rounds in turns, each launch's scratch in MB beside it. Prints one line
per result and the nvidia-smi name and power limit.
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

SOFT = 0.1
# the kernels by a piece of their mangled names
WALKS = (("tri", "14sym_tri_kernel"), ("cross", "16sym_cross_kernel"),
         ("ablate", "17sym_ablate_kernel"))
PAIR_FLOPS, PEAK_FP32_FLOPS = 28.0, 67e12
N_MAIN, N_BIG = 65536, 135168


def walk_counts(label: str, source: pathlib.Path) -> dict:
    """Print the ptxas lines of `source` and the SASS count a pair of each
    instantiation's walk loops; returns {(kernel, ROWS): the off-diagonal
    (fewest) count}, the ablations by (ablate, ROWS, reaction)."""
    import re

    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    for line in _build.ptxas_lines(source, label=label, usage=usage):
        print(line)
    names = _build.demangle(usage)
    best = {}
    for walk, key in WALKS:
        loops = {}
        for loop in _build.sass_loops(sass, key):
            loops.setdefault(loop["function"], []).append(loop)
        for fname, found in loops.items():
            name = names.get(fname, fname)
            counts = []
            for loop in found:
                pairs = loop["pairs"]
                per = loop["instructions"] / pairs
                counts.append(per)
                mix = ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(loop["mix"].items()))
                print(f"sass {label}: {name}: walk loop of {loop['instructions']} instructions "
                      f"over {pairs} pairs = {per:.2f} a pair; per pair: {mix}")
            # cu++filt prints the rows as <8> or <(int)8>
            rows = re.search(r"<(?:\(int\))?(\d+)", name)
            rows = int(rows.group(1)) if rows else 0
            # cu++filt prints an enum argument as (Reaction)0 or Reaction::kFull
            tail = re.search(r"Reaction(?:\)|::k)(\w+)", name)
            tail = tail and {"0": "Full", "1": "None", "2": "TreeSmall"}.get(tail.group(1),
                                                                          tail.group(1))
            k = (walk, rows, tail) if tail else (walk, rows)
            best[k] = min(counts)
            regs = usage.get(fname, {}).get("registers")
            print(f"sass {label}: {name}: {regs} registers, walk {min(counts):.2f} SASS a pair"
                  + (f" (off-diagonal), {max(counts):.2f} (diagonal)" if len(counts) > 1 else ""))
    return best


def against_library(source: pathlib.Path, tmp: pathlib.Path):
    """Another checkout's csrc/symmetric_kernels.cu, built on its own with the
    library's flags, with the C signatures the port's wrappers call."""
    from nbody_tpu_torch.ops import _build
    from torch_aj_dispatch import build_so

    lib = build_so(source, tmp)
    _build.declare_sym(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


def state(torch, n, seed=42, pad=0):
    """Shell ICs at the tuned scales with masses from [0.5, 2]; the last
    `pad` bodies zero-mass at the origin."""
    import numpy as np

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, _ = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
    pos[:, 3] = np.random.default_rng(seed + 7).uniform(0.5, 2.0, n)
    if pad:
        pos[-pad:] = 0.0
    return torch.tensor(pos, device="cuda")


def checks(torch, ck, reference) -> bool:
    def err(a, b):
        tol = 1e-4 * b.abs().max().item() + 1e-4
        return (a - b).abs().max().item(), tol

    ok = True
    for tile in ck.SYM_TILES:
        for n in (1, 33, 1000, 4099):
            p = state(torch, n, pad=min(7, n - 1))
            a = ck.sym_accel_cuda(p, SOFT, tile=tile)
            e, tol = err(a, reference.compute_accel_symmetric(p, SOFT))
            same = torch.equal(a, ck.sym_accel_cuda(p, SOFT, tile=tile))
            ok &= e <= tol and same
            print(f"check tri tile={tile} N={n}: max|da|={e:.3e} tol={tol:.3e} "
                  f"repeat bit-equal={same}")
        for bi, bj in ((777, 4099), (33, 1), (1, 33), (4099, 777), (1025, 2048)):
            pi, pj = state(torch, bi, seed=3), state(torch, bj, pad=min(7, bj - 1))
            a_k, r_k = ck.sym_cross_cuda(pi, pj, SOFT, tile=tile)
            a_r, r_r = reference.sym_cross(pi, pj, SOFT)
            e1, t1 = err(a_k, a_r)
            e2, t2 = err(r_k, r_r)
            a2, r2 = ck.sym_cross_cuda(pi, pj, SOFT, tile=tile)
            same = bool(torch.equal(a_k, a2) and torch.equal(r_k, r2))
            ok &= e1 <= t1 and e2 <= t2 and same
            print(f"check cross tile={tile} ({bi},{bj}): acc {e1:.3e}/{t1:.3e} "
                  f"react {e2:.3e}/{t2:.3e} repeat bit-equal={same}")
        for n in (1000, 4099):
            p = state(torch, n, pad=7)
            act, react = reference.sym_ablated_accel(p, SOFT, reaction="full", tile=tile)
            tol = 1e-4 * (act + react.t()).abs().max().item() + 1e-4
            prod = ck.sym_accel_cuda(p, SOFT, tile=tile)
            acc_f, react_f, total = ck.sym_ablated_accel_cuda(p, SOFT, reaction="full",
                                                              tile=tile, with_total=True)
            e = max((acc_f - act).abs().max().item(), (react_f - react).abs().max().item())
            ties = bool(torch.equal(total, prod))
            for r in ("none", "tree_small"):
                acc, _ = ck.sym_ablated_accel_cuda(p, SOFT, reaction=r, tile=tile)
                e = max(e, (acc - act).abs().max().item())
                ties &= bool(torch.equal(acc, acc_f))
            ok &= e <= tol and ties
            print(f"check ablate tile={tile} N={n}: max|d| {e:.3e} (tol {tol:.3e}); full's "
                  f"total equal to the triangle and none / tree_small actions to full's: {ties}")
    p = state(torch, N_MAIN)
    a_k = ck.compute_accel_symmetric_blocked_cuda(p, SOFT, block_cap=32768, tile=256)
    e, tol = err(a_k, reference.compute_accel(p, SOFT))
    ok &= e <= tol
    print(f"check blocked N={N_MAIN} cap=32768 tile=256 vs one-sided plain: {e:.3e} tol {tol:.3e}")
    torch.cuda.synchronize()
    return ok


@contextlib.contextmanager
def routed(lib):
    """BodySystem's sym force through `lib` (uncounted) while the block runs."""
    from nbody_tpu_torch.models import body_system
    from nbody_tpu_torch.ops import cuda_kernel as ck

    saved = body_system.compute_accel_symmetric_blocked_cuda

    def blocked(pos, softening, *, block_cap=None, tile=None):
        return ck._sym_blocked(pos, softening, block_cap, tile, lib)

    body_system.compute_accel_symmetric_blocked_cuda = blocked
    try:
        yield
    finally:
        body_system.compute_accel_symmetric_blocked_cuda = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, action="append", default=[],
                    help="a checkout whose csrc/symmetric_kernels.cu is timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the tile and cap sweep")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:
    import torch

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import card_line, elapsed_ms
    from torch_aj_dispatch import Clocks

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = card_line()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pair = {"this": walk_counts("this", _build.CSRC / "symmetric_kernels.cu")}
    others = {}
    for k, d in enumerate(args.against):
        d = d.resolve()
        csrc = d / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = d / "csrc"
        label = f"against{k}" if len(args.against) > 1 else "against"
        print(f"{label}: {d}")
        per_pair[label] = walk_counts(label, csrc / "symmetric_kernels.cu")
        where = tmp / label
        where.mkdir(parents=True)
        others[label] = against_library(csrc / "symmetric_kernels.cu", where)
    ok = checks(torch, ck, reference)
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    labels = ["this", *others]
    _, tile = ck.sym_default_dispatch(N_MAIN)
    rows = tile // 128

    def turns(runs: dict, pairs: dict, rounds: int = 6, reps: int = 5) -> dict:
        """Time each run in turns (in order, then reversed), print the
        median and every round, the bound and the issue bound of its walk's
        SASS count at the sampled SM clock; returns the medians."""
        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(reps)],
                                               dev) / reps)
        mhz = clocks.median_mhz()
        out = {}
        for k, ts in times.items():
            med = out[k] = statistics.median(ts)
            extra = ""
            if k in pairs:
                n_pairs, flops_a_pair, slots = pairs[k]
                bound = n_pairs * flops_a_pair / PEAK_FP32_FLOPS * 1e3
                extra = f"; bound {bound:.3f} ms ({100 * bound / med:.1f} %)"
                if slots and mhz:
                    issue = n_pairs * slots / 32 / (sms * 4 * mhz * 1e6) * 1e3
                    extra += (f"; issue bound {issue:.3f} ms at {slots:.2f} a pair, {mhz:.0f} "
                              f"MHz ({100 * issue / med:.1f} %)")
            print(f"{k}: median {med:.4f} ms, min {min(ts):.4f} (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")
        return out

    p = state(torch, N_MAIN)
    pb = state(torch, N_BIG)
    _, blk = reference.sym_blocking(N_BIG, tile, ck.SYM_BLOCK_CAP)
    pi, pj = pb[:blk], pb[blk:2 * blk]
    half = float(N_MAIN) * (N_MAIN - 1) / 2
    runs, pairs = {}, {}
    for label in labels:
        lib = others.get(label)
        count = per_pair[label]
        runs[f"{label} triangle N={N_MAIN} tile={tile}"] = (
            lambda lib=lib: ck._sym(p, SOFT, tile, None, lib))
        pairs[f"{label} triangle N={N_MAIN} tile={tile}"] = (half, 28.0, count.get(("tri", rows)))
        runs[f"{label} rectangle ({blk},{blk}) tile={tile}"] = (
            lambda lib=lib: ck._sym_cross(pi, pj, SOFT, tile, None, lib))
        pairs[f"{label} rectangle ({blk},{blk}) tile={tile}"] = (
            float(blk) * blk, 28.0, count.get(("cross", rows)))
        runs[f"{label} force N={N_BIG} default dispatch"] = (
            lambda lib=lib: ck._sym_blocked(pb, SOFT, None, None, lib))
        pairs[f"{label} force N={N_BIG} default dispatch"] = (
            float(N_BIG) * (N_BIG - 1) / 2, 28.0, count.get(("tri", rows)))
    turns(runs, pairs)
    runs, pairs = {}, {}
    for label in labels:
        lib = others.get(label)
        for r, tail in (("none", "None"), ("tree_small", "TreeSmall"), ("full", "Full")):
            key = f"{label} ablation {r} N={N_MAIN} tile={tile}"
            runs[key] = lambda lib=lib, r=r: ck._sym_ablated(p, SOFT, r, tile, False, lib)
            pairs[key] = (half, 20.0 if r == "none" else 28.0,
                          per_pair[label].get(("ablate", rows, tail)))
    turns(runs, pairs)
    device_times(torch, ck, smi, others, p, pb, tile)
    del pi, pj
    system_steps(torch, others, smi)
    if not args.no_sweep:
        sweep(torch, ck, smi, turns)
    print(smi)
    return 0


def device_times(torch, ck, smi: str, others: dict, p, pb, tile: int) -> None:
    """Device time a call of each kernel by torch.profiler, beside the host
    wall a call, over 10 calls after one: the triangle at N = 65536 and the
    force at 135168, this build's and each DIR's."""
    import time

    from torch.profiler import ProfilerActivity, profile

    calls = {}
    for label in ["this", *others]:
        lib = others.get(label)
        calls[f"{label} triangle N={p.shape[0]}"] = lambda lib=lib: ck._sym(p, SOFT, tile, None,
                                                                            lib)
        calls[f"{label} force N={pb.shape[0]}"] = lambda lib=lib: ck._sym_blocked(
            pb, SOFT, None, None, lib)
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


def system_steps(torch, others: dict, smi: str) -> None:
    """A sym Euler step and a one-sided vpu Euler step through Compute at
    N = 65536 and 135168, in turns (six rounds: vpu, then this build's and
    each DIR's sym in order, then the reverse; the median of each), ms a
    step of run_benchmark(10)."""
    from nbody_tpu_torch.compute import Compute

    for n in (N_MAIN, N_BIG):
        computes = {"vpu": Compute(num_bodies=n, device="cuda", variant="vpu", log=lambda s: None),
                    "sym": Compute(num_bodies=n, device="cuda", variant="sym", log=lambda s: None)}
        runs = {"vpu": (computes["vpu"], None), "this sym": (computes["sym"], None),
                **{f"{label} sym": (computes["sym"], lib) for label, lib in others.items()}}
        ms = {k: [] for k in runs}
        for r in range(6):
            for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                compute, lib = runs[k]
                with routed(lib) if lib is not None else contextlib.nullcontext():
                    res = compute.run_benchmark(10)
                ms[k].append(res["milliseconds"] / res["iterations"])
        print(f"Euler step through Compute N={n}: " + "; ".join(
            f"{k} median {statistics.median(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
            for k, t in ms.items()) + f" ms a step [{smi}]")
        del computes, runs


def sweep(torch, ck, smi: str, turns) -> None:
    """This build's force at N = 65536, 135168 and 262144 for each tile and
    block cap (one triangle where the cap is N), two rounds in turns; the
    scratch of the widest launch in MB beside each."""
    for n in (N_MAIN, N_BIG, 262144):
        p = state(torch, n)
        caps = sorted({n, n // 2, 131072, 65536, 32768})
        runs = {}
        for tile in ck.SYM_TILES:
            for cap in caps:
                if cap > n or (tile < 512 and n > N_BIG):
                    continue
                mb = 12.0 * min(cap, n) ** 2 / tile / 1e6
                runs[f"sweep N={n} tile={tile} cap={cap} (scratch {mb:.0f} MB)"] = (
                    lambda tile=tile, cap=cap: ck.compute_accel_symmetric_blocked_cuda(
                        p, SOFT, block_cap=cap, tile=tile))
        turns(runs, {}, rounds=2, reps=3)
        del p
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
