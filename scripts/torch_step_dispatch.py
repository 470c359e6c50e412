#!/usr/bin/env python3
"""Measure the fp32 one-sided step kernel of nbody_tpu_torch and its twins
(csrc/nbody_kernels.cu: step_kernel, step_t_kernel, step_dual_kernel,
step_packed_kernel) on the card, to fix their j-split (``step_splits``,
ops/cuda_kernel.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_step_dispatch.py [--quick] [--against DIR ...] [--no-sweep]

First it prints what ptxas says of every kernel of csrc/nbody_kernels.cu
(registers, spills, shared memory) and the SASS count a pair of the step
kernels' walks (the innermost loop that holds the rsqrt, over its
MUFU.RSQ). Then it holds the step kernel to its plain version
(``reference.nbody_step_vs``) at odd and ragged M and N, N below a stage
and not a multiple of it, with masses from [0.5, 2], a random vel.w and
damping 0.5, in one j-chunk, the rule's and three, at blocks 32 to 1024:
the force the velocities carry within 1e-4 * max|a| + 1e-4, the velocity
within 1e-5 + dt * that and the position within 1e-5 + dt^2 * that, the w
lanes kept, repeats and blocks bit-equal; the rollout, dual-bank and packed
twins bit-equal to it at the same S and every block. --quick stops there.

--against DIR (may be given more than once) builds DIR/csrc/nbody_kernels.cu
(another checkout's, or a copy with other constants, with its shared
headers) with the library's nvcc flags into a library of its own, launched
through the port's wrappers (``cuda_kernel._step``, ``_rollout`` with
``lib=``; a build without the j-split entry points runs one chunk, as it
was written), prints its ptxas lines and SASS counts, and times it in turns
with this checkout's kernel (DIR ..., this, then the reverse, six rounds;
the median and every round printed) at (M, N) = (65536, 65536), (16384,
65536), (16384, 16384) and (135168, 135168) (one card at the main N, a
four-card allgather rank or ring hop, a four-card hop at N = 65536 / 4 a
card, and the CLI's default N on an H100), each at block 256, with
nvidia-smi's SM clock sampled beside and the issue bound of each walk's
SASS count; then a ``vpu`` Euler step of ``BodySystem`` at N = 65536 and
135168 (DIR's kernel routed into the system) and a 10-step rollout at
65536, in turns.

Then, unless --no-sweep, it times the step kernel at those shapes per
block size (64 to 1024) and per fill of the rule (264 to 4224 blocks), two
rounds in turns. Prints one line per measurement and the nvidia-smi name
and power limit.
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

SOURCE = "nbody_kernels.cu"
# the step kernels by a piece of their mangled names
WALKS = (("step", "11step_kernel"), ("step_t", "13step_t_kernel"),
         ("step_dual", "16step_dual_kernel"), ("step_packed", "18step_packed_kernel"))
# the timed shapes (M, N)
SHAPES = ((65536, 65536), (16384, 65536), (16384, 16384), (135168, 135168))
# the fp32 rate a pair: 20 flops by the reference's count, at 67 TFLOP/s
PAIR_FLOPS, PEAK_FP32_FLOPS = 20.0, 67e12


def against_library(source: pathlib.Path, tmp: pathlib.Path, tag: str):
    """Another checkout's csrc/nbody_kernels.cu, built on its own with the
    library's flags into tmp/tag, with the C signatures the port's wrappers
    call."""
    from nbody_tpu_torch.ops import _build
    from torch_aj_dispatch import build_so

    where = tmp / tag  # build_so names the library after the source
    where.mkdir()
    lib = build_so(source, where)
    _build.declare_step(lib)
    # the library's error text comes from another source: name the code only
    lib.nbody_error_string = lambda err: f"code {err}".encode()
    return lib


def walk_counts(label: str, source) -> dict:
    """Print the ptxas lines of `source` and the SASS count a pair of each
    step kernel's walk (every instantiation); returns {kernel: the cheapest
    walk's count}."""
    from nbody_tpu_torch.ops import _build

    usage, sass = _build.sass_of(source)
    for line in _build.ptxas_lines(source, label=label, usage=usage):
        print(line)
    names = _build.demangle(usage)
    best = {}
    for kernel, key in WALKS:
        for loop in _build.sass_loops(sass, key):
            pairs = loop["pairs"]
            per = loop["instructions"] / pairs
            mix = ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(loop["mix"].items()))
            print(f"sass {label}: {names.get(loop['function'], loop['function'])}: walk loop of "
                  f"{loop['instructions']} instructions over {pairs} pairs = {per:.2f} a pair; "
                  f"per pair: {mix}")
            best[kernel] = min(best.get(kernel, per), per)
    return best


@contextlib.contextmanager
def routed(lib):
    """BodySystem's fp32 step through `lib`, uncounted, while the block
    runs: in the rule's j-chunks, or in one where `lib` has no j-split
    entry point (the unsplit kernel's form)."""
    from nbody_tpu_torch.models import body_system
    from nbody_tpu_torch.ops import cuda_kernel as ck

    saved = body_system.nbody_step_cuda
    sp = None if hasattr(lib, "nbody_step_split_f32") else 1

    def step(pos, vel, dt, softening, damping, *, block_size=ck.DEFAULT_BLOCK_SIZE, out=None,
             splits=None):
        return ck._step(pos, vel, pos, dt, softening, damping, block_size, out, splits=sp,
                        lib=lib)

    body_system.nbody_step_cuda = step
    try:
        yield
    finally:
        body_system.nbody_step_cuda = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, action="append", default=[],
                    help="a checkout whose csrc/nbody_kernels.cu is timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the block and fill sweep")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        return run(args, pathlib.Path(tmp))


def run(args, tmp: pathlib.Path) -> int:
    import numpy as np
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference
    from nbody_tpu_torch.utils.timing import card_line, elapsed_ms
    from torch_aj_dispatch import Clocks

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = card_line()
    print(f"card: {smi}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pair = {"this": walk_counts("this", SOURCE)}
    others = {}
    for k, d in enumerate(args.against):
        d = d.resolve()
        csrc = d / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = d / "csrc"
        label = f"against{k}" if len(args.against) > 1 else "against"
        print(f"{label}: {d}")
        per_pair[label] = walk_counts(label, csrc / SOURCE)
        others[label] = against_library(csrc / SOURCE, tmp, label)

    dev = torch.device("cuda", 0)
    demo = DEMO_PARAMS[0]
    dt, soft = demo.time_step, demo.softening
    ok = True

    def state(n, seed=42, masses=False):
        scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
        pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
        if masses:
            rng = np.random.default_rng(7)
            pos[:, 3] = rng.uniform(0.5, 2.0, n)
            vel[:, 3] = rng.standard_normal(n)
        return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # the step at odd M and N, N below a stage and not a multiple of it, in
    # one j-chunk (1), the rule's (None) and three, at every block-size
    # class (4 rows a thread up to 512 threads, 1 above): within the bound
    # of plain, w lanes kept, the same bits at every block and on a repeat;
    # at M = N the twins at the same S and block give the step's bits
    for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 255),
                 (4099, 65537), (4099, 4099)):
        pi, vi = state(m, seed=3, masses=True)
        pj, _ = state(n, masses=True)
        if m == n:
            pj = pi
        rp, rv = reference.nbody_step_vs(pi, vi, pj, dt, soft, 0.5)
        tol_a = 1e-4 * reference.compute_accel_vs(pi, pj, soft).abs().max().item() + 1e-4
        for sp in (None, 1, 3):
            s = ck.step_splits(m, n) if sp is None else sp
            first, twins = None, True
            for bs in (32, 64, 128, 256, 512, 1024):
                got = ck._step(pi, vi, pj, dt, soft, 0.5, bs, None, splits=sp)
                again = ck._step(pi, vi, pj, dt, soft, 0.5, bs, None, splits=sp)
                first = got if first is None else first
                rep = same(got, again) and same(got, first)
                e_p = (got[0] - rp).abs().max().item()
                e_v = (got[1] - rv).abs().max().item()
                kept = bool(torch.equal(got[0][:, 3], pi[:, 3]) and
                            torch.equal(got[1][:, 3], vi[:, 3]))
                good = e_p <= 1e-5 + dt * dt * tol_a and e_v <= 1e-5 + dt * tol_a and kept
                ok &= rep and good
                print(f"check step ({m},{n}) splits={s} block={bs}: max|dpos|={e_p:.3e} "
                      f"max|dvel|={e_v:.3e} (tol_a {tol_a:.3e}); w lanes kept {kept}; repeat "
                      f"and block 32 bit-equal {rep}")
                if m == n:
                    roll = ck._rollout(pi, vi, dt, soft, 0.5, 1, bs, splits=sp)
                    dual = ck.nbody_step_dual_cuda(pi, vi, dt, soft, 0.5, block_size=bs,
                                                   splits=sp)
                    ns, npl = ck.nbody_step_packed_cuda(torch.cat([pi, vi], 1),
                                                        pi.t().contiguous(), dt, soft, 0.5,
                                                        block_size=bs, splits=sp)
                    twins &= (same(roll, got) and same(dual, got) and
                              same((ns[:, :4], ns[:, 4:]), got) and
                              bool(torch.equal(npl, got[0].t())))
            if m == n:
                ok &= twins
                print(f"check twins ({m},{n}) splits={s}: rollout, dual and packed bit-equal "
                      f"to the step at blocks 32-1024 {twins}")
    torch.cuda.synchronize()
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    def turns(runs: dict, pairs: dict, rounds: int) -> None:
        """Time each run in turns (in order, then reversed, `rounds`
        rounds), print the median and every round, and the issue-bound time
        of its SASS count at the sampled SM clock."""
        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(5)],
                                               dev) / 5)
        mhz = clocks.median_mhz()
        for k, ts in times.items():
            extra = ""
            if pairs.get(k) and mhz:
                n_pairs, slots = pairs[k]
                flops = n_pairs * PAIR_FLOPS / PEAK_FP32_FLOPS * 1e3
                extra = f"; bound {flops:.3f} ms ({100 * flops / statistics.median(ts):.1f} %)"
                if slots:
                    issue = n_pairs * slots / 32 / (sms * 4 * mhz * 1e6) * 1e3
                    extra += (f"; issue bound {issue:.3f} ms at {slots:.2f} a pair, {mhz:.0f} "
                              f"MHz ({100 * issue / statistics.median(ts):.1f} %)")
            print(f"{k}: median {statistics.median(ts):.4f} ms, min {min(ts):.4f} (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    p65, v65 = state(65536)
    p135, v135 = state(135168)

    def shape_state(m, n):
        pj, vj = (p135, v135) if n == 135168 else (p65[:n], v65[:n])
        return pj[:m], vj[:m], pj

    def kernel_runs(label, lib):
        split = lib is None or hasattr(lib, "nbody_step_split_f32")
        sp = None if split else 1
        runs, pairs = {}, {}
        for m, n in SHAPES:
            pi, vi, pj = shape_state(m, n)
            out = (torch.empty_like(pi), torch.empty_like(vi))
            s = ck.step_splits(m, n) if split else 1
            key = f"{label} step ({m},{n}) block=256 splits={s}"
            runs[key] = (lambda pi=pi, vi=vi, pj=pj, out=out: ck._step(
                pi, vi, pj, dt, soft, 1.0, 256, out, splits=sp, lib=lib))
            pairs[key] = (float(m) * n, per_pair[label].get("step"))
        key = f"{label} rollout N=65536 block=256, 10 steps"
        runs[key] = (lambda: ck._rollout(p65, v65, dt, soft, 1.0, 10, 256, splits=sp, lib=lib))
        pairs[key] = (10.0 * 65536 * 65536, per_pair[label].get("step_t"))
        return runs, pairs

    if others:
        groups = [kernel_runs(label, lib) for label, lib in others.items()]
        groups.append(kernel_runs("this", None))
        for idx in range(len(groups[0][0])):
            runs, pairs = {}, {}
            for g_runs, g_pairs in groups:
                k = list(g_runs)[idx]
                runs[k] = g_runs[k]
                pairs[k] = g_pairs[k]
            turns(runs, pairs, rounds=6)
        system_steps(torch, others, smi, dev)
    if args.no_sweep:
        return 0
    # the step kernel per block and per fill of the rule, at each shape
    for m, n in SHAPES:
        pi, vi, pj = shape_state(m, n)
        out = (torch.empty_like(pi), torch.empty_like(vi))
        runs, pairs = {}, {}
        for bs in (64, 128, 256, 512, 1024):
            for fill in (264, 528, 1056, 2112, 4224):
                sp = ck.one_sided_splits(m, n, tile_i=ck.AJ_TILE_I, stage=ck.STEP_STAGE,
                                         fill=fill)
                key = f"step ({m},{n}) block={bs} splits={sp}"
                runs.setdefault(key, lambda bs=bs, sp=sp: ck._step(pi, vi, pj, dt, soft, 1.0, bs,
                                                                   out, splits=sp))
                pairs[key] = (float(m) * n, per_pair["this"].get("step"))
        print(f"sweep ({m},{n}): the rule's S = {ck.step_splits(m, n)}")
        turns(runs, pairs, rounds=2)
    return 0


def system_steps(torch, others: dict, smi: str, dev) -> None:
    """A ``vpu`` Euler step of BodySystem at N = 65536 and 135168, each
    DIR's kernel (routed, one chunk) in turns with this checkout's: the
    median of six rounds, ms a step over `steps` steps after one."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.utils.timing import elapsed_ms

    for n, steps in ((65536, 10), (135168, 3)):
        system = BodySystem(n, DEMO_PARAMS[0], device=dev, variant="vpu")
        labels = [*others, "this"]
        ms = {label: [] for label in labels}
        for r in range(6):
            for label in (labels if r % 2 == 0 else labels[::-1]):
                ctx = routed(others[label]) if label in others else contextlib.nullcontext()
                with ctx:
                    system.update_many(1)
                    ms[label].append(elapsed_ms(lambda: system.update_many(steps), dev) / steps)
        print(f"vpu Euler step N={n}: " + "; ".join(
            f"{label} median {statistics.median(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
            for label, t in ms.items()) + f" ms a step [{smi}]")
        del system
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
