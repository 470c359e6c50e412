#!/usr/bin/env python3
"""Check and measure the fp32 one-sided force kernel (csrc/nbody_kernels.cu:
accel_kernel) and the fused ring kernel (csrc/ring_kernels.cu:
ring_accel_kernel) of nbody_tpu_torch on the card. Both run the step
kernel's walk (walk_chunk, csrc/allpairs_common.cuh) in ``step_splits``
j-chunks; a ring hop is the force at (M, M).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_accel_dispatch.py [--quick] [--against DIR]

First it prints what ptxas says of every kernel of csrc/nbody_kernels.cu and
csrc/ring_kernels.cu (registers, spills, shared memory) and the SASS count a
pair of the force's, the ring's and the step's walks (the innermost loop
that holds the rsqrt, over its MUFU.RSQ), and the co-resident ring blocks.
Then it holds the force to its plain version (``reference.compute_accel_vs``)
at odd and ragged M and N, with masses from [0.5, 2], in one j-chunk, the
rule's and three, at blocks 32 to 1024: within 1e-4 * max|a| + 1e-4, repeats
and blocks bit-equal, and, at the rule's S, bit-equal to the velocity of a
step kernel's step from rest (dt = 1, damping 1); and the ring on states
with 77 zero-mass bodies at the origin, at D = 1 against one force launch
and emulated at D = 2, 4 and 8 against the hop-ordered force launches
(torch.add), bit for bit, and within the bound of
``reference.ring_accel_fused_plain``, at blocks 128, 256 and 1024. --quick
stops there.

Then it times with CUDA events, in turns (six rounds, this build and
DIR's, then the reverse; the median and every round printed, nvidia-smi's
SM clock sampled beside and the issue bound of each walk's SASS count): the
force at (M, N) = (65536, 65536), (16384, 65536), (16384, 16384), (135168,
135168) and (4099, 4099); the ring at D = 1 and N = 65536, and emulated at D
= 2, 4 and 8 with 16384 bodies a rank; a ``vpu`` leapfrog step of
BodySystem at N = 65536; and a ``ring`` and a ``ring_fused`` Euler step on
a one-rank NCCL mesh at 65536. --against DIR builds DIR's
csrc/nbody_kernels.cu and csrc/ring_kernels.cu (another checkout's, e.g. the
parent's unpacked under compare/, with their shared headers) with the
library's flags into libraries of their own and routes them through the
port's wrappers (``cuda_kernel._accel(..., lib=)``; its one-chunk entry point
where it has no ``nbody_accel_split_f32``) and, for the ring, through a
launch of its own C interface (a table of six fields and no j-split where
its ``kTableFields`` is 6, as before the split), on the port's regions, whose
layout is unchanged. --against may be given more than once (the parent, and
copies with other constants). Prints one line per result and the nvidia-smi
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import pathlib
import statistics
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

SOFT = 0.1
# the walks by a piece of their mangled names, and their sources
WALKS = (("accel", "nbody_kernels.cu", "12accel_kernel"),
         ("ring", "ring_kernels.cu", "17ring_accel_kernel"),
         ("step", "nbody_kernels.cu", "11step_kernel"))
# the timed force shapes (M, N)
SHAPES = ((65536, 65536), (16384, 65536), (16384, 16384), (135168, 135168), (4099, 4099))
# the timed rings (D, M)
RINGS = ((1, 65536), (2, 16384), (4, 16384), (8, 16384))
PAIR_FLOPS, PEAK_FP32_FLOPS = 20.0, 67e12


def walk_counts(label: str, csrc: pathlib.Path) -> dict:
    """Print the ptxas lines of `csrc`'s two sources and the SASS count a
    pair of each walk (every instantiation); returns {walk: the cheapest
    instantiation's count}."""
    from nbody_tpu_torch.ops import _build

    best = {}
    for src in ("nbody_kernels.cu", "ring_kernels.cu"):
        usage, sass = _build.sass_of(csrc / src)
        for line in _build.ptxas_lines(csrc / src, label=label, usage=usage):
            print(line)
        names = _build.demangle(usage)
        for walk, source, key in WALKS:
            if source != src:
                continue
            for loop in _build.sass_loops(sass, key):
                pairs = loop["pairs"]
                per = loop["instructions"] / pairs
                mix = ", ".join(f"{k} {v / pairs:.2f}" for k, v in sorted(loop["mix"].items()))
                fname = names.get(loop["function"], loop["function"])
                print(f"sass {label}: {fname}: walk loop of {loop['instructions']} instructions "
                      f"over {pairs} pairs = {per:.2f} a pair; per pair: {mix}")
                best[walk] = min(best.get(walk, per), per)
    return best


def against_libraries(csrc: pathlib.Path, tmp: pathlib.Path):
    """DIR's csrc/nbody_kernels.cu and csrc/ring_kernels.cu, each built on its
    own with the library's flags: (force lib, ring lib, the ring's table
    fields)."""
    import re

    from nbody_tpu_torch.ops import _build
    from torch_aj_dispatch import build_so

    libs = []
    for src in ("nbody_kernels.cu", "ring_kernels.cu"):
        where = tmp / src.split(".")[0]
        where.mkdir(parents=True)
        lib = build_so(csrc / src, where)
        # the library's error text comes from another source: name the code only
        lib.nbody_error_string = lambda err: f"code {err}".encode()
        libs.append(lib)
    _build.declare_accel(libs[0])
    (fields,) = re.findall(r"constexpr int kTableFields = (\d+);",
                           (csrc / "ring_kernels.cu").read_text())
    return libs[0], libs[1], int(fields)


class OtherRing:
    """Another build of the ring kernel on the port's regions (the layout is
    unchanged: two slots and the flags), each rank's FusedRing allocated by
    this build. With a table of six fields (pos, acc, self, right, left,
    rank), the kernel before the split: no j-split, one block an i-block of
    blockDim.x rows. With seven (parts after acc), the split ring: this
    build's G and S and a scratch for the partials. G is capped at the
    blocks that build's kernel can keep resident together."""

    def __init__(self, lib, fields, torch, device, d: int, m: int, block_size: int = 256):
        from nbody_tpu_torch.ops import cuda_kernel as ck

        i64 = ctypes.c_int64
        lib.nbody_ring_coresident_blocks.argtypes = [i64, ctypes.POINTER(i64)]
        split = [i64] if fields == 7 else []
        lib.nbody_ring_accel_f32.argtypes = [ctypes.POINTER(i64), i64, i64, i64, i64, *split,
                                             ctypes.c_float, i64, ctypes.c_uint64, i64,
                                             ctypes.c_void_p]
        lib.nbody_ring_read_error.argtypes = [ctypes.c_void_p, i64, i64, ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_uint64)]
        out = i64()
        with torch.cuda.device(device):
            check_err(lib.nbody_ring_coresident_blocks(block_size, ctypes.byref(out)))
        work = ck.ring_items(m, block_size) if fields == 7 else ck._cdiv(m, block_size)
        groups = min(work, out.value // d)
        self.splits = ck.step_splits(m, m) if fields == 7 else None
        self.lib, self.torch, self.d, self.m, self.bs = lib, torch, d, m, block_size
        self.rings = [ck.FusedRing(m, d, r, device=device, block_size=block_size,
                                   groups=groups) for r in range(d)]
        for r, ring in enumerate(self.rings):
            ring.connect(self.rings[(r - 1) % d], self.rings[(r + 1) % d])
        self.groups = groups

    def __call__(self, shards, softening):
        torch = self.torch
        accs = [torch.empty((self.m, 3), dtype=torch.float32, device=s.device) for s in shards]
        parts = split = ()
        if self.splits is not None:
            parts = torch.empty((len(shards), self.d, self.splits, 3, self.m),
                                dtype=torch.float32, device=shards[0].device)
            split = (self.splits,)
        rows = []
        for k, (s, a, ring) in enumerate(zip(shards, accs, self.rings)):
            own = [parts[k].data_ptr()] if split else []
            rows += [s.data_ptr(), a.data_ptr(), *own, ring.base, ring.right, ring.left,
                     ring.rank]
        table = (ctypes.c_int64 * len(rows))(*rows)
        r0 = self.rings[0]
        epoch = r0.calls + 1
        for ring in self.rings:
            ring.calls = epoch
        word = ctypes.c_uint64()
        stream = torch.cuda.current_stream().cuda_stream
        check_err(self.lib.nbody_ring_accel_f32(table, len(shards), self.d, self.m, self.groups,
                                                *split, ctypes.c_float(softening ** 2), self.bs,
                                                epoch, 10 ** 10, stream))
        check_err(self.lib.nbody_ring_read_error(r0.base, self.m, self.groups, stream,
                                                 ctypes.byref(word)))
        if word.value:
            raise RuntimeError(f"the other build's ring timed out (word {word.value:#x})")
        return accs

    def close(self):
        for ring in self.rings:
            ring.close()


def check_err(err: int) -> None:
    if err:
        raise RuntimeError(f"CUDA error {err}")


def ring_state(torch, n, seed=42):
    """Shell ICs with masses from [0.5, 2] and the last 77 bodies zero-mass
    at the origin (the padding of a ragged ring)."""
    import numpy as np

    from nbody_tpu_torch import NBodyConfig, ic, tuned_scales

    pos, _ = ic.generate(NBodyConfig.SHELL, n, *(tuned_scales(n) or (1.54, 8.0)), seed=seed)
    pos[:, 3] = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    pos[-77:] = 0.0
    return torch.tensor(pos, device="cuda")


def hop_ordered(torch, ck, shards, block_size=256):
    """Each rank's force as the unfused ring sums it: one force launch a
    hop, hop h from rank r - h, added in hop order (torch.add)."""
    d = len(shards)
    out = []
    for r in range(d):
        total = ck.compute_accel_cuda(shards[r], shards[r], SOFT, block_size=block_size)
        for h in range(1, d):
            total = torch.add(total, ck.compute_accel_cuda(shards[r], shards[(r - h) % d], SOFT,
                                                           block_size=block_size))
        out.append(total)
    return out


def checks(torch, ck, reference) -> bool:
    ok = True
    for m, n in ((1000, 1000), (777, 4099), (4099, 777), (1, 33), (33, 1), (1025, 255),
                 (1025, 65537), (4099, 4099), (16384, 65536), (16384, 16384)):
        pj = ring_state(torch, n)
        pi = pj[:m].contiguous() if m <= n else ring_state(torch, m, seed=3)
        want = reference.compute_accel_vs(pi, pj, SOFT)
        tol = 1e-4 * want.abs().max().item() + 1e-4
        # a step from rest, dt = 1, damping 1: its velocity is the force
        rest = ck.nbody_step_cuda_vs(pi, torch.zeros_like(pi), pj, 1.0, SOFT, 1.0)[1][:, :3]
        for sp in (None, 1, 3):
            s = ck.step_splits(m, n) if sp is None else sp
            first = ck._accel(pi, pj, SOFT, 32, splits=sp)
            err = (first - want).abs().max().item()
            same = True
            for bs in (64, 128, 256, 512, 1024, 256):
                same &= bool(torch.equal(ck._accel(pi, pj, SOFT, bs, splits=sp), first))
            step = bool(torch.equal(first, rest)) if sp is None else None
            good = err <= tol and same and step is not False
            ok &= good
            print(f"check force ({m},{n}) splits={s}: max|da|={err:.3e} (tol {tol:.3e}); blocks "
                  f"32-1024 and repeats bit-equal {same}"
                  + ("" if step is None else f"; the step-from-rest velocity bit-equal {step}"))
    for d, m in ((1, 4099), (1, 65536), (2, 1025), (4, 1025), (8, 1025), (2, 16384),
                 (4, 16384)):
        shards = [s.contiguous() for s in ring_state(torch, d * m).split(m)]
        want = hop_ordered(torch, ck, shards)
        plain = reference.ring_accel_fused_plain(shards, SOFT)
        tol = 1e-4 * max(p.abs().max().item() for p in plain) + 1e-4
        for bs in (128, 256, 1024):
            if d == 1:
                ring = ck.FusedRing(m, 1, 0, device=shards[0].device, block_size=bs)
                got = [ck.ring_accel_fused_cuda(shards[0], SOFT, ring)]
                groups, splits = ring.groups, ring.splits
                ring.close()
            else:
                rings = ck.emulated_ring(shards[0].device, d, m, bs)
                got = ck.ring_accel_fused_emulated_cuda(shards, SOFT, rings=rings, block_size=bs)
                groups, splits = rings[0].groups, rings[0].splits
                for ring in rings:
                    ring.close()
            bits = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max((g - p).abs().max().item() for g, p in zip(got, plain))
            ok &= bits and err <= tol
            print(f"check ring D={d} M={m} block={bs} (G={groups}, S={splits}): bit-equal to the "
                  f"hop-ordered force launches {bits}; max|da| against plain {err:.3e} "
                  f"(tol {tol:.3e})")
    torch.cuda.synchronize()
    return ok


@contextlib.contextmanager
def routed(force_lib, ring_fn):
    """The force of BodySystem and of a mesh's ``ring`` through `force_lib`
    (uncounted; one chunk where it has no j-split entry point), and a mesh's
    ``ring_fused`` force through ring_fn(shard, softening), while the block
    runs."""
    from nbody_tpu_torch.models import body_system
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import sharded

    sp = None if hasattr(force_lib, "nbody_accel_split_f32") else 1

    def accel(pos_i, pos_j, softening, *, block_size=ck.DEFAULT_BLOCK_SIZE):
        return ck._accel(pos_i, pos_j, softening, block_size, splits=sp, lib=force_lib)

    saved = body_system.compute_accel_cuda, ck.compute_accel_cuda, sharded.ShardedStep.accel
    fused = sharded.ShardedStep.accel

    def sharded_accel(self, pos, softening):
        if self.strategy == "ring_fused":
            return ring_fn(pos, softening)
        return fused(self, pos, softening)

    body_system.compute_accel_cuda = ck.compute_accel_cuda = accel
    sharded.ShardedStep.accel = sharded_accel
    try:
        yield
    finally:
        body_system.compute_accel_cuda, ck.compute_accel_cuda, sharded.ShardedStep.accel = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="build, count and check only")
    ap.add_argument("--against", type=pathlib.Path, action="append", default=[],
                    help="a checkout whose force and ring kernels are timed in turns")
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
    per_pair = {"this": walk_counts("this", _build.CSRC)}
    print("co-resident ring blocks: " + ", ".join(
        f"{ck.ring_coresident_blocks(dev, bs)} at {bs} threads" for bs in (128, 256, 512, 1024)))
    others = {}  # label: (force lib, ring lib, the ring's table fields)
    for k, d in enumerate(args.against):
        d = d.resolve()
        csrc = d / "nbody_tpu_torch" / "csrc"
        if not csrc.is_dir():
            csrc = d / "csrc"
        label = f"against{k}" if len(args.against) > 1 else "against"
        print(f"{label}: {d}")
        per_pair[label] = walk_counts(label, csrc)
        others[label] = against_libraries(csrc, tmp / label)
    ok = checks(torch, ck, reference)
    print(f"checks {'passed' if ok else 'FAILED'}")
    if not ok:
        return 1
    if args.quick:
        return 0

    def turns(runs: dict, pairs: dict, rounds: int = 6, reps: int = 5) -> None:
        """Time each run in turns (in order, then reversed), print the
        median and every round, the bound and the issue bound of its walk's
        SASS count at the sampled SM clock."""
        for fn in runs.values():
            fn()
        times = {k: [] for k in runs}
        with Clocks() as clocks:
            for r in range(rounds):
                for k in (list(runs) if r % 2 == 0 else list(reversed(runs))):
                    times[k].append(elapsed_ms(lambda fn=runs[k]: [fn() for _ in range(reps)],
                                               dev) / reps)
        mhz = clocks.median_mhz()
        for k, ts in times.items():
            med = statistics.median(ts)
            extra = ""
            if k in pairs:
                n_pairs, slots = pairs[k]
                flops = n_pairs * PAIR_FLOPS / PEAK_FP32_FLOPS * 1e3
                extra = f"; bound {flops:.3f} ms ({100 * flops / med:.1f} %)"
                if slots and mhz:
                    issue = n_pairs * slots / 32 / (sms * 4 * mhz * 1e6) * 1e3
                    extra += (f"; issue bound {issue:.3f} ms at {slots:.2f} a pair, {mhz:.0f} "
                              f"MHz ({100 * issue / med:.1f} %)")
            print(f"{k}: median {med:.4f} ms, min {min(ts):.4f} (rounds: "
                  + ", ".join(f"{t:.4f}" for t in ts) + f"){extra} [{smi}]")
        print(f"  clocks beside it: {clocks.summary()}")

    labels = ["this", *others]
    # the force
    for m, n in SHAPES:
        pj = ring_state(torch, n)
        pi = pj[:m]
        runs, pairs = {}, {}
        for label in labels:
            lib = others[label][0] if label in others else None
            sp = None if lib is None or hasattr(lib, "nbody_accel_split_f32") else 1
            s = ck.step_splits(m, n) if sp is None else 1
            key = f"{label} force ({m},{n}) block=256 splits={s}"
            runs[key] = lambda lib=lib, sp=sp: ck._accel(pi, pj, SOFT, 256, splits=sp, lib=lib)
            pairs[key] = (float(m) * n, per_pair[label].get("accel"))
        turns(runs, pairs)
        del pj, pi
    # the ring
    for d, m in RINGS:
        shards = [s.contiguous() for s in ring_state(torch, d * m).split(m)]
        runs, pairs, kept = {}, {}, []
        for label in labels:
            if label in others:
                other = OtherRing(*others[label][1:], torch, dev, d, m)
                kept.append(other)
                key = (f"{label} ring D={d} M={m} block=256 (G={other.groups}, "
                       f"S={other.splits or 1})")
                runs[key] = lambda other=other: other(shards, SOFT)
            else:
                rings = ck.emulated_ring(dev, d, m)
                kept.append(RingSet(rings))
                key = (f"this ring D={d} M={m} block=256 (G={rings[0].groups}, "
                       f"S={rings[0].splits})")
                runs[key] = lambda rings=rings: ck.ring_accel_fused_emulated_cuda(
                    shards, SOFT, rings=rings)
            pairs[key] = (float(d * m) * d * m, per_pair[label].get("ring"))
        turns(runs, pairs)
        for k in kept:
            k.close()
        del shards
    torch.cuda.empty_cache()
    device_times(torch, ck, smi, dev)
    system_steps(torch, others, smi, dev)
    print(smi)
    return 0


def device_times(torch, ck, smi: str, dev) -> None:
    """Device time a call of each kernel by torch.profiler, beside the host
    wall a call, over 10 calls after one: the force at (65536, 65536) and
    (16384, 16384), the ring at D = 1, 65536 and emulated at D = 4, 16384 a
    rank (a ring call synchronises its stream to read its error word)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    pos = ring_state(torch, 65536)
    small = pos[:16384].contiguous()
    shards = [s.contiguous() for s in pos.split(16384)]
    ring1, rings4 = ck.FusedRing(65536, 1, 0, device=dev), ck.emulated_ring(dev, 4, 16384)
    calls = {"force (65536,65536)": lambda: ck.compute_accel_cuda(pos, pos, SOFT),
             "force (16384,16384)": lambda: ck.compute_accel_cuda(small, small, SOFT),
             "ring D=1 M=65536": lambda: ck.ring_accel_fused_cuda(pos, SOFT, ring1),
             "ring D=4 M=16384": lambda: ck.ring_accel_fused_emulated_cuda(shards, SOFT,
                                                                            rings=rings4)}
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
    for ring in (ring1, *rings4):
        ring.close()


class RingSet:
    """The FusedRings of an emulated ring, closed together."""

    def __init__(self, rings):
        self.rings = rings

    def close(self):
        for ring in self.rings:
            ring.close()


def system_steps(torch, others: dict, smi: str, dev) -> None:
    """A vpu leapfrog step of BodySystem at N = 65536 and a ring and a
    ring_fused Euler step on a one-rank NCCL mesh at 65536, each this
    build's and (with --against) each DIR's kernels routed in, in turns: the
    median of six rounds, ms a step over 10 steps after one."""
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.utils.timing import elapsed_ms

    n, steps = 65536, 10
    mesh = make_mesh(1)
    try:
        systems = {"vpu leapfrog": BodySystem(n, DEMO_PARAMS[0], device=dev, variant="vpu",
                                              integrator="leapfrog"),
                   "ring Euler (mesh of 1)": BodySystem(n, DEMO_PARAMS[0], device=dev,
                                                        mesh=mesh, strategy="ring"),
                   "ring_fused Euler (mesh of 1)": BodySystem(n, DEMO_PARAMS[0], device=dev,
                                                              mesh=mesh, strategy="ring_fused")}
        rings = {label: OtherRing(*libs[1:], torch, dev, 1, n) for label, libs in others.items()}
        labels = ["this", *others]
        for tag, system in systems.items():
            ms = {label: [] for label in labels}
            for r in range(6):
                for label in (labels if r % 2 == 0 else labels[::-1]):
                    ctx = (routed(others[label][0],
                                  lambda pos, soft, ring=rings.get(label): ring([pos], soft)[0])
                           if label in others else contextlib.nullcontext())
                    with ctx:
                        system.update_many(1)
                        ms[label].append(elapsed_ms(lambda: system.update_many(steps), dev)
                                         / steps)
            print(f"{tag} step N={n}: " + "; ".join(
                f"{label} median {statistics.median(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                for label, t in ms.items()) + f" ms a step [{smi}]")
        del systems
        for ring in rings.values():
            ring.close()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
