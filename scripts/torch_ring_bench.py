#!/usr/bin/env python3
"""Check and measure the fused ring kernel (csrc/ring_kernels.cu) of
nbody_tpu_torch on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_ring_bench.py [--quick]

First it prints what ptxas says of the ring kernel and of the one-sided
force kernel whose j-loop it shares (registers, spills, shared memory) and
the blocks a cooperative launch may hold. Then it checks the kernel on
states with masses from [0.5, 2], a random vel.w and 77 zero-mass bodies at
the origin: at D = 1 (one rank, no copies) against one force-kernel launch,
and through the emulated ring (D virtual ranks in one launch, each with its
own slots and flags in the card's memory) at D = 2, 4 and 8 against the
hop-ordered sum of force-kernel launches, bit for bit, and against the
plain version (reference.ring_accel_fused_plain) at 1e-4 * max|a| + 1e-4;
200 emulated D = 4 calls back to back, every one equal to the first; and a
rank whose left neighbour never runs, which must raise after its timeout.
--quick stops there. Then it times, with CUDA events after a warm-up call,
in turns: the kernel at D = 1, N = 65536 beside the force kernel; the
emulated ring at D = 2, 4 and 8 with N = 65536 in all beside one force
launch at 65536; and D = 4 at block sizes 128 and 256. Prints one line per
result and the nvidia-smi name and power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOFT = 0.1
N_MAIN = 65536


def ptxas_report() -> None:
    from nbody_tpu_torch.ops import _build

    for src in ("ring_kernels.cu", "nbody_kernels.cu"):
        for line in _build.ptxas_lines(src):
            print(line)


def state(torch, n, seed=42):
    """Shell ICs with masses from [0.5, 2], a random vel.w, and the last 77
    bodies zero-mass at the origin (the padding of a ragged ring)."""
    import numpy as np

    from nbody_tpu_torch import NBodyConfig, ic, tuned_scales

    pos, vel = ic.generate(NBodyConfig.SHELL, n, *(tuned_scales(n) or (1.54, 8.0)), seed=seed)
    rng = np.random.default_rng(seed)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    pos[-77:] = 0.0
    return torch.tensor(pos, device="cuda")


def hop_ordered(torch, ck, shards, block_size):
    """Each rank's force as the unfused ring sums it: one force-kernel
    launch a hop, hop h from rank r-h, added in hop order."""
    d = len(shards)
    out = []
    for r in range(d):
        total = ck.compute_accel_cuda(shards[r], shards[r], SOFT, block_size=block_size)
        for h in range(1, d):
            total = torch.add(total, ck.compute_accel_cuda(shards[r], shards[(r - h) % d], SOFT,
                                                           block_size=block_size))
        out.append(total)
    return out


def checks(torch, ck, reference) -> None:
    for d, m in ((1, 4099), (1, N_MAIN), (2, 1025), (4, 1025), (8, 1025), (2, 16384),
                 (4, 16384)):
        pos = state(torch, d * m)
        shards = [s.contiguous() for s in pos.split(m)]
        if d == 1:
            ring = ck.FusedRing(m, 1, 0, device=pos.device)
            got = [ck.ring_accel_fused_cuda(shards[0], SOFT, ring)]
            ring.close()
        else:
            got = ck.ring_accel_fused_emulated_cuda(shards, SOFT)
        want = hop_ordered(torch, ck, shards, ck.DEFAULT_BLOCK_SIZE)
        plain = reference.ring_accel_fused_plain(shards, SOFT)
        torch.cuda.synchronize()
        bits = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max((g - p).abs().max().item() for g, p in zip(got, plain))
        tol = 1e-4 * max(p.abs().max().item() for p in plain) + 1e-4
        print(f"check D={d} M={m}: bit-equal to hop-ordered accel launches {bits}; "
              f"max|da| against plain {err:.3e} (tol {tol:.3e})")
        if not (bits and err <= tol):
            raise RuntimeError(f"ring kernel wrong at D={d} M={m}")
    shards = [s.contiguous() for s in state(torch, 4 * 1025).split(1025)]
    rings = ck.emulated_ring(shards[0].device, 4, 1025)
    first = ck.ring_accel_fused_emulated_cuda(shards, SOFT, rings=rings)
    same = all(all(torch.equal(a, b) for a, b in
                   zip(ck.ring_accel_fused_emulated_cuda(shards, SOFT, rings=rings), first))
               for _ in range(200))
    for ring in rings:
        ring.close()
    print(f"check 200 emulated D=4 calls: all bit-equal to the first {same}")
    if not same:
        raise RuntimeError("repeated ring calls differ")
    # a rank of a D=2 ring whose left neighbour never launches
    lone = ck.FusedRing(1025, 2, 0, device=shards[0].device)
    dead = ck.FusedRing(1025, 2, 1, device=shards[0].device, groups=lone.groups)
    lone.connect(dead, dead)
    try:
        ck.ring_accel_fused_cuda(shards[0], SOFT, lone, timeout_s=0.2)
    except RuntimeError as e:
        print(f"check lone rank: raised {e}")
    else:
        raise RuntimeError("a rank with no neighbour did not time out")
    lone.close()
    dead.close()


def times(torch, ck, reference, smi) -> None:
    from nbody_tpu_torch.utils.timing import elapsed_ms

    pos = state(torch, N_MAIN)
    reps = 10

    def run(fn):
        fn()
        torch.cuda.synchronize()
        return elapsed_ms(lambda: [fn() for _ in range(reps)], pos.device) / reps

    ring1 = ck.FusedRing(N_MAIN, 1, 0, device=pos.device)
    calls = {"accel 65536": lambda: ck.compute_accel_cuda(pos, pos, SOFT),
             "ring D=1": lambda: ck.ring_accel_fused_cuda(pos, SOFT, ring1)}
    kept = []  # every emulated ring's buffers, kept across its calls
    for d, bs in ((2, 256), (4, 256), (8, 256), (4, 128)):
        shards = [s.contiguous() for s in pos.split(N_MAIN // d)]
        kept.append(ck.emulated_ring(pos.device, d, N_MAIN // d, bs))
        calls[f"emulated D={d}" + (f" block {bs}" if bs != 256 else "")] = (
            lambda s, r, b: lambda: ck.ring_accel_fused_emulated_cuda(
                s, SOFT, rings=r, block_size=b))(shards, kept[-1], bs)
    shards4 = [s.contiguous() for s in pos.split(N_MAIN // 4)]
    calls["hop-ordered accel D=4"] = lambda: hop_ordered(torch, ck, shards4, 256)
    order = list(calls) + list(reversed(calls))
    ms = {k: [] for k in calls}
    for k in order:
        ms[k].append(run(calls[k]))
    for k, v in ms.items():
        print(f"time {k}: {', '.join(f'{t:.3f}' for t in v)} ms per call [{smi}]")
    t0 = elapsed_ms(lambda: reference.ring_accel_fused_plain(shards4, SOFT), pos.device)
    print(f"time plain D=4 (N=65536 in all): {t0:.3f} ms [{smi}]")
    for ring in (ring1, *(r for rings in kept for r in rings)):
        ring.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    ptxas_report()
    print(f"co-resident ring blocks at 256 threads: {ck.ring_coresident_blocks(0)}, "
          f"at 128: {ck.ring_coresident_blocks(0, 128)}")
    checks(torch, ck, reference)
    if "--quick" not in sys.argv:
        times(torch, ck, reference, smi)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
