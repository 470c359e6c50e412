#!/usr/bin/env python3
"""The packed-state step on the card: the port of scripts/tpu_r3_packed.py.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_r3_packed.py [--cpu]

The TPU script kept the state as one (N, 8) array [pos | vel], which
halves a tile's small DMAs. It read the j-side from the (4, N) planes,
which XLA transposed from each new state. Its Hopper counterpart,
csrc/nbody_kernels.cu::step_packed_kernel
(``cuda_kernel.nbody_step_packed_cuda``), reads and writes one 32-byte row
a body. It reads the j-side from the planes and writes the next step's
planes itself.

As the TPU script does, this script takes shell ICs, demo 0 and N = 65536.
It holds one packed step against the production step (the step kernel),
by its largest |difference| and by its bits, and its planes against the
new positions. Then it times a roll of 25 steps, best of 3, in turns
beside the two kernels it varies: the step kernel and the
transposed-carry rollout step_t_kernel (``nbody_rollout_cuda``), whose
planes it shares. The order is step, step_t, packed, packed, step_t,
step. It prints ms per step, G interactions/s and GFLOP/s at 20 flops an
interaction. It also prints what ptxas says of every kernel of
csrc/nbody_kernels.cu, and the card's name and power limit.

Every kernel runs at block 256. --cpu rehearses the same flow on the host
with the plain versions, at N = 257 in rolls of 2 steps, one round each.
Its times are host times of PyTorch's CPU operations, not times of the
card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N, ITERS, ROUNDS, BLOCK = 65536, 25, 3, 256
# --cpu: a rehearsal the host runs in moments, at an odd N; two steps a
# roll, so the rollout's ping-pong turns once
CPU_N, CPU_ITERS, CPU_ROUNDS = 257, 2, 1


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the host with the plain versions (no device times)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.utils.timing import best_of_ms, card_line

    args = parse(argv)
    if args.cpu:
        device = torch.device("cpu")
        print("cpu rehearsal: the plain versions on the host; times are not device times")
    else:
        if not torch.cuda.is_available():
            print("needs an NVIDIA GPU (or --cpu for a rehearsal)", file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        print(f"card: {card_line()}")
        for line in _build.ptxas_lines("nbody_kernels.cu"):
            print(line)
    p = DEMO_PARAMS[0]
    dt, soft, damp = p.time_step, p.softening, p.damping
    n, iters, rounds = (CPU_N, CPU_ITERS, CPU_ROUNDS) if args.cpu else (N, ITERS, ROUNDS)
    bs = BLOCK
    pos, vel = ic.generate(NBodyConfig.SHELL, n, p.cluster_scale, p.velocity_scale, seed=42)
    p0, v0 = torch.tensor(pos, device=device), torch.tensor(vel, device=device)
    state0 = torch.cat([p0, v0], dim=1)
    planes0 = p0.t().contiguous()

    rp, rv = ck.nbody_step_cuda(p0, v0, dt, soft, damp, block_size=bs)
    ns, npl = ck.nbody_step_packed_cuda(state0, planes0, dt, soft, damp, block_size=bs)
    if not bool(torch.isfinite(ns).all()):
        raise RuntimeError("non-finite packed step")
    err = max((ns[:, :4] - rp).abs().max().item(), (ns[:, 4:] - rv).abs().max().item())
    same = bool(torch.equal(ns[:, :4], rp) and torch.equal(ns[:, 4:], rv))
    planes_kept = bool(torch.equal(npl, ns[:, :4].t()))
    print(f"packed correctness err = {err:.2e}, bit-equal to the step kernel: {same}, "
          f"planes equal the new positions: {planes_kept}", flush=True)

    bufs = [(torch.empty_like(p0), torch.empty_like(v0)) for _ in range(2)]

    def steps():
        a, b = p0, v0
        for k in range(iters):
            a, b = ck.nbody_step_cuda(a, b, dt, soft, damp, block_size=bs, out=bufs[k % 2])

    rolls = {"step": steps,
             "step_t": lambda: ck.nbody_rollout_cuda(p0, v0, dt, soft, damp, steps=iters,
                                                     block_size=bs),
             "packed": lambda: ck.nbody_rollout_packed_cuda(state0, dt, soft, damp,
                                                            steps=iters, block_size=bs)}
    ms = {k: [] for k in rolls}
    for name in ("step", "step_t", "packed", "packed", "step_t", "step"):
        ms[name].append(best_of_ms(rolls[name], device, rounds=rounds) / iters)
    for name in ("packed", "step_t", "step"):
        t = min(ms[name])
        g = n * n / t * 1e3 / 1e9
        print(f"{name} scan, block {bs}: {t:.4f} ms per step  {g:.1f} G int/s "
              f"({g * 20:.0f} GFLOP/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
