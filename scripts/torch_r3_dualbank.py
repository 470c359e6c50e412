#!/usr/bin/env python3
"""The dual-bank step on the card: the port of scripts/tpu_r3_dualbank.py.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 scripts/torch_r3_dualbank.py [--cpu]

The TPU script gave each 128-row i-tile two independent 64-row banks.
Its Hopper counterpart, csrc/nbody_kernels.cu::step_dual_kernel
(``cuda_kernel.nbody_step_dual_cuda``), gives each thread two i-bodies with
two independent accumulator chains. Each staged j-body is read once from
shared memory for both. As the TPU script does, this script takes shell
ICs, demo 0 and N = 65536. It holds one dual step against the production
step (the step kernel at the same block size), by its largest
|difference| and by its bits. Then it times a roll of 25 steps, best of 3,
and prints ms per step, G interactions/s and GFLOP/s at 20 flops an
interaction. Where the TPU script swept (tile_i, tile_j), this one sweeps
the block size: a block of b threads covers 2b rows, so N = 65536 gives
65536 / (2b) blocks, against 132 SMs on an H100. The production step
kernel is timed beside it at each block, in turns (step, dual, dual,
step). The script also prints what ptxas says of every kernel of
csrc/nbody_kernels.cu, and the card's name and power limit.

--cpu rehearses the same flow on the host with the plain versions, at
N = 257 in rolls of 2 steps, one round each. Its times are host times of
PyTorch's CPU operations, not times of the card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N, ITERS, ROUNDS, BLOCKS = 65536, 25, 3, (64, 128, 256)
# --cpu: a rehearsal the host runs in moments, at an odd N
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
    pos, vel = ic.generate(NBodyConfig.SHELL, n, p.cluster_scale, p.velocity_scale, seed=42)
    p0, v0 = torch.tensor(pos, device=device), torch.tensor(vel, device=device)
    bufs = [(torch.empty_like(p0), torch.empty_like(v0)) for _ in range(2)]

    for bs in BLOCKS:
        rp, rv = ck.nbody_step_cuda(p0, v0, dt, soft, damp, block_size=bs)
        gp, gv = ck.nbody_step_dual_cuda(p0, v0, dt, soft, damp, block_size=bs)
        if not bool(torch.isfinite(gp).all() and torch.isfinite(gv).all()):
            raise RuntimeError(f"non-finite dual step at block {bs}")
        err = max((gp - rp).abs().max().item(), (gv - rv).abs().max().item())
        same = bool(torch.equal(gp, rp) and torch.equal(gv, rv))

        def roll(step, bs=bs):
            def run():
                a, b = p0, v0
                for k in range(iters):
                    a, b = step(a, b, dt, soft, damp, block_size=bs, out=bufs[k % 2])
            return run

        rolls = {"step": roll(ck.nbody_step_cuda), "dual": roll(ck.nbody_step_dual_cuda)}
        ms = {"step": [], "dual": []}
        for name in ("step", "dual", "dual", "step"):
            ms[name].append(best_of_ms(rolls[name], device, rounds=rounds) / iters)
        for name in ("dual", "step"):
            t = min(ms[name])
            g = n * n / t * 1e3 / 1e9
            extra = (f"  err={err:.1e}, bit-equal to the step kernel: {same}"
                     if name == "dual" else "")
            print(f"{name} block={bs} ({-(-n // (2 * bs if name == 'dual' else bs))} blocks): "
                  f"{t:.4f} ms per step  {g:.1f} G int/s ({g * 20:.0f} GFLOP/s){extra}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
