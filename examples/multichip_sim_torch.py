"""Body-sharded simulation over a mesh of ranks, on the PyTorch / CUDA port.

The port's counterpart of ``examples/multichip_sim.py``: one rank a card
(NCCL), started by torchrun, and on the mesh

  * 10 steps of the allgather strategy (``make_sharded_step``,
    ``make_sharded_rollout``), N = 1024 a rank;
  * one step of the 2-D (2 x D/2) force decomposition
    (``make_sharded_step_2d``) when D is even;
  * one step of sharded P3M with the distributed (slab) FFT long range
    (``ops.p3m.make_sharded_p3m_step``, the capacity auto-sized as
    ``BodySystem`` sizes it).

    torchrun --standalone --nproc_per_node D examples/multichip_sim_torch.py
    torchrun --standalone --nproc_per_node D examples/multichip_sim_torch.py --cpu

``--cpu`` runs gloo ranks on the host with the plain versions. Without
torchrun the script is one rank. Rank 0 prints; every rank destroys its
process group before it exits.
"""

import argparse
import os

import torch
import torch.distributed as dist

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.ops.p3m import make_sharded_p3m_step, p3m_max_occupancy
from nbody_tpu_torch.parallel import (
    all_gather_rows,
    initialize_multihost,
    make_mesh,
    make_mesh_2d,
    make_sharded_rollout,
    make_sharded_step,
    make_sharded_step_2d,
    shard_state,
)

DT, SOFT, DAMP = 0.016, 0.1, 1.0


def run(mesh, device, say) -> bool:
    ndev = mesh.size
    n = 1024 * ndev
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=42)
    ok = True

    def finite(shard, m=mesh):
        return bool(torch.isfinite(all_gather_rows(m, shard)).all())

    step = make_sharded_step(mesh, strategy="allgather")
    ps, vs = make_sharded_rollout(step, steps=10)(*shard_state(mesh, pos, vel), DT, SOFT, DAMP)
    good = finite(ps)
    ok &= good
    say(f"{n} bodies over {ndev} {device.type} ranks x 10 steps: finite={good}")

    if ndev % 2 == 0:
        mesh2d = make_mesh_2d(2, ndev // 2, device=device)
        step2d = make_sharded_step_2d(mesh2d)
        p2, _ = step2d(*shard_state(mesh2d, pos, vel), DT, SOFT, DAMP)
        good = bool(torch.isfinite(p2).all())
        ok &= good
        say(f"2-D decomposition (2x{ndev // 2}): finite={good}")

    occ = int(p3m_max_occupancy(torch.tensor(pos, device=device), grid=32))
    cap = max(8, -(-int(occ * 1.5 + 1) // 8) * 8)  # auto-sized as BodySystem sizes it
    p3m = make_sharded_p3m_step(mesh, grid=32, capacity=cap, fft="slab")
    p3, _ = p3m(*shard_state(mesh, pos, vel), DT, SOFT, DAMP)
    good = finite(p3)
    ok &= good
    say(f"sharded P3M + slab FFT (capacity {cap}): finite={good}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the host")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if "WORLD_SIZE" in os.environ:
        initialize_multihost(device=device.type)
    try:
        mesh = make_mesh(device="cpu" if args.cpu else None)
        device = mesh.device
        ok = run(mesh, device, print if mesh.rank == 0 else (lambda *a: None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
