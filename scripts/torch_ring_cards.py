#!/usr/bin/env python3
"""The fused ring (strategy="ring_fused") on the D cards of one host, beside
the unfused ring (strategy="ring").

Run from the repository root, one process a card:

    torchrun --standalone --nproc_per_node D scripts/torch_ring_cards.py \\
        [--cpu] [--numbodies N ...] [--qa-bodies N]

Every rank joins a mesh of the D ranks (NCCL on the cards, gloo with
--cpu). For each N (default 65536 and 262144, shell ICs, demo-0 params):
the two strategies' systems step the same state 10 Euler steps, and then
10 leapfrog steps, and must agree bit for bit; Compute.run_benchmark(10)
times ring, ring_fused, ring_fused, ring in turns (ms a step). Then the QA
of ring_fused (Compute.compare_results, Euler and leapfrog) at --qa-bodies
(default 16384). Every rank must have launched the ring kernel (on the
cards). Rank 0 prints each result and, on the cards, the nvidia-smi name
and power limit of its card; every rank exits 1 when a check failed.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--numbodies", type=int, nargs="+", default=[65536, 262144])
    p.add_argument("--qa-bodies", type=int, default=16384)
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import initialize_multihost, make_mesh

    device = "cpu" if args.cpu else "cuda"
    d = initialize_multihost(device=device)
    mesh = make_mesh(d, device=device if args.cpu else None)
    rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    smi = "cpu"
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", f"--id={mesh.device.index}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    say(f"mesh of {d} ranks on {mesh.device.type} over {dist.get_backend()} [{smi}]")
    ok = True
    for n in args.numbodies:
        for integrator in ("euler", "leapfrog"):
            states = {}
            for strategy in ("ring", "ring_fused"):
                s = BodySystem(n, DEMO_PARAMS[0], device=mesh.device, mesh=mesh,
                               strategy=strategy, integrator=integrator)
                s.update_many(10)
                states[strategy] = s.state
            bits = all(torch.equal(a, b) for a, b in zip(states["ring"], states["ring_fused"]))
            ok = ok and bits
            say(f"N={n} {integrator}: 10 ring_fused steps bit-equal to 10 ring steps: {bits}")
        ms = {"ring": [], "ring_fused": []}
        for strategy in ("ring", "ring_fused", "ring_fused", "ring"):
            c = Compute(num_bodies=n, device=mesh.device, mesh=mesh, strategy=strategy,
                        log=lambda s: None)
            res = c.run_benchmark(10)
            ms[strategy].append(res["milliseconds"] / res["iterations"])
        say(f"N={n} ({n // d} a rank): ms a step, in turns: "
            + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}" for k, v in ms.items())
            + f" [{smi}]")
    for integrator in ("euler", "leapfrog"):
        c = Compute(num_bodies=args.qa_bodies, device=mesh.device, mesh=mesh,
                    strategy="ring_fused", integrator=integrator, log=say)
        passed = c.compare_results()
        ok = ok and passed
    launched = ck.LAUNCHES["ring_fused"] > 0 or args.cpu
    ok = ok and launched
    flags = [None] * d
    dist.all_gather_object(flags, (ok, ck.LAUNCHES["ring_fused"]))
    say(f"ring kernel launches by rank: {[k for _, k in flags]}")
    say(f"all ranks passed: {all(f for f, _ in flags)}")
    dist.destroy_process_group()
    return 0 if all(f for f, _ in flags) else 1


if __name__ == "__main__":
    sys.exit(main())
