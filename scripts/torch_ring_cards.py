#!/usr/bin/env python3
"""The mesh strategies on the D cards of one host: the fused ring
(strategy="ring_fused") beside the unfused ring, each pair once across the
mesh (strategy="sym") beside emulated_sym, and the step times of allgather,
ring, ring_fused, sym and the 2-D grid.

Run from the repository root, one process a card:

    torchrun --standalone --nproc_per_node D scripts/torch_ring_cards.py \\
        [--cpu] [--numbodies N ...] [--qa-bodies N] [--rounds R]

Every rank joins a mesh of the D ranks (NCCL on the cards, gloo with
--cpu). For each N (default 65536 and 2^20, shell ICs, demo-0 params):
the ring and ring_fused systems step the same state 10 Euler steps, and
then 10 leapfrog steps, and must agree bit for bit; each rank's sym force
of the state must equal emulated_sym's rows of its shard bit for bit (all
D ranks' work in one process, summed in the reduce-scatter's order); then
Compute.run_benchmark(10) times allgather, ring, ring_fused, sym and, where
D is a square, the sqrt(D) x sqrt(D) grid (make_mesh_2d), in turns (the
order, then the reverse, --rounds times), and rank 0 prints each one's
medians in ms a step. At the first N, torch.profiler records 10 steps of
sym, allgather and the grid on every rank, and rank 0 prints its window's
host wall time, the device time of each kernel (NCCL's included) and the
idle share, 1 - (sum of kernel times) / wall. Then QA
(Compute.compare_results) at --qa-bodies
(default 16384): ring_fused Euler and leapfrog, sym Euler and Hermite, the
grid's Euler. Every rank must have launched the ring kernel and the sym
triangle and rectangle kernels (on the cards; one rank has no rectangle). Rank 0 prints each result
and, on the cards, the nvidia-smi name and power limit of its card; every
rank exits 1 when a check failed.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def profile_steps(torch, system, steps: int = 10) -> tuple:
    """torch.profiler over `steps` steps of `system` after one warm-up
    window: (host wall ms of the window, {kernel: (device ms, calls)})."""
    from torch.profiler import ProfilerActivity, profile, schedule

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            system.update_many(steps)
            system.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            prof.step()
    kernels = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("ProfilerStep")):
            us = getattr(evt, "device_time_total", None)
            kernels[evt.key] = ((evt.cuda_time_total if us is None else us) / 1e3, evt.count)
    return walls[-1], kernels


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--numbodies", type=int, nargs="+", default=[65536, 1 << 20])
    p.add_argument("--qa-bodies", type=int, default=16384)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()

    import torch
    import torch.distributed as dist

    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.models import BodySystem
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import (
        emulated_sym,
        initialize_multihost,
        make_mesh,
        make_mesh_2d,
        shard_rows,
    )

    device = "cpu" if args.cpu else "cuda"
    d = initialize_multihost(device=device)
    mesh = make_mesh(d, device=device if args.cpu else None)
    side = math.isqrt(d)
    grid = make_mesh_2d(side, side, device=device if args.cpu else None) \
        if side * side == d and d > 1 else None
    rank0 = mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    smi = "cpu"
    if not args.cpu:
        smi = subprocess.run(["nvidia-smi", f"--id={mesh.device.index}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    say(f"mesh of {d} ranks on {mesh.device.type} over {dist.get_backend()} [{smi}]")
    ok = True
    strategies = ["allgather", "ring", "ring_fused", "sym"] + (["2d"] if grid else [])

    def on(strategy):
        return (grid, "auto") if strategy == "2d" else (mesh, strategy)

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
        s = BodySystem(n, DEMO_PARAMS[0], device=mesh.device, mesh=mesh, strategy="sym")
        rows = shard_rows(mesh, n)
        force = s.accelerations()[rows]  # this rank's rows, as the mesh computed them
        want = emulated_sym(s.state[0], d, s.params.softening)[rows]
        bits = [None] * d
        dist.all_gather_object(bits, bool(torch.equal(force, want)))
        ok = ok and all(bits)
        say(f"N={n}: each rank's sym force bit-equal to emulated_sym's shard: {bits}")
        del s, force, want
        ms = {k: [] for k in strategies}
        for _ in range(args.rounds):
            for strategy in strategies + strategies[::-1]:
                on_mesh, strat = on(strategy)
                c = Compute(num_bodies=n, device=mesh.device, mesh=on_mesh, strategy=strat,
                            log=lambda s: None)
                res = c.run_benchmark(10)
                ms[strategy].append(res["milliseconds"] / res["iterations"])
                del c
        say(f"N={n} ({n // d} a rank): ms a step, medians of {2 * args.rounds} in turns: "
            + "; ".join(f"{k} {statistics.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                        for k, v in ms.items()) + f" [{smi}]")
        if n != args.numbodies[0]:
            continue
        for strategy in ("sym", "allgather", "2d") if grid else ("sym", "allgather"):
            on_mesh, strat = on(strategy)
            s = BodySystem(n, DEMO_PARAMS[0], device=mesh.device, mesh=on_mesh, strategy=strat)
            wall, kernels = profile_steps(torch, s)
            busy = sum(t for t, _ in kernels.values())
            say(f"N={n} {strategy}, rank 0's profile of 10 steps: host wall {wall:.4f} ms, "
                f"device busy {busy:.4f} ms, idle share {1 - busy / wall:.4f} [{smi}]")
            for key, (t, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
                say(f"    {t:10.4f} ms  {count:4d} calls  {key[:90]}")
            del s
    qa = [("ring_fused", "euler"), ("ring_fused", "leapfrog"), ("sym", "euler"),
          ("sym", "hermite")] + ([("2d", "euler")] if grid else [])
    for strategy, integrator in qa:
        on_mesh, strat = on(strategy)
        c = Compute(num_bodies=args.qa_bodies, device=mesh.device, mesh=on_mesh, strategy=strat,
                    integrator=integrator, log=say)
        passed = c.compare_results()
        ok = ok and passed
    counts = {k: ck.LAUNCHES[k] for k in ("ring_fused", "sym", "sym_cross", "aj_sym")}
    # one rank's sym is its triangle alone: no rectangle below the cap
    launched = args.cpu or all(v for k, v in counts.items() if d > 1 or k != "sym_cross")
    ok = ok and launched
    flags = [None] * d
    dist.all_gather_object(flags, (ok, counts))
    say(f"launches by rank: {[k for _, k in flags]}")
    say(f"all ranks passed: {all(f for f, _ in flags)}")
    dist.destroy_process_group()
    return 0 if all(f for f, _ in flags) else 1


if __name__ == "__main__":
    sys.exit(main())
