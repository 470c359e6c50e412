#!/usr/bin/env python3
"""The mesh strategies on the D cards of one host: the fused ring
(strategy="ring_fused") beside the unfused ring, each pair once across the
mesh (strategy="sym") beside emulated_sym, and the step times of allgather,
ring, ring_fused, sym and the 2-D grid.

Run from the repository root, one process a card:

    torchrun --standalone --nproc_per_node D scripts/torch_ring_cards.py \\
        [--cpu] [--parts ring p3m demo adaptive] [--numbodies N ...]
        [--qa-bodies N] [--rounds R] [--p3m-bodies N] [--demo-bodies N]
        [--adaptive-bodies N] [--adaptive-ds-bodies N]

--parts picks what runs ("ring", "p3m" and "demo" by default): "ring" the
strategies below; "p3m" the sharded P3M step; "demo" the demo loop on the
mesh; "adaptive" the sharded adaptive rollouts.

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

p3m (--p3m-bodies, default 2^20, shell ICs, demo-0 params, G=64): rank 0
runs README's one-card P3M Euler run with the auto-refresh (the other ranks
wait) and gives every rank the capacity it grew to; then at that capacity
Compute.run_benchmark(3) times one card (rank 0) and the D-rank mesh, with
--pm-fft replicated and slab, in turns (one card, replicated, slab, the
reverse), and rank 0 prints the medians in ms a step, every rank's, and the
largest |dpos| of the mesh's state against one card's after the same steps.
Then every rank times its share of one force evaluation by CUDA events: the
tables of the whole state, which every rank builds, and its range of the
pair kernel (p3m.item_range); the whole launch's time on one card beside.

adaptive (--adaptive-bodies, default 2^20, shell ICs, demo-0 params): the
sym mesh's adaptive Euler step (update_many_adaptive, one scalar all_reduce
a step for the global dt) against its fixed-dt step, 5 steps each, in turns
(fixed, adaptive, adaptive, fixed, --rounds times), rank 0 printing the
medians in ms a step; then, where D is a square, the ds adaptive and
fixed-dt Euler steps on the sqrt(D) x sqrt(D) grid at --adaptive-ds-bodies
(default 65536), 3 steps each, alike. Every rank's stats must be rank 0's.

demo (--demo-bodies, default 65536): the CLI's demo loop in every rank's
process, nbody-torch --devices D --strategy ring_fused and then sym with
--render for 30 frames (the first frame included); every rank must return
0, which it does not when a wait of the fused ring times out (RuntimeError,
exit 3). Rank 0 prints the frames written and the seconds of each run.
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


def p3m_cards(torch, dist, mesh, say, smi, n: int, rounds: int) -> bool:
    """The p3m part (see the docstring); True when its checks held."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.ops import p3m

    box = [None]
    if mesh.rank == 0:
        c = Compute(num_bodies=n, device=mesh.device, kernel="p3m", p3m_auto_refresh=True,
                    log=lambda s: None)
        c.run_benchmark(3)
        box = [(c.system.p3m_capacity, c.system.p3m_refreshes)]
        del c
    dist.broadcast_object_list(box, src=0, group=mesh.group, device=mesh.device)
    cap, refreshes = box[0]
    say(f"p3m N={n}: one card's auto-refreshed run grew to capacity {cap} (rewinds "
        f"{refreshes}); every run below at that capacity")
    ms = {"one card": [], "replicated": [], "slab": []}
    states = {}
    order = ["one card", "replicated", "slab"]
    for _ in range(rounds):
        for what in order + order[::-1]:
            if what == "one card":
                got = [None]
                if mesh.rank == 0:
                    c = Compute(num_bodies=n, device=mesh.device, kernel="p3m",
                                p3m_capacity=cap, log=lambda s: None)
                    res = c.run_benchmark(3)
                    got = [res["milliseconds"] / res["iterations"]]
                    states[what] = c.system.positions
                    del c
                dist.broadcast_object_list(got, src=0, group=mesh.group, device=mesh.device)
                ms[what].append(got[0])
                continue
            c = Compute(num_bodies=n, device=mesh.device, mesh=mesh, kernel="p3m",
                        p3m_capacity=cap, pm_fft=what, log=lambda s: None)
            res = c.run_benchmark(3)
            every = [None] * mesh.size
            dist.all_gather_object(every, res["milliseconds"] / res["iterations"])
            ms[what].append(max(every))
            states[what] = c.system.positions
            del c
    say(f"p3m N={n} ({n // mesh.size} a rank), capacity {cap}, ms a step (the slowest rank), "
        f"medians of {2 * rounds} in turns: "
        + "; ".join(f"{k} {statistics.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"
                    for k, v in ms.items()) + f" [{smi}]")
    ok = True
    if mesh.rank == 0:
        for what in ("replicated", "slab"):
            d = float(abs(states[what] - states["one card"])[:, :3].max())
            scale = float(abs(states["one card"])[:, :3].max())
            say(f"p3m N={n}: the {mesh.size}-rank {what} state after 4 steps against one card's: "
                f"max|dpos| {d:.3e} (max|pos| {scale:.3e})")
            ok = ok and d <= 1e-4 * scale
    # one force evaluation's shares on every rank: the tables of the whole
    # state, then this rank's range of the pair kernel
    pos = torch.tensor(states.get("one card", states["replicated"]), device=mesh.device)
    dist.broadcast(pos, src=0, group=mesh.group)
    soft, blk = DEMO_PARAMS[0].softening, p3m.p3m_kernel_blk(cap)
    times = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        tables = p3m.pair_tables(pos, soft, grid=64, capacity=cap, blk=blk)
        ev[1].record()
        ck.p3m_sr_range_cuda(tables, p3m.item_range(tables, mesh.rank, mesh.size))
        ev[2].record()
        ck.p3m_sr_pairs_cuda(tables)
        ev[3].record()
        torch.cuda.synchronize(mesh.device)
        times.append([ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    mine = [statistics.median(t[k] for t in times) for k in range(3)]
    every = [None] * mesh.size
    dist.all_gather_object(every, mine)
    say(f"p3m N={n}: by rank, medians of 3 (ms): tables "
        + ", ".join(f"{t[0]:.3f}" for t in every) + "; its range of the pair kernel "
        + ", ".join(f"{t[1]:.3f}" for t in every) + f"; the whole launch on one card "
        f"{every[0][2]:.3f} [{smi}]")
    return ok


def adaptive_cards(torch, dist, mesh, grid, say, smi, n: int, n_ds: int, rounds: int) -> bool:
    """The adaptive part (module docstring): True when every rank's stats
    equal rank 0's."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem, DSBodySystem

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def ms_a_step(fn, steps):
        sync()
        t0 = time.perf_counter()
        fn(steps)
        sync()
        return (time.perf_counter() - t0) * 1e3 / steps

    ok = True
    runs = [("sym", n, 5, lambda: BodySystem(n, DEMO_PARAMS[0], device=mesh.device, mesh=mesh,
                                             strategy="sym"))]
    if grid is not None:
        runs.append(("ds 2-D grid", n_ds, 3, lambda: DSBodySystem(
            n_ds, DEMO_PARAMS[0], device=grid.device, mesh=grid)))
    for name, size, steps, make in runs:
        s = make()
        s.update_many(1)
        s.update_many_adaptive(1)
        ms = {"fixed": [], "adaptive": []}
        stats = None
        for _ in range(rounds):
            for kind in ("fixed", "adaptive", "adaptive", "fixed"):
                if kind == "fixed":
                    ms[kind].append(ms_a_step(s.update_many, steps))
                    continue
                box = {}
                ms[kind].append(ms_a_step(
                    lambda k: box.update(s.update_many_adaptive(k)), steps))
                stats = box
        seen = [None] * mesh.size
        dist.all_gather_object(seen, stats)
        same = all(x == seen[0] for x in seen)
        ok = ok and same
        say(f"N={size} {name} ({s.strategy}), ms a step, medians of {2 * rounds} in turns: fixed "
            f"{statistics.median(ms['fixed']):.3f} ({min(ms['fixed']):.3f}-"
            f"{max(ms['fixed']):.3f}), adaptive {statistics.median(ms['adaptive']):.3f} "
            f"({min(ms['adaptive']):.3f}-{max(ms['adaptive']):.3f}); last stats {stats}; every "
            f"rank's stats rank 0's: {same} [{smi}]")
        del s
    return ok


def demo_cards(dist, mesh, say, n: int, extra: list) -> bool:
    """The demo part (see the docstring); True when every rank returned 0."""
    import tempfile

    from nbody_tpu_torch import cli

    ok = True
    for strategy in ("ring_fused", "sym"):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            rc = cli.main(["--devices", str(mesh.size), "--strategy", strategy, "--numbodies",
                           str(n), "--frames", "30", "--render", "--outdir", d, "--no-cycle",
                           *extra])
            secs = time.perf_counter() - t0
            written = len(list(pathlib.Path(d).glob("frame_*.png")))
        rcs = [None] * mesh.size
        dist.all_gather_object(rcs, rc)
        ok = ok and all(r == 0 for r in rcs) and (mesh.rank != 0 or written == 30)
        say(f"demo {strategy} N={n} --render on {mesh.size} ranks: every rank's exit code "
            f"{rcs}, {written} frames written, {secs:.3f} s (the first frame included)")
    return ok


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--parts", nargs="+", choices=["ring", "p3m", "demo", "adaptive"],
                   default=["ring", "p3m", "demo"])
    p.add_argument("--adaptive-bodies", type=int, default=1 << 20)
    p.add_argument("--adaptive-ds-bodies", type=int, default=65536)
    p.add_argument("--p3m-bodies", type=int, default=1 << 20)
    p.add_argument("--demo-bodies", type=int, default=65536)
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

    if "p3m" in args.parts and not args.cpu:
        ok = p3m_cards(torch, dist, mesh, say, smi, args.p3m_bodies, args.rounds) and ok
    if "adaptive" in args.parts:
        ok = adaptive_cards(torch, dist, mesh, grid, say, smi, args.adaptive_bodies,
                            args.adaptive_ds_bodies, args.rounds) and ok
    if "demo" in args.parts:
        ok = demo_cards(dist, mesh, say, args.demo_bodies,
                        ["--cpu", "--width", "160", "--height", "120"] if args.cpu else []) and ok
    for n in args.numbodies if "ring" in args.parts else ():
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
    qa = ([("ring_fused", "euler"), ("ring_fused", "leapfrog"), ("sym", "euler"),
           ("sym", "hermite")] + ([("2d", "euler")] if grid else [])
          if "ring" in args.parts else [])
    for strategy, integrator in qa:
        on_mesh, strat = on(strategy)
        c = Compute(num_bodies=args.qa_bodies, device=mesh.device, mesh=on_mesh, strategy=strat,
                    integrator=integrator, log=say)
        passed = c.compare_results()
        ok = ok and passed
    counts = {k: ck.LAUNCHES[k] for k in ("ring_fused", "sym", "sym_cross", "aj_sym")}
    # one rank's sym is its triangle alone: no rectangle below the cap
    launched = args.cpu or "ring" not in args.parts or all(
        v for k, v in counts.items() if d > 1 or k != "sym_cross")
    ok = ok and launched
    flags = [None] * d
    dist.all_gather_object(flags, (ok, counts))
    say(f"launches by rank: {[k for _, k in flags]}")
    say(f"all ranks passed: {all(f for f, _ in flags)}")
    dist.destroy_process_group()
    return 0 if all(f for f, _ in flags) else 1


if __name__ == "__main__":
    sys.exit(main())
