"""One rank's run of a cell: set-up, warm-up, the measured window, the
records the metrics read, and the check.

The window repeats segments: ``update_many(K)``, a synchronise, then
``positions`` (one snapshot of the state on the host), K the traffic's
``steps_per_segment``, until ``--seconds`` have passed. In a cell with
``replay_steps`` the state goes back to the seed's initial state every
``replay_steps`` steps (the P3M capacity sized anew from it, as a new
system sizes it): a P3M step costs what its state's clustering costs, so
without this a faster program would reach later, dearer states. On a mesh
every rank steps, rank 0's clock ends the window, and every rank follows.
"""

from __future__ import annotations

import gc
import math
import time

from benchmark.harness import check, inputs, spec, trace


class Rank:
    """This process's rank of the run (rank 0 of 1 on one card)."""

    def __init__(self, rank: int, world: int, device: str, port: int):
        import torch

        self.rank, self.world = rank, world
        self.mesh = None
        if device == "cuda":
            self.device = torch.device("cuda", rank)
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        if world > 1:
            import torch.distributed as dist

            from nbody_tpu_torch.parallel import make_mesh

            dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                    init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=world, rank=rank)
            self.mesh = make_mesh(world, device=self.device)

    def agree(self, flag: bool) -> bool:
        """rank 0's `flag` on every rank."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist

        t = torch.tensor([1 if flag else 0], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def close(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def build(cell: dict, seed: int, rank: Rank, *, n=None):
    """(Compute, (pos0, vel0)) of the cell on this rank: the seed's
    initial state, and the system built on it as the configuration says."""
    from nbody_tpu_torch.compute import Compute

    cfg, wl = cell["config"], cell["workload"]
    par = cfg["params"]
    n = wl["n"] if n is None else n
    ic = inputs.shell(n, par["cluster_scale"], par["velocity_scale"], seed)
    solver = cfg["solver"]
    compute = Compute(
        device=rank.device, precision=cfg["precision"], variant=cfg["variant"],
        integrator=wl["integrator"], kernel="auto" if solver == "allpairs" else solver,
        pm_grid=cfg.get("pm_grid", 64), pm_assignment=cfg.get("pm_assignment", "cic"),
        p3m_short_range=cfg.get("p3m_short_range", "auto"),
        p3m_auto_refresh=cfg.get("p3m_auto_refresh", False), cycle_demo=False,
        tipsy_state=ic, mesh=rank.mesh, strategy=wl.get("strategy", "auto"),
        log=lambda *a, **k: None)
    compute.update_params(time_step=par["time_step"], softening=par["softening"],
                          damping=par["damping"])
    return compute, ic


def restart(system, ic) -> None:
    """The seed's initial state again, the P3M capacity sized from it."""
    if getattr(system, "kernel", "auto") == "p3m":
        system.p3m_capacity = None
    system.set_state(*ic)


def window(system, ic, cell: dict, seconds: float, rank: Rank, samples: list, *,
           traced: bool = False, max_segments=None) -> tuple:
    """Drive the measured window for `seconds` (or `max_segments`
    segments); returns its records, and for `samples` the start states and
    the snapshots that the check compares."""
    from torch.profiler import record_function

    wl = cell["workload"]
    k = int(wl["steps_per_segment"])
    replay = wl.get("replay_steps")
    dt = cell["config"]["params"]["time_step"]
    want = set(samples)
    kept, snaps = {}, {}
    seg_s, read_s, host_s = [], [], 0.0
    steps = since = seg = 0
    replays = 1 if replay else 0
    refreshes0 = len(getattr(system, "p3m_refreshes", []))
    prof = trace.profiler() if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        with record_function(trace.SPAN_PREFIX + "window"):
            tw = time.perf_counter()
            while True:
                if replay and since >= replay:
                    with record_function(trace.SPAN_PREFIX + "replay"):
                        restart(system, ic)
                    since = 0
                    replays += 1
                if seg in want:
                    with record_function(trace.SPAN_PREFIX + "clone"):
                        kept[seg] = tuple(t.clone() for t in system.state)
                t0 = time.perf_counter()
                with record_function(trace.SPAN_PREFIX + "update_many"):
                    system.update_many(k, dt)
                t1 = time.perf_counter()
                with record_function(trace.SPAN_PREFIX + "synchronize"):
                    system.synchronize()
                t2 = time.perf_counter()
                with record_function(trace.SPAN_PREFIX + "positions"):
                    snap = system.positions
                t3 = time.perf_counter()
                host_s += t1 - t0
                seg_s.append(t3 - t0)
                read_s.append(t3 - t2)
                if seg in want:
                    snaps[seg] = snap
                steps += k
                since += k
                seg += 1
                if rank.agree(t3 - tw >= seconds or seg == max_segments):
                    break
            window_s = time.perf_counter() - tw
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    rec = {"window_s": window_s, "steps": steps, "segments": seg, "segment_s": seg_s,
           "read_s": read_s, "host_s": host_s, "replays": replays,
           "p3m_refreshes": (len(system.p3m_refreshes) - refreshes0
                             if getattr(system, "kernel", "auto") == "p3m" else None)}
    if prof is not None:
        rec["trace"] = trace.reduce(prof)
    return rec, kept, snaps


def run(cell: dict, seed: int, seconds: float, traced: bool, rank: Rank, t_start: float, *,
        n=None) -> dict:
    """The whole run on this rank; rank 0 returns the result's fields."""
    import torch

    compute, ic = build(cell, seed, rank, n=n)
    system = compute.system
    wl, cfg = cell["workload"], cell["config"]
    k = int(wl["steps_per_segment"])
    dt = cfg["params"]["time_step"]
    # set-up: the first step (the kernels' library loads, or builds, here),
    # then one segment as the window runs it, then the initial state again
    t = time.perf_counter()
    system.update_many(1, dt)
    system.synchronize()
    first_step_s = time.perf_counter() - t
    system.update_many(k, dt)
    system.synchronize()
    _ = system.positions
    if wl.get("replay_steps"):
        restart(system, ic)
    else:
        system.set_state(*ic)
    system.synchronize()
    setup_s = time.perf_counter() - t_start
    samples = check.sample_segments(seed, wl["check"])
    rec, kept, snaps = window(system, ic, cell, seconds, rank, samples, traced=traced)
    rec.update(cell=cell["name"], workload=wl, config=cfg, setup_s=setup_s,
               first_step_s=first_step_s)
    peak = (torch.cuda.max_memory_allocated(rank.device) if rank.device.type == "cuda" else 0)
    gathered = rank.gather({"peak": peak, "trace": rec.get("trace")})
    rec["memory_peak_bytes"] = max(g["peak"] for g in gathered)
    if traced:
        traces = [g["trace"] for g in gathered]
        rec["trace"] = dict(traces[0])
        for key in ("busy_s", "window_s", "nccl_s"):
            rec["trace"][key] = sum(tr[key] for tr in traces) / len(traces)
        rec["bound_s_per_step"] = spec.load_module("rooflines", cell["config"]["name"]) \
            .bound_s_per_step(wl if n is None else dict(wl, n=n), cfg,
                              torch.as_tensor(ic[0], device=rank.device))
    # the program's state is freed before the reference runs
    del system, compute
    gc.collect()
    if rank.device.type == "cuda":
        torch.cuda.empty_cache()
    rows = group = None
    if rank.world > 1:
        nloc = -(-len(ic[0]) // rank.world)
        rows = slice(rank.rank * nloc, min(len(ic[0]), (rank.rank + 1) * nloc))
        group = rank.mesh.group
    verdict = check.judge(kept, snaps, ic, steps=k, config=cfg,
                          integrator=wl["integrator"], limits=wl["check"]["limits"],
                          rows=rows, group=group)
    rec["check"] = verdict
    return rec


def metrics(cell: dict, rec: dict, traced: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's metrics that read something:
    the end-to-end ones untraced, the per-layer ones traced."""
    out = {}
    for m in (cell["per_layer"] if traced else cell["end_to_end"]):
        value = spec.load_module("metrics", m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(rec: dict) -> dict:
    tr = rec["trace"]
    return {"device_ops": trace.top_ops(tr["ops"]), "idle_gaps": tr["gaps"]}

