"""D gloo ranks for tests/test_torch_sharded.py, _sharded_sym.py and
_sharded_2d.py: a pool of processes, one a rank of a torch.distributed
process group on the CPU, that run the port's sharded code on request.

It holds no tests itself: the ranks import this module, which imports
torch and nbody_tpu_torch only (no JAX, whose import would cost each rank
seconds).
Each rank starts its group from a FileStore under the test's temporary
directory (no fixed port, so parallel test workers cannot collide), runs
with one intra-op thread, and answers tasks in the order they come: every
rank runs the same task, so the collectives meet. A task is a function of
this module, by name, with picklable arguments; a rank returns its result,
or the traceback of what it raised. A failure or a timeout ends the pool.
"""

from __future__ import annotations

import datetime
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120


def _rank_main(rank: int, world: int, store_path: str, timeout_s: float, tasks,
               results) -> None:
    """Rank `rank`'s loop. The group connects with TIMEOUT_S, however long
    the other ranks take to start under a loaded host, and only then are its
    collectives bounded by `timeout_s`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if timeout_s != TIMEOUT_S:
        from torch.distributed.distributed_c10d import _set_pg_timeout

        dist.barrier()  # every rank connected, on the start-up bound
        _set_pg_timeout(datetime.timedelta(seconds=timeout_s))
    try:
        while (task := tasks.get()) is not None:
            name, args = task
            try:
                results.put((rank, True, globals()[name](*args)))
            except Exception:  # reported to the test, which fails with it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` gloo ranks, their group's collectives bounded by `timeout_s`
    once the group has connected (the connection by TIMEOUT_S);
    ``run(name, *args)`` runs task `name` on every rank and returns the
    results in rank order."""

    def __init__(self, world: int, store_path: str, timeout_s: float = TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, store_path, timeout_s, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = None

    def run(self, name: str, *args):
        if self.broken:
            raise RuntimeError(f"the rank pool ended earlier: {self.broken}")
        for q in self.tasks:
            q.put((name, args))
        got = {}
        try:
            for _ in range(self.world):
                rank, ok, value = self.results.get(timeout=TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"rank {rank} raised in {name}:\n{value}")
                got[rank] = value
        except (RuntimeError, queue.Empty) as e:
            self.broken = f"{name}: {type(e).__name__}"
            self.close()
            raise
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        if not self.broken:
            for q in self.tasks:
                q.put(None)
        for p in self.procs:
            p.join(timeout=10 if not self.broken else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ---- tasks: each runs on every rank; arrays in and out are numpy ----


def _mesh(rows=None):
    """The 1-D mesh of every rank, or with `rows` the rows x world/rows grid."""
    from nbody_tpu_torch.parallel import make_mesh, make_mesh_2d

    if rows is not None:
        return make_mesh_2d(rows, dist.get_world_size() // rows, device="cpu")
    return make_mesh(dist.get_world_size(), device="cpu")


class _caps:
    """The each-pair-once dispatch constants of ops/cuda_kernel.py set to
    `caps` (a dict of name -> value, or None) for a block, then restored."""

    def __init__(self, caps):
        self.caps = caps or {}

    def __enter__(self):
        from nbody_tpu_torch.ops import cuda_kernel as ck

        self.saved = {k: getattr(ck, k) for k in self.caps}
        for k, v in self.caps.items():
            setattr(ck, k, v)

    def __exit__(self, *exc):
        from nbody_tpu_torch.ops import cuda_kernel as ck

        for k, v in self.saved.items():
            setattr(ck, k, v)


def _shard(mesh, a):
    from nbody_tpu_torch.parallel import shard_rows

    return torch.from_numpy(np.ascontiguousarray(a[shard_rows(mesh, a.shape[0])]))


def fp32_step(strategy, integrator, variant, pos, vel, dt, soft, damp, backend="torch",
              steps=1):
    """`steps` fp32 sharded steps of the whole (pos, vel); this rank's shard
    out."""
    from nbody_tpu_torch.parallel import make_sharded_step

    mesh = _mesh()
    step = make_sharded_step(mesh, backend=backend, strategy=strategy, integrator=integrator,
                             variant=variant)
    p, v = _shard(mesh, pos), _shard(mesh, vel)
    for _ in range(steps):
        p, v = step(p, v, dt, soft, damp)
    step.close()
    return p.numpy(), v.numpy()


def fused_ring_over_hosts(m):
    """The error open_fused_ring raises on a card mesh whose ranks name
    different hosts (each rank its own here; the block count is stubbed,
    since the refusal comes before any buffer is made)."""
    import dataclasses
    from unittest import mock

    from nbody_tpu_torch.ops import cuda_kernel as ck
    from nbody_tpu_torch.parallel import sharded

    mesh = dataclasses.replace(_mesh(), device=torch.device("cuda", 0))
    with mock.patch.object(sharded.socket, "gethostname", lambda: f"host{mesh.rank}"), \
            mock.patch.object(ck, "ring_groups", lambda *args: 1):
        try:
            sharded.open_fused_ring(mesh, m, 256)
        except ValueError as e:
            return str(e)
    return None


def ds_step(strategy, integrator, planes, scal, steps=1):
    """`steps` ds sharded steps of the whole planes; this rank's shards out."""
    from nbody_tpu_torch.parallel import make_sharded_ds_step

    mesh = _mesh()
    step = make_sharded_ds_step(mesh, backend="torch", strategy=strategy,
                                integrator=integrator)
    shards = tuple(_shard(mesh, a) for a in planes)
    for _ in range(steps):
        shards = step(*shards, torch.from_numpy(scal))
    return tuple(t.numpy() for t in shards)


def ring_order(n_local):
    """The rank whose shard each hop of the ring brings, read from the
    shards themselves: rank r's shard is filled with r."""
    from nbody_tpu_torch.parallel.sharded import _ring

    mesh = _mesh()
    shard = torch.full((n_local, 4), float(mesh.rank))
    return [int(j[0, 0]) for j in _ring(mesh, shard)]


def system(kind, num_bodies, params, kw, state, steps, ds_planes=None, mesh_rows=None):
    """A DSBodySystem ("ds") or BodySystem ("fp32", or float64 with
    kw dtype) on the mesh (the grid of `mesh_rows` rows if given) from
    `state` (or the raw `ds_planes`), `steps` steps: (positions,
    velocities, accelerations, strategy, variant, ds planes or None), all of
    the whole system."""
    from nbody_tpu_torch.models import BodySystem, DSBodySystem
    from nbody_tpu_torch.ops import ds

    cls = DSBodySystem if kind == "ds" else BodySystem
    s = cls(num_bodies, params, device="cpu", mesh=_mesh(mesh_rows), state=state, **kw)
    if ds_planes is not None:
        s.set_ds_state(*ds_planes)
    s.update_many(steps)
    if kind == "ds":
        acc = ds.ds_to_f64(*s.accelerations())
        planes = s.get_ds_state()
    else:
        acc = s.accelerations().numpy()
        planes = None
    return s.positions, s.velocities, acc, s.strategy, s.variant, planes


def step_span_paths(strategy, params, state, steps):
    """The nesting of the program's spans (``test_torch_spans.span_paths``)
    in `steps` steps of a BodySystem on the mesh by `strategy` and one read
    of its positions, under a CPU profiler, after an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.models import BodySystem
    from test_torch_spans import span_paths

    s = BodySystem(state[0].shape[0], params, device="cpu", mesh=_mesh(), strategy=strategy,
                   state=state)
    s.update_many(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.update_many(steps)
        _ = s.positions
    return sorted(span_paths(prof))


def compute_checks(num_bodies, kw, drift_steps, mesh_rows=None):
    """Compute on the mesh (the grid of `mesh_rows` rows if given): the QA
    verdict and the drift check's result, each as every rank sees it."""
    from nbody_tpu_torch.compute import Compute

    c = Compute(num_bodies=num_bodies, device="cpu", mesh=_mesh(mesh_rows), log=lambda s: None,
                **kw)
    return c.compare_results(), c.drift_check(drift_steps), c.system.positions


def slow_verdict(judge_s):
    """Compute's rank-0 verdict when rank 0's judge (the stand-in for a long
    oracle run) takes `judge_s` seconds while the other ranks wait: (the
    verdict as this rank got it, the seconds this rank waited)."""
    import time

    from nbody_tpu_torch.compute import Compute

    c = Compute(num_bodies=64, device="cpu", mesh=_mesh(), log=lambda s: None)

    def judge():
        time.sleep(judge_s)
        return "rank 0's verdict"

    t0 = time.monotonic()
    verdict = c._from_rank0(judge)
    return verdict, time.monotonic() - t0


def judge_groups():
    """Whether two meshes of this process group share one judge group:
    new_group runs once a process group, not once a mesh."""
    a, b = _mesh(), _mesh()
    return a.judge_group is not None and a.judge_group is b.judge_group


def make_mesh_error(num_devices):
    """The error make_mesh raises for a mesh the world does not match."""
    from nbody_tpu_torch.parallel import make_mesh

    try:
        make_mesh(num_devices, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def multihost_view():
    """(initialize_multihost(), is_multihost()) inside a started group."""
    from nbody_tpu_torch.parallel import initialize_multihost, is_multihost

    return initialize_multihost(device="cpu"), is_multihost()


def sym_step(integrator, pos, vel, dt, soft, damp, steps=1, caps=None):
    """strategy="sym": `steps` steps of the whole (pos, vel) and this
    rank's force fields (acc, or acc and jerk for Hermite) of the initial
    state; whether those fields and a second run of the steps repeat bit
    for bit, and whether the fields equal emulated_sym's rows of this rank
    bit for bit."""
    from nbody_tpu_torch.parallel import emulated_sym, make_sharded_step, shard_rows

    mesh = _mesh()
    rows = shard_rows(mesh, pos.shape[0])
    with _caps(caps):
        step = make_sharded_step(mesh, strategy="sym", integrator=integrator)
        p, v = _shard(mesh, pos), _shard(mesh, vel)
        if integrator == "hermite":
            fields = step.accel_jerk(p, v, soft)
            whole = emulated_sym(torch.from_numpy(pos), mesh.size, soft,
                                 vel=torch.from_numpy(vel))
            emulated = tuple(f[rows] for f in whole)
            again = step.accel_jerk(p, v, soft)
        else:
            fields = (step.accel(p, soft),)
            emulated = (emulated_sym(torch.from_numpy(pos), mesh.size, soft)[rows],)
            again = (step.accel(p, soft),)
        runs = []
        for _ in range(2):
            q, w = p, v
            for _ in range(steps):
                q, w = step(q, w, dt, soft, damp)
            runs.append((q, w))
    return (runs[0][0].numpy(), runs[0][1].numpy(), tuple(f.numpy() for f in fields),
            all(torch.equal(a, b) for a, b in zip(fields, emulated)),
            all(torch.equal(a, b) for a, b in zip(fields, again))
            and all(torch.equal(a, b) for a, b in zip(runs[0], runs[1])))


def rollout(strategy, integrator, pos, vel, dt, soft, damp, steps, mesh_rows=None):
    """make_sharded_rollout(step, steps) of the whole (pos, vel) and, from
    the same state, `steps` calls of the step: this rank's shards of both."""
    from nbody_tpu_torch.parallel import (
        make_sharded_rollout,
        make_sharded_step,
        make_sharded_step_2d,
    )

    mesh = _mesh(mesh_rows)
    if mesh_rows is None:
        step = make_sharded_step(mesh, strategy=strategy, integrator=integrator,
                                 backend="auto")
    else:
        step = make_sharded_step_2d(mesh, integrator=integrator)
    p, v = _shard(mesh, pos), _shard(mesh, vel)
    rolled = make_sharded_rollout(step, steps)(p, v, dt, soft, damp)
    for _ in range(steps):
        p, v = step(p, v, dt, soft, damp)
    return tuple(t.numpy() for t in rolled), (p.numpy(), v.numpy())


def step_2d(rows, integrator, pos, vel, dt, soft, damp, steps=1):
    """make_sharded_step_2d on the rows x world/rows grid: `steps` steps of
    the whole (pos, vel), fp32 or float64 as given; this rank's chunks out,
    with whether its force equals emulated_accel_2d's rows bit for bit."""
    from nbody_tpu_torch.parallel import emulated_accel_2d, make_sharded_step_2d, shard_rows

    mesh = _mesh(rows)
    step = make_sharded_step_2d(mesh, integrator=integrator)
    p, v = _shard(mesh, pos), _shard(mesh, vel)
    acc = step.accel(p, soft)
    bits = torch.equal(acc, emulated_accel_2d(torch.from_numpy(pos), mesh.rows, mesh.cols,
                                              soft)[shard_rows(mesh, pos.shape[0])])
    for _ in range(steps):
        p, v = step(p, v, dt, soft, damp)
    return p.numpy(), v.numpy(), bits


def ds_step_2d(rows, integrator, planes, scal, steps=1):
    """make_sharded_ds_step_2d on the rows x world/rows grid: `steps` steps
    of the whole planes; this rank's chunks out."""
    from nbody_tpu_torch.parallel import make_sharded_ds_step_2d

    mesh = _mesh(rows)
    step = make_sharded_ds_step_2d(mesh, backend="torch", integrator=integrator)
    shards = tuple(_shard(mesh, a) for a in planes)
    for _ in range(steps):
        shards = step(*shards, torch.from_numpy(scal))
    return tuple(t.numpy() for t in shards)


def reduce_scatter_bits(m, k, seed, rows=None):
    """ring_reduce_scatter of random partials (each rank's from its own
    seed, magnitudes spread so that the sum order shows in the bits) against
    emulated_reduce_scatter of every rank's partials, with torch.add and
    with ds_add; on a grid along its rows and along its cols. Whether each
    equals bit for bit."""
    from nbody_tpu_torch.ops import ds, reference
    from nbody_tpu_torch.parallel import ring_reduce_scatter
    from nbody_tpu_torch.parallel.sym import emulated_reduce_scatter

    mesh = _mesh(rows)
    lines = [mesh] if rows is None else [mesh.along_rows, mesh.along_cols]

    def partial(rank, d):
        g = torch.Generator().manual_seed(seed + rank)
        scale = torch.exp(8 * torch.randn(d * m, k, generator=g))
        hi = (torch.randn(d * m, k, generator=g) * scale).float()
        return hi, (hi * 2.0 ** -30 * torch.rand(d * m, k, generator=g)).float()

    out = []
    for line in lines:
        d = line.size
        mine = partial(line.peer(line.rank), d)
        every = [partial(line.peer(r), d) for r in range(d)]
        for fields, add, cut in (((mine[0],), reference.add_fields, 1), (mine, ds.ds_add, 2)):
            got = ring_reduce_scatter(line, fields, add)
            want = emulated_reduce_scatter([e[:cut] for e in every], add)[line.rank]
            out.append(all(torch.equal(a, b) for a, b in zip(got, want)))
    return out


def mesh_2d_view(rows):
    """(size, rank, the grid's shape, along_rows' global ranks, along_cols'
    global ranks) of the rows x world/rows grid, as this rank sees it."""
    mesh = _mesh(rows)
    return (mesh.size, mesh.rank, mesh.shape, [mesh.along_rows.peer(i) for i in
                                               range(mesh.rows)],
            [mesh.along_cols.peer(i) for i in range(mesh.cols)])


def switch_strategy(num_bodies, strategy):
    """The strategy of a mesh BodySystem, of its float64 switch and of the
    float32 switch back."""
    from nbody_tpu_torch import DEMO_PARAMS
    from nbody_tpu_torch.models import BodySystem

    s = BodySystem(num_bodies, DEMO_PARAMS[0], device="cpu", mesh=_mesh(), strategy=strategy)
    s64 = s.switch_precision()
    return s.strategy, s64.strategy, s64.switch_precision().strategy


def mesh_solver_step(kernel, kw, pos, vel, dt, soft, damp, steps=1):
    """`steps` sharded PM ("pm") or P3M ("p3m") steps of the whole (pos,
    vel), `kw` to make_sharded_pm_step / make_sharded_p3m_step, twice from
    the same state: (this rank's shard, whether the repeat gave its bits)."""
    from nbody_tpu_torch.ops.p3m import make_sharded_p3m_step
    from nbody_tpu_torch.ops.pm import make_sharded_pm_step

    mesh = _mesh()
    make = make_sharded_pm_step if kernel == "pm" else make_sharded_p3m_step
    step = make(mesh, **kw)
    runs = []
    for _ in range(2):
        p, v = _shard(mesh, pos), _shard(mesh, vel)
        for _ in range(steps):
            p, v = step(p, v, dt, soft, damp)
        runs.append((p.numpy(), v.numpy()))
    repeat = all(np.array_equal(a, b) for a, b in zip(*runs))
    return runs[0], repeat


def xla_partial(grid, capacity, pos, vel, dt, soft, damp):
    """The cell-list engine on the mesh: this rank's partial of the whole
    state's short range (its round robin of cells, in body order), and the
    counted host reads of one sharded Euler step with short_range "xla"."""
    from nbody_tpu_torch.ops import p3m
    from nbody_tpu_torch.utils import timing

    mesh = _mesh()
    part, _ = p3m.cell_list_short_range(torch.from_numpy(pos), soft, grid=grid,
                                        capacity=capacity, rank=mesh.rank, ndev=mesh.size)
    step = p3m.make_sharded_p3m_step(mesh, grid=grid, capacity=capacity, short_range="xla")
    before = timing.HOST_READS["p3m_xla"]
    step(_shard(mesh, pos), _shard(mesh, vel), dt, soft, damp)
    return part.numpy(), timing.HOST_READS["p3m_xla"] - before


def p3m_breach(num_bodies, params, kw, state, steps, auto_refresh):
    """A P3M BodySystem on the mesh, `steps` steps of `state`: without
    auto-refresh the first breached step its probe finds; with it (the
    contract-broken warnings, the capacity before and after, the rewinds,
    the final positions)."""
    import warnings

    from nbody_tpu_torch.models import BodySystem

    s = BodySystem(num_bodies, params, device="cpu", mesh=_mesh(), kernel="p3m", state=state,
                   p3m_auto_refresh=auto_refresh, **kw)
    if not auto_refresh:
        return s._probed_steps(steps, params.time_step)
    cap0 = s.p3m_capacity
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s.update_many(steps)
    broken = [str(x.message) for x in w if "contract broken" in str(x.message)]
    return broken, cap0, s.p3m_capacity, s.p3m_refreshes, s.positions


def demo_keys(keys, frames):
    """The demo loop on the mesh with --interactive, rank 0's stdin replaced
    by `keys` (one string a frame, read at each frame's end): (the steps
    taken, paused, the active demo and params, the positions) as this rank
    ends the loop."""
    from unittest import mock

    from nbody_tpu_torch import cli
    from nbody_tpu_torch.compute import Compute
    from nbody_tpu_torch.ui import controls

    mesh = _mesh()
    args = cli.build_parser().parse_args(["--cpu", "--numbodies", "64", "--frames", str(frames),
                                          "--interactive", "--no-cycle"])
    c = Compute(num_bodies=64, device="cpu", mesh=mesh, log=lambda s: None)
    feed = iter(keys)
    with mock.patch.object(controls.Controls, "read_keys",
                           staticmethod(lambda: next(feed, "") if mesh.rank == 0 else "")):
        cli._run_demo(c, args, mesh)
    return c.steps_taken, c.paused, c.active_demo, c.active_params, c.system.positions


def adaptive(kind, num_bodies, params, kw, state, steps, akw, mesh_rows=None):
    """A DSBodySystem ("ds") or BodySystem on the mesh (the grid of
    `mesh_rows` rows if given) from `state`, ``update_many_adaptive(steps,
    **akw)``: (positions, velocities, stats, strategy) of the whole system."""
    from nbody_tpu_torch.models import BodySystem, DSBodySystem

    cls = DSBodySystem if kind == "ds" else BodySystem
    s = cls(num_bodies, params, device="cpu", mesh=_mesh(mesh_rows), state=state, **kw)
    stats = s.update_many_adaptive(steps, **akw)
    return s.positions, s.velocities, stats, s.strategy


def adaptive_rollout(kind, kw, state, mesh_rows=None):
    """The public sharded adaptive rollout of `kind` ("fp32" or "ds", on the
    1-D mesh or the grid of `mesh_rows` rows) with `kw`, run on this rank's
    rows of `state` (float64 (pos, vel); split into ds planes for "ds"):
    (this rank's positions as float64, its stats)."""
    from nbody_tpu_torch.ops import ds
    from nbody_tpu_torch.parallel import (
        make_sharded_adaptive_rollout,
        make_sharded_adaptive_rollout_2d,
        make_sharded_ds_adaptive_rollout,
        make_sharded_ds_adaptive_rollout_2d,
    )

    mesh = _mesh(mesh_rows)
    pos, vel = (_shard(mesh, a) for a in state)
    if kind == "ds":
        build = (make_sharded_ds_adaptive_rollout if mesh_rows is None
                 else make_sharded_ds_adaptive_rollout_2d)
        out = build(mesh, **kw)(*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))
        return ds.ds_to_f64(out[0], out[1]), out[4].numpy()
    build = make_sharded_adaptive_rollout if mesh_rows is None else make_sharded_adaptive_rollout_2d
    p, _, stats = build(mesh, **kw)(pos.float(), vel.float())
    return p.double().numpy(), stats.numpy()


def p3m_adaptive(num_bodies, params, kw, state, steps, auto_refresh, akw):
    """A P3M BodySystem on the mesh, ``update_many_adaptive(steps, **akw)``
    of `state`: (the contract-broken warnings, the capacity before and
    after, the rewinds, the stats, the final positions)."""
    import warnings

    from nbody_tpu_torch.models import BodySystem

    s = BodySystem(num_bodies, params, device="cpu", mesh=_mesh(), kernel="p3m", state=state,
                   p3m_auto_refresh=auto_refresh, **kw)
    cap0 = s.p3m_capacity
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stats = s.update_many_adaptive(steps, **akw)
    broken = [str(x.message) for x in w if "contract broken" in str(x.message)]
    return broken, cap0, s.p3m_capacity, s.p3m_refreshes, stats, s.positions


def diff_grads(strategy, pos, vel, dt, soft, damp):
    """The gradients of sum(p[:, :3]**2) over the whole state's step,
    through ``make_sharded_step_diff(strategy=...)``: each rank's loss is
    its rows' part, and its backward gives the whole loss's gradient of its
    pos and vel rows and of dt, softening and damping (0-d tensors that
    require grad)."""
    from nbody_tpu_torch.ops.diff import make_sharded_step_diff

    mesh = _mesh()
    step = make_sharded_step_diff(mesh, strategy=strategy)
    p, v = (_shard(mesh, a).requires_grad_() for a in (pos, vel))
    scalars = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
               for x in (dt, soft, damp)]
    try:
        out, _ = step(p, v, *scalars)
        grads = torch.autograd.grad(torch.sum(out[:, :3] ** 2), [p, v, *scalars])
    finally:
        step.close()
    return [g.numpy() for g in grads]


def diff_2d_error():
    """The error make_sharded_step_diff raises on a 2-D mesh."""
    from nbody_tpu_torch.ops.diff import make_sharded_step_diff

    try:
        make_sharded_step_diff(_mesh(rows=2))
    except ValueError as e:
        return str(e)
    return None


def diff_second_order_error(pos, vel, dt, soft, damp):
    """The error a backward of the sharded step raises when it is asked for
    a graph of the gradient: its collectives are not differentiated."""
    from nbody_tpu_torch.ops.diff import make_sharded_step_diff

    mesh = _mesh()
    step = make_sharded_step_diff(mesh, strategy="allgather")
    p, v = (_shard(mesh, a) for a in (pos, vel))
    s = torch.tensor(soft, dtype=torch.float32, requires_grad=True)
    try:
        out, _ = step(p, v, dt, s, damp)
        torch.autograd.grad(torch.sum(out[:, :3] ** 2), s, create_graph=True)
    except RuntimeError as e:
        return str(e)
    finally:
        step.close()
    return None
