"""Adaptive global (shared) timestep rollouts.

Counterpart of ``nbody_tpu/ops/adaptive.py``. One dt a step, shared by every
body, picked from the force the step evaluates anyway:

* euler / leapfrog: dt = eta * sqrt(softening / max_i |a_i|)
* hermite: dt = eta * min_i |a_i| / |j_i| (Aarseth's rule)

both clipped to [dt_min, dt_max]. dt stays a 0-d tensor of the state's type
on the state's device, as JAX's traced dt does: the criterion is a max or a
min reduction on the device, the update runs on that tensor
(``reference.integrate``'s and the Hermite polynomials' arithmetic, dt*dt/2
in the state's type), and the stats block [t, dt_last, dt_lo, dt_hi]
accumulates there too. A rollout makes no host synchronisation: its caller
reads the stats once (``utils.timing.host_read``).

Integrator forms (one force evaluation a step for euler and leapfrog, the
end-of-step acceleration of the KDK leapfrog carried into the next step's
first kick; Hermite keeps its two, the first doubling as the criterion's
input)::

    euler    a = accel(x);  dt = crit(a);  v' = (v + a dt) d;  x' = x + v' dt
    KDK      dt = crit(a_carried); v½ = v + a dt/2; x' = x + v½ dt;
             a' = accel(x'); v' = (v½ + a' dt/2) d
    hermite  (a0, j0) = aj(x, v); dt = crit(a0, j0); P(EC)

Damping keeps the reference's per-step multiplier. On a mesh (``mesh=``, a
``parallel.Mesh`` or ``Mesh2D``) the force closures see this rank's shard
and carry their own collectives; the criterion's max (|a|²) or min (|a|/|j|)
is one scalar ``all_reduce`` over every rank of the mesh, exact and
independent of the order, so every rank steps with the same dt.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nbody_tpu_torch.ops.reference import hermite_correct, hermite_predict

INTEGRATORS = ("euler", "leapfrog", "hermite")


def _reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    """`x` reduced by `op` over every rank of `mesh` (x itself without one)."""
    if mesh is None or mesh.size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _full(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s type and device holding `value` rounded to
    that type: a fill on the device, no host copy."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _clip(dt: torch.Tensor, dt_min, dt_max) -> torch.Tensor:
    return torch.clamp(dt, min=float(dt_min), max=float(dt_max))


def accel_timestep(acc, softening, eta, dt_min, dt_max, *, mesh=None) -> torch.Tensor:
    """Global dt from accelerations: eta * sqrt(softening / max|a|), clipped
    to [dt_min, dt_max], a 0-d tensor of acc's type. `acc` is (N, 3) (a
    shard's rows on a mesh, whose max over the ranks is the global one)."""
    amax2 = _reduce(torch.amax(torch.sum(acc * acc, dim=-1)), mesh, dist.ReduceOp.MAX)
    amax = torch.sqrt(amax2)
    tiny = torch.finfo(acc.dtype).tiny
    dt = eta * torch.sqrt(_full(softening, amax) / torch.clamp(amax, min=tiny))
    return _clip(dt, dt_min, dt_max)


def aarseth_timestep(acc, jerk, eta, dt_min, dt_max, *, mesh=None) -> torch.Tensor:
    """Global dt from Aarseth's rule: eta * min_i |a_i| / |j_i|, clipped."""
    a = torch.sqrt(torch.sum(acc * acc, dim=-1))
    j = torch.sqrt(torch.sum(jerk * jerk, dim=-1))
    t = torch.amin(a / torch.clamp(j, min=torch.finfo(acc.dtype).tiny))
    t = _reduce(t, mesh, dist.ReduceOp.MIN)
    return _clip(eta * t, dt_min, dt_max)


def stats_init(like: torch.Tensor) -> torch.Tensor:
    """[t, dt_last, dt_lo, dt_hi] = [0, 0, inf, 0] in `like`'s type and
    device."""
    zeros = torch.zeros(4, dtype=like.dtype, device=like.device)
    # a fill, not an item assignment: a Python scalar assigned into a card's
    # tensor is copied from the host and waits for it
    return zeros.masked_fill(torch.arange(4, device=like.device) == 2, float("inf"))


def stats_update(stats: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    return torch.stack([stats[0] + dt, dt, torch.minimum(stats[2], dt),
                        torch.maximum(stats[3], dt)])


def new_totals(dt_max, steps: int) -> dict:
    """The stats dict of a call of `steps` adaptive steps before its first
    segment is merged in (``merge_stats``)."""
    return {"t": 0.0, "dt_last": float(dt_max), "dt_lo": float("inf"), "dt_hi": 0.0,
            "steps": int(steps)}


def merge_stats(totals: dict, st) -> dict:
    """Fold the stats of a later run into `totals` and return it: `st` is a
    segment's [t, dt_last, dt_lo, dt_hi] read from the device (its steps
    are counted in `totals` already) or a whole call's stats dict (its
    steps add). The times add, dt_last is the later run's, the extrema
    merge."""
    if isinstance(st, dict):
        totals["steps"] += st["steps"]
        st = [st[k] for k in ("t", "dt_last", "dt_lo", "dt_hi")]
    totals["t"] += st[0]
    totals["dt_last"] = st[1]
    totals["dt_lo"] = min(totals["dt_lo"], st[2])
    totals["dt_hi"] = max(totals["dt_hi"], st[3])
    return totals


def _with_mass(p3, like):
    return torch.cat([p3, like[:, 3:4]], dim=1)


def make_adaptive_rollout(integrator: str, *, accel_fn=None, accel_jerk_fn=None, softening,
                          damping, eta: float, dt_min: float, dt_max: float, steps: int,
                          mesh=None, probe_fn=None):
    """`run(pos, vel) -> (pos, vel, stats)`: `steps` adaptive steps, every
    launch queued with no host synchronisation (``nbody_tpu``'s
    ``make_adaptive_scan`` and ``make_adaptive_rollout`` in one: the port
    has no jit to tell them apart). stats is the (4,) tensor
    [t_total, dt_last, dt_lo, dt_hi] in the state's type on its device.
    `accel_fn(pos4) -> (N,3)` for euler and leapfrog, `accel_jerk_fn(pos4,
    vel4) -> (acc, jerk)` for hermite; `mesh` reduces the criterion over a
    mesh's ranks (the closures then see this rank's shard).

    `probe_fn(pos4) -> bool tensor` carries a contract probe through the
    steps (the P3M capacity breach): the return grows to (pos, vel, stats,
    first, bpos, bvel, bstats), `first` the first breached step as a 0-d
    int64 tensor (-1: none), `bpos`/`bvel` the state of that step and
    `bstats` the stats through it, so that an auto-refresh can rewind there
    and account the simulated time exactly."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if integrator == "hermite":
        if accel_jerk_fn is None:
            raise ValueError("hermite needs accel_jerk_fn")
    elif accel_fn is None:
        raise ValueError(f"{integrator} needs accel_fn")
    steps = int(steps)

    def crit(acc, jerk=None):
        if jerk is None:
            return accel_timestep(acc, softening, eta, dt_min, dt_max, mesh=mesh)
        return aarseth_timestep(acc, jerk, eta, dt_min, dt_max, mesh=mesh)

    def step(p, v, acc):
        """One step; returns (p', v', the acceleration the next step takes
        (leapfrog) or None, dt)."""
        if integrator == "euler":
            a = accel_fn(p)
            dt = crit(a)
            v3 = (v[:, :3] + a * dt) * damping
            return _with_mass(p[:, :3] + v3 * dt, p), _with_mass(v3, v), None, dt
        if integrator == "leapfrog":
            dt = crit(acc)
            v_half = v[:, :3] + acc * (dt / 2)
            np_ = _with_mass(p[:, :3] + v_half * dt, p)
            acc_new = accel_fn(np_)
            v3 = (v_half + acc_new * (dt / 2)) * damping
            return np_, _with_mass(v3, v), acc_new, dt
        x0, v0 = p[:, :3], v[:, :3]
        a0, j0 = accel_jerk_fn(p, v)
        dt = crit(a0, j0)
        xp, vp = hermite_predict(x0, v0, a0, j0, dt)
        a1, j1 = accel_jerk_fn(_with_mass(xp, p), _with_mass(vp, v))
        x1, v1 = hermite_correct(x0, v0, a0, j0, a1, j1, dt, damping)
        return _with_mass(x1, p), _with_mass(v1, v), None, dt

    def run(pos, vel):
        stats = stats_init(pos)
        acc = accel_fn(pos) if integrator == "leapfrog" else None
        if probe_fn is not None:
            first = torch.full((), -1, dtype=torch.int64, device=pos.device)
            bp, bv, bst = pos, vel, stats
        for i in range(steps):
            pos, vel, acc, dt = step(pos, vel, acc)
            stats = stats_update(stats, dt)
            if probe_fn is None:
                continue
            newly = (first < 0) & probe_fn(pos)
            first = torch.where(newly, i, first)
            bp = torch.where(newly, pos, bp)
            bv = torch.where(newly, vel, bv)
            bst = torch.where(newly, stats, bst)
        if probe_fn is None:
            return pos, vel, stats
        return pos, vel, stats, first, bp, bv, bst

    return run



def make_ds_adaptive_rollout(integrator: str, *, criterion_fn, step_fn, base_scal, eta: float,
                             softening, dt_min: float, dt_max: float, steps: int, mesh=None):
    """`run(planes) -> (planes, stats)`: `steps` ds adaptive steps, the
    design of ``nbody_tpu/ops/ds_kernel.py::make_ds_adaptive_rollout``: the
    criterion in float32 from the hi planes (`criterion_fn(planes) -> (acc,
    ctx)`, or `((acc, jerk), ctx)` for hermite, `ctx` what the step may reuse,
    such as gathered planes), the scalar block's dt columns rebuilt from
    that float32 dt on the device (``ds.ds_scal_with_dt`` of `base_scal`, a
    block on the planes' device), then `step_fn(planes, scal, ctx) ->
    planes`, the ds step. stats is float32, on the device; nothing is read
    on the host."""
    from nbody_tpu_torch.ops.ds import ds_scal_with_dt

    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    steps = int(steps)

    def run(planes):
        stats = stats_init(planes[0])
        for _ in range(steps):
            f, ctx = criterion_fn(planes)
            if integrator == "hermite":
                dt = aarseth_timestep(f[0], f[1], eta, dt_min, dt_max, mesh=mesh)
            else:
                dt = accel_timestep(f, softening, eta, dt_min, dt_max, mesh=mesh)
            planes = step_fn(planes, ds_scal_with_dt(base_scal, dt, integrator=integrator), ctx)
            stats = stats_update(stats, dt)
        return planes, stats

    return run
