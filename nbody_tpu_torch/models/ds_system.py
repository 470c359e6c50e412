"""DSBodySystem: double-single (fp64-grade) simulation state on a torch
device, and stepping.

Counterpart of ``nbody_tpu/models/ds_system.py``. The state is
four (N,4) float32 planes, pos_hi, pos_lo, vel_hi and vel_lo, each value the
unevaluated sum hi + lo (a ~49-bit significand); the public accessors speak
float64. As in ``BodySystem``, two sets of planes are preallocated and a
step reads one set and writes the other (the reference's ping-pong buffers).

Backends:
  * "cuda"  — the hand-written ds kernels (``ops/cuda_kernel.py``)
  * "torch" — their plain versions (``ops/ds.py``), on any device
  * "auto"  — "cuda" on a CUDA device, else "torch"

Variants, resolved as ``nbody_tpu`` resolves them (ds_system.py:120-149):
  * "sym"       — each pair once: for Euler the blocked ds triangle and
    rectangle composition (``ds_sym_default_dispatch``), then the ds Euler
    update (one glue kernel on the card); for Hermite the blocked ds
    accel + jerk composition (``ds_aj_sym_default_dispatch``)
  * "one_sided" — the fused one-sided ds step, or for Hermite the one-sided
    ds accel + jerk kernel; leapfrog has only this form
  * "auto"      — "sym" for Euler and Hermite, "one_sided" for leapfrog
On a CUDA device with backend "cuda" and no mesh, "auto" (or an explicit
variant given no ``block_size`` and no ``tile``) reads the port's tuner's
winner for this card and N, family "ds", "ds_leapfrog" or "ds_hermite" by
integrator (``tune.best_config``; ``nbody-tune-torch``), as ``nbody_tpu``
reads its TPU tuner's (ds_system.py:132-149): its variant (a cached "sym"
only where sym applies), block size and tile; an entry of the other
variant gives none of them. Without an entry the measured tables
(``ds_default_block_size``, ``ds_sym_default_dispatch``,
``ds_aj_sym_default_dispatch``) apply. ``tile`` is the j-tile of the
each-pair-once kernels (``SYM_TILES`` for Euler, ``DS_AJ_TILES`` for
Hermite), None for the tables'.

Integrators: "euler" (damped semi-implicit), "leapfrog" (the fused
drift-kick-drift kernel) and "hermite" (4th-order P(EC): two ds accel +
jerk evaluations a step around the ds predictor and corrector, one glue
kernel each on the card, as ``nbody_step_pallas_ds_hermite``).

Meshes: with ``mesh=make_mesh(D)`` (a 1-D body mesh of ``parallel/``) each
rank holds N/D bodies, N rounded up to a multiple of D, and steps them with
``make_sharded_ds_step`` by ``strategy`` "allgather" (the planes gather,
one fused one-sided kernel), "ring" (the ds accel-only kernel a hop) or
"auto" (``choose_strategy``); with ``mesh=make_mesh_2d(R, C)`` the R·C ranks
run ``make_sharded_ds_step_2d`` (``strategy`` must be "auto" and reads
"2d", as in ``nbody_tpu``); the sharded steps are one-sided, so
``variant="auto"`` is "one_sided" there and "sym" raises, as in
``nbody_tpu``. ``positions``, ``velocities``, ``state``, ``get_ds_state()``
and the force accessors give the whole system on every rank;
``set_state`` / ``set_ds_state`` take it and each rank keeps its rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch import ic
from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.models.body_system import (
    BodySystem,
    _as_numpy,
    check_mesh,
    device_block_size,
    resolve_device,
)
from nbody_tpu_torch.ops import ds, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    DS_AJ_TILES,
    SYM_TILES,
    check_sym_tile,
    compute_accel_cuda,
    compute_accel_ds_cuda_vs,
    compute_accel_ds_symmetric_blocked_cuda,
    compute_accel_jerk_ds_cuda_vs,
    compute_accel_jerk_cuda,
    compute_accel_jerk_ds_symmetric_blocked_cuda,
    ds_aj_sym_default_dispatch,
    ds_default_block_size,
    ds_hermite_correct_cuda,
    ds_hermite_predict_cuda,
    ds_integrate_cuda,
    ds_sym_default_dispatch,
    nbody_step_ds_cuda,
    nbody_step_ds_leapfrog_cuda,
    potential_energy_per_row_cuda,
)
from nbody_tpu_torch.ops.energy import kinetic_energy, potential_energy_per_row, total_energy_f64
from nbody_tpu_torch.params import NBodyParams
from nbody_tpu_torch.utils.profiling import annotate
from nbody_tpu_torch.utils.timing import synchronize as _synchronize


class DSBodySystem:
    """Owns ds (hi/lo float32 plane) state and advances it with the ds
    kernels. Public state in and out is float64."""

    def __init__(
        self,
        num_bodies: int,
        params: NBodyParams,
        *,
        device="cuda",
        backend: str = "auto",
        block_size: Optional[int] = None,
        tile: Optional[int] = None,
        integrator: str = "euler",
        variant: str = "auto",
        mesh=None,
        strategy: str = "auto",
        config: NBodyConfig = NBodyConfig.SHELL,
        seed: int = 42,
        state: Optional[tuple] = None,
    ):
        self.device = resolve_device(device)
        ndev = 1
        if mesh is not None:
            # nbody_tpu/models/ds_system.py:66-106
            ndev = check_mesh(
                mesh, self.device, strategy, strategies=("auto", "allgather", "ring"),
                axes_error="DSBodySystem shards over a 1-D body mesh (make_sharded_ds_step) or "
                f"a 2-D rows×cols mesh (make_sharded_ds_step_2d); got "
                f"{tuple(getattr(mesh, 'axis_names', ()))}",
                strategy_error="DSBodySystem strategy must be 'auto', 'allgather', or "
                f"'ring' (got {strategy!r}); ring_fused/sym are fp32 mesh paths",
                strategy_2d_error="the ds 2-D decomposition is its own communication pattern "
                "(two-axis gathers + a ds reduce-scatter over cols); leave strategy at 'auto' "
                "— allgather/ring are 1-D body-mesh strategies")
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "cuda" if self.device.type == "cuda" else "torch"
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device; got {self.device}")
        if integrator not in ("euler", "leapfrog", "hermite"):
            raise ValueError(f"unknown integrator {integrator!r}")
        if variant not in ("auto", "sym", "one_sided"):
            raise ValueError(f"unknown ds variant {variant!r}")
        if variant == "sym" and integrator == "leapfrog":
            raise ValueError("variant='sym' applies to the euler and hermite ds steps (the "
                             "fused leapfrog kernel is one-sided)")
        if variant == "sym" and mesh is not None:
            raise ValueError(
                "variant='sym' applies to the euler/hermite ds steps on "
                "a single device (the sharded ds step is one-sided)")
        sym_ok = integrator != "leapfrog" and mesh is None
        if (backend == "cuda" and mesh is None
                and (variant == "auto" or (block_size is None and tile is None))):
            from nbody_tpu_torch import tune

            family = {"euler": "ds", "leapfrog": "ds_leapfrog", "hermite": "ds_hermite"}
            variant, block_size, tile = tune.resolve_cached(
                tune.best_config(int(num_bodies), family=family[integrator]),
                variant=variant, block_size=block_size, tile=tile, sym_ok=sym_ok)
        if variant == "auto":
            variant = "sym" if sym_ok else "one_sided"

        self.backend = backend
        self.variant = variant
        self.integrator = integrator
        # N rounded up so the body shards divide evenly (nbody_tpu's rule)
        self.num_bodies = -(-int(num_bodies) // ndev) * ndev
        self.block_size = (ds_default_block_size(self.num_bodies) if block_size is None
                           else device_block_size(block_size, self.device))
        self.tile = None if tile is None else check_sym_tile(
            tile, DS_AJ_TILES if integrator == "hermite" else SYM_TILES)
        self.params = params
        self.config = config
        self.seed = seed
        self.mesh = mesh
        self.strategy = "allgather"
        self._sharded = None
        if mesh is not None and len(mesh.axis_names) == 2:
            from nbody_tpu_torch.parallel import make_sharded_ds_step_2d

            self.strategy = "2d"
            # one-sided kernels on the row block: its block size is the row
            # block's
            self._sharded = make_sharded_ds_step_2d(
                mesh, axes=mesh.axis_names, backend=backend, integrator=integrator,
                block_size=block_size)
        elif mesh is not None:
            from nbody_tpu_torch.parallel import choose_strategy, make_sharded_ds_step

            self.strategy = (choose_strategy(self.num_bodies, ndev) if strategy == "auto"
                             else strategy)
            # one-sided kernels on the shard: their block size is the shard's
            self._sharded = make_sharded_ds_step(
                mesh, backend=backend, integrator=integrator, strategy=self.strategy,
                block_size=block_size)
        nloc = self.num_bodies // ndev

        def planes():
            return [torch.empty((nloc, 4), dtype=torch.float32, device=self.device)
                    for _ in range(4)]

        # [current, next] sets of (pos_hi, pos_lo, vel_hi, vel_lo), and for
        # Hermite the predicted state's
        self._planes = [planes(), planes()]
        self._pred = planes() if integrator == "hermite" else None
        self._cur = 0
        if state is not None:
            self.set_state(*state)
        else:
            self.reset(params, config, seed=seed)

    # ---- state ----

    def set_state(self, pos, vel) -> None:
        """Replace the state from float64 (N,4) arrays or tensors, split
        exactly into hi + lo; fewer rows than num_bodies are padded with
        zero-mass bodies at the origin."""
        p64, v64 = (np.asarray(_as_numpy(a), np.float64) for a in (pos, vel))
        if p64.ndim != 2 or p64.shape[1] != 4 or v64.shape != p64.shape:
            raise ValueError(f"state must be two (N, 4) arrays; got {p64.shape} and {v64.shape}")
        pad = self.num_bodies - p64.shape[0]
        if pad < 0:
            raise ValueError(f"state has {p64.shape[0]} bodies > allocated {self.num_bodies}")
        if pad:
            p64 = np.pad(p64, ((0, pad), (0, 0)))
            v64 = np.pad(v64, ((0, pad), (0, 0)))
        self.set_ds_state(*ds.ds_from_f64(p64), *ds.ds_from_f64(v64))

    def set_positions(self, pos) -> None:
        """Replace the positions, keeping the velocities (nbody_tpu's
        ``set_positions``)."""
        self.set_state(pos, self.velocities)

    def set_velocities(self, vel) -> None:
        """Replace the velocities, keeping the positions."""
        self.set_state(self.positions, vel)

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """`t`, a field of this rank's bodies, for the whole system: on a
        mesh gathered from every rank, else `t` itself."""
        if self.mesh is None:
            return t
        from nbody_tpu_torch.parallel import all_gather_rows

        return all_gather_rows(self.mesh, t)

    def _whole_planes(self):
        return [self._whole(t) for t in self._planes[self._cur]]

    def get_ds_state(self):
        """The raw (pos_hi, pos_lo, vel_hi, vel_lo) float32 planes as host
        numpy arrays: the bit-exact checkpoint payload, in the layout of
        ``nbody_tpu``'s ``DSBodySystem.get_ds_state``."""
        return tuple(t.detach().to("cpu", copy=True).numpy() for t in self._whole_planes())

    def set_ds_state(self, pos_hi, pos_lo, vel_hi, vel_lo) -> None:
        """Restore raw hi/lo planes bit for bit (``get_ds_state``'s inverse;
        planes from ``nbody_tpu``'s ``get_ds_state`` load unchanged)."""
        rows = slice(None)
        if self.mesh is not None:
            from nbody_tpu_torch.parallel import shard_rows

            rows = shard_rows(self.mesh, self.num_bodies)
        for dst, src in zip(self._planes[self._cur], (pos_hi, pos_lo, vel_hi, vel_lo)):
            src = src if isinstance(src, torch.Tensor) else torch.from_numpy(np.array(src))
            if src.dtype != torch.float32 or tuple(src.shape) != (self.num_bodies, 4):
                raise ValueError(f"ds planes must be float32 (N, 4) with N={self.num_bodies}; "
                                 f"got {src.dtype} {tuple(src.shape)}")
            dst.copy_(src[rows])

    @property
    def state(self):
        """The current (pos_hi, vel_hi) float32 device tensors, which carry
        the float32-visible state (``nbody_tpu``'s ``DSBodySystem.state``);
        valid until the next step."""
        planes = self._planes[self._cur]
        return self._whole(planes[0]), self._whole(planes[2])

    @property
    def positions(self) -> np.ndarray:
        """(N, 4) float64 [x, y, z, m], hi + lo, on the host."""
        planes = self._planes[self._cur]
        with annotate("nbody.readback"):
            return ds.ds_to_f64(self._whole(planes[0]), self._whole(planes[1]))

    @property
    def velocities(self) -> np.ndarray:
        planes = self._planes[self._cur]
        with annotate("nbody.readback"):
            return ds.ds_to_f64(self._whole(planes[2]), self._whole(planes[3]))

    # ---- parameters ----

    def update_params(self, params: NBodyParams) -> None:
        """Live parameter update: dt, softening and damping enter each
        launch through the scalar block, so nothing is rebuilt."""
        self.params = params

    def reset(self, params: NBodyParams, config: NBodyConfig, *,
              seed: Optional[int] = None) -> None:
        """Regenerate the initial conditions from the seed, in float64."""
        self.params = params
        self.config = config
        if seed is not None:
            self.seed = seed
        pos, vel = ic.generate(config, self.num_bodies, params.cluster_scale,
                               params.velocity_scale, seed=self.seed, dtype=np.float64)
        self.set_state(pos, vel)

    # ---- stepping ----

    def _scal(self, dt: float, damping: Optional[float] = None) -> torch.Tensor:
        p = self.params
        damping = p.damping if damping is None else damping
        if self.integrator == "leapfrog":
            return ds.scal_ds_leapfrog(dt, p.softening, damping)
        if self.integrator == "hermite":
            return ds.scal_ds_hermite(dt, p.softening, damping)
        return ds.scal_ds(dt, p.softening, damping)

    def _sym_accel(self, pos_hi, pos_lo, scal):
        with annotate("nbody.force"):
            if self.backend == "cuda":
                return compute_accel_ds_symmetric_blocked_cuda(pos_hi, pos_lo, scal, tile=self.tile)
            cap, tile = ds_sym_default_dispatch(pos_hi.shape[0])
            return ds.ds_accel_symmetric_blocked(pos_hi, pos_lo, scal, block_cap=cap,
                                                 tile_j=self.tile or tile)

    def _fused_step(self, planes, scal, out) -> None:
        """The one-sided fused step (Euler or leapfrog) from `planes` into
        `out`, with the backend's kernel or plain version."""
        with annotate("nbody.force"):
            euler = self.integrator == "euler"
            if self.backend == "cuda":
                step = nbody_step_ds_cuda if euler else nbody_step_ds_leapfrog_cuda
                step(*planes, scal, block_size=self.block_size, out=out)
                return
            step = ds.nbody_step_ds if euler else ds.nbody_step_ds_leapfrog
            for t, r in zip(out, step(*planes, scal)):
                t.copy_(r)

    def _accel_jerk(self, planes, scal):
        """(acc_hi, acc_lo, jerk_hi, jerk_lo) of the state `planes` with
        this system's variant and backend: (N,3) each from the each-pair-once
        composition, (N,4) from the one-sided kernel."""
        with annotate("nbody.force"):
            if self.variant == "sym":
                if self.backend == "cuda":
                    return compute_accel_jerk_ds_symmetric_blocked_cuda(*planes, scal,
                                                                        tile=self.tile)
                cap, tile = ds_aj_sym_default_dispatch(self.num_bodies)
                return ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=cap,
                                                          tile_j=self.tile or tile)
            if self.backend == "cuda":
                return compute_accel_jerk_ds_cuda_vs(*planes, *planes, scal,
                                                     block_size=self.block_size)
            return ds.ds_accel_jerk_vs(*planes, *planes, scal)

    def _hermite_step(self, planes, scal, out) -> None:
        """One ds Hermite P(EC) step from `planes` into `out`: accel + jerk,
        the predictor into the predicted planes, accel + jerk there, the
        corrector; on the card four launches (one-sided) or eight and more
        (each pair once) and no host synchronisation."""
        f0 = self._accel_jerk(planes, scal)
        with annotate("nbody.integrate"):
            pred = (ds_hermite_predict_cuda(*planes, *f0, scal, out=self._pred)
                    if self.backend == "cuda"
                    else ds.ds_hermite_predict(*planes, f0[:2], f0[2:], scal))
        f1 = self._accel_jerk(pred, scal)
        with annotate("nbody.integrate"):
            if self.backend == "cuda":
                ds_hermite_correct_cuda(*planes, *f0, *f1, scal, out=out)
                return
            for t, r in zip(out, ds.ds_hermite_correct(*planes, f0[:2], f0[2:], f1[:2], f1[2:],
                                                       scal)):
                t.copy_(r)

    def _step(self, scal) -> None:
        cur, nxt = self._cur, 1 - self._cur
        planes, out = self._planes[cur], self._planes[nxt]
        if self.mesh is not None:
            for t, r in zip(out, self._sharded(*planes, scal)):
                t.copy_(r)
        elif self.integrator == "hermite":
            self._hermite_step(planes, scal, out)
        elif self.variant == "sym":
            acc = self._sym_accel(planes[0], planes[1], scal)
            with annotate("nbody.integrate"):
                if self.backend == "cuda":
                    ds_integrate_cuda(*planes, *acc, scal, out=out)
                else:
                    for t, r in zip(out, ds.ds_integrate(*planes, acc, scal)):
                        t.copy_(r)
        else:
            self._fused_step(planes, scal, out)
        self._cur = nxt

    def update(self, dt: Optional[float] = None) -> None:
        """Advance one step (dt defaults to params.time_step)."""
        self.update_many(1, dt)

    def update_many(self, steps: int, dt: Optional[float] = None) -> None:
        """Advance `steps` steps: the launches of each step queued on the
        current stream, with no host synchronisation in between."""
        # the block is uploaded once a call, where the kernels read it
        scal = ds.scal_on(self._scal(self.params.time_step if dt is None else dt), self.device)
        for _ in range(steps):
            with annotate("nbody.step"):
                self._step(scal)

    # steps of one adaptive segment, whose stats are read once
    _MAX_ROLLOUT_SEGMENT = BodySystem._MAX_ROLLOUT_SEGMENT

    def update_many_adaptive(self, steps: int, *, eta: float = 0.025,
                             dt_min: Optional[float] = None,
                             dt_max: Optional[float] = None) -> dict:
        """Adaptive global timestep in ds, ``nbody_tpu``'s
        ``DSBodySystem.update_many_adaptive`` (``models/ds_system.py:
        387-480``): each step picks dt from a float32 criterion on the hi
        planes (the float32 one-sided force, or accel + jerk for Hermite:
        it only picks dt), rebuilds the scalar block's dt columns on the
        device (``ds.ds_scal_with_dt``) and runs the system's full ds step
        on it, the kernels reading the block from device memory: no step
        waits on the host, and each segment of up to 1000 steps reads its
        stats once (``host_read``, "adaptive_stats"). Criterion, [dt_min,
        dt_max] defaults and stats are ``BodySystem.update_many_adaptive``'s.
        On a 1-D mesh the rollout is allgather whatever the strategy
        (``make_sharded_ds_adaptive_rollout``: the criterion needs the
        gathered hi planes anyway), on a 2-D mesh the ds 2-D decomposition
        (``make_sharded_ds_adaptive_rollout_2d``)."""
        from nbody_tpu_torch.ops.adaptive import make_ds_adaptive_rollout, merge_stats, new_totals
        from nbody_tpu_torch.utils import timing
        p = self.params
        if dt_max is None:
            dt_max = p.time_step
        if dt_min is None:
            dt_min = dt_max / 1024.0
        if not (0.0 < dt_min <= dt_max):
            raise ValueError(f"need 0 < dt_min <= dt_max, got [{dt_min}, {dt_max}]")
        if not eta > 0.0:   # also rejects NaN
            raise ValueError(f"need eta > 0, got {eta}")
        stats = new_totals(dt_max, steps)
        kw = dict(integrator=self.integrator, softening=p.softening, damping=p.damping,
                  eta=eta, dt_min=dt_min, dt_max=dt_max)
        done = 0
        while done < steps:
            seg = min(steps - done, self._MAX_ROLLOUT_SEGMENT)
            with annotate("nbody.ds_adaptive_rollout", f"seg={seg}"):
                if self.mesh is not None:
                    from nbody_tpu_torch.parallel.sharded import ds_adaptive_rollout_on

                    out = ds_adaptive_rollout_on(self._adaptive_step(), steps=seg, **kw)(
                        *self._planes[self._cur])
                    nxt = 1 - self._cur
                    for t, r in zip(self._planes[nxt], out[:4]):
                        t.copy_(r)
                    self._cur = nxt
                    st = out[4]
                else:
                    run = make_ds_adaptive_rollout(
                        self.integrator, criterion_fn=self._criterion, step_fn=self._scal_step,
                        base_scal=ds.scal_on(self._scal(0.0), self.device), eta=eta,
                        softening=p.softening, dt_min=dt_min, dt_max=dt_max, steps=seg)
                    st = run(self._planes[self._cur])[1]
            merge_stats(stats, timing.host_read(st, "adaptive_stats"))
            done += seg
        return stats

    def _criterion(self, planes):
        """The float32 force (accel + jerk for Hermite) of the hi planes, the
        adaptive criterion's input: the one-sided kernel (its plain version
        with backend 'torch'), as ``nbody_tpu``'s ds rollout takes it."""
        soft = self.params.softening
        ph, vh = planes[0], planes[2]
        if self.integrator == "hermite":
            if self.backend == "cuda":
                return compute_accel_jerk_cuda(ph, vh, ph, vh, soft), None
            return reference.compute_accel_jerk(ph, vh, soft), None
        if self.backend == "cuda":
            return compute_accel_cuda(ph, ph, soft), None
        return reference.compute_accel(ph, soft), None

    def _scal_step(self, planes, scal, ctx=None):
        """One ds step of the current planes with the scalar block `scal`
        (on the device); returns the new current planes."""
        self._step(scal)
        return self._planes[self._cur]

    def _adaptive_step(self):
        """The sharded ds step the mesh's adaptive rollout runs on: the 2-D
        one, or an allgather one on a 1-D mesh."""
        if self.strategy in ("2d", "allgather"):
            return self._sharded
        if getattr(self, "_allgather", None) is None:
            from nbody_tpu_torch.parallel import make_sharded_ds_step

            self._allgather = make_sharded_ds_step(
                self.mesh, backend=self.backend, integrator=self.integrator,
                strategy="allgather", block_size=self._sharded.block_size)
        return self._allgather

    def accelerations(self):
        """(acc_hi, acc_lo), each (N,3), of the current state on the device,
        with this system's kernels (or plain versions). With Hermite, the
        accel + jerk kernels'. For "sym" that is the each-pair-once
        composition; for the one-sided Euler and leapfrog variants the ds
        accel kernel (``compute_accel_ds_cuda_vs``) in the j-chunks of the
        system's step kernel (``ds_splits``, the rule of all three), so with
        its force's bits; on a mesh each shard's force by the mesh's
        strategy, gathered."""
        planes = self._planes[self._cur]
        scal = self._scal(1.0, 1.0)
        if self.integrator == "hermite":
            return self.accelerations_and_jerks()[:2]
        if self.mesh is not None:
            acc = self._sharded.accel(planes[0], planes[1], scal)
            return tuple(self._whole(a) for a in acc)
        if self.variant == "sym":
            return self._sym_accel(planes[0], planes[1], scal)
        if self.backend == "cuda":
            return compute_accel_ds_cuda_vs(planes[0], planes[1], planes[0], planes[1], scal,
                                            block_size=self.block_size)
        return ds.ds_accel_vs(planes[0], planes[1], planes[0], planes[1], scal)

    def accelerations_and_jerks(self):
        """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (N,3), of the current
        state on the device, with this system's variant of the accel + jerk
        kernels (or plain versions), as ``BodySystem.accelerations_and_jerks``
        in ds; on a mesh each shard's by the mesh's strategy, gathered."""
        planes, scal = self._planes[self._cur], self._scal(1.0, 1.0)
        if self.mesh is not None:
            return tuple(self._whole(f[:, :3]) for f in self._sharded.accel_jerk(*planes, scal))
        return tuple(f[:, :3] for f in self._accel_jerk(planes, scal))

    def synchronize(self) -> None:
        """Wait for every queued step to finish."""
        _synchronize(self.device)

    # nbody_tpu's names of the same barrier
    block_until_ready = synchronize
    hard_sync = synchronize

    # ---- diagnostics ----

    def total_energy(self, *, precise: bool = True) -> float:
        """Kinetic + softened potential energy of the current state. ds
        states are precision anchors, so the float64 functional on the
        host (``total_energy_f64`` of the float64 state) is the default, as
        in ``nbody_tpu``; precise=False is the float32 diagnostic of the hi
        planes (the potential kernel with backend='cuda')."""
        soft = self.params.softening
        if precise:
            return total_energy_f64(self.positions, self.velocities, soft)
        pos, vel = self.state
        if self.backend == "cuda":
            per_row = potential_energy_per_row_cuda(pos, soft)
        else:
            per_row = potential_energy_per_row(pos, soft)
        return float(kinetic_energy(pos, vel) - 0.5 * torch.sum(per_row))
