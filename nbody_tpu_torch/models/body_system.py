"""BodySystem: simulation state on a torch device, and stepping.

Counterpart of ``nbody_tpu/models/body_system.py`` for the port's slices so
far: fp32 or fp64 (``dtype=torch.float64``, below), damped semi-implicit
Euler, leapfrog or 4th-order Hermite, the one-sided force
(``variant="vpu"``), the each-pair-once force
(``variant="sym"``) or the force reduction on the tensor cores
(``variant="mxu"`` / ``"mxu_bf16"``, Euler), the mesh solvers (``kernel=
"pm"`` and ``"p3m"``, Euler and leapfrog, on one device or a 1-D mesh), the
energy diagnostics, and a body mesh (``mesh=``, ``strategy=``, below).

State lives in two preallocated pairs of (pos, vel) buffers, the reference's
ping-pong double buffer: a step reads one pair and writes the other, so the
fused kernel never writes the array it reads the j-bodies from. (The JAX
package gets the same effect from a donated ``lax.scan``.)

Backends:
  * "cuda"  — the hand-written CUDA kernels (``ops/cuda_kernel.py``)
  * "torch" — the plain PyTorch versions (``ops/reference.py``), on any device
  * "auto"  — "cuda" on a CUDA device, else "torch"

Variants (the force):
  * "vpu"  — one-sided all-pairs; Euler runs the fused step kernel
  * "sym"  — each pair once, the blocked triangle + rectangle composition
    (``sym_default_dispatch``); the O(N) update is plain torch, written into
    the other ping-pong buffer, as the JAX package leaves it to XLA
  * "mxu" / "mxu_bf16" — Euler runs the fused step with the force reduced
    as a matrix product on the tensor cores (``csrc/mxu_kernels.cu``), in
    f32 grade or with bf16 operands; leapfrog and Hermite keep the one-sided
    kernels, as the JAX package's do (its mxu variants reach only
    ``nbody_step_pallas``). mxu_bf16 is not faithful to energy.
  * "auto" — on a CUDA device with backend "cuda", no mesh and fp32 the
    port's tuner's cached winner for this card and N (``tune.best_config``,
    the "hermite" family for Hermite, else "euler"; ``nbody-tune-torch``),
    variant, block size and tile, an explicit ``block_size`` or ``tile``
    winning with a warning; without an entry AUTO_VARIANT_CUDA and the
    dispatch tables. Elsewhere "vpu". (The JAX package reads its TPU
    tuner's cache likewise, and resolves to its Pallas sym path only on the
    TPU.) An mxu_bf16 winner is cached only past the tuner's drift gate.

``tile`` is the j-tile of the each-pair-once kernels (the force for Euler
and leapfrog, accel + jerk for Hermite; one of ``SYM_TILES``), None for
the dispatch table's (``sym_default_dispatch`` / ``aj_sym_default_dispatch``).

fp64 (``dtype=torch.float64``): the state, its ping-pong and host buffers
are float64, and every integrator runs on the double kernels
(``csrc/f64_kernels.cu``) with backend "cuda", on the plain versions in
float64 with "torch": nbody_tpu's fp64 is its XLA path, so ``variant="auto"``
resolves to "vpu", "sym" (Pallas-only there) raises, and "mxu" / "mxu_bf16"
run the one-sided kernels, as that path ignores them. On a mesh float64
runs allgather, ring, auto and the 2-D step; the ring_fused and sym
strategies raise (float32 kernels). ``kernel="pm"`` / ``"p3m"`` in float64
does what ``nbody_tpu``'s BodySystem does: the mesh solver's force from the
float32 positions, the update in float64. ``switch_precision()`` hops
between float32 and float64 with the same state, as the reference's Enter
key does; like ``nbody_tpu``'s it runs the exact all-pairs force in float64
(the double kernels) and the requested kernel again on the way back.

Integrators: "euler" (damped semi-implicit), "leapfrog" (drift-kick-drift
around one force evaluation of the variant's force) and "hermite" (the
4th-order P(EC) predictor-corrector, two accel + jerk evaluations of the
variant a step: the one-sided accel + jerk kernel for "vpu", the
each-pair-once triangle and rectangle for "sym").

Kernels (the algorithm; the JAX package's ``backend`` "pallas" / "xla" /
"pm" / "p3m", the CLI's ``--kernel``; here ``backend`` already names the
implementation, so the algorithm has its own keyword):
  * "auto" — the all-pairs force of the variant above
  * "pm"   — plain particle-mesh (``ops/pm.py``): the raw 1/r kernel on a
    ``pm_grid``^3 mesh, ``pm_assignment`` "cic" or "tsc"; plain PyTorch, as
    the JAX package's PM is XLA
  * "p3m"  — PM long range + exact short range (``ops/p3m.py``), the
    optimal influence, ``pm_assignment`` "cic" or "tsc", with Euler or
    leapfrog; the variant is ignored, as in the JAX package. The short
    range runs the pair kernel (``csrc/p3m_kernels.cu``) with backend
    "cuda", its plain version with "torch"; ``p3m_short_range`` "auto" and
    "pallas" both name it, and resolve to "pallas" (the JAX package's
    "auto" is its cell-list engine off a TPU); "xla" runs that engine
    (``p3m.cell_list_short_range``, plain PyTorch) whatever the backend, on
    one device and on a mesh. ``p3m_capacity`` is the cell
    capacity: None auto-sizes it from the first state (max occupancy +
    50 %, a multiple of 8), and every state set raises when a cell
    overflows it. Each step of ``update_many`` probes the contract on the
    device (no host synchronisation) and keeps the first breached step and
    its state; after the steps, a breach warns once per episode, naming
    the step, or with ``p3m_auto_refresh`` rewinds to that state, re-sizes
    the capacity from it (``refresh_p3m_contract``) and runs the remaining
    steps (``p3m_refreshes`` lists each rewind).
  On one CUDA device with backend "cuda", "pm" and "p3m" with the pair
  kernel replay their force as a CUDA graph (``ops/force_graph.py``): the
  first call under a key (N, grid, assignment, capacity, blk, softening)
  runs eagerly, then captures; later calls replay. ``force_calls`` counts
  the calls by kind. Meshes, the cell-list engine and backend "torch" run eagerly.

Placements (the reference's BodySystemCUDA variants):
  * "device" — state stays in device memory between calls
  * "host"   — state lives in host memory (pinned when the device is a CUDA
    card); each ``update`` / ``update_many`` call copies it to the device
    once, steps there, and copies it back: the HostMemory body system.
    One device only: a mesh with placement="host" raises.

Adaptive and block timesteps: ``update_many_adaptive`` steps with one global
dt chosen on the device from each step's force (``ops/adaptive.py``; every
force, precision, placement and mesh above but the ring_fused strategy), and
``update_many_block`` with per-body rungs of a power-of-two ladder
(``ops/block_timestep.py``; one device, the exact kernels, damping 1), as
``nbody_tpu``'s do.

Meshes (``parallel/``): with ``mesh=make_mesh(D)`` each of the D ranks
holds N/D bodies (N rounded up to a multiple of D with zero-mass bodies, as
``nbody_tpu`` rounds it) and steps them with ``make_sharded_step``, by
``strategy`` "allgather", "ring", "ring_fused" (Euler and leapfrog, the
fused ring kernel), "sym" (each pair once across the mesh) or "auto"
(``choose_strategy``). With ``mesh=make_mesh_2d(R, C)`` the R·C ranks run
``make_sharded_step_2d`` (``strategy`` reads "2d"; the mxu variants and
the mesh solvers raise, and so do the strategies "sym", as in
``nbody_tpu``'s CLI, and "ring_fused"). With ``kernel="pm"`` / ``"p3m"`` a
1-D mesh runs ``make_sharded_pm_step`` / ``make_sharded_p3m_step`` whatever
the strategy, ``pm_fft`` "replicated" (a fixed-order sum of the density
grid, a redundant solve a rank) or "slab" (the distributed FFT; D must
divide 2 * pm_grid). On a mesh
``variant="auto"`` is "vpu" and the variant reaches only the allgather Euler
step, as in ``nbody_tpu``. The accessors speak of the whole system on every
rank: ``state``, ``positions``, ``velocities``, ``accelerations()`` and
``accelerations_and_jerks()`` gather; ``set_state`` takes the whole state
and each rank keeps its rows. Every rank must make the same calls.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch import ic
from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.io.checkpoint import load_checkpoint as _load_npz
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.ops.cuda_kernel import (
    DEFAULT_BLOCK_SIZE,
    aj_sym_default_dispatch,
    check_block_size,
    check_sym_tile,
    compute_accel_cuda,
    compute_accel_jerk_cuda,
    compute_accel_jerk_symmetric_blocked_cuda,
    compute_accel_symmetric_blocked_cuda,
    nbody_step_cuda,
    nbody_step_mxu_cuda,
    potential_energy_per_row_cuda,
    sym_default_dispatch,
)
from nbody_tpu_torch.ops.force_graph import ForceGraphs, graph_engages
from nbody_tpu_torch.ops.p3m import (
    check_short_range,
    make_sharded_p3m_step,
    p3m_accel,
    p3m_kernel_blk,
    p3m_max_occupancy,
    p3m_overflow_count,
)
from nbody_tpu_torch.ops.pm import check_assignment, check_slab, make_sharded_pm_step, pm_accel
from nbody_tpu_torch.ops.energy import (
    kinetic_energy,
    potential_energy_per_row,
    total_energy_precise,
)
from nbody_tpu_torch.params import NBodyParams
from nbody_tpu_torch.utils import timing
from nbody_tpu_torch.utils.profiling import annotate
from nbody_tpu_torch.utils.timing import synchronize as _synchronize

# What variant="auto" runs on a CUDA device, for every integrator, where the
# tuner's cache has no entry for the card and N: the variant measured
# faster at N=65536 on an NVIDIA H100 80GB HBM3, 700 W power limit
# (PERF.md). Euler and leapfrog: a sym Euler step through Compute
# 1.537 / 6.369 ms against the one-sided vpu step's 2.279 / 9.500 ms at
# N = 65536 / 135168 (scripts/torch_sym_dispatch.py, medians in turns), and
# the steps through Compute in chip_smoke.py. Hermite, measured on its own kernels:
# the sym accel + jerk 4.208 ms against the one-sided 6.178 ms per
# evaluation (scripts/torch_aj_dispatch.py), 1.39x at N=135168 and 262144.
AUTO_VARIANT_CUDA = "sym"


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist, or this raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (the CLI's --cpu) for the plain "
                "PyTorch path on the host")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def state_from_numpy(pos, vel, *, device, num_bodies: Optional[int] = None,
                     dtype=torch.float32):
    """(pos, vel) (N,4) tensors of `dtype` (float32, the port's state type,
    or float64) on `device` from nbody_tpu's numpy state. Fewer bodies than
    `num_bodies` are padded with zero-mass bodies at the origin, which exert
    no force (as nbody_tpu's BodySystem does). The arrays are converted to
    `dtype` here."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pos = np.asarray(pos, dtype=np_dtype)
    vel = np.asarray(vel, dtype=np_dtype)
    if pos.ndim != 2 or pos.shape[1] != 4 or vel.shape != pos.shape:
        raise ValueError(
            f"state must be two (N, 4) arrays; got {pos.shape} and {vel.shape}")
    n = pos.shape[0] if num_bodies is None else int(num_bodies)
    pad = n - pos.shape[0]
    if pad < 0:
        raise ValueError(f"state has {pos.shape[0]} bodies > allocated {n}")
    if pad:
        pos = np.pad(pos, ((0, pad), (0, 0)))
        vel = np.pad(vel, ((0, pad), (0, 0)))
    return torch.tensor(pos, device=device), torch.tensor(vel, device=device)


def load_checkpoint(path, *, device):
    """Read an npz checkpoint written by ``nbody_tpu.io.save_checkpoint``
    (through the port's own reader); returns (pos, vel, params, meta) with
    the state on `device`."""
    pos, vel, params, meta = _load_npz(path)
    pos, vel = state_from_numpy(pos, vel, device=resolve_device(device))
    return pos, vel, params, meta


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# the strategies of an fp32 system on a 1-D mesh; a float64 one takes the
# first three (ring_fused and sym are float32 kernels)
MESH_STRATEGIES = ("auto", "allgather", "ring", "ring_fused", "sym")


def check_mesh(mesh, device: torch.device, strategy: str, *,
               strategies: tuple = MESH_STRATEGIES, axes_error: str | None = None,
               strategy_error: str | None = None, strategy_2d_error: str | None = None) -> int:
    """Validate a body mesh for a system on `device` and its `strategy` by
    ``nbody_tpu``'s rules; return the mesh size (rows·cols for a 2-D mesh).
    On a 1-D mesh the strategy is one of `strategies`; a 2-D mesh is its
    own communication pattern, which ``nbody_tpu``'s fp32 system runs
    whatever its strategy (the port refuses sym, as that CLI does, and
    ring_fused, the 1-D ring's kernel) and its ds system only at "auto"
    (`strategy_2d_error`, raised for any other). `axes_error`
    and `strategy_error` replace the messages for a mesh of other than one
    or two axes and for a strategy outside `strategies` (the ds system's
    texts, which refuse ring_fused and sym as fp32 paths)."""
    names = tuple(getattr(mesh, "axis_names", ()))
    if len(names) not in (1, 2):
        raise ValueError(axes_error or f"a system shards over a 1-D body mesh "
                         f"(parallel.make_mesh); got axes {names}")
    if len(names) == 2 and strategy_2d_error and strategy != "auto":
        raise ValueError(strategy_2d_error)
    if strategy not in strategies:
        raise ValueError(strategy_error or f"unknown strategy {strategy!r}")
    if len(names) == 2 and strategy in ("ring_fused", "sym"):
        # nbody_tpu/cli.py:615-618 for sym; ring_fused is the 1-D ring's
        # kernel likewise, which a grid cannot run
        raise ValueError(f"strategy={strategy!r} uses the 1-D body mesh; a 2-D mesh is its "
                         "own decomposition (leave strategy at 'auto')")
    if mesh.device != device:
        raise ValueError(f"the mesh's shards live on {mesh.device}, the system on {device}")
    return int(mesh.size)


def device_block_size(block_size, device: torch.device) -> int:
    """A system's block size on `device`: on a card held to the kernels'
    rule (``check_block_size``); on the CPU, which has no thread blocks and
    ignores it (as nbody_tpu's XLA path ignores --blockSize), any positive
    int."""
    if device.type == "cuda":
        return check_block_size(block_size)
    bs = int(block_size)
    if bs < 1:
        raise ValueError(f"block_size must be positive; got {block_size}")
    return bs


class BodySystem:
    """Owns the (pos, vel) state and advances it with the selected backend."""

    def __init__(
        self,
        num_bodies: int,
        params: NBodyParams,
        *,
        device="cuda",
        backend: str = "auto",
        block_size: Optional[int] = None,
        tile: Optional[int] = None,
        placement: str = "device",
        variant: str = "auto",
        integrator: str = "euler",
        kernel: str = "auto",
        pm_grid: int = 64,
        pm_assignment: str = "cic",
        pm_fft: str = "replicated",
        p3m_capacity: Optional[int] = None,
        p3m_short_range: str = "auto",
        p3m_auto_refresh: bool = False,
        dtype=torch.float32,
        mesh=None,
        strategy: str = "auto",
        config: NBodyConfig = NBodyConfig.SHELL,
        seed: int = 42,
        state: Optional[tuple] = None,
    ):
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {dtype}")
        fp64 = dtype == torch.float64
        ndev = 1 if mesh is None else check_mesh(mesh, self.device, strategy)
        two_d = mesh is not None and len(mesh.axis_names) == 2
        if fp64 and mesh is not None and strategy in ("ring_fused", "sym"):
            # nbody_tpu/cli.py:626-631: float32 kernel paths there too
            raise ValueError(
                f"strategy={strategy!r} is a float32 kernel path; it does not combine with "
                "dtype float64 (allgather, ring and auto run the double kernels)")
        # the requests before resolution, which switch_precision carries
        self._requested_backend = backend
        self._requested_variant = variant
        self._requested_strategy = strategy
        self._requested_kernel = kernel
        if backend in ("pm", "p3m"):
            raise ValueError(
                f"backend={backend!r} names an algorithm; the port's backend is the "
                f"implementation ('cuda', 'torch' or 'auto'): pass kernel={backend!r}")
        if kernel not in ("auto", "pm", "p3m"):
            raise ValueError(f"unknown kernel {kernel!r}")
        mesh_solver = kernel in ("pm", "p3m")
        check_assignment(pm_assignment)
        check_short_range(p3m_short_range)
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "cuda" if self.device.type == "cuda" else "torch"
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device; got {self.device}")
        if variant not in ("auto", "vpu", "sym", *reference.MXU_VARIANTS):
            raise ValueError(f"unknown kernel variant {variant!r}")
        if integrator not in ("euler", "leapfrog", "hermite"):
            raise ValueError(f"unknown integrator {integrator!r}")
        if fp64 and variant == "sym":
            # nbody_tpu/models/body_system.py:176-181: sym is its Pallas
            # kernel, and its fp64 is the XLA path
            raise ValueError(
                "variant='sym' runs the float32 each-pair-once kernels; fp64 runs "
                "the one-sided double kernels: use variant='auto' or 'vpu'")
        if integrator == "hermite" and mesh_solver:
            raise ValueError(
                "integrator='hermite' needs the jerk of the exact pairwise "
                "force, which the mesh solvers do not provide; use euler "
                f"or leapfrog with kernel={kernel!r}")
        if mesh is not None:
            # nbody_tpu/models/body_system.py:184-189, 229-236, 244-264
            if mesh_solver and two_d:
                raise ValueError("the mesh solvers shard over a 1-D body mesh; use a 1-D "
                                 "mesh with kernel='pm'/'p3m'")
            if mesh_solver:
                check_slab(pm_fft, int(pm_grid), ndev)
            if variant == "sym":
                raise ValueError(
                    "variant='sym' is single-device (the reaction "
                    "accumulator is chip-local); for the each-pair-once "
                    "saving on a mesh use strategy='sym' instead")
            if two_d and variant not in ("vpu", "auto"):
                raise ValueError("the 2-D decomposition uses the accel-only kernels (no mxu "
                                 "variants); leave variant at 'vpu'/'auto'")
            if placement == "host":
                raise ValueError("placement='host' is a single-device placement; a mesh keeps "
                                 "each shard in its device's memory")
            if variant == "auto":
                variant = "vpu"
        if fp64 and variant != "vpu":
            # nbody_tpu's fp64 XLA path ignores the variant: auto and the
            # mxu variants run the one-sided force
            variant = "vpu"
        if (variant == "auto" and backend == "cuda" and mesh is None and not fp64
                and kernel == "auto"):
            from nbody_tpu_torch import tune

            family = "hermite" if integrator == "hermite" else "euler"
            variant, block_size, tile = tune.resolve_cached(
                tune.best_config(int(num_bodies), family=family), block_size=block_size,
                tile=tile)
        if variant == "auto":
            variant = AUTO_VARIANT_CUDA if self.device.type == "cuda" else "vpu"
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement {placement!r}")
        check_slab(pm_fft, int(pm_grid), 1)

        self.backend = backend
        self.variant = variant
        self.integrator = integrator
        self.kernel = kernel
        self.pm_grid = int(pm_grid)
        self.pm_assignment = pm_assignment
        self.pm_fft = pm_fft
        self.p3m_capacity = None if p3m_capacity is None else int(p3m_capacity)
        # "auto" is the pair kernel on every device, where nbody_tpu's is its
        # cell-list engine off a TPU (ROADMAP.md, deviations)
        self.p3m_short_range = "pallas" if p3m_short_range == "auto" else p3m_short_range
        self.p3m_auto_refresh = bool(p3m_auto_refresh)
        # the auto-refresh's rewinds: (step of the call, capacity before, after)
        self.p3m_refreshes = []
        self._p3m_contract_warned = False
        # the one-device mesh-solver force, replayed as a CUDA graph where
        # graph_engages allows; its calls by kind in force_calls
        self._force_graphs = ForceGraphs(graph_engages(
            self.device, mesh=mesh, kernel=kernel, backend=backend,
            short_range=self.p3m_short_range))
        self.dtype = dtype
        self.placement = placement
        self.block_size = (DEFAULT_BLOCK_SIZE if block_size is None
                           else device_block_size(block_size, self.device))
        self.tile = None if tile is None else check_sym_tile(tile)
        # N rounded up so the body shards divide evenly (nbody_tpu's rule)
        self.num_bodies = -(-int(num_bodies) // ndev) * ndev
        self.params = params
        self.config = config
        self.seed = seed
        self.mesh = mesh
        self.strategy = strategy
        self._sharded = None
        if two_d:
            from nbody_tpu_torch.parallel import make_sharded_step_2d

            self.strategy = "2d"
            self._sharded = make_sharded_step_2d(
                mesh, axes=mesh.axis_names, backend=backend, block_size=self.block_size,
                integrator=integrator)
        elif mesh is not None and mesh_solver:
            # built at the first step: P3M's capacity auto-sizes from the
            # first state, set below
            pass
        elif mesh is not None:
            from nbody_tpu_torch.parallel import choose_strategy, make_sharded_step

            if strategy == "auto":
                self.strategy = choose_strategy(self.num_bodies, ndev)
            # ring_fused and sym take "auto" to their kernels' wrappers, which
            # on a CPU mesh run the plain versions; "torch" they refuse
            self._sharded = make_sharded_step(
                mesh, backend=(self._requested_backend if self.strategy in ("ring_fused", "sym")
                               else backend),
                strategy=self.strategy, block_size=self.block_size,
                variant=variant, integrator=integrator)

        shape = (self.num_bodies // ndev, 4)

        def empty():
            return torch.empty(shape, dtype=dtype, device=self.device)

        # [current, next] ping-pong pairs; self._cur indexes the current one
        self._pos = [empty(), empty()]
        self._vel = [empty(), empty()]
        self._cur = 0
        # bumped by every state change: the block rollout's force chain is
        # valid while it is unchanged (the buffers are rewritten in place)
        self._version = 0
        self._block_chain = None
        if placement == "host":
            pin = self.device.type == "cuda"
            self._host_pos = torch.empty(shape, dtype=dtype, pin_memory=pin)
            self._host_vel = torch.empty(shape, dtype=dtype, pin_memory=pin)

        if state is not None:
            self.set_state(*state)
        else:
            self.reset(params, config, seed=seed)

    # ---- state access ----

    def set_state(self, pos, vel) -> None:
        """Replace the state; arrays or tensors of (N,4), zero-mass padded up
        to num_bodies. On a mesh each rank keeps its own rows."""
        host = self.placement == "host"
        p, v = state_from_numpy(_as_numpy(pos), _as_numpy(vel),
                                device="cpu" if host or self.mesh is not None else self.device,
                                num_bodies=self.num_bodies, dtype=self.dtype)
        if self.mesh is not None:
            from nbody_tpu_torch.parallel import shard_rows

            rows = shard_rows(self.mesh, self.num_bodies)
            self._pos[self._cur].copy_(p[rows])
            self._vel[self._cur].copy_(v[rows])
        elif host:
            self._host_pos.copy_(p)
            self._host_vel.copy_(v)
        else:
            self._pos[self._cur].copy_(p)
            self._vel[self._cur].copy_(v)
        if self.kernel == "p3m":
            self._probe_p3m_capacity(p)
        self._version += 1

    def _mesh_solver_step(self):
        """The sharded step of kernel pm / p3m on a 1-D mesh, made at the
        first step (P3M's with the resolved capacity) and again after a
        refresh."""
        if self._sharded is None:
            if self.kernel == "pm":
                self._sharded = make_sharded_pm_step(
                    self.mesh, grid=self.pm_grid, axis=self.mesh.axis,
                    integrator=self.integrator, assignment=self.pm_assignment,
                    fft=self.pm_fft)
            else:
                self._sharded = make_sharded_p3m_step(
                    self.mesh, grid=self.pm_grid, capacity=self.p3m_capacity,
                    axis=self.mesh.axis, integrator=self.integrator,
                    assignment=self.pm_assignment, fft=self.pm_fft, backend=self.backend,
                    short_range=self.p3m_short_range)
        return self._sharded

    def set_positions(self, pos) -> None:
        """Replace the positions, keeping the velocities (nbody_tpu's
        ``set_positions``)."""
        self.set_state(pos, self.velocities)

    def set_velocities(self, vel) -> None:
        """Replace the velocities, keeping the positions."""
        self.set_state(self.positions, vel)

    def _probe_p3m_capacity(self, pos) -> None:
        """Fail fast when the cell capacity cannot hold this state (an
        overflowing cell drops short-range pairs): the JAX package's
        ``_probe_p3m_capacity``. p3m_capacity=None auto-sizes from the first
        state: the largest massive occupancy + 50 %, rounded up to a multiple
        of 8. Zero-mass padding is inert and not counted."""
        if self.p3m_capacity is None:
            occ = timing.host_read(p3m_max_occupancy(pos, grid=self.pm_grid), "p3m_contract")
            self.p3m_capacity = max(8, -(-int(occ * 1.5 + 1) // 8) * 8)
        overflow = timing.host_read(p3m_overflow_count(pos, grid=self.pm_grid,
                                                       capacity=self.p3m_capacity), "p3m_contract")
        if overflow:
            raise ValueError(
                f"p3m cell capacity {self.p3m_capacity} overflows for "
                f"{overflow} bodies of this state; raise p3m_capacity "
                f"(--p3m-capacity) or the mesh resolution (--pm-grid)")

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        from nbody_tpu_torch.parallel import all_gather_rows

        return all_gather_rows(self.mesh, t)

    @property
    def state(self):
        """The current (pos, vel) tensors: the device buffers, valid until the
        next step, or the host tensors for placement='host'; on a mesh the
        whole state, gathered on the device."""
        if self.placement == "host":
            return self._host_pos, self._host_vel
        pos, vel = self._pos[self._cur], self._vel[self._cur]
        if self.mesh is not None:
            return self._gather(pos), self._gather(vel)
        return pos, vel

    @property
    def positions(self) -> np.ndarray:
        """(N, 4) [x, y, z, m] on the host, a copy."""
        with annotate("nbody.readback"):
            return self.state[0].detach().to("cpu", copy=True).numpy()

    @property
    def velocities(self) -> np.ndarray:
        with annotate("nbody.readback"):
            return self.state[1].detach().to("cpu", copy=True).numpy()

    # ---- parameters ----

    def update_params(self, params: NBodyParams) -> None:
        """Live parameter update: dt, softening and damping are kernel
        arguments, so nothing is rebuilt."""
        self.params = params

    def reset(self, params: NBodyParams, config: NBodyConfig, *,
              seed: Optional[int] = None) -> None:
        """Regenerate the initial conditions with the port's ic from the seed."""
        self.params = params
        self.config = config
        if seed is not None:
            self.seed = seed
        pos, vel = ic.generate(config, self.num_bodies, params.cluster_scale,
                               params.velocity_scale, seed=self.seed,
                               dtype=np.float64 if self.dtype == torch.float64 else np.float32)
        self.set_state(pos, vel)

    # ---- stepping ----

    def _accel(self, pos: torch.Tensor) -> torch.Tensor:
        """Acceleration (N,3) of `pos` with this system's backend and force
        variant. The mesh solvers' comes from the float32 positions, in the
        state's type."""
        with annotate("nbody.force"):
            soft = self.params.softening
            if self.kernel in ("pm", "p3m"):
                return self._force_graphs(*self._mesh_solver_force(pos.shape[0], soft), pos)
            if self.variant == "sym":
                if self.backend == "cuda":
                    return compute_accel_symmetric_blocked_cuda(pos, soft, tile=self.tile)
                cap, tile = sym_default_dispatch(pos.shape[0])
                return reference.compute_accel_symmetric_blocked(
                    pos, soft, block_cap=cap, tile_j=self.tile or tile)
            if self.backend == "cuda":
                return compute_accel_cuda(pos, pos, soft, block_size=self.block_size)
            return reference.compute_accel(pos, soft)

    def _mesh_solver_force(self, n: int, soft):
        """(key, fn) of the one-device mesh-solver force for ``ForceGraphs``:
        fn maps an (N, 4) state to its float32 (N, 3) force, and the key
        holds every value that its launches bake in."""
        grid, assignment = self.pm_grid, self.pm_assignment
        if self.kernel == "pm":
            return ("pm", n, grid, assignment), lambda p: pm_accel(
                p.to(torch.float32), grid=grid, assignment=assignment)
        cap = self.p3m_capacity
        blk = p3m_kernel_blk(cap)
        return ("p3m", n, grid, assignment, cap, blk, float(soft)), lambda p: p3m_accel(
            p.to(torch.float32), soft, grid=grid, capacity=cap, blk=blk, backend=self.backend,
            assignment=assignment, short_range=self.p3m_short_range)[0]

    @property
    def force_calls(self) -> dict:
        """The mesh-solver force's calls by kind (``ops/force_graph.py``):
        {"eager", "replay"} force evaluations and the "capture"s that follow
        a key's eager one; all-pairs forces are not counted."""
        return self._force_graphs.calls

    def _accel_jerk(self, pos: torch.Tensor, vel: torch.Tensor):
        """(acc, jerk), each (N,3), of `pos`, `vel` with this system's
        backend and variant: the Hermite scheme's force evaluation."""
        with annotate("nbody.force"):
            soft = self.params.softening
            if self.variant == "sym":
                if self.backend == "cuda":
                    return compute_accel_jerk_symmetric_blocked_cuda(pos, vel, soft, tile=self.tile)
                cap, tile = aj_sym_default_dispatch(pos.shape[0])
                return reference.compute_accel_jerk_symmetric_blocked(
                    pos, vel, soft, block_cap=cap, tile_j=self.tile or tile)
            if self.backend == "cuda":
                return compute_accel_jerk_cuda(pos, vel, pos, vel, soft, block_size=self.block_size)
            return reference.compute_accel_jerk(pos, vel, soft)

    def _mxu_step(self, pos, vel, dt, damping, out) -> None:
        """The mxu Euler step of (pos, vel) into out: the tensor-core kernel,
        or its plain version with backend='torch'."""
        soft = self.params.softening
        with annotate("nbody.force"):
            if self.backend == "cuda":
                nbody_step_mxu_cuda(pos, vel, dt, soft, damping, variant=self.variant, out=out)
                return
            new_pos, new_vel = reference.nbody_step_mxu(
                pos, vel, dt, soft, damping, mxu_dtype=reference.MXU_DTYPES[self.variant])
            out[0].copy_(new_pos)
            out[1].copy_(new_vel)

    @property
    def mxu_force(self) -> Optional[str]:
        """The mxu variant whose algebra ``accelerations()`` computes (Euler
        with variant mxu or mxu_bf16), else None (the one-sided or sym
        force)."""
        if (self.kernel == "auto" and self.integrator == "euler"
                and self.variant in reference.MXU_VARIANTS
                and (self.mesh is None or self.strategy == "allgather")):
            return self.variant
        return None

    def _step(self, dt: float) -> None:
        p = self.params
        cur, nxt = self._cur, 1 - self._cur
        pos, vel = self._pos[cur], self._vel[cur]
        out = (self._pos[nxt], self._vel[nxt])
        if self.mesh is not None:
            step = self._sharded if self.kernel == "auto" else self._mesh_solver_step()
            for t, r in zip(out, step(pos, vel, dt, p.softening, p.damping)):
                t.copy_(r)
        elif self.integrator in ("leapfrog", "hermite"):
            if self.integrator == "leapfrog":
                new_pos, new_vel = reference.nbody_step_leapfrog(
                    pos, vel, dt, p.softening, p.damping, accel_fn=self._accel)
            else:
                new_pos, new_vel = reference.nbody_step_hermite(
                    pos, vel, dt, p.softening, p.damping, accel_jerk_fn=self._accel_jerk)
            out[0].copy_(new_pos)
            out[1].copy_(new_vel)
        elif self.kernel != "auto":
            reference.integrate_into(pos, vel, self._accel(pos), dt, p.damping, out)
        elif self.variant == "vpu" and self.backend == "cuda":
            with annotate("nbody.force"):
                nbody_step_cuda(pos, vel, dt, p.softening, p.damping,
                                block_size=self.block_size, out=out)
        elif self.variant in reference.MXU_VARIANTS:
            self._mxu_step(pos, vel, dt, p.damping, out)
        else:
            reference.integrate_into(pos, vel, self._accel(pos), dt, p.damping, out)
        self._cur = nxt
        self._version += 1

    def _advance_to(self, pos, vel) -> None:
        """Make (pos, vel) the current state: written into the other
        ping-pong buffers, which become the current ones."""
        nxt = 1 - self._cur
        self._pos[nxt].copy_(pos)
        self._vel[nxt].copy_(vel)
        self._cur = nxt
        self._version += 1

    def update(self, dt: Optional[float] = None) -> None:
        """Advance one step (dt defaults to params.time_step)."""
        self.update_many(1, dt)

    def update_many(self, steps: int, dt: Optional[float] = None) -> None:
        """Advance `steps` steps: one launch per step, queued on the current
        stream with no host synchronisation in between. With
        placement='host' the state is copied in once and back once.

        With kernel='p3m' each step also probes the capacity contract on the
        device (``p3m_overflow_count`` of the new state > 0, no FFT, no pair
        math; on a mesh of the gathered state), and device tensors keep the
        first breached step and its state; they are read once, after the
        steps. A breach warns once per breach episode, as the JAX package's
        probed rollout does (``update_many``,
        ``nbody_tpu/models/body_system.py:907-960``), or with
        p3m_auto_refresh rewinds to the breached state (every step before
        it kept the contract), re-sizes the capacity from it and runs the
        remaining steps."""
        dt = self.params.time_step if dt is None else dt
        host = self.placement == "host"
        if host:
            self._pos[self._cur].copy_(self._host_pos, non_blocking=True)
            self._vel[self._cur].copy_(self._host_vel, non_blocking=True)
        done = 0
        while done < steps:
            first = self._probed_steps(steps - done, dt)
            if first < 0:
                self._p3m_contract_warned = False
                break
            if self.p3m_auto_refresh:
                # resume from the state of the first breached step
                with annotate("nbody.p3m.refresh"):
                    self._pos[self._cur].copy_(self._snapshot[0])
                    self._vel[self._cur].copy_(self._snapshot[1])
                    before = self.p3m_capacity
                    self.refresh_p3m_contract()
                self.p3m_refreshes.append((done + first, before, self.p3m_capacity))
                done += first + 1
                continue
            if not self._p3m_contract_warned:
                import warnings

                warnings.warn(
                    f"p3m contract broken mid-rollout: first breach at step {done + first} "
                    f"of {steps} — short-range terms have been dropped since. Call "
                    "refresh_p3m_contract() and re-run, enable p3m_auto_refresh "
                    "(--p3m-auto-refresh), or raise --p3m-capacity / --pm-grid.",
                    stacklevel=2,
                )
                self._p3m_contract_warned = True
            break
        self._snapshot = None
        if host:
            # a copy into pageable or pinned host memory without
            # non_blocking waits for the steps to finish
            self._host_pos.copy_(self._pos[self._cur])
            self._host_vel.copy_(self._vel[self._cur])

    def _probed_steps(self, steps: int, dt) -> int:
        """`steps` steps; with kernel='p3m' the first breached step of them
        (-1 if none, always -1 otherwise), read once after the steps, and
        with p3m_auto_refresh its state in ``_snapshot``."""
        probed = self.kernel == "p3m" and steps > 0
        if probed:
            first = torch.full((), -1, dtype=torch.int64, device=self.device)
            snap = None
        for i in range(steps):
            with annotate("nbody.step"):
                self._step(dt)
            if not probed:
                continue
            with annotate("nbody.p3m.probe"):
                pos = self._pos[self._cur]
                newly = (first < 0) & self._p3m_breach(pos)
                first = torch.where(newly, i, first)
                if self.p3m_auto_refresh:
                    state = (pos, self._vel[self._cur])
                    snap = ([t.clone() for t in state] if snap is None
                            else [torch.where(newly, t, k) for t, k in zip(state, snap)])
        self._snapshot = snap if probed else None
        if not probed:
            return -1
        with annotate("nbody.p3m.probe"):
            return timing.host_read(first, "p3m_probe")

    # steps (adaptive) or substeps (block) of one rollout segment, whose stats
    # are read once: nbody_tpu's segment off the TPU
    # (models/body_system.py:888-905)
    _MAX_ROLLOUT_SEGMENT = 1000

    def _p3m_breach(self, pos) -> torch.Tensor:
        """The P3M contract probe of `pos` (this rank's shard on a mesh) as a
        device bool: a cell over the capacity (``_probed_steps``' probe)."""
        whole = self._gather(pos) if self.mesh is not None else pos
        return p3m_overflow_count(whole.to(torch.float32), grid=self.pm_grid,
                                  capacity=self.p3m_capacity) > 0

    def update_many_adaptive(self, steps: int, *, eta: float = 0.025,
                             dt_min: Optional[float] = None,
                             dt_max: Optional[float] = None) -> dict:
        """Advance `steps` steps with a global adaptive timestep
        (``ops/adaptive.py``), ``nbody_tpu``'s ``update_many_adaptive``
        (``models/body_system.py:993-1113``). The criterion is
        eta*sqrt(softening/max|a|) for euler and leapfrog (the leapfrog in
        its KDK form, the acceleration carried between steps) and Aarseth's
        eta*min|a|/|j| for hermite, clipped to [dt_min, dt_max]; dt_max
        defaults to params.time_step and dt_min to dt_max/1024. dt stays on
        the device: the steps are queued with no host synchronisation and
        each segment of up to 1000 steps reads its stats once
        (``host_read``, "adaptive_stats"). Returns {"t", "dt_last",
        "dt_lo", "dt_hi", "steps"}.

        Every force runs: the variant's (sym, vpu; the mxu variants' Euler
        takes the one-sided force), fp32 or float64, pm and p3m, host
        placement, and on a mesh every strategy but ring_fused (the fixed-dt
        update is fused into its kernel) and the 2-D grid. With kernel='p3m'
        each step probes the contract as ``update_many`` does; a breach warns
        once, or with p3m_auto_refresh rewinds to the breached step, re-sizes
        and resumes, accounting the simulated time through that step.
        Each call evaluates the starting force once (leapfrog), so batch
        frames into one call."""
        from nbody_tpu_torch.ops.adaptive import merge_stats, new_totals

        if self.mesh is not None and self.strategy == "ring_fused":
            raise ValueError(
                "strategy='ring_fused' fuses the fixed-dt Euler "
                "update into its kernel; use allgather/ring/auto "
                "for adaptive rollouts")
        p = self.params
        if dt_max is None:
            dt_max = p.time_step
        if dt_min is None:
            dt_min = dt_max / 1024.0
        if not (0.0 < dt_min <= dt_max):
            raise ValueError(f"need 0 < dt_min <= dt_max, got [{dt_min}, {dt_max}]")
        if not eta > 0.0:   # also rejects NaN
            raise ValueError(f"need eta > 0, got {eta}")
        host = self.placement == "host"
        probed = self.kernel == "p3m"
        totals = new_totals(dt_max, steps)

        if host:
            self._pos[self._cur].copy_(self._host_pos, non_blocking=True)
            self._vel[self._cur].copy_(self._host_vel, non_blocking=True)
        done = 0
        while done < steps:
            seg = min(steps - done, self._MAX_ROLLOUT_SEGMENT)
            run = self._adaptive_rollout_fn(seg, eta, dt_min, dt_max)
            with annotate("nbody.adaptive_rollout", f"seg={seg}"):
                out = run(self._pos[self._cur], self._vel[self._cur])
            if not probed:
                self._advance_to(*out[:2])
                merge_stats(totals, timing.host_read(out[2], "adaptive_stats"))
                done += seg
                continue
            npos, nvel, stats, first, bp, bv, bst = out
            # one read: the stats, the first breached step, the stats through it
            got = timing.host_read(torch.cat([stats.double(), first.double()[None], bst.double()]),
                                   "adaptive_stats")
            first = int(got[4])
            done += seg
            if first < 0:
                self._advance_to(npos, nvel)
                merge_stats(totals, got[:4])
                self._p3m_contract_warned = False
                continue
            if self.p3m_auto_refresh:
                # rewind to the state of the first breached step, and account
                # the simulated time through it
                self._advance_to(bp, bv)
                merge_stats(totals, got[5:])
                before = self.p3m_capacity
                self.refresh_p3m_contract()
                self.p3m_refreshes.append((done - seg + first, before, self.p3m_capacity))
                done -= seg - first - 1
                continue
            self._advance_to(npos, nvel)
            merge_stats(totals, got[:4])
            if not self._p3m_contract_warned:
                import warnings

                warnings.warn(
                    f"p3m contract broken mid-rollout: first breach "
                    f"at adaptive step {done - seg + first} of "
                    f"{steps} — short-range terms have been dropped "
                    "since. Call refresh_p3m_contract() and re-run, "
                    "enable p3m_auto_refresh (--p3m-auto-refresh), "
                    "or raise --p3m-capacity / --pm-grid.",
                    stacklevel=2,
                )
                self._p3m_contract_warned = True
        if host:
            self._host_pos.copy_(self._pos[self._cur])
            self._host_vel.copy_(self._vel[self._cur])
        return totals

    def _adaptive_rollout_fn(self, steps: int, eta: float, dt_min: float, dt_max: float):
        """The adaptive rollout of this system: its own force closures on
        one device, the sharded rollouts' on a mesh (the mesh solvers' sharded
        force on a 1-D mesh), with the P3M probe for kernel='p3m'."""
        from nbody_tpu_torch.ops.adaptive import make_adaptive_rollout

        p = self.params
        kw = dict(softening=p.softening, damping=p.damping, eta=eta, dt_min=dt_min,
                  dt_max=dt_max, steps=steps)
        probe = self._p3m_breach if self.kernel == "p3m" else None
        if self.mesh is not None and self.kernel == "auto":
            from nbody_tpu_torch.parallel.sharded import adaptive_rollout_on

            return adaptive_rollout_on(self._sharded, integrator=self.integrator, **kw)
        if self.mesh is not None:
            def accel_fn(p4):
                return self._mesh_solver_step().accel(p4, p.softening)

            return make_adaptive_rollout(self.integrator, accel_fn=accel_fn, mesh=self.mesh,
                                         probe_fn=probe, **kw)
        return make_adaptive_rollout(self.integrator, accel_fn=self._accel,
                                     accel_jerk_fn=self._accel_jerk, probe_fn=probe, **kw)

    def update_many_block(self, macro_steps: int, *, eta: float = 0.025,
                          dt_max: Optional[float] = None, n_classes: int = 4) -> dict:
        """Advance `macro_steps` macro steps of dt_max with per-body block
        timesteps on a power-of-two ladder (``ops/block_timestep.py``),
        ``nbody_tpu``'s ``update_many_block`` (``models/body_system.py:
        1226-1324``): each body at the largest rung dt_max/2^k not exceeding
        its own eta*sqrt(softening/|a_i|), KDK leapfrog per class. dt_max
        defaults to params.time_step. Returns {"t", "rows", "global_rows",
        "k_max", "macro_steps"}, ``nbody_tpu``'s stats: rows is the force
        rows computed, global_rows what a global dt at the deepest occupied
        rung would have computed.

        The exact kernels on one device, damping 1 only, as in
        ``nbody_tpu``: the prefix force is this system's one-sided force
        (its backend's, in its dtype) at (n_active, N), and each macro step
        reads its class counts on the host once (``host_read``,
        "block_counts"). The classifying force is chained across calls
        while the state is unchanged (a state version, which every state
        set and step bumps)."""
        p = self.params
        if self.mesh is not None:
            raise ValueError(
                "block timesteps are single-device (the sharded "
                "composition is rejected on measured numbers — "
                "ARCHITECTURE.md 'Per-body block timesteps'); use "
                "update_many_adaptive on meshes")
        if self.kernel in ("pm", "p3m"):
            raise ValueError(
                "block timesteps drive the exact kernels; pm/p3m take "
                "update_many_adaptive (per-body ladders below the mesh "
                "force's cell-scale error floor are meaningless)")
        if p.damping != 1.0:
            raise ValueError(
                "block timesteps need damping=1.0 (a per-kick damping "
                "is not the reference's per-step multiplier once bodies"
                " kick at different cadences)")
        if dt_max is None:
            dt_max = p.time_step
        if not dt_max > 0:
            raise ValueError(f"need dt_max > 0, got {dt_max}")
        if not eta > 0.0:   # also rejects NaN
            raise ValueError(f"need eta > 0, got {eta}")
        if not 1 <= n_classes <= 16:
            raise ValueError(f"need 1 <= n_classes <= 16, got {n_classes}")
        totals = {"t": 0.0, "rows": 0.0, "global_rows": 0.0, "k_max": 0,
                  "macro_steps": macro_steps}
        s_count = 1 << (n_classes - 1)
        seg_max = max(1, self._MAX_ROLLOUT_SEGMENT // s_count)
        pos, vel = self._device_state()
        chain = self._block_chain
        if chain is not None and chain[0] == self._version and chain[1] == p.softening:
            a0 = chain[2]
        else:
            # the chain's start force (the system's force), billed to neither
            # rows column, as nbody_tpu's
            a0 = self._accel(pos)
        done = 0
        while done < macro_steps:
            seg = min(seg_max, macro_steps - done)
            run = self._block_rollout_fn(seg, eta, dt_max, n_classes)
            with annotate("nbody.block_rollout", f"seg={seg}"):
                pos, vel, a0, stats = run(self._pos[self._cur], self._vel[self._cur], a0)
            self._advance_to(pos, vel)
            totals["t"] += float(stats[0])
            totals["rows"] += float(stats[1])
            totals["global_rows"] += float(stats[2])
            totals["k_max"] = max(totals["k_max"], int(stats[3]))
            done += seg
        if self.placement == "host":
            self._host_pos.copy_(self._pos[self._cur])
            self._host_vel.copy_(self._vel[self._cur])
        self._block_chain = (self._version, p.softening, a0)
        return totals

    def _block_rollout_fn(self, macro_steps: int, eta: float, dt_max: float, n_classes: int):
        """The block rollout on this system's one-sided force, the kernel
        ``nbody_tpu``'s pallas backend plugs into the prefix
        (``body_system.py:1326-1360``): the fp32 or double force kernel at
        (n_active, N) with backend 'cuda', the plain version with 'torch'."""
        from nbody_tpu_torch.ops.block_timestep import make_block_rollout

        soft, bs = self.params.softening, self.block_size
        if self.backend == "cuda":
            def accel_vs(pi, pj):
                return compute_accel_cuda(pi, pj, soft, block_size=bs)
        else:
            def accel_vs(pi, pj):
                return reference.compute_accel_vs(pi, pj, soft)

        return make_block_rollout(softening=soft, eta=eta, dt_max=dt_max, n_classes=n_classes,
                                  macro_steps=macro_steps, accel_vs_fn=accel_vs)

    def refresh_p3m_contract(self) -> None:
        """Re-size the P3M capacity from the current state (the whole state
        on a mesh, where every rank calls it) and rebuild the sharded step:
        the answer to the mid-run contract warning, as ``nbody_tpu``'s
        (``body_system.py:849-860``)."""
        if self.kernel != "p3m":
            raise ValueError("refresh_p3m_contract applies to kernel='p3m'")
        with annotate("nbody.p3m.refresh"):
            self.p3m_capacity = None
            if self.mesh is not None:
                self._sharded = None  # rebuilt at the next step with the new size
            self._p3m_contract_warned = False
            pos = self._device_state()[0]
            self._probe_p3m_capacity(self._gather(pos) if self.mesh is not None else pos)

    def _device_state(self):
        """The current (pos, vel) on the device; with placement='host' the
        host state is copied into the current device buffers first."""
        pos, vel = self._pos[self._cur], self._vel[self._cur]
        if self.placement == "host":
            pos.copy_(self._host_pos)
            vel.copy_(self._host_vel)
        return pos, vel

    def accelerations(self) -> torch.Tensor:
        """Acceleration (N,3) of the current state with this system's backend
        and force variant (a CUDA force kernel or the plain version), on the
        device. For the mxu variants with Euler it is the mxu step's own
        force: there is no force-only mxu kernel, so one fused step from zero
        velocities with dt = 1 and damping = 1, into the other ping-pong
        buffers, leaves v' = a exactly. On a mesh: each shard's force by the
        mesh's strategy (the mxu one through the sharded step alike),
        gathered."""
        pos = self._device_state()[0]
        if self.mesh is not None:
            soft = self.params.softening
            if self.mxu_force is None:
                sharded = self._sharded if self.kernel == "auto" else self._mesh_solver_step()
                return self._gather(sharded.accel(pos, soft))
            vel = self._sharded(pos, torch.zeros_like(pos), 1.0, soft, 1.0)[1]
            return self._gather(vel[:, :3].contiguous())
        if self.mxu_force is None:
            return self._accel(pos)
        nxt = 1 - self._cur
        out = (self._pos[nxt], self._vel[nxt])
        self._mxu_step(pos, torch.zeros_like(pos), 1.0, 1.0, out)
        # a copy: the next step writes these buffers
        return out[1][:, :3].clone()

    def accelerations_and_jerks(self):
        """(acc, jerk), each (N,3), of the current state with this system's
        backend and variant (the accel + jerk kernels or the plain
        versions), on the device."""
        if self.mesh is not None:
            fields = self._sharded.accel_jerk(*self._device_state(), self.params.softening)
            return tuple(self._gather(f) for f in fields)
        return self._accel_jerk(*self._device_state())

    def synchronize(self) -> None:
        """Wait for every queued step to finish."""
        _synchronize(self.device)

    # nbody_tpu's names of the same barrier
    block_until_ready = synchronize
    hard_sync = synchronize

    # ---- precision switch (the reference's Enter key) ----

    def switch_precision(self) -> "BodySystem":
        """A new BodySystem in the other precision (float32 <-> float64) with
        the same state, cast on the host, as ``nbody_tpu``'s
        ``switch_precision`` (``body_system.py:1368-1417``). The requested
        variant and mesh strategy are carried across the hop: a sym variant,
        or a ring_fused or sym strategy, runs "auto" in float64 (they are
        float32 kernels) and again on the way back, so fp32 -> fp64 -> fp32
        restores them; kernel "pm" / "p3m" likewise runs the exact force in
        float64, as ``nbody_tpu``'s hop does."""
        to64 = self.dtype == torch.float32
        self.synchronize()
        requested = self._requested_variant
        strategy = self._requested_strategy
        other = BodySystem(
            self.num_bodies, self.params, device=self.device, backend=self._requested_backend,
            block_size=self.block_size, tile=self.tile, placement=self.placement,
            variant="auto" if to64 and requested == "sym" else requested,
            integrator=self.integrator,
            # nbody_tpu's float64 hop runs its exact XLA force
            # (body_system.py:1375-1381): the double kernels here
            kernel="auto" if to64 else self._requested_kernel, pm_grid=self.pm_grid,
            pm_assignment=self.pm_assignment, pm_fft=self.pm_fft,
            p3m_capacity=self.p3m_capacity, p3m_short_range=self.p3m_short_range,
            p3m_auto_refresh=self.p3m_auto_refresh,
            dtype=torch.float64 if to64 else torch.float32,
            mesh=self.mesh,
            strategy="auto" if to64 and strategy in ("ring_fused", "sym") else strategy,
            config=self.config, seed=self.seed, state=(self.positions, self.velocities))
        other._requested_variant = requested
        other._requested_strategy = strategy
        other._requested_kernel = self._requested_kernel
        return other

    # ---- diagnostics ----

    def total_energy(self, *, precise: bool = False) -> float:
        """Kinetic + softened potential energy of the current state.

        The default is the fast diagnostic in the state's type: the per-row
        pair sums of the potential kernel (the double one in fp64; the plain
        version with backend='torch'), summed on the device, plus the kinetic
        term. precise=True is
        ``total_energy_precise``, the float64 functional for drift
        comparisons, where fp32 summation noise at N >= 65k is of the order
        of the drifts themselves."""
        soft = self.params.softening
        if precise:
            return total_energy_precise(*self.state, soft, device=self.device)
        pos, vel = self.state if self.mesh is not None else self._device_state()
        if self.backend == "cuda":
            per_row = potential_energy_per_row_cuda(pos, soft)
        else:
            per_row = potential_energy_per_row(pos, soft)
        return float(kinetic_energy(pos, vel) - 0.5 * torch.sum(per_row))
