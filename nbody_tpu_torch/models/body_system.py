"""BodySystem: simulation state on a torch device, and stepping.

Counterpart of ``nbody_tpu/models/body_system.py`` for the port's slices so
far: fp32 or fp64 (``dtype=torch.float64``, below), damped semi-implicit
Euler, leapfrog or 4th-order Hermite, the one-sided force
(``variant="vpu"``), the each-pair-once force
(``variant="sym"``) or the force reduction on the tensor cores
(``variant="mxu"`` / ``"mxu_bf16"``, Euler), the P3M fast mode
(``kernel="p3m"``, Euler and leapfrog, one device), the energy diagnostics,
and a 1-D body mesh (``mesh=``, ``strategy=``, below).

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
  * "auto" — AUTO_VARIANT_CUDA on a CUDA device, else "vpu" (the JAX package
    resolves to its Pallas sym path only on the TPU, and to an mxu variant
    only from its TPU autotuner's cache, ROADMAP.md Queue 1 #12)

fp64 (``dtype=torch.float64``): the state, its ping-pong and host buffers
are float64, and every integrator runs on the double kernels
(``csrc/f64_kernels.cu``) with backend "cuda", on the plain versions in
float64 with "torch": nbody_tpu's fp64 is its XLA path, so ``variant="auto"``
resolves to "vpu", "sym" (Pallas-only there) raises, and "mxu" / "mxu_bf16"
run the one-sided kernels, as that path ignores them. On a mesh float64
runs allgather, ring, auto and the 2-D step; the ring_fused and sym
strategies raise (float32 kernels). ``kernel="p3m"`` raises: in float64 it
is a later slice (ROADMAP.md Queue 1 #16). ``switch_precision()`` hops
between float32 and float64 with the same state, as the reference's Enter
key does.

Integrators: "euler" (damped semi-implicit), "leapfrog" (drift-kick-drift
around one force evaluation of the variant's force) and "hermite" (the
4th-order P(EC) predictor-corrector, two accel + jerk evaluations of the
variant a step: the one-sided accel + jerk kernel for "vpu", the
each-pair-once triangle and rectangle for "sym").

Kernels (the algorithm; the JAX package's ``backend`` "pallas" / "xla" /
"pm" / "p3m", the CLI's ``--kernel``; here ``backend`` already names the
implementation, so the algorithm has its own keyword):
  * "auto" — the all-pairs force of the variant above
  * "p3m"  — PM long range + exact short range (``ops/p3m.py``), CIC with
    the optimal influence, on a ``pm_grid``^3 mesh, with Euler or leapfrog;
    the variant is ignored, as in the JAX package. The short range runs the
    pair kernel (``csrc/p3m_kernels.cu``) with backend "cuda", its plain
    version with "torch". ``p3m_capacity`` is the cell capacity: None
    auto-sizes it from the first state (max occupancy + 50 %, a multiple
    of 8), and every state set raises when a cell overflows it; each step
    of ``update_many`` probes the contract on the device and a call that
    breached it warns once, naming the first breached step.

Placements (the reference's BodySystemCUDA variants):
  * "device" — state stays in device memory between calls
  * "host"   — state lives in host memory (pinned when the device is a CUDA
    card); each ``update`` / ``update_many`` call copies it to the device
    once, steps there, and copies it back: the HostMemory body system.
    One device only: a mesh with placement="host" raises.

Meshes (``parallel/``): with ``mesh=make_mesh(D)`` each of the D ranks
holds N/D bodies (N rounded up to a multiple of D with zero-mass bodies, as
``nbody_tpu`` rounds it) and steps them with ``make_sharded_step``, by
``strategy`` "allgather", "ring", "ring_fused" (Euler and leapfrog, the
fused ring kernel), "sym" (each pair once across the mesh) or "auto"
(``choose_strategy``). With ``mesh=make_mesh_2d(R, C)`` the R·C ranks run
``make_sharded_step_2d`` (``strategy`` reads "2d"; the mxu variants and
P3M raise, and so do the strategies "sym", as in ``nbody_tpu``'s CLI, and
"ring_fused"). On a mesh
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
    compute_accel_cuda,
    compute_accel_jerk_cuda,
    compute_accel_jerk_symmetric_blocked_cuda,
    compute_accel_symmetric_blocked_cuda,
    nbody_step_cuda,
    nbody_step_mxu_cuda,
    potential_energy_per_row_cuda,
    sym_default_dispatch,
)
from nbody_tpu_torch.ops.p3m import p3m_accel, p3m_max_occupancy, p3m_overflow_count
from nbody_tpu_torch.ops.energy import (
    kinetic_energy,
    potential_energy_per_row,
    total_energy_precise,
)
from nbody_tpu_torch.params import NBodyParams
from nbody_tpu_torch.utils.timing import synchronize as _synchronize

# Options of nbody_tpu that later slices of the port bring, and the
# ROADMAP.md item that brings each.
LATER_SLICES = {
    "pm": "Queue 1 #16 (the rest of #10: plain PM, TSC, refresh and the XLA cell list; "
          "P3M in float64; the sharded PM and P3M steps)",
    "mesh": "Queue 1 #13 (the rest of parallel/: the demo loop and --selftest on a mesh)",
    "adaptive": "Queue 1 #7 (adaptive and block timesteps; their sharded rollouts with #13)",
}


# What variant="auto" runs on a CUDA device, for every integrator: the
# variant measured faster at N=65536 on an NVIDIA H100 80GB HBM3, 700 W power
# limit (PERF.md). Euler and leapfrog: a sym Euler step through Compute
# 1.537 / 6.369 ms against the one-sided vpu step's 2.279 / 9.500 ms at
# N = 65536 / 135168 (scripts/torch_sym_dispatch.py, medians in turns), and
# the steps through Compute in chip_smoke.py. Hermite, measured on its own kernels:
# the sym accel + jerk 4.208 ms against the one-sided 6.178 ms per
# evaluation (scripts/torch_aj_dispatch.py), 1.39x at N=135168 and 262144.
AUTO_VARIANT_CUDA = "sym"


def not_ported(option: str, value, *, key: Optional[str] = None) -> ValueError:
    """The error for an nbody_tpu option that a later slice of the port
    brings; `key` names its LATER_SLICES entry when neither the value nor
    the option does."""
    if key is None:
        key = value if isinstance(value, str) and value in LATER_SLICES else option
    return ValueError(
        f"{option}={value!r} is not ported to nbody_tpu_torch yet; "
        f"ROADMAP.md {LATER_SLICES[key]} brings it")


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
        placement: str = "device",
        variant: str = "auto",
        integrator: str = "euler",
        kernel: str = "auto",
        pm_grid: int = 64,
        p3m_capacity: Optional[int] = None,
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
        if backend == "pm":
            raise not_ported("backend", backend)
        if backend == "p3m":
            raise ValueError(
                "backend='p3m' names an algorithm; the port's backend is the "
                "implementation ('cuda', 'torch' or 'auto'): pass kernel='p3m'")
        if kernel == "pm":
            raise not_ported("kernel", kernel)
        if kernel not in ("auto", "p3m"):
            raise ValueError(f"unknown kernel {kernel!r}")
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
        if fp64 and kernel == "p3m":
            raise not_ported("kernel with dtype float64", "p3m", key="pm")
        if fp64 and variant == "sym":
            # nbody_tpu/models/body_system.py:176-181: sym is its Pallas
            # kernel, and its fp64 is the XLA path
            raise ValueError(
                "variant='sym' runs the float32 each-pair-once kernels; fp64 runs "
                "the one-sided double kernels: use variant='auto' or 'vpu'")
        if integrator == "hermite" and kernel == "p3m":
            raise ValueError(
                "integrator='hermite' needs the jerk of the exact pairwise "
                "force, which the mesh solvers do not provide; use euler "
                "or leapfrog with kernel='p3m'")
        if mesh is not None:
            # nbody_tpu/models/body_system.py:184-189, 229-236, 244-264
            if kernel == "p3m" and two_d:
                raise ValueError("the mesh solvers shard over a 1-D body mesh; use a 1-D "
                                 "mesh with kernel='p3m'")
            if kernel == "p3m":
                raise not_ported("mesh with kernel", "p3m", key="pm")
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
        if variant == "auto":
            variant = AUTO_VARIANT_CUDA if self.device.type == "cuda" else "vpu"
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement {placement!r}")

        self.backend = backend
        self.variant = variant
        self.integrator = integrator
        self.kernel = kernel
        self.pm_grid = int(pm_grid)
        self.p3m_capacity = None if p3m_capacity is None else int(p3m_capacity)
        self._p3m_contract_warned = False
        self.dtype = dtype
        self.placement = placement
        self.block_size = (DEFAULT_BLOCK_SIZE if block_size is None
                           else device_block_size(block_size, self.device))
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
            occ = int(p3m_max_occupancy(pos, grid=self.pm_grid))
            self.p3m_capacity = max(8, -(-int(occ * 1.5 + 1) // 8) * 8)
        overflow = int(p3m_overflow_count(pos, grid=self.pm_grid, capacity=self.p3m_capacity))
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
        return self.state[0].detach().to("cpu", copy=True).numpy()

    @property
    def velocities(self) -> np.ndarray:
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
        variant."""
        soft = self.params.softening
        if self.kernel == "p3m":
            return p3m_accel(pos, soft, grid=self.pm_grid, capacity=self.p3m_capacity,
                             backend=self.backend)[0]
        if self.variant == "sym":
            if self.backend == "cuda":
                return compute_accel_symmetric_blocked_cuda(pos, soft)
            cap, tile = sym_default_dispatch(pos.shape[0])
            return reference.compute_accel_symmetric_blocked(
                pos, soft, block_cap=cap, tile_j=tile)
        if self.backend == "cuda":
            return compute_accel_cuda(pos, pos, soft, block_size=self.block_size)
        return reference.compute_accel(pos, soft)

    def _accel_jerk(self, pos: torch.Tensor, vel: torch.Tensor):
        """(acc, jerk), each (N,3), of `pos`, `vel` with this system's
        backend and variant: the Hermite scheme's force evaluation."""
        soft = self.params.softening
        if self.variant == "sym":
            if self.backend == "cuda":
                return compute_accel_jerk_symmetric_blocked_cuda(pos, vel, soft)
            cap, tile = aj_sym_default_dispatch(pos.shape[0])
            return reference.compute_accel_jerk_symmetric_blocked(
                pos, vel, soft, block_cap=cap, tile_j=tile)
        if self.backend == "cuda":
            return compute_accel_jerk_cuda(pos, vel, pos, vel, soft, block_size=self.block_size)
        return reference.compute_accel_jerk(pos, vel, soft)

    def _mxu_step(self, pos, vel, dt, damping, out) -> None:
        """The mxu Euler step of (pos, vel) into out: the tensor-core kernel,
        or its plain version with backend='torch'."""
        soft = self.params.softening
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
            for t, r in zip(out, self._sharded(pos, vel, dt, p.softening, p.damping)):
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
        elif self.kernel == "p3m":
            reference.integrate_into(pos, vel, self._accel(pos), dt, p.damping, out)
        elif self.variant == "vpu" and self.backend == "cuda":
            nbody_step_cuda(pos, vel, dt, p.softening, p.damping,
                            block_size=self.block_size, out=out)
        elif self.variant in reference.MXU_VARIANTS:
            self._mxu_step(pos, vel, dt, p.damping, out)
        else:
            reference.integrate_into(pos, vel, self._accel(pos), dt, p.damping, out)
        self._cur = nxt

    def update(self, dt: Optional[float] = None) -> None:
        """Advance one step (dt defaults to params.time_step)."""
        self.update_many(1, dt)

    def update_many(self, steps: int, dt: Optional[float] = None) -> None:
        """Advance `steps` steps: one launch per step, queued on the current
        stream with no host synchronisation in between. With
        placement='host' the state is copied in once and back once.

        With kernel='p3m' each step also probes the capacity contract on the
        device (``p3m_overflow_count`` of the new state > 0, no FFT, no pair
        math), and a device int keeps the first breached step; it is read
        once, after the steps. A breach warns once per breach episode, as
        the JAX package's probed rollout does (``update_many``,
        ``nbody_tpu/models/body_system.py:907-960``)."""
        dt = self.params.time_step if dt is None else dt
        host = self.placement == "host"
        if host:
            self._pos[self._cur].copy_(self._host_pos, non_blocking=True)
            self._vel[self._cur].copy_(self._host_vel, non_blocking=True)
        probed = self.kernel == "p3m" and steps > 0
        if probed:
            first = torch.full((), -1, dtype=torch.int64, device=self.device)
        for i in range(steps):
            self._step(dt)
            if probed:
                breach = p3m_overflow_count(self._pos[self._cur], grid=self.pm_grid,
                                            capacity=self.p3m_capacity) > 0
                first = torch.where((first < 0) & breach, i, first)
        if host:
            # a copy into pageable or pinned host memory without
            # non_blocking waits for the steps to finish
            self._host_pos.copy_(self._pos[self._cur])
            self._host_vel.copy_(self._vel[self._cur])
        if probed:
            self._report_p3m_breach(int(first), steps)

    def _report_p3m_breach(self, first: int, steps: int) -> None:
        """Warn once per breach episode: `first` is the first breached step
        of a call of `steps` steps, or -1 when the contract held."""
        if first < 0:
            self._p3m_contract_warned = False
            return
        if self._p3m_contract_warned:
            return
        import warnings

        warnings.warn(
            f"p3m contract broken mid-rollout: first breach at step {first} of "
            f"{steps} — short-range terms have been dropped since. Re-create the "
            "system (the capacity auto-sizes from its first state), or raise "
            "--p3m-capacity / --pm-grid (refresh_p3m_contract and "
            "--p3m-auto-refresh: ROADMAP.md Queue 1 #16).",
            stacklevel=3,
        )
        self._p3m_contract_warned = True

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
                return self._gather(self._sharded.accel(pos, soft))
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
        restores them."""
        to64 = self.dtype == torch.float32
        self.synchronize()
        requested = self._requested_variant
        strategy = self._requested_strategy
        other = BodySystem(
            self.num_bodies, self.params, device=self.device, backend=self._requested_backend,
            block_size=self.block_size, placement=self.placement,
            variant="auto" if to64 and requested == "sym" else requested,
            integrator=self.integrator, kernel=self.kernel, pm_grid=self.pm_grid,
            p3m_capacity=self.p3m_capacity, dtype=torch.float64 if to64 else torch.float32,
            mesh=self.mesh,
            strategy="auto" if to64 and strategy in ("ring_fused", "sym") else strategy,
            config=self.config, seed=self.seed, state=(self.positions, self.velocities))
        other._requested_variant = requested
        other._requested_strategy = strategy
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
