"""BodySystem: simulation state on a torch device, and stepping.

Counterpart of ``nbody_tpu/models/body_system.py`` for the port's slices so
far: fp32, one device, damped semi-implicit Euler, leapfrog or 4th-order
Hermite, the one-sided force (``variant="vpu"``), the each-pair-once force
(``variant="sym"``) or the force reduction on the tensor cores
(``variant="mxu"`` / ``"mxu_bf16"``, Euler), the P3M fast mode
(``kernel="p3m"``, Euler and leapfrog), and the energy diagnostics.

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
    "fp64": "Queue 1 #5 (fp64)",
    "pm": "Queue 1 #16 (the rest of #10: plain PM, TSC, refresh and the XLA cell list)",
    "mesh": "Queue 1 #13 (parallel/)",
}


# What variant="auto" runs on a CUDA device, for every integrator: the
# variant measured faster at N=65536 on an NVIDIA H100 80GB HBM3, 700 W power
# limit (PERF.md). Euler and leapfrog: the sym force 1.780 ms against the
# one-sided step's 3.536 ms (scripts/torch_sym_dispatch.py), and the steps
# through Compute in chip_smoke.py. Hermite, measured on its own kernels:
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


def state_from_numpy(pos, vel, *, device, num_bodies: Optional[int] = None):
    """(pos, vel) float32 (N,4) tensors on `device` from nbody_tpu's numpy
    state. Fewer bodies than `num_bodies` are padded with zero-mass bodies at
    the origin, which exert no force (as nbody_tpu's BodySystem does). The
    arrays are converted to float32 here, the port's state type."""
    pos = np.asarray(pos, dtype=np.float32)
    vel = np.asarray(vel, dtype=np.float32)
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
        config: NBodyConfig = NBodyConfig.SHELL,
        seed: int = 42,
        state: Optional[tuple] = None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise not_ported("mesh", mesh)
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
        if integrator == "hermite" and kernel == "p3m":
            raise ValueError(
                "integrator='hermite' needs the jerk of the exact pairwise "
                "force, which the mesh solvers do not provide; use euler "
                "or leapfrog with kernel='p3m'")
        if variant == "auto":
            variant = AUTO_VARIANT_CUDA if self.device.type == "cuda" else "vpu"
        if dtype == torch.float64:
            raise not_ported("dtype", "fp64")
        if dtype != torch.float32:
            raise ValueError(f"unsupported dtype {dtype}")
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement {placement!r}")

        self.backend = backend
        self.variant = variant
        self.integrator = integrator
        self.kernel = kernel
        self.pm_grid = int(pm_grid)
        self.p3m_capacity = None if p3m_capacity is None else int(p3m_capacity)
        self._p3m_contract_warned = False
        self.dtype = torch.float32
        self.placement = placement
        self.block_size = (DEFAULT_BLOCK_SIZE if block_size is None
                           else check_block_size(block_size))
        self.num_bodies = int(num_bodies)
        self.params = params
        self.config = config
        self.seed = seed

        shape = (self.num_bodies, 4)

        def empty():
            return torch.empty(shape, dtype=torch.float32, device=self.device)

        # [current, next] ping-pong pairs; self._cur indexes the current one
        self._pos = [empty(), empty()]
        self._vel = [empty(), empty()]
        self._cur = 0
        if placement == "host":
            pin = self.device.type == "cuda"
            self._host_pos = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
            self._host_vel = torch.empty(shape, dtype=torch.float32, pin_memory=pin)

        if state is not None:
            self.set_state(*state)
        else:
            self.reset(params, config, seed=seed)

    # ---- state access ----

    def set_state(self, pos, vel) -> None:
        """Replace the state; arrays or tensors of (N,4), zero-mass padded up
        to num_bodies."""
        host = self.placement == "host"
        p, v = state_from_numpy(_as_numpy(pos), _as_numpy(vel),
                                device="cpu" if host else self.device,
                                num_bodies=self.num_bodies)
        if host:
            self._host_pos.copy_(p)
            self._host_vel.copy_(v)
        else:
            self._pos[self._cur].copy_(p)
            self._vel[self._cur].copy_(v)
        if self.kernel == "p3m":
            self._probe_p3m_capacity(p)

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

    @property
    def state(self):
        """The current (pos, vel) tensors: the device buffers, valid until the
        next step, or the host tensors for placement='host'."""
        if self.placement == "host":
            return self._host_pos, self._host_vel
        return self._pos[self._cur], self._vel[self._cur]

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
                               dtype=np.float32)
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
                and self.variant in reference.MXU_VARIANTS):
            return self.variant
        return None

    def _step(self, dt: float) -> None:
        p = self.params
        cur, nxt = self._cur, 1 - self._cur
        pos, vel = self._pos[cur], self._vel[cur]
        out = (self._pos[nxt], self._vel[nxt])
        if self.integrator in ("leapfrog", "hermite"):
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
        buffers, leaves v' = a exactly."""
        pos = self._device_state()[0]
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
        return self._accel_jerk(*self._device_state())

    def synchronize(self) -> None:
        """Wait for every queued step to finish."""
        _synchronize(self.device)

    # ---- diagnostics ----

    def total_energy(self, *, precise: bool = False) -> float:
        """Kinetic + softened potential energy of the current state.

        The default is the fast float32 diagnostic: the per-row pair sums of
        the potential kernel (the plain version with backend='torch'),
        summed on the device, plus the kinetic term. precise=True is
        ``total_energy_precise``, the float64 functional for drift
        comparisons, where fp32 summation noise at N >= 65k is of the order
        of the drifts themselves."""
        soft = self.params.softening
        if precise:
            return total_energy_precise(*self.state, soft, device=self.device)
        pos, vel = self._device_state()
        if self.backend == "cuda":
            per_row = potential_energy_per_row_cuda(pos, soft)
        else:
            per_row = potential_energy_per_row(pos, soft)
        return float(kinetic_energy(pos, vel) - 0.5 * torch.sum(per_row))
