"""BodySystem: simulation state on a torch device, and stepping.

Counterpart of ``nbody_tpu/models/body_system.py`` for the port's first
slice: fp32, damped semi-implicit Euler, one device, the one-sided kernel.

State lives in two preallocated pairs of (pos, vel) buffers, the reference's
ping-pong double buffer: a step reads one pair and writes the other, so the
fused kernel never writes the array it reads the j-bodies from. (The JAX
package gets the same effect from a donated ``lax.scan``.)

Backends:
  * "cuda"  — the hand-written CUDA step kernel (``ops/cuda_kernel.py``)
  * "torch" — the plain PyTorch step (``ops/reference.py``), on any device
  * "auto"  — "cuda" on a CUDA device, else "torch"

Placements (the reference's BodySystemCUDA variants):
  * "device" — state stays in device memory between calls
  * "host"   — state lives in host memory (pinned when the device is a CUDA
    card); each ``update`` / ``update_many`` call copies it to the device
    once, steps there, and copies it back: the HostMemory body system.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from nbody_tpu import ic
from nbody_tpu.config import NBodyConfig
from nbody_tpu.params import NBodyParams
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.ops.cuda_kernel import (
    DEFAULT_BLOCK_SIZE,
    check_block_size,
    compute_accel_cuda,
    nbody_step_cuda,
)
from nbody_tpu_torch.ops.energy import total_energy as _total_energy
from nbody_tpu_torch.utils.timing import synchronize as _synchronize

# Options of nbody_tpu that later slices of the port bring, and the
# ROADMAP.md item that brings each.
LATER_SLICES = {
    "sym": "Queue 1 #3 (main path, each pair once)",
    "fp64": "Queue 1 #5 (fp64)",
    "leapfrog": "Queue 1 #6 (leapfrog + Hermite)",
    "hermite": "Queue 1 #6 (leapfrog + Hermite)",
    "ds": "Queue 1 #8 (double-single precision)",
    "pm": "Queue 1 #10 (PM / P3M)",
    "p3m": "Queue 1 #10 (PM / P3M)",
    "mesh": "Queue 1 #13 (parallel/)",
    "mxu": "Queue 2 #3 (_mxu_step_kernel)",
    "mxu_bf16": "Queue 2 #3 (_mxu_step_kernel)",
}


def not_ported(option: str, value) -> ValueError:
    """The error for an nbody_tpu option that a later slice of the port brings."""
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
    """Read an npz checkpoint written by ``nbody_tpu.io.save_checkpoint``;
    returns (pos, vel, params, meta) with the state on `device`."""
    from nbody_tpu.io.checkpoint import load_checkpoint as _load_npz

    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory, which needs "
                         "JAX; save an npz checkpoint instead")
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
        dtype=torch.float32,
        mesh=None,
        config: NBodyConfig = NBodyConfig.SHELL,
        seed: int = 42,
        state: Optional[tuple] = None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise not_ported("mesh", mesh)
        if backend in ("pm", "p3m"):
            raise not_ported("backend", backend)
        if backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "auto":
            backend = "cuda" if self.device.type == "cuda" else "torch"
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device; got {self.device}")
        if variant in ("sym", "mxu", "mxu_bf16"):
            raise not_ported("variant", variant)
        if variant not in ("auto", "vpu"):
            raise ValueError(f"unknown kernel variant {variant!r}")
        if integrator in ("leapfrog", "hermite"):
            raise not_ported("integrator", integrator)
        if integrator != "euler":
            raise ValueError(f"unknown integrator {integrator!r}")
        if dtype == torch.float64:
            raise not_ported("dtype", "fp64")
        if dtype != torch.float32:
            raise ValueError(f"unsupported dtype {dtype}")
        if placement not in ("device", "host"):
            raise ValueError(f"unknown placement {placement!r}")

        self.backend = backend
        # the one-sided kernel until the each-pair-once slice lands
        self.variant = "vpu"
        self.integrator = integrator
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
        """Regenerate the initial conditions with nbody_tpu.ic from the seed."""
        self.params = params
        self.config = config
        if seed is not None:
            self.seed = seed
        pos, vel = ic.generate(config, self.num_bodies, params.cluster_scale,
                               params.velocity_scale, seed=self.seed,
                               dtype=np.float32)
        self.set_state(pos, vel)

    # ---- stepping ----

    def _step(self, dt: float) -> None:
        p = self.params
        cur, nxt = self._cur, 1 - self._cur
        pos, vel = self._pos[cur], self._vel[cur]
        out = (self._pos[nxt], self._vel[nxt])
        if self.backend == "cuda":
            nbody_step_cuda(pos, vel, dt, p.softening, p.damping,
                            block_size=self.block_size, out=out)
        else:
            new_pos, new_vel = reference.nbody_step(pos, vel, dt, p.softening, p.damping)
            out[0].copy_(new_pos)
            out[1].copy_(new_vel)
        self._cur = nxt

    def update(self, dt: Optional[float] = None) -> None:
        """Advance one step (dt defaults to params.time_step)."""
        self.update_many(1, dt)

    def update_many(self, steps: int, dt: Optional[float] = None) -> None:
        """Advance `steps` steps: one launch per step, queued on the current
        stream with no host synchronisation in between. With
        placement='host' the state is copied in once and back once."""
        dt = self.params.time_step if dt is None else dt
        host = self.placement == "host"
        if host:
            self._pos[self._cur].copy_(self._host_pos, non_blocking=True)
            self._vel[self._cur].copy_(self._host_vel, non_blocking=True)
        for _ in range(steps):
            self._step(dt)
        if host:
            # a copy into pageable or pinned host memory without
            # non_blocking waits for the steps to finish
            self._host_pos.copy_(self._pos[self._cur])
            self._host_vel.copy_(self._vel[self._cur])

    def accelerations(self) -> torch.Tensor:
        """Acceleration (N,3) of the current state with this system's backend
        (the CUDA force kernel or the plain version), on the device."""
        pos = self._pos[self._cur]
        if self.placement == "host":
            pos.copy_(self._host_pos)
        soft = self.params.softening
        if self.backend == "cuda":
            return compute_accel_cuda(pos, pos, soft, block_size=self.block_size)
        return reference.compute_accel(pos, soft)

    def synchronize(self) -> None:
        """Wait for every queued step to finish."""
        _synchronize(self.device)

    # ---- diagnostics ----

    def total_energy(self) -> float:
        """Kinetic + softened potential energy of the current state (plain
        PyTorch, in the state's float32)."""
        pos, vel = self.state
        return float(_total_energy(pos, vel, self.params.softening))
