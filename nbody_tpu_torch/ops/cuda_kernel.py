"""Wrappers of the hand-written CUDA kernels (``csrc/nbody_kernels.cu``).

Counterparts of ``nbody_step_pallas_vs`` / ``nbody_step_pallas`` /
``compute_accel_pallas`` (``nbody_tpu/ops/pallas_kernel.py``), with the
reference's ``block_size`` (threads per block, and j-bodies per shared-memory
tile) in place of the Pallas ``tile_i`` / ``tile_j``.

For a CUDA tensor a wrapper launches its kernel on PyTorch's current stream,
or raises: when the library cannot be built or loaded, or the launch returns
a CUDA error. For a CPU tensor it computes the plain version in
``ops/reference.py``; that is all the CPU path is for. Both paths check
dtype (float32 only, never cast), shape ``(., 4)``, contiguity, 16-byte
alignment (the kernels load ``float4``) and device.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
path went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops import reference

DEFAULT_BLOCK_SIZE = 256

LAUNCHES = {"step": 0, "accel": 0}


def check_block_size(block_size: int) -> int:
    bs = int(block_size)
    if bs < 32 or bs > 1024 or bs % 32:
        raise ValueError(
            f"block_size must be a multiple of 32 in [32, 1024]; got {block_size}")
    return bs


def _check_state(name: str, t, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(
            f"{name} is {t.dtype}; the CUDA kernels are float32 only (no "
            "implicit cast: convert the state explicitly)")
    if t.dim() != 2 or t.shape[1] != 4:
        raise ValueError(f"{name} must have shape (N, 4); got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(
            f"{name} is not 16-byte aligned (storage offset {t.storage_offset()}); "
            "the kernels read each body as one float4")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return False
    a0 = a.data_ptr()
    b0 = b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _raise_on_error(lib, err: int, what: str) -> None:
    if err:
        msg = lib.nbody_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def nbody_step_cuda_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                       *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """Fused step of the i-set (M,4) under forces from the j-set (N,4).

    Returns (new_pos, new_vel), each (M,4). ``out=(new_pos, new_vel)`` writes
    into preallocated tensors, which must not overlap any input: every
    thread block reads all of pos_j while others write their new positions.
    """
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    for name, t in (("pos_i", pos_i), ("vel_i", vel_i), ("pos_j", pos_j)):
        _check_state(name, t, device)
    if vel_i.shape[0] != pos_i.shape[0]:
        raise ValueError(f"vel_i has {vel_i.shape[0]} rows, pos_i {pos_i.shape[0]}")
    bs = check_block_size(block_size)
    m, n = pos_i.shape[0], pos_j.shape[0]
    if out is None:
        out = (torch.empty_like(pos_i), torch.empty_like(vel_i))
    new_pos, new_vel = out
    for name, t in (("out[0]", new_pos), ("out[1]", new_vel)):
        _check_state(name, t, device)
        if t.shape[0] != m:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {m}")
        for src in (pos_i, vel_i, pos_j):
            if _overlaps(t, src):
                raise ValueError(f"{name} overlaps an input of the step")
    if _overlaps(new_pos, new_vel):
        raise ValueError("out[0] and out[1] overlap")

    if device.type != "cuda":
        p, v = reference.nbody_step_vs(pos_i, vel_i, pos_j, dt, softening, damping)
        new_pos.copy_(p)
        new_vel.copy_(v)
        return new_pos, new_vel
    if m == 0:
        return new_pos, new_vel

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_step_f32(
            pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(),
            new_pos.data_ptr(), new_vel.data_ptr(), m, n,
            ctypes.c_float(float(dt)), ctypes.c_float(float(softening) ** 2),
            ctypes.c_float(float(damping)), bs, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_step_f32 launch")
    LAUNCHES["step"] += 1
    return new_pos, new_vel


def nbody_step_cuda(pos, vel, dt, softening, damping,
                    *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """Single-device fused step: forces of the whole set on itself."""
    return nbody_step_cuda_vs(pos, vel, pos, dt, softening, damping,
                              block_size=block_size, out=out)


def compute_accel_cuda(pos_i, pos_j, softening, *, block_size: int = DEFAULT_BLOCK_SIZE):
    """Acceleration (M,3) on the i-set (M,4) due to the j-set (N,4)."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_state("pos_i", pos_i, device)
    _check_state("pos_j", pos_j, device)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return reference.compute_accel_vs(pos_i, pos_j, softening)

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    m, n = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty((m, 3), dtype=torch.float32, device=device)
    if m == 0:
        return acc
    with torch.cuda.device(device):
        err = lib.nbody_accel_f32(
            pos_i.data_ptr(), pos_j.data_ptr(), acc.data_ptr(), m, n,
            ctypes.c_float(float(softening) ** 2), bs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_accel_f32 launch")
    LAUNCHES["accel"] += 1
    return acc
