"""Wrappers of the hand-written CUDA kernels (``csrc/nbody_kernels.cu``,
``csrc/mxu_kernels.cu``, ``csrc/symmetric_kernels.cu``,
``csrc/symmetric_aj_kernels.cu``, and the double-single
``csrc/ds_kernels.cu``, ``csrc/ds_symmetric_kernels.cu``,
``csrc/ds_aj_kernels.cu`` and ``csrc/ds_symmetric_aj_kernels.cu``).

Counterparts of ``nbody_step_pallas_vs`` / ``nbody_step_pallas`` (the
vpu and, on the tensor cores, the mxu / mxu_bf16 variants) /
``nbody_rollout_pallas`` / ``compute_accel_pallas`` /
``compute_accel_jerk_pallas`` and of the per-row sums of
``potential_energy_pallas`` (``nbody_tpu/ops/pallas_kernel.py``),
with the reference's ``block_size`` (threads per block, and j-bodies per
shared-memory tile) in place of the Pallas ``tile_i`` / ``tile_j``; and of
``compute_accel_symmetric`` / ``_sym_cross`` /
``compute_accel_symmetric_blocked`` and their accel + jerk siblings
``compute_accel_jerk_symmetric`` / ``_aj_sym_cross`` /
``compute_accel_jerk_symmetric_blocked`` (``nbody_tpu/ops/symmetric_kernel.py``),
with one square ``tile`` of 128, 256, 512 or 1024 bodies, and the measured
``sym_default_dispatch`` / ``aj_sym_default_dispatch``; and of the ds
kernels of ``nbody_tpu/ops/ds_kernel.py`` (``_ds_step_kernel``,
``_ds_leapfrog_kernel``, ``_ds_sym_kernel``, ``_ds_sym_cross_kernel``) with
their ``ds_sym_default_dispatch``, and of the ds Hermite step's
(``_ds_accel_jerk_kernel``, ``_ds_aj_sym_kernel``, ``_ds_aj_sym_cross_kernel``)
with ``ds_aj_sym_default_dispatch``; and of the P3M short-range pair
kernel ``_sr_pair_kernel`` (``nbody_tpu/ops/p3m_kernel.py``) in
``csrc/p3m_kernels.cu``, over the tables of ``ops/p3m.py``.

For a CUDA tensor a wrapper launches its kernel on PyTorch's current stream,
or raises: when the library cannot be built or loaded, or the launch returns
a CUDA error. For a CPU tensor it computes the plain version in
``ops/reference.py``, ``ops/energy.py`` or ``ops/ds.py``; that is all the
CPU path is for (``p3m_sr_pairs_cuda``, whose padded rows have no plain
counterpart, raises instead).
Both paths check dtype (float32 only, never cast), shape ``(., 4)``,
contiguity, 16-byte alignment (the kernels load ``float4``) and device.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
path went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

from nbody_tpu_torch.ops import ds, energy, reference

DEFAULT_BLOCK_SIZE = 256

LAUNCHES = {"step": 0, "step_t": 0, "mxu_step": 0, "mxu_bf16_step": 0, "accel": 0,
            "sym": 0, "sym_cross": 0, "accel_jerk": 0, "potential": 0, "aj_sym": 0,
            "aj_sym_cross": 0,
            "ds_step": 0, "ds_leapfrog": 0, "ds_sym": 0, "ds_sym_cross": 0,
            "ds_integrate": 0, "ds_accel_jerk": 0, "ds_aj_sym": 0, "ds_aj_sym_cross": 0,
            "ds_hermite_predict": 0, "ds_hermite_correct": 0, "p3m_sr": 0}

SYM_TILES = (128, 256, 512, 1024)


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


def _step_outs(pos_i, vel_i, pos_j, out):
    """Check the inputs of a fused step and its out=(new_pos, new_vel),
    allocated when None; returns (device, new_pos, new_vel). The outputs
    must not overlap any input: every thread block reads all of pos_j while
    others write their new positions."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    for name, t in (("pos_i", pos_i), ("vel_i", vel_i), ("pos_j", pos_j)):
        _check_state(name, t, device)
    if vel_i.shape[0] != pos_i.shape[0]:
        raise ValueError(f"vel_i has {vel_i.shape[0]} rows, pos_i {pos_i.shape[0]}")
    m = pos_i.shape[0]
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
    return device, new_pos, new_vel


def nbody_step_cuda_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                       *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """Fused step of the i-set (M,4) under forces from the j-set (N,4).

    Returns (new_pos, new_vel), each (M,4). ``out=(new_pos, new_vel)`` writes
    into preallocated tensors, which must not overlap any input.
    """
    device, new_pos, new_vel = _step_outs(pos_i, vel_i, pos_j, out)
    bs = check_block_size(block_size)
    m, n = pos_i.shape[0], pos_j.shape[0]
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


# ---- the force reduction on the tensor cores: csrc/mxu_kernels.cu ----

# variant -> (C entry point, LAUNCHES key)
MXU_KERNELS = {"mxu": ("nbody_mxu_step_f32", "mxu_step"),
               "mxu_bf16": ("nbody_mxu_step_bf16", "mxu_bf16_step")}


def nbody_step_mxu_cuda_vs(pos_i, vel_i, pos_j, dt, softening, damping, *, variant: str,
                           out=None):
    """The fused Euler step of the i-set (M,4) under the j-set (N,4), the
    force reduced as a matrix product on the tensor cores (the kernel of
    ``_mxu_step_kernel``): ``variant="mxu"`` in f32 grade (3xTF32),
    ``"mxu_bf16"`` with bf16 operands and f32 sums. Returns (new_pos,
    new_vel); ``out`` as for ``nbody_step_cuda_vs``. A CPU tensor takes the
    plain version, ``reference.nbody_step_mxu_vs``."""
    entry, key = MXU_KERNELS[reference.check_mxu_variant(variant)]
    device, new_pos, new_vel = _step_outs(pos_i, vel_i, pos_j, out)
    m, n = pos_i.shape[0], pos_j.shape[0]
    if device.type != "cuda":
        p, v = reference.nbody_step_mxu_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                                           mxu_dtype=reference.MXU_DTYPES[variant])
        new_pos.copy_(p)
        new_vel.copy_(v)
        return new_pos, new_vel
    if m == 0:
        return new_pos, new_vel

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(),
            new_pos.data_ptr(), new_vel.data_ptr(), m, n,
            ctypes.c_float(float(dt)), ctypes.c_float(float(softening) ** 2),
            ctypes.c_float(float(damping)), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, f"{entry} launch")
    LAUNCHES[key] += 1
    return new_pos, new_vel


def nbody_step_mxu_cuda(pos, vel, dt, softening, damping, *, variant: str, out=None):
    """Single-device mxu step: forces of the whole set on itself."""
    return nbody_step_mxu_cuda_vs(pos, vel, pos, dt, softening, damping, variant=variant,
                                  out=out)


def nbody_rollout_cuda(pos, vel, dt, softening, damping, *, steps: int,
                       block_size: int = DEFAULT_BLOCK_SIZE):
    """`steps` fused one-sided Euler steps that carry the j-side as the
    planes (4, N) of the positions from step to step (the kernel of
    ``_step_kernel_t``; the counterpart of ``nbody_rollout_pallas``): the
    positions are transposed once, before the first step, and each launch
    writes the planes the next one reads. Equals `steps` launches of
    ``nbody_step_cuda`` at the same block size bit for bit. Returns the new
    (pos, vel), each (N,4); the inputs are not written (steps=0 returns
    them, as ``reference.rollout`` does). No path of the port calls it: on
    the TPU it was measured slower than the step scan (a recorded negative
    result), and PERF.md has its time on the card."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_pair("pos", pos, "vel", vel, device)
    bs = check_block_size(block_size)
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"steps must be >= 0; got {steps}")
    if device.type != "cuda":
        return reference.rollout(pos, vel, dt, softening, damping, steps=steps)
    n = pos.shape[0]
    if steps == 0 or n == 0:
        return pos, vel

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    bufs = [(torch.empty_like(pos), torch.empty_like(vel)) for _ in range(2)]
    # copies, never views: a step writes the planes the step before read,
    # and (4, 1) pos.t() would be pos itself
    planes = [torch.empty((4, n), dtype=torch.float32, device=device) for _ in range(2)]
    planes[0].copy_(pos.t())
    cur = (pos, vel)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for k in range(steps):
            nxt = bufs[k % 2]
            err = lib.nbody_step_t_f32(
                cur[0].data_ptr(), cur[1].data_ptr(), planes[k % 2].data_ptr(),
                nxt[0].data_ptr(), nxt[1].data_ptr(), planes[1 - k % 2].data_ptr(), n,
                ctypes.c_float(float(dt)), ctypes.c_float(float(softening) ** 2),
                ctypes.c_float(float(damping)), bs, stream)
            _raise_on_error(lib, err, "nbody_step_t_f32 launch")
            LAUNCHES["step_t"] += 1
            cur = nxt
    return cur


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


def _check_pair(pos_name, pos, vel_name, vel, device) -> None:
    """A (pos, vel) pair of states: each checked, and the same row count."""
    _check_state(pos_name, pos, device)
    _check_state(vel_name, vel, device)
    if vel.shape[0] != pos.shape[0]:
        raise ValueError(f"{vel_name} has {vel.shape[0]} rows, {pos_name} {pos.shape[0]}")


def compute_accel_jerk_cuda(pos_i, vel_i, pos_j, vel_j, softening,
                            *, block_size: int = DEFAULT_BLOCK_SIZE):
    """(acc, jerk), each (M,3), on the i-set (M,4) due to the j-set (N,4):
    the one-sided accel + jerk kernel (``_accel_jerk_kernel``)."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_pair("pos_i", pos_i, "vel_i", vel_i, device)
    _check_pair("pos_j", pos_j, "vel_j", vel_j, device)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return reference.compute_accel_jerk_vs(pos_i, vel_i, pos_j, vel_j, softening)

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    m, n = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty((m, 3), dtype=torch.float32, device=device)
    jerk = torch.empty((m, 3), dtype=torch.float32, device=device)
    if m == 0:
        return acc, jerk
    with torch.cuda.device(device):
        err = lib.nbody_accel_jerk_f32(
            pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(), vel_j.data_ptr(),
            acc.data_ptr(), jerk.data_ptr(), m, n, ctypes.c_float(float(softening) ** 2),
            bs, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_accel_jerk_f32 launch")
    LAUNCHES["accel_jerk"] += 1
    return acc, jerk


def potential_energy_per_row_cuda(pos, softening, *, block_size: int = DEFAULT_BLOCK_SIZE):
    """(N,) per-row pair-potential sums of the set (N,4), row i holding
    sum_{j != i} m_i m_j / sqrt(r^2 + eps^2), the self pair dropped by its
    index: the potential kernel (``_potential_kernel``). The potential
    energy is -1/2 of their sum."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_state("pos", pos, device)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return energy.potential_energy_per_row(pos, softening)

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    n = pos.shape[0]
    per_row = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return per_row
    with torch.cuda.device(device):
        err = lib.nbody_potential_f32(
            pos.data_ptr(), per_row.data_ptr(), n, ctypes.c_float(float(softening) ** 2), bs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_potential_f32 launch")
    LAUNCHES["potential"] += 1
    return per_row


# ---- each pair once: csrc/symmetric_kernels.cu ----

# The dispatch table of the blocked composition, measured on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit by scripts/torch_sym_dispatch.py (PERF.md,
# Findings), force ms per call at N = 65536 / 135168 / 262144:
#   tile 1024, one triangle        1.780 / 7.371 / 27.348
#   tile 1024, cap 131072          1.780 / 7.456 / 27.564
#   tile 1024, cap 65536           1.780 / 7.746 / 28.359
#   tile 512,  one triangle        1.922 / 8.027 / 30.389
#   tile 256 / 128, cap 65536      2.269 / 3.844 at 65536
# The widest tile wins everywhere (ROWS = 8 i-bodies a thread amortise the
# shuffles). One triangle is fastest, but its scratch grows as 12 N^2 / tile
# bytes (13 GB at N = 2^20); cap 131072 costs at most 1.2 % at the measured
# N and bounds each launch's scratch at 201 MB.
DEFAULT_SYM_TILE = 1024
SYM_BLOCK_CAP = 131072


def sym_default_dispatch(n: int) -> tuple[int, int]:
    """``(block_cap, tile)`` of the each-pair-once force at N bodies: the
    fixed table above, the same at every N so far measured."""
    del n
    return SYM_BLOCK_CAP, DEFAULT_SYM_TILE


def check_sym_tile(tile: int, tiles: tuple = SYM_TILES) -> int:
    t = int(tile)
    if t not in tiles:
        raise ValueError(f"tile must be one of {tiles}; got {tile}")
    return t


def _check_out(name: str, t, shape: tuple, device, inputs) -> None:
    """An output tensor: float32, this exact shape, contiguous, 16-byte
    aligned, on `device`, and overlapping none of `inputs`."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 torch.Tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}; got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned (storage offset {t.storage_offset()})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    for src in inputs:
        if _overlaps(t, src):
            raise ValueError(f"{name} overlaps an input")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sym_accel_cuda(pos, softening, *, tile: int = DEFAULT_SYM_TILE, out=None):
    """(N,4) -> (N,3): the set's acceleration on itself, each pair once over
    the triangle j > i (the kernel of ``_sym_kernel``). ``out`` is an
    optional preallocated (N,3) tensor that must not overlap pos."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_state("pos", pos, device)
    tile = check_sym_tile(tile)
    n = pos.shape[0]
    if out is None:
        out = torch.empty((n, 3), dtype=torch.float32, device=device)
    _check_out("out", out, (n, 3), device, (pos,))
    if device.type != "cuda":
        out.copy_(reference.compute_accel_symmetric(pos, softening))
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch = torch.empty((_cdiv(n, tile), 3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_sym_accel_f32(
            pos.data_ptr(), n, ctypes.c_float(float(softening) ** 2), tile,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_sym_accel_f32 launch")
    LAUNCHES["sym"] += 1
    return out


def sym_cross_cuda(pos_i, pos_j, softening, *, tile: int = DEFAULT_SYM_TILE, out=None):
    """The rectangle of the i-set (Bi,4) and the j-set (Bj,4), each pair once
    and with no mask (the kernel of ``_sym_cross_kernel``): returns
    (acc_i (Bi,4) with w = 0, react_j (3,Bj)), the JAX package's layout.
    ``out=(acc_i, react_j)`` are preallocated tensors of those shapes."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_state("pos_i", pos_i, device)
    _check_state("pos_j", pos_j, device)
    tile = check_sym_tile(tile)
    bi, bj = pos_i.shape[0], pos_j.shape[0]
    if out is None:
        out = (torch.empty((bi, 4), dtype=torch.float32, device=device),
               torch.empty((3, bj), dtype=torch.float32, device=device))
    acc_i, react_j = out
    _check_out("out[0]", acc_i, (bi, 4), device, (pos_i, pos_j))
    _check_out("out[1]", react_j, (3, bj), device, (pos_i, pos_j, acc_i))
    if device.type != "cuda":
        a, r = reference.sym_cross(pos_i, pos_j, softening)
        acc_i.copy_(a)
        react_j.copy_(r)
        return acc_i, react_j

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch_i = torch.empty((_cdiv(bj, tile), 3, bi), dtype=torch.float32, device=device)
    scratch_j = torch.empty((_cdiv(bi, tile), 3, bj), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_sym_cross_f32(
            pos_i.data_ptr(), bi, pos_j.data_ptr(), bj,
            ctypes.c_float(float(softening) ** 2), tile,
            scratch_i.data_ptr(), scratch_j.data_ptr(), acc_i.data_ptr(),
            react_j.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_sym_cross_f32 launch")
    LAUNCHES["sym_cross"] += 1
    return acc_i, react_j


def compute_accel_symmetric_blocked_cuda(pos, softening, *, block_cap: int | None = None,
                                         tile: int | None = None):
    """(N,4) -> (N,3), each pair once at any N: one triangle launch for
    N <= block_cap, else k triangle and k(k-1)/2 cross launches summed in a
    fixed order (``reference.compose_symmetric_blocked``). Defaults from
    ``sym_default_dispatch``."""
    cap, t = sym_default_dispatch(pos.shape[0])
    cap = cap if block_cap is None else int(block_cap)
    t = check_sym_tile(t if tile is None else tile)
    (acc,) = reference.compose_symmetric_blocked(
        (pos,), softening, block_cap=cap, tile_j=t,
        triangle=lambda p, soft: (sym_accel_cuda(p, soft, tile=t),),
        cross=lambda p_i, p_j, soft: sym_cross_cuda(p_i, p_j, soft, tile=t))
    return acc


# ---- accel + jerk, each pair once: csrc/symmetric_aj_kernels.cu ----

# The dispatch table of the blocked accel + jerk composition, its own and
# not the force's: a pair carries 13 values around the warp where the force
# carries 7, a thread holds 13 floats an i-row where the force holds 7
# (ptxas: 48 / 64 / 96 / 168 registers at tile 128 / 256 / 512 / 1024, no
# spills), and the reaction scratch is 6 N^2 / tile floats, twice the
# force's. Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# scripts/torch_aj_dispatch.py (PERF.md, Findings), ms per call at
# N = 65536 / 135168 / 262144:
#   tile 512,  cap 65536           4.208 / 17.654 / 65.255
#   tile 512,  cap 131072          4.208 / 17.407 / 64.825
#   tile 512,  one triangle        4.208 / 17.376 / 65.577
#   tile 1024, cap 65536           4.327 / 19.494 / 68.929
#   tile 1024, one triangle        4.327 / 17.589 / 65.041
#   tile 256 / 128, cap 65536      4.495 / 6.312 at 65536
#   one-sided accel + jerk         6.178 / 24.450 / 90.801 (block 256)
# Tile 512 (ROWS 4: 96 registers and 48 KB a block, 4 blocks an SM) beats
# 1024 (ROWS 8: 168 registers and 96 KB, 2 blocks an SM). Cap 65536 bounds
# a launch's scratch at 201 MB, as the force's table does, for at most
# 1.4 % against the fastest cap at these N.
AJ_SYM_TILE = 512
AJ_SYM_BLOCK_CAP = 65536


def aj_sym_default_dispatch(n: int) -> tuple[int, int]:
    """``(block_cap, tile)`` of the each-pair-once accel + jerk at N bodies:
    the fixed table above, the same at every N so far measured."""
    del n
    return AJ_SYM_BLOCK_CAP, AJ_SYM_TILE


def aj_sym_cuda(pos, vel, softening, *, tile: int = AJ_SYM_TILE, out=None):
    """(N,4), (N,4) -> (acc, jerk), each (N,3): the set's accel + jerk on
    itself, each pair once over the triangle j > i (the kernel of
    ``_aj_sym_kernel``). ``out=(acc, jerk)`` are optional preallocated (N,3)
    tensors that must not overlap the inputs or each other."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_pair("pos", pos, "vel", vel, device)
    tile = check_sym_tile(tile)
    n = pos.shape[0]
    if out is None:
        out = (torch.empty((n, 3), dtype=torch.float32, device=device),
               torch.empty((n, 3), dtype=torch.float32, device=device))
    acc, jerk = out
    _check_out("out[0]", acc, (n, 3), device, (pos, vel))
    _check_out("out[1]", jerk, (n, 3), device, (pos, vel, acc))
    if device.type != "cuda":
        a, j = reference.compute_accel_jerk_symmetric(pos, vel, softening)
        acc.copy_(a)
        jerk.copy_(j)
        return acc, jerk
    if n == 0:
        return acc, jerk

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch = torch.empty((_cdiv(n, tile), 6, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_aj_sym_f32(
            pos.data_ptr(), vel.data_ptr(), n, ctypes.c_float(float(softening) ** 2), tile,
            scratch.data_ptr(), acc.data_ptr(), jerk.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_aj_sym_f32 launch")
    LAUNCHES["aj_sym"] += 1
    return acc, jerk


def aj_sym_cross_cuda(pos_i, vel_i, pos_j, vel_j, softening, *, tile: int = AJ_SYM_TILE,
                      out=None):
    """The accel + jerk rectangle of the i-set (Bi,4) and the j-set (Bj,4),
    each pair once and with no mask (the kernel of ``_aj_sym_cross_kernel``):
    returns (acc_i (Bi,4), jerk_i (Bi,4), both with w = 0, react_acc (3,Bj),
    react_jerk (3,Bj)), the JAX package's layout. ``out`` holds four
    preallocated tensors of those shapes."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_pair("pos_i", pos_i, "vel_i", vel_i, device)
    _check_pair("pos_j", pos_j, "vel_j", vel_j, device)
    tile = check_sym_tile(tile)
    bi, bj = pos_i.shape[0], pos_j.shape[0]
    if out is None:
        out = tuple(torch.empty(shape, dtype=torch.float32, device=device)
                    for shape in ((bi, 4), (bi, 4), (3, bj), (3, bj)))
    inputs = [pos_i, vel_i, pos_j, vel_j]
    for k, (t, shape) in enumerate(zip(out, ((bi, 4), (bi, 4), (3, bj), (3, bj)))):
        _check_out(f"out[{k}]", t, shape, device, inputs)
        inputs.append(t)
    acc_i, jerk_i, r_acc, r_jerk = out
    if device.type != "cuda":
        for t, r in zip(out, reference.aj_sym_cross(pos_i, vel_i, pos_j, vel_j, softening)):
            t.copy_(r)
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch_i = torch.empty((_cdiv(bj, tile), 6, bi), dtype=torch.float32, device=device)
    scratch_j = torch.empty((_cdiv(bi, tile), 6, bj), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_aj_cross_f32(
            pos_i.data_ptr(), vel_i.data_ptr(), bi, pos_j.data_ptr(), vel_j.data_ptr(), bj,
            ctypes.c_float(float(softening) ** 2), tile, scratch_i.data_ptr(),
            scratch_j.data_ptr(), acc_i.data_ptr(), jerk_i.data_ptr(), r_acc.data_ptr(),
            r_jerk.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_aj_cross_f32 launch")
    LAUNCHES["aj_sym_cross"] += 1
    return out


def compute_accel_jerk_symmetric_blocked_cuda(pos, vel, softening, *,
                                              block_cap: int | None = None,
                                              tile: int | None = None):
    """(N,4), (N,4) -> (acc, jerk), each (N,3), each pair once at any N: one
    triangle launch for N <= block_cap, else k triangle and k(k-1)/2 cross
    launches summed in a fixed order (``reference.compose_symmetric_blocked``).
    Defaults from ``aj_sym_default_dispatch``."""
    cap, t = aj_sym_default_dispatch(pos.shape[0])
    cap = cap if block_cap is None else int(block_cap)
    t = check_sym_tile(t if tile is None else tile)
    return reference.compose_symmetric_blocked(
        (pos, vel), softening, block_cap=cap, tile_j=t,
        triangle=lambda p, v, soft: aj_sym_cuda(p, v, soft, tile=t),
        cross=lambda p_i, v_i, p_j, v_j, soft: aj_sym_cross_cuda(p_i, v_i, p_j, v_j, soft,
                                                                  tile=t))


# ---- double-single: csrc/ds_kernels.cu, csrc/ds_symmetric_kernels.cu ----
#
# A ds state is four (N,4) float32 planes pos_hi, pos_lo, vel_hi, vel_lo;
# `scal` is the (2,4) float32 host block of ops/ds.py::scal_ds (Euler) or
# scal_ds_leapfrog (leapfrog), which the kernels read as hi/lo pairs.

_PLANES = ("pos_hi", "pos_lo", "vel_hi", "vel_lo")


def _check_scal(scal, widths=(4,)) -> None:
    """`scal`: a contiguous (2, w) float32 CPU block of ops/ds.py, w in `widths`."""
    if (not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32
            or scal.dim() != 2 or scal.shape[0] != 2 or scal.shape[1] not in widths
            or scal.device.type != "cpu" or not scal.is_contiguous()):
        shapes = " or ".join(f"(2, {w})" for w in widths)
        raise ValueError(f"scal must be the contiguous {shapes} float32 CPU tensor of "
                         "ops/ds.py::scal_ds, scal_ds_leapfrog or scal_ds_hermite")


def _check_planes(names, planes, device) -> None:
    """ds planes: each a state (_check_state), all with one row count."""
    for name, t in zip(names, planes):
        _check_state(name, t, device)
    for name, t in zip(names[1:], planes[1:]):
        if t.shape[0] != planes[0].shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} rows, {names[0]} {planes[0].shape[0]}")


def _ds_outs(out, shapes, device, inputs):
    """Preallocated outputs, or new ones, checked against `inputs` and each
    other."""
    if out is None:
        out = tuple(torch.empty(shape, dtype=torch.float32, device=device) for shape in shapes)
    if len(out) != len(shapes):
        raise ValueError(f"out must hold {len(shapes)} tensors; got {len(out)}")
    inputs = list(inputs)
    for k, (t, shape) in enumerate(zip(out, shapes)):
        _check_out(f"out[{k}]", t, shape, device, inputs)
        inputs.append(t)
    return tuple(out)


def nbody_step_ds_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, scal,
                          *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """One ds Euler step of the i-set (M,4 planes) under the j-set
    (jpos_hi, jpos_lo (N,4)): the kernel of ``_ds_step_kernel``. Returns the
    four new (M,4) planes; ``out`` holds four preallocated ones, which must
    not overlap any input."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(("jpos_hi", "jpos_lo"), (jpos_hi, jpos_lo), device)
    _check_scal(scal)
    bs = check_block_size(block_size)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, jpos_hi, jpos_lo))
    if device.type != "cuda":
        for t, r in zip(out, ds.nbody_step_ds_vs(*planes, jpos_hi, jpos_lo, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_ds_step(
            *(t.data_ptr() for t in (*planes, jpos_hi, jpos_lo, *out)), m, n, scal.data_ptr(),
            bs, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_step launch")
    LAUNCHES["ds_step"] += 1
    return out


def nbody_step_ds_cuda(pos_hi, pos_lo, vel_hi, vel_lo, scal,
                       *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """One ds Euler step of the set on itself (``nbody_step_pallas_ds``)."""
    return nbody_step_ds_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, pos_hi, pos_lo, scal,
                                 block_size=block_size, out=out)


def nbody_step_ds_leapfrog_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo,
                                   jvel_hi, jvel_lo, scal,
                                   *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """One fused ds drift-kick-drift step of the i-set under the j-set,
    both half-drifted from the start of the step: the kernel of
    ``_ds_leapfrog_kernel``. `scal` from ``scal_ds_leapfrog``. Returns the
    four new (M,4) planes."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    jplanes = (jpos_hi, jpos_lo, jvel_hi, jvel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(tuple("j" + name for name in _PLANES), jplanes, device)
    _check_scal(scal)
    bs = check_block_size(block_size)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.nbody_step_ds_leapfrog_vs(*planes, *jplanes, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_ds_leapfrog(
            *(t.data_ptr() for t in (*planes, *jplanes, *out)), m, n, scal.data_ptr(), bs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_leapfrog launch")
    LAUNCHES["ds_leapfrog"] += 1
    return out


def nbody_step_ds_leapfrog_cuda(pos_hi, pos_lo, vel_hi, vel_lo, scal,
                                *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """One fused ds DKD step of the set on itself
    (``nbody_step_pallas_ds_leapfrog``)."""
    return nbody_step_ds_leapfrog_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, pos_hi, pos_lo,
                                          vel_hi, vel_lo, scal, block_size=block_size, out=out)


# The dispatch tables of the ds kernels, their own: a ds pair costs ~225
# FP32-pipe instructions one-sided and ~294 for both sides (against 12 and
# 16 in fp32), a ds pair carries 14 values around the warp, and ptxas gives
# 56 / 72 / 128 / 177 registers at ROWS 1 / 2 / 4 / 8 (no spills). Measured
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# scripts/torch_ds_dispatch.py (PERF.md, Findings), ms per call at
# N = 16384 / 32768 / 65536 / 131072:
#   ds step, block 128                4.029 / 10.224 / 37.011 / 139.302
#   ds step, block 256                5.121 / 10.227 / 35.135 / 136.329
#   ds sym, tile 256, one triangle    1.473 /  5.625 / 22.026 /  87.711
#   ds sym, tile 512, one triangle    1.687 /  5.749 / 21.732 /  85.184
#   ds sym, tile 512, cap 65536           - /      - / 21.732 /  87.090
#   ds sym, tile 128 / 1024, one triangle: 1.556 / 3.897 at 16384
# A thread owns one i-body (one-sided) or ROWS of them (sym), so up to
# N = 32768 the smaller block and tile put more blocks on the 132 SMs; from
# 65536 on the wider ones win. Cap 65536 bounds a launch's scratch
# (ceil(N/512) * 6 * N floats) at 201 MB, as the fp32 tables do, for 2.2 %
# against one triangle at N = 131072.
DS_SMALL_N = 32768
DS_BLOCK_SIZES = (128, 256)  # at N <= DS_SMALL_N, above
DS_SYM_TILES = (256, 512)  # at N <= DS_SMALL_N, above
DS_SYM_BLOCK_CAP = 65536


def ds_default_block_size(n: int) -> int:
    """The one-sided ds kernels' block size at N bodies: the table above."""
    return DS_BLOCK_SIZES[n > DS_SMALL_N]


def ds_sym_default_dispatch(n: int) -> tuple[int, int]:
    """``(block_cap, tile)`` of the each-pair-once ds force at N bodies:
    the table above."""
    return DS_SYM_BLOCK_CAP, DS_SYM_TILES[n > DS_SMALL_N]


def ds_sym_accel_cuda(pos_hi, pos_lo, scal, *, tile: int = DS_SYM_TILES[1]):
    """(N,4) hi/lo planes -> (acc_hi, acc_lo), each (N,3): the set's ds
    acceleration on itself, each pair once over the triangle j > i, the
    i-side and the reaction merged in ds (the kernel of ``_ds_sym_kernel``)."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    _check_planes(_PLANES[:2], (pos_hi, pos_lo), device)
    _check_scal(scal)
    tile = check_sym_tile(tile)
    n = pos_hi.shape[0]
    out = _ds_outs(None, [(n, 3)] * 2, device, (pos_hi, pos_lo))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_accel_symmetric(pos_hi, pos_lo, scal)):
            t.copy_(r)
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch = torch.empty((_cdiv(n, tile), 6, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_sym_accel(
            pos_hi.data_ptr(), pos_lo.data_ptr(), n, scal.data_ptr(), tile, scratch.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_sym_accel launch")
    LAUNCHES["ds_sym"] += 1
    return out


def ds_sym_cross_cuda(pos_hi_i, pos_lo_i, pos_hi_j, pos_lo_j, scal, *,
                      tile: int = DS_SYM_TILES[1]):
    """The ds rectangle of the i-set (Bi,4 planes) and the j-set (Bj,4
    planes), each pair once and with no mask (the kernel of
    ``_ds_sym_cross_kernel``): returns (acc_hi (Bi,4), acc_lo (Bi,4), both
    with w = 0, react_hi (3,Bj), react_lo (3,Bj))."""
    device = pos_hi_i.device if isinstance(pos_hi_i, torch.Tensor) else None
    _check_planes(("pos_hi_i", "pos_lo_i"), (pos_hi_i, pos_lo_i), device)
    _check_planes(("pos_hi_j", "pos_lo_j"), (pos_hi_j, pos_lo_j), device)
    _check_scal(scal)
    tile = check_sym_tile(tile)
    bi, bj = pos_hi_i.shape[0], pos_hi_j.shape[0]
    out = _ds_outs(None, [(bi, 4), (bi, 4), (3, bj), (3, bj)], device,
                   (pos_hi_i, pos_lo_i, pos_hi_j, pos_lo_j))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_sym_cross(pos_hi_i, pos_lo_i, pos_hi_j, pos_lo_j, scal)):
            t.copy_(r)
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch_i = torch.empty((_cdiv(bj, tile), 6, bi), dtype=torch.float32, device=device)
    scratch_j = torch.empty((_cdiv(bi, tile), 6, bj), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_sym_cross(
            pos_hi_i.data_ptr(), pos_lo_i.data_ptr(), bi, pos_hi_j.data_ptr(),
            pos_lo_j.data_ptr(), bj, scal.data_ptr(), tile, scratch_i.data_ptr(),
            scratch_j.data_ptr(), *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_sym_cross launch")
    LAUNCHES["ds_sym_cross"] += 1
    return out


def compute_accel_ds_symmetric_blocked_cuda(pos_hi, pos_lo, scal, *,
                                            block_cap: int | None = None,
                                            tile: int | None = None):
    """(N,4) hi/lo planes -> (acc_hi, acc_lo), each (N,3), each pair once at
    any N: one triangle launch for N <= block_cap, else k triangle and
    k(k-1)/2 cross launches summed in ds in a fixed order
    (``reference.compose_symmetric_blocked`` with ``ds_add``). Defaults from
    ``ds_sym_default_dispatch``."""
    cap, t = ds_sym_default_dispatch(pos_hi.shape[0])
    cap = cap if block_cap is None else int(block_cap)
    t = check_sym_tile(t if tile is None else tile)
    return reference.compose_symmetric_blocked(
        (pos_hi, pos_lo), scal, block_cap=cap, tile_j=t,
        triangle=lambda ph, pl, sc: ds_sym_accel_cuda(ph, pl, sc, tile=t),
        cross=lambda pih, pil, pjh, pjl, sc: ds_sym_cross_cuda(pih, pil, pjh, pjl, sc, tile=t),
        add=ds.ds_add)


def ds_integrate_cuda(pos_hi, pos_lo, vel_hi, vel_lo, acc_hi, acc_lo, scal, *, out=None):
    """The damped Euler update in ds after the each-pair-once force (one
    launch of ``ds_integrate_kernel``, csrc/ds_symmetric_kernels.cu; glue,
    not a TPU kernel): the four new (N,4) planes from the state and the ds
    acceleration (N,3). Its plain version is ``ds.ds_integrate``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    _check_planes(_PLANES, planes, device)
    _check_scal(scal)
    n = pos_hi.shape[0]
    for name, t in (("acc_hi", acc_hi), ("acc_lo", acc_lo)):
        _check_out(name, t, (n, 3), device, ())
    out = _ds_outs(out, [(n, 4)] * 4, device, (*planes, acc_hi, acc_lo))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_integrate(*planes, (acc_hi, acc_lo), scal)):
            t.copy_(r)
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_ds_integrate(
            *(t.data_ptr() for t in (*planes, acc_hi, acc_lo, *out)), n, scal.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_integrate launch")
    LAUNCHES["ds_integrate"] += 1
    return out


# ---- double-single accel + jerk and the Hermite glue:
# csrc/ds_aj_kernels.cu, csrc/ds_symmetric_aj_kernels.cu ----
#
# The accel + jerk kernels read eps^2 from column 1 of a ds scalar block,
# (2,4) or the (2,8) of ops/ds.py::scal_ds_hermite; the predictor and
# corrector take the (2,8) block.

DS_AJ_TILES = (128, 256)  # ROWS 1, 2; ROWS 4 and 8 are not built

# The dispatch tables of the ds accel + jerk kernels, their own: a pair
# costs ~452 FP32-pipe instructions one-sided and ~608 for both sides, a
# pair carries 26 values around the warp, and ptxas gives 96 / 128 / 168
# registers at ROWS 1 / 2 / 4 (the last spilling 8 bytes) and 62 one-sided.
# Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# scripts/torch_ds_aj_dispatch.py (PERF.md, Findings), ms per call at
# N = 16384 / 32768 / 65536:
#   one-sided, block 128              7.404 / 19.446 / 73.439
#   one-sided, block 256              9.801 / 19.507 / 69.775
#   sym, tile 128, one triangle       3.208 / 12.195 /      -
#   sym, tile 256, one triangle       3.336 / 12.417 / 48.212
#   sym, tile 256, cap 32768              - /      - / 48.037
#   sym, tile 512, one triangle       4.283 / 14.038 / 53.162
# and above the cap, composed at cap 32768, at N = 36864 / 65536, with the
# composition's rectangle alone at (N/2, N/2):
#   sym, tile 128, cap 32768          15.863 / 48.537   rectangle 8.054 / 24.537
#   sym, tile 256, cap 32768          15.818 / 48.020   rectangle 7.768 / 23.481
# Up to N = 32768 tile 128 (ROWS 1: 96 registers, 24 KB a block, twice the
# blocks of ROWS 2) wins the triangle; above the cap the rectangle, which
# has blocks enough at either tile, runs 4 % faster at tile 256 (it shuffles
# half as often a pair), and so does the composition. The one-sided kernel takes
# the ds step's ds_default_block_size. ROWS 4's registers and 96 KB a block
# lost everywhere and it is not built. Cap 32768 bounds a launch's scratch
# (ceil(N/T) * 12 * N floats) at 403 MB and costs nothing at N = 65536.
DS_AJ_SYM_TILES = (128, 256)  # at N <= DS_SMALL_N, above
DS_AJ_SYM_BLOCK_CAP = 32768


def ds_aj_sym_default_dispatch(n: int) -> tuple[int, int]:
    """``(block_cap, tile)`` of the each-pair-once ds accel + jerk at N
    bodies: the table above."""
    return DS_AJ_SYM_BLOCK_CAP, DS_AJ_SYM_TILES[n > DS_SMALL_N]


def _eps_block(scal) -> torch.Tensor:
    """The (2,4) head of a checked ds scalar block: the layout the
    accel + jerk kernels read (eps^2 in column 1)."""
    return scal if scal.shape[1] == 4 else scal[:, :4].contiguous()


def compute_accel_jerk_ds_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi,
                                  jvel_lo, scal, *, block_size: int | None = None, out=None):
    """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (M,4) with w = 0: the ds
    accel + jerk of the i-set (M,4 planes) under the j-set (N,4 planes),
    the kernel of ``_ds_accel_jerk_kernel``. ``block_size`` defaults to
    ``ds_default_block_size``; ``out`` holds four preallocated (M,4)
    tensors, which must not overlap any input."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    jplanes = (jpos_hi, jpos_lo, jvel_hi, jvel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(tuple("j" + name for name in _PLANES), jplanes, device)
    _check_scal(scal, (4, 8))
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    bs = check_block_size(ds_default_block_size(m) if block_size is None else block_size)
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_accel_jerk_vs(*planes, *jplanes, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    head = _eps_block(scal)
    with torch.cuda.device(device):
        err = lib.nbody_ds_accel_jerk(
            *(t.data_ptr() for t in (*planes, *jplanes, *out)), m, n, head.data_ptr(), bs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_accel_jerk launch")
    LAUNCHES["ds_accel_jerk"] += 1
    return out


def ds_aj_sym_cuda(pos_hi, pos_lo, vel_hi, vel_lo, scal, *, tile: int = DS_AJ_SYM_TILES[1]):
    """(N,4) hi/lo planes -> (acc_hi, acc_lo, jerk_hi, jerk_lo), each
    (N,3): the set's ds accel + jerk on itself, each pair once over the
    triangle j > i, the i-side and the reaction merged in ds (the kernel of
    ``_ds_aj_sym_kernel``)."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    _check_planes(_PLANES, planes, device)
    _check_scal(scal, (4, 8))
    tile = check_sym_tile(tile, DS_AJ_TILES)
    n = pos_hi.shape[0]
    out = _ds_outs(None, [(n, 3)] * 4, device, planes)
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_accel_jerk_symmetric(*planes, scal)):
            t.copy_(r)
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    head = _eps_block(scal)
    scratch = torch.empty((_cdiv(n, tile), 12, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_aj_sym(
            *(t.data_ptr() for t in planes), n, head.data_ptr(), tile, scratch.data_ptr(),
            *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_aj_sym launch")
    LAUNCHES["ds_aj_sym"] += 1
    return out


def ds_aj_sym_cross_cuda(pos_hi_i, pos_lo_i, vel_hi_i, vel_lo_i, pos_hi_j, pos_lo_j, vel_hi_j,
                         vel_lo_j, scal, *, tile: int = DS_AJ_SYM_TILES[1]):
    """The ds accel + jerk rectangle of the i-set (Bi,4 planes) and the
    j-set (Bj,4 planes), each pair once and with no mask (the kernel of
    ``_ds_aj_sym_cross_kernel``): returns (acc_hi, acc_lo, jerk_hi, jerk_lo),
    each (Bi,4) with w = 0, then (react_acc_hi, react_acc_lo,
    react_jerk_hi, react_jerk_lo), each (3,Bj)."""
    device = pos_hi_i.device if isinstance(pos_hi_i, torch.Tensor) else None
    iplanes = (pos_hi_i, pos_lo_i, vel_hi_i, vel_lo_i)
    jplanes = (pos_hi_j, pos_lo_j, vel_hi_j, vel_lo_j)
    _check_planes(tuple(name + "_i" for name in _PLANES), iplanes, device)
    _check_planes(tuple(name + "_j" for name in _PLANES), jplanes, device)
    _check_scal(scal, (4, 8))
    tile = check_sym_tile(tile, DS_AJ_TILES)
    bi, bj = pos_hi_i.shape[0], pos_hi_j.shape[0]
    out = _ds_outs(None, [(bi, 4)] * 4 + [(3, bj)] * 4, device, (*iplanes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_aj_sym_cross(*iplanes, *jplanes, scal)):
            t.copy_(r)
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    head = _eps_block(scal)
    scratch_i = torch.empty((_cdiv(bj, tile), 12, bi), dtype=torch.float32, device=device)
    scratch_j = torch.empty((_cdiv(bi, tile), 12, bj), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_aj_cross(
            *(t.data_ptr() for t in iplanes), bi, *(t.data_ptr() for t in jplanes), bj,
            head.data_ptr(), tile, scratch_i.data_ptr(), scratch_j.data_ptr(),
            *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_aj_cross launch")
    LAUNCHES["ds_aj_sym_cross"] += 1
    return out


def compute_accel_jerk_ds_symmetric_blocked_cuda(pos_hi, pos_lo, vel_hi, vel_lo, scal, *,
                                                 block_cap: int | None = None,
                                                 tile: int | None = None):
    """(N,4) hi/lo planes -> (acc_hi, acc_lo, jerk_hi, jerk_lo), each
    (N,3), each pair once at any N: one triangle launch for N <= block_cap,
    else k triangle and k(k-1)/2 cross launches, each block's parts ds-added
    in a fixed order (``reference.compose_symmetric_blocked``). Defaults
    from ``ds_aj_sym_default_dispatch``."""
    cap, t = ds_aj_sym_default_dispatch(pos_hi.shape[0])
    cap = cap if block_cap is None else int(block_cap)
    t = check_sym_tile(t if tile is None else tile, DS_AJ_TILES)
    return reference.compose_symmetric_blocked(
        (pos_hi, pos_lo, vel_hi, vel_lo), scal, block_cap=cap, tile_j=t,
        triangle=lambda *a: ds_aj_sym_cuda(*a, tile=t),
        cross=lambda *a: ds_aj_sym_cross_cuda(*a, tile=t),
        add=ds.ds_add_aj)


def _field_width(names, fields, n: int, device) -> int:
    """The row width, 3 or 4, of the ds acceleration and jerk fields of a
    Hermite step: each a float32 (n,3) or (n,4) tensor like the first."""
    first = fields[0]
    width = first.shape[1] if isinstance(first, torch.Tensor) and first.dim() == 2 else 0
    if width not in (3, 4):
        raise ValueError(f"{names[0]} must have shape (N, 3) or (N, 4)")
    for name, t in zip(names, fields):
        _check_out(name, t, (n, width), device, ())
    return width


def ds_hermite_predict_cuda(pos_hi, pos_lo, vel_hi, vel_lo, acc_hi, acc_lo, jerk_hi, jerk_lo,
                            scal, *, out=None):
    """The ds Hermite predictor (one launch of ``ds_hermite_predict_kernel``,
    csrc/ds_aj_kernels.cu; glue, not a TPU kernel): the four predicted
    (N,4) planes from the state and its ds acceleration and jerk, (N,3) or
    (N,4) each, mass and vel.w carried. `scal` from ``scal_ds_hermite``.
    Its plain version is ``ds.ds_hermite_predict``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    fields = (acc_hi, acc_lo, jerk_hi, jerk_lo)
    _check_planes(_PLANES, planes, device)
    _check_scal(scal, (8,))
    n = pos_hi.shape[0]
    width = _field_width(("acc_hi", "acc_lo", "jerk_hi", "jerk_lo"), fields, n, device)
    out = _ds_outs(out, [(n, 4)] * 4, device, (*planes, *fields))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_hermite_predict(*planes, fields[:2], fields[2:], scal)):
            t.copy_(r)
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_ds_hermite_predict(
            *(t.data_ptr() for t in (*planes, *fields)), width, *(t.data_ptr() for t in out), n,
            scal.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_hermite_predict launch")
    LAUNCHES["ds_hermite_predict"] += 1
    return out


def ds_hermite_correct_cuda(pos_hi, pos_lo, vel_hi, vel_lo, acc0_hi, acc0_lo, jerk0_hi,
                            jerk0_lo, acc1_hi, acc1_lo, jerk1_hi, jerk1_lo, scal, *, out=None):
    """The ds Hermite corrector (one launch of ``ds_hermite_correct_kernel``,
    csrc/ds_aj_kernels.cu; glue, not a TPU kernel): the four new (N,4)
    planes from the start-of-step state, its (acc0, jerk0) and the predicted
    state's (acc1, jerk1). Its plain version is ``ds.ds_hermite_correct``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    fields = (acc0_hi, acc0_lo, jerk0_hi, jerk0_lo, acc1_hi, acc1_lo, jerk1_hi, jerk1_lo)
    _check_planes(_PLANES, planes, device)
    _check_scal(scal, (8,))
    n = pos_hi.shape[0]
    width = _field_width(("acc0_hi", "acc0_lo", "jerk0_hi", "jerk0_lo", "acc1_hi", "acc1_lo",
                          "jerk1_hi", "jerk1_lo"), fields, n, device)
    out = _ds_outs(out, [(n, 4)] * 4, device, (*planes, *fields))
    if device.type != "cuda":
        pairs = [fields[k:k + 2] for k in range(0, 8, 2)]
        for t, r in zip(out, ds.ds_hermite_correct(*planes, *pairs, scal)):
            t.copy_(r)
        return out
    if n == 0:
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_ds_hermite_correct(
            *(t.data_ptr() for t in (*planes, *fields)), width, *(t.data_ptr() for t in out), n,
            scal.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_hermite_correct launch")
    LAUNCHES["ds_hermite_correct"] += 1
    return out


# ---- the P3M short-range pair sum: csrc/p3m_kernels.cu ----

P3M_BLKS = (128, 256, 512)


def p3m_sr_pairs_cuda(tables):
    """One launch of the pair kernel ``nbody_p3m_sr_f32`` over the tables of
    ``p3m.pair_tables``: the (M + blk, 4) short-range sums of the padded
    rows (w = 0; rows of inert i-rows hold nothing of use). CUDA tensors
    only: the CPU has no counterpart of the padded rows' sums (its plain
    version of the whole short range is ``reference.p3m_short_range``)."""
    padded = tables.padded
    device = padded.device
    _check_state("padded", padded, device)
    if tables.blk not in P3M_BLKS:
        raise ValueError(f"blk must be one of {P3M_BLKS}; got {tables.blk}")
    if device.type != "cuda":
        raise ValueError("p3m_sr_pairs_cuda launches the CUDA pair kernel; the tables are on "
                         f"{device}")
    ints = (tables.ablk, tables.tpc, tables.e_cell, tables.e_t)
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError("the pair tables' index arrays must be contiguous int32 on "
                             f"{device}")
    if tables.meta.dtype != torch.float32 or tables.meta.shape != (4,):
        raise ValueError("the pair tables' meta must be (4,) float32")
    acc_pad = torch.empty_like(padded)

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = lib.nbody_p3m_sr_f32(
            padded.data_ptr(), acc_pad.data_ptr(), *(t.data_ptr() for t in ints),
            tables.meta.data_ptr(), tables.e_cell.shape[0], tables.gc, tables.blk,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_p3m_sr_f32 launch")
    LAUNCHES["p3m_sr"] += 1
    return acc_pad


def p3m_short_range_cuda(pos, softening, *, grid: int = 64, capacity: int = 128,
                         blk: int | None = None):
    """The P3M short-range force of the (N, 4) state: ((N, 3) accelerations,
    overflow count as a 0-d tensor). On a CUDA tensor: the tables
    (``p3m.pair_tables``, torch ops on the card), one launch of the pair
    kernel, and the padded rows mapped back to the bodies (dropped bodies
    get 0); no host synchronisation. On a CPU tensor: the plain version,
    ``reference.p3m_short_range``, and ``p3m.p3m_overflow_count``. ``blk``
    defaults to ``p3m.p3m_kernel_blk(capacity)``."""
    from nbody_tpu_torch.ops import p3m

    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_state("pos", pos, device)
    blk = p3m.p3m_kernel_blk(capacity) if blk is None else int(blk)
    if blk not in P3M_BLKS:
        raise ValueError(f"blk must be one of {P3M_BLKS}; got {blk}")
    if device.type != "cuda":
        return (reference.p3m_short_range(pos, softening, grid=grid, capacity=capacity),
                p3m.p3m_overflow_count(pos, grid=grid, capacity=capacity))
    if pos.shape[0] == 0:
        return pos.new_zeros((0, 3)), torch.zeros((), dtype=torch.int64, device=device)
    tables = p3m.pair_tables(pos, softening, grid=grid, capacity=capacity, blk=blk)
    return p3m.short_range_from_tables(p3m_sr_pairs_cuda(tables), tables), tables.overflow
