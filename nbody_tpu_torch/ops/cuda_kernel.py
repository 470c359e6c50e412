"""Wrappers of the hand-written CUDA kernels (``csrc/nbody_kernels.cu``,
``csrc/mxu_kernels.cu``, ``csrc/f64_kernels.cu``, ``csrc/symmetric_kernels.cu``,
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
``_ds_leapfrog_kernel``, ``_ds_accel_kernel``, ``_ds_sym_kernel``,
``_ds_sym_cross_kernel``) with
their ``ds_sym_default_dispatch``, and of the ds Hermite step's
(``_ds_accel_jerk_kernel``, ``_ds_aj_sym_kernel``, ``_ds_aj_sym_cross_kernel``)
with ``ds_aj_sym_default_dispatch``; and of the P3M short-range pair
kernel ``_sr_pair_kernel`` (``nbody_tpu/ops/p3m_kernel.py``) in
``csrc/p3m_kernels.cu``, over the tables of ``ops/p3m.py``; and of the
fused ring kernel ``_kernel`` (``nbody_tpu/ops/ring_kernel.py``) in
``csrc/ring_kernels.cu``, with its buffers (``FusedRing``), a real ring of
processes or an emulated ring of D ranks in one launch on one card; and of
the three kernels of the JAX package's experiment scripts: the dual-bank
step (``scripts/tpu_r3_dualbank.py::_dual_kernel``), the packed-state step
(``scripts/tpu_r3_packed.py::_packed_kernel``) and the sym triangle's
reaction ablations (``scripts/tpu_r4_sym_budget.py::_ablate_kernel``),
which the ports of those scripts (``scripts/torch_r3_dualbank.py``,
``scripts/torch_r3_packed.py``, ``scripts/torch_r4_sym_budget.py``) run.

For a CUDA tensor a wrapper launches its kernel on PyTorch's current stream,
or raises: when the library cannot be built or loaded, or the launch returns
a CUDA error. For a CPU tensor it computes the plain version in
``ops/reference.py``, ``ops/energy.py`` or ``ops/ds.py``; that is all the
CPU path is for (``p3m_sr_pairs_cuda``, whose padded rows have no plain
counterpart, raises instead; ``ring_accel_fused_cuda`` takes a CPU ring's
exchanges with the plain force).
Both paths check dtype (never cast), shape ``(., 4)``, contiguity,
alignment and device. The step, force, accel + jerk and potential wrappers
take float32 (16-byte aligned: the kernels load ``float4``) or float64
(32-byte aligned: ``csrc/f64_kernels.cu`` loads two ``double2`` a body),
one type for all of a call's tensors, and dispatch on it; every other
wrapper takes float32 only.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
path went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from nbody_tpu_torch.ops import ds, energy, reference
from nbody_tpu_torch.utils.profiling import annotate

DEFAULT_BLOCK_SIZE = 256

LAUNCHES = {"step": 0, "step_t": 0, "mxu_step": 0, "mxu_bf16_step": 0, "accel": 0,
            "sym": 0, "sym_cross": 0, "accel_jerk": 0, "potential": 0, "aj_sym": 0,
            "aj_sym_cross": 0,
            "ds_step": 0, "ds_leapfrog": 0, "ds_sym": 0, "ds_sym_cross": 0,
            "ds_integrate": 0, "ds_accel": 0, "ds_accel_jerk": 0, "ds_aj_sym": 0,
            "ds_aj_sym_cross": 0,
            "ds_hermite_predict": 0, "ds_hermite_correct": 0, "p3m_sr": 0, "p3m_sr_range": 0,
            "ring_fused": 0,
            "step_dual": 0, "step_packed": 0, "sym_ablate_full": 0, "sym_ablate_none": 0,
            "sym_ablate_tree_small": 0,
            "step_f64": 0, "accel_f64": 0, "accel_jerk_f64": 0, "potential_f64": 0}

SYM_TILES = (128, 256, 512, 1024)


def check_block_size(block_size: int) -> int:
    bs = int(block_size)
    if bs < 32 or bs > 1024 or bs % 32:
        raise ValueError(
            f"block_size must be a multiple of 32 in [32, 1024]; got {block_size}")
    return bs


# the state types a wrapper takes: float32 only, or float32 and float64
# (the step, force, accel + jerk and potential, csrc/f64_kernels.cu)
FP32 = (torch.float32,)
FP32_FP64 = (torch.float32, torch.float64)


def _check_state(name: str, t, device: torch.device, dtypes: tuple = FP32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(
            f"{name} is {t.dtype}; this kernel takes {kinds} only (no "
            "implicit cast: convert the state explicitly)")
    if t.dim() != 2 or t.shape[1] != 4:
        raise ValueError(f"{name} must have shape (N, 4); got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    align = 32 if t.dtype == torch.float64 else 16
    if t.data_ptr() % align:
        raise ValueError(
            f"{name} is not {align}-byte aligned (storage offset {t.storage_offset()}); "
            "the kernels read each body as one float4 (two double2 in float64)")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _one_dtype(**tensors) -> torch.dtype:
    """The one state type of a call's tensors; mixed types raise TypeError
    (nothing is cast)."""
    dtypes = {name: t.dtype for name, t in tensors.items()}
    if len(set(dtypes.values())) > 1:
        raise TypeError(f"the tensors of one call must share a type; got "
                        + ", ".join(f"{k} {v}" for k, v in dtypes.items()))
    return next(iter(dtypes.values()))


def _scalars(dtype, *values):
    """The float arguments of an entry point of the state type `dtype`."""
    c = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    return tuple(c(float(v)) for v in values)


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


def _step_outs(pos_i, vel_i, pos_j, out, dtypes: tuple = FP32):
    """Check the inputs of a fused step and its out=(new_pos, new_vel),
    allocated when None; returns (device, new_pos, new_vel). The outputs
    must not overlap any input: every thread block reads all of pos_j while
    others write their new positions. All are of one type of `dtypes`."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    for name, t in (("pos_i", pos_i), ("vel_i", vel_i), ("pos_j", pos_j)):
        _check_state(name, t, device, dtypes)
    if vel_i.shape[0] != pos_i.shape[0]:
        raise ValueError(f"vel_i has {vel_i.shape[0]} rows, pos_i {pos_i.shape[0]}")
    m = pos_i.shape[0]
    if out is None:
        out = (torch.empty_like(pos_i), torch.empty_like(vel_i))
    new_pos, new_vel = out
    for name, t in (("out[0]", new_pos), ("out[1]", new_vel)):
        _check_state(name, t, device, dtypes)
        if t.shape[0] != m:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {m}")
        for src in (pos_i, vel_i, pos_j):
            if _overlaps(t, src):
                raise ValueError(f"{name} overlaps an input of the step")
    if _overlaps(new_pos, new_vel):
        raise ValueError("out[0] and out[1] overlap")
    _one_dtype(pos_i=pos_i, vel_i=vel_i, pos_j=pos_j, new_pos=new_pos, new_vel=new_vel)
    return device, new_pos, new_vel


def nbody_step_cuda_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                       *, block_size: int = DEFAULT_BLOCK_SIZE, out=None,
                       splits: int | None = None):
    """Fused step of the i-set (M,4) under forces from the j-set (N,4), in
    `splits` j-chunks (``step_splits(M, N)`` by default; float64 states run
    the double kernel in ``f64_splits(M, N)``).

    Returns (new_pos, new_vel), each (M,4). ``out=(new_pos, new_vel)`` writes
    into preallocated tensors, which must not overlap any input.
    """
    return _step(pos_i, vel_i, pos_j, dt, softening, damping, block_size, out, splits)


def _step(pos_i, vel_i, pos_j, dt, softening, damping, block_size, out, splits=None,
          lib=None):
    """``nbody_step_cuda_vs`` through `lib`: the port's library by default,
    or another build of the kernel (``scripts/torch_step_dispatch.py
    --against``), whose launches are not counted; with splits = 1 only its
    one-chunk entry point is called, which every build has."""
    device, new_pos, new_vel = _step_outs(pos_i, vel_i, pos_j, out, FP32_FP64)
    bs = check_block_size(block_size)
    m, n = pos_i.shape[0], pos_j.shape[0]
    if device.type != "cuda":
        p, v = reference.nbody_step_vs(pos_i, vel_i, pos_j, dt, softening, damping)
        new_pos.copy_(p)
        new_vel.copy_(v)
        return new_pos, new_vel
    if m == 0:
        return new_pos, new_vel

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    f64 = pos_i.dtype == torch.float64
    entry, key = ("nbody_step_f64", "step_f64") if f64 else ("nbody_step_f32", "step")
    s = int(splits) if splits is not None else (f64_splits if f64 else step_splits)(m, n)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, entry, s, (3, m), device, (
            pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(), new_pos.data_ptr(),
            new_vel.data_ptr(), m, n, *_step_scalars(dt, softening, damping, pos_i.dtype), bs))
    _raise_on_error(lib, err, f"{entry} launch")
    if counted:
        LAUNCHES[key] += 1
    return new_pos, new_vel


def _step_scalars(dt, softening, damping, dtype=torch.float32):
    """dt, eps^2 and damping as the step entry points of `dtype` take them."""
    return _scalars(dtype, dt, float(softening) ** 2, damping)


def _launch_chunks(lib, entry: str, s: int, parts: tuple, device, args) -> int:
    """Launch the entry point `entry` of `lib` (a one-chunk name such as
    ``nbody_step_f32`` or ``nbody_mxu_step_bf16``) on the current stream: as
    named for one j-chunk, else its ``_split`` twin (``nbody_step_split_f32``,
    ``nbody_mxu_step_split_bf16``) with S and a scratch (S, *parts) for the
    chunks' partials (float64 for an ``_f64`` entry point, else float32).
    Returns its error code."""
    stream = torch.cuda.current_stream().cuda_stream
    if s == 1:
        return getattr(lib, entry)(*args, stream)
    head, _, dtype = entry.rpartition("_")
    scratch = torch.empty((s, *parts), device=device,
                          dtype=torch.float64 if dtype == "f64" else torch.float32)
    return getattr(lib, f"{head}_split_{dtype}")(*args, s, scratch.data_ptr(), stream)


def nbody_step_cuda(pos, vel, dt, softening, damping,
                    *, block_size: int = DEFAULT_BLOCK_SIZE, out=None):
    """Single-device fused step: forces of the whole set on itself."""
    return nbody_step_cuda_vs(pos, vel, pos, dt, softening, damping,
                              block_size=block_size, out=out)


# ---- the force reduction on the tensor cores: csrc/mxu_kernels.cu ----

# variant -> (C entry point of one j-chunk, LAUNCHES key); the split entry
# point is its _split twin (_launch_chunks)
MXU_KERNELS = {"mxu": ("nbody_mxu_step_f32", "mxu_step"),
               "mxu_bf16": ("nbody_mxu_step_bf16", "mxu_bf16_step")}


def nbody_step_mxu_cuda_vs(pos_i, vel_i, pos_j, dt, softening, damping, *, variant: str,
                           out=None):
    """The fused Euler step of the i-set (M,4) under the j-set (N,4), the
    force reduced as a matrix product on the tensor cores (the kernel of
    ``_mxu_step_kernel``): ``variant="mxu"`` in f32 grade (3xTF32),
    ``"mxu_bf16"`` with bf16 operands and f32 sums, in ``mxu_splits(M, N)``
    j-chunks. Returns (new_pos, new_vel); ``out`` as for
    ``nbody_step_cuda_vs``. A CPU tensor takes the plain version,
    ``reference.nbody_step_mxu_vs``."""
    return _mxu_step(pos_i, vel_i, pos_j, dt, softening, damping, variant, out)


def _mxu_step(pos_i, vel_i, pos_j, dt, softening, damping, variant, out, splits=None,
              lib=None):
    """``nbody_step_mxu_cuda_vs`` in `splits` j-chunks (``mxu_splits`` by
    default) through `lib`: the port's library by default, or another build
    of the kernels (``scripts/torch_mxu_bench.py --against``), whose launches
    are not counted; with splits = 1 only its one-chunk entry point is
    called, which every build has."""
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

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = mxu_splits(m, n) if splits is None else int(splits)
    args = (pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(), new_pos.data_ptr(),
            new_vel.data_ptr(), m, n, *_step_scalars(dt, softening, damping))
    with torch.cuda.device(device):
        err = _launch_chunks(lib, entry, s, (4, m), device, args)
    _raise_on_error(lib, err, f"{entry} launch")
    if counted:
        LAUNCHES[key] += 1
    return new_pos, new_vel


def nbody_step_mxu_cuda(pos, vel, dt, softening, damping, *, variant: str, out=None):
    """Single-device mxu step: forces of the whole set on itself."""
    return nbody_step_mxu_cuda_vs(pos, vel, pos, dt, softening, damping, variant=variant,
                                  out=out)


def nbody_rollout_cuda(pos, vel, dt, softening, damping, *, steps: int,
                       block_size: int = DEFAULT_BLOCK_SIZE, splits: int | None = None):
    """`steps` fused one-sided Euler steps that carry the j-side as the
    planes (4, N) of the positions from step to step (the kernel of
    ``_step_kernel_t``; the counterpart of ``nbody_rollout_pallas``): the
    positions are transposed once, before the first step, and each launch
    writes the planes the next one reads. Each step runs in `splits`
    j-chunks (``step_splits(N, N)`` by default), so the rollout equals
    `steps` launches of ``nbody_step_cuda`` at the same S bit for bit, at
    any block size. Returns the new (pos, vel), each (N,4); the inputs are
    not written (steps=0 returns them, as ``reference.rollout`` does). No
    path of the port calls it: on the TPU it was measured slower than the
    step scan (a recorded negative result), and PERF.md has its time on the
    card."""
    return _rollout(pos, vel, dt, softening, damping, steps, block_size, splits)


def _rollout(pos, vel, dt, softening, damping, steps, block_size, splits=None, lib=None):
    """``nbody_rollout_cuda`` through `lib`, as ``_step``."""
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

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = step_splits(n, n) if splits is None else int(splits)
    bufs = [(torch.empty_like(pos), torch.empty_like(vel)) for _ in range(2)]
    # copies, never views: a step writes the planes the step before read,
    # and (4, 1) pos.t() would be pos itself
    planes = [torch.empty((4, n), dtype=torch.float32, device=device) for _ in range(2)]
    planes[0].copy_(pos.t())
    cur = (pos, vel)
    with torch.cuda.device(device):
        for k in range(steps):
            nxt = bufs[k % 2]
            err = _launch_chunks(lib, "nbody_step_t_f32", s, (3, n), device, (
                cur[0].data_ptr(), cur[1].data_ptr(), planes[k % 2].data_ptr(),
                nxt[0].data_ptr(), nxt[1].data_ptr(), planes[1 - k % 2].data_ptr(), n,
                *_step_scalars(dt, softening, damping), bs))
            _raise_on_error(lib, err, "nbody_step_t_f32 launch")
            if counted:
                LAUNCHES["step_t"] += 1
            cur = nxt
    return cur


# ---- the experiment scripts' one-sided steps: csrc/nbody_kernels.cu ----


def nbody_step_dual_cuda(pos, vel, dt, softening, damping, *,
                         block_size: int = DEFAULT_BLOCK_SIZE, out=None,
                         splits: int | None = None):
    """The dual-bank step (the kernel of ``scripts/tpu_r3_dualbank.py``'s
    ``_dual_kernel``): the fused one-sided Euler step of the set (N,4) on
    itself with two i-bodies a thread, so a block of `block_size` threads
    covers 2 * block_size rows. It computes the same function as
    ``nbody_step_cuda``, whose plain version, ``reference.nbody_step``, is
    its plain version too. It runs in `splits` j-chunks (``step_splits(N,
    N)`` by default) and each row sums its chunks in the step kernel's
    order, so the two give the same bits at any block size. Returns
    (new_pos, new_vel); ``out`` as for ``nbody_step_cuda``."""
    device, new_pos, new_vel = _step_outs(pos, vel, pos, out)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        p, v = reference.nbody_step(pos, vel, dt, softening, damping)
        new_pos.copy_(p)
        new_vel.copy_(v)
        return new_pos, new_vel
    n = pos.shape[0]
    if n == 0:
        return new_pos, new_vel

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    s = step_splits(n, n) if splits is None else int(splits)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, "nbody_step_dual_f32", s, (3, n), device, (
            pos.data_ptr(), vel.data_ptr(), pos.data_ptr(), new_pos.data_ptr(),
            new_vel.data_ptr(), n, n, *_step_scalars(dt, softening, damping), bs))
    _raise_on_error(lib, err, "nbody_step_dual_f32 launch")
    LAUNCHES["step_dual"] += 1
    return new_pos, new_vel


def _check_packed(state, planes, device) -> None:
    """A packed state (N,8) = [pos | vel] and the (4,N) planes of its
    positions: float32, contiguous, 16-byte aligned, on `device`."""
    if not isinstance(state, torch.Tensor) or state.dim() != 2 or state.shape[1] != 8:
        raise ValueError("state must be an (N, 8) [pos | vel] tensor; got "
                         f"{tuple(state.shape) if isinstance(state, torch.Tensor) else state}")
    n = state.shape[0]
    _check_out("state", state, (n, 8), device, ())
    _check_out("planes", planes, (4, n), device, ())


def nbody_step_packed_cuda(state, planes, dt, softening, damping, *,
                           block_size: int = DEFAULT_BLOCK_SIZE, out=None,
                           splits: int | None = None):
    """The packed-state step (the kernel of ``scripts/tpu_r3_packed.py``'s
    ``_packed_kernel``): the fused one-sided Euler step of the packed state
    (N,8) = [pos | vel], one 32-byte row a body read once and written once,
    the j-side from `planes` (4,N), the x, y, z, m planes of the positions.
    Returns (new_state (N,8), new_planes (4,N)), the planes the next step
    reads, written by the kernel from the new rows; ``out=(new_state,
    new_planes)`` are preallocated tensors that overlap no input. It runs in
    `splits` j-chunks (``step_splits(N, N)`` by default), as the step
    kernel, whose bits it gives. The plain version is
    ``reference.nbody_step_packed``."""
    device = state.device if isinstance(state, torch.Tensor) else None
    _check_packed(state, planes, device)
    bs = check_block_size(block_size)
    n = state.shape[0]
    if out is None:
        out = (torch.empty_like(state), torch.empty_like(planes))
    new_state, new_planes = out
    _check_out("out[0]", new_state, (n, 8), device, (state, planes))
    _check_out("out[1]", new_planes, (4, n), device, (state, planes, new_state))
    if device.type != "cuda":
        s_new, p_new = reference.nbody_step_packed(state, planes, dt, softening, damping)
        new_state.copy_(s_new)
        new_planes.copy_(p_new)
        return new_state, new_planes
    if n == 0:
        return new_state, new_planes

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    s = step_splits(n, n) if splits is None else int(splits)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, "nbody_step_packed_f32", s, (3, n), device, (
            state.data_ptr(), planes.data_ptr(), new_state.data_ptr(), new_planes.data_ptr(),
            n, *_step_scalars(dt, softening, damping), bs))
    _raise_on_error(lib, err, "nbody_step_packed_f32 launch")
    LAUNCHES["step_packed"] += 1
    return new_state, new_planes


def nbody_rollout_packed_cuda(state, dt, softening, damping, *, steps: int,
                              block_size: int = DEFAULT_BLOCK_SIZE):
    """`steps` packed-state steps from the state (N,8) = [pos | vel]: its
    planes made once, before the first step, then each launch writes the
    state and the planes the next one reads, ping-ponged (a launch never
    writes what it reads). Returns the new state (N,8); the input is not
    written (steps=0 returns it). The script's ``lax.scan`` of
    ``step_packed``, whose planes XLA transposed from each new state."""
    device = state.device if isinstance(state, torch.Tensor) else None
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"steps must be >= 0; got {steps}")
    if steps == 0:
        return state
    planes = state[:, :4].t().contiguous()
    _check_packed(state, planes, device)
    bufs = [(torch.empty_like(state), torch.empty_like(planes)) for _ in range(2)]
    cur = (state, planes)
    for k in range(steps):
        cur = nbody_step_packed_cuda(*cur, dt, softening, damping, block_size=block_size,
                                     out=bufs[k % 2])
    return cur[0]


def compute_accel_cuda(pos_i, pos_j, softening, *, block_size: int = DEFAULT_BLOCK_SIZE):
    """Acceleration (M,3) on the i-set (M,4) due to the j-set (N,4): the
    force kernel (``_accel_kernel``) in ``step_splits(M, N)`` j-chunks, the
    step kernel's walk, so its sums are the ones the step applies; for
    float64 states the double force kernel in ``f64_splits(M, N)``."""
    return _accel(pos_i, pos_j, softening, block_size)


def _accel(pos_i, pos_j, softening, block_size, splits=None, lib=None):
    """``compute_accel_cuda`` in `splits` j-chunks (``step_splits`` by
    default). `lib` is the port's library by default, or another build of
    the kernel (``scripts/torch_accel_dispatch.py --against``), whose
    launches are not counted; with splits = 1 only its one-chunk entry
    point is called, which every build has."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_state("pos_i", pos_i, device, FP32_FP64)
    _check_state("pos_j", pos_j, device, FP32_FP64)
    dtype = _one_dtype(pos_i=pos_i, pos_j=pos_j)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return reference.compute_accel_vs(pos_i, pos_j, softening)

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    m, n = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty((m, 3), dtype=dtype, device=device)
    if m == 0:
        return acc
    f64 = dtype == torch.float64
    entry, key = ("nbody_accel_f64", "accel_f64") if f64 else ("nbody_accel_f32", "accel")
    s = int(splits) if splits is not None else (f64_splits if f64 else step_splits)(m, n)
    args = (pos_i.data_ptr(), pos_j.data_ptr(), acc.data_ptr(), m, n,
            *_scalars(dtype, float(softening) ** 2), bs)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, entry, s, (3, m), device, args)
    _raise_on_error(lib, err, f"{entry} launch")
    if counted:
        LAUNCHES[key] += 1
    return acc


def _check_pair(pos_name, pos, vel_name, vel, device, dtypes: tuple = FP32) -> None:
    """A (pos, vel) pair of states: each checked, and the same row count."""
    _check_state(pos_name, pos, device, dtypes)
    _check_state(vel_name, vel, device, dtypes)
    if vel.shape[0] != pos.shape[0]:
        raise ValueError(f"{vel_name} has {vel.shape[0]} rows, {pos_name} {pos.shape[0]}")


# The j-split of the one-sided accel + jerk kernels (csrc/nbody_kernels.cu,
# csrc/ds_aj_kernels.cu), of the fp32 step kernel and its twins
# (csrc/nbody_kernels.cu) and of the ds step, force and leapfrog kernels
# (csrc/ds_kernels.cu). A launch of M i-rows under N j-bodies runs in S
# j-chunks, each a whole number of the kernel's shared-memory stages; each
# chunk sums its j-bodies in index order and a second kernel adds the chunks'
# partials in chunk order, so S, and the bits, depend on (M, N) alone: not on
# the card, the call or the block size. S is the least power of two whose
# grid of ceil(M / tile_i) x S blocks reaches `fill` blocks, at most one
# chunk a stage, then evened out so that no chunk is short or empty; 1 where
# the i-tiles fill the card on their own. tile_i is a block's i-rows at the
# default block: 256 threads x 4 rows (kAjRows) in fp32, 128 x 1 in ds.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W by scripts/torch_aj_dispatch.py
# and scripts/torch_ds_aj_dispatch.py (PERF.md, Findings): equal chunks
# matter more than their count (fp32 at (65536, 65536): 16 chunks of 16
# stages 4.763 ms, 18 with a last chunk of one stage 5.039); fp32 at 528
# blocks (4 an SM of 132, 2 waves of the 2 blocks of 256 threads an SM
# holds) within 2 % of the best S timed at every shape; ds at 4224, as
# fewer chunks left 2-11 % at M above 32768, where the ds blocks are 256
# threads (36864: 24.37 ms at S = 4 against 21.67 at 15). The ds step and
# force kernels take the ds accel + jerk's tile and fill (their own stage,
# of the same length, is DS_STAGE): by
# scripts/torch_ds_dispatch.py (PERF.md, Findings) the rule's S within 1.5 %
# and 3.9 % (two calls) of the best S swept (fills 264-8448, blocks 64-256)
# at (16384, 16384), (65536, 65536), (4096, 16384), (4096, 4096) and
# (16384, 65536). The ds leapfrog kernel takes ds_splits too, so that a
# leapfrog step from zero velocity gives the force kernel's bits. The fp32
# step kernel and its rollout, dual-bank and packed twins take step_splits,
# on the accel + jerk kernel's tile (256 threads x 4 rows) and fill (by
# scripts/torch_step_dispatch.py, PERF.md, Findings, within 3.4 % of the
# best fill swept) and a stage of the same length (STEP_STAGE), one rule for
# all four so that they give one another's bits; the fp32 force kernel
# runs their walk and takes the same rule, so its sums are theirs, and the
# fused ring's hops take it at (M, M), so a hop is the force kernel's.
AJ_STAGE = 256  # j-bodies a stage: kAjStage of csrc/nbody_kernels.cu
AJ_TILE_I = 1024
AJ_FILL_BLOCKS = 528
DS_AJ_STAGE = 128  # kDsAjStage of csrc/ds_aj_kernels.cu
DS_AJ_TILE_I = 128
DS_AJ_FILL_BLOCKS = 4224
DS_STAGE = 128  # kDsStage of csrc/ds_kernels.cu
STEP_STAGE = 256  # kStepStage of csrc/allpairs_common.cuh
STEP_ROWS = 4  # kStepRows of csrc/allpairs_common.cuh: rows a thread up to 512 threads
# The tensor-core step (csrc/mxu_kernels.cu) takes the rule on its own i-tile
# (kMxuRows: 4 warps x 4 m16 tiles), stage (kMxuStage: four 128-body tile
# sums a barrier) and fill: 2112 blocks, 16 an SM of 132, about three waves
# of the 5 blocks of 128 threads at 96 registers an SM holds. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W by scripts/torch_mxu_bench.py (PERF.md,
# Findings), S from 1 to four times the rule's in turns: the 3xTF32 step at
# the rule's S within 1.5 % of the best S timed at 65536 (S = 16: 2.495 ms,
# 32: 2.457, 1: 2.693), 135168 (S = 4: 10.259, 16: 10.153, 1: 10.562) and
# the four-card hop (16384, 65536) (S = 64: 0.647, 1: 1.714), within 3 % at
# 16384^2 (S = 32: 0.187, 16: 0.182); bf16 alike.
MXU_TILE_I = 256
MXU_STAGE = 512
MXU_FILL_BLOCKS = 2112
# The double kernels (csrc/f64_kernels.cu) take the rule on their own
# i-tile, 256 threads x kF64Rows (2) rows, the fp32 step's stage (256
# bodies: step_chunk) and fill (528 blocks). One rule for the step and the
# force, so that the force's sums are the ones the step applies.
F64_TILE_I = 512
F64_FILL_BLOCKS = 528


def one_sided_splits(m: int, n: int, *, tile_i: int, stage: int, fill: int) -> int:
    """S, the j-chunks of a one-sided accel + jerk launch (the rule above)."""
    if m <= 0 or n <= 0:
        return 1
    stages, tiles = _cdiv(n, stage), _cdiv(m, tile_i)
    s = 1
    while tiles * s < fill and s < stages:
        s *= 2
    s = min(s, stages)
    return _cdiv(stages, _cdiv(stages, s))


def aj_splits(m: int, n: int) -> int:
    """S of the fp32 one-sided accel + jerk kernel at M i-rows, N j-bodies."""
    return one_sided_splits(m, n, tile_i=AJ_TILE_I, stage=AJ_STAGE, fill=AJ_FILL_BLOCKS)


def step_splits(m: int, n: int) -> int:
    """S of the fp32 one-sided step kernel and its twins (``step_t``,
    ``step_dual``, ``step_packed``), of the force kernel and of a fused
    ring hop (at M = N) at M i-rows, N j-bodies."""
    return one_sided_splits(m, n, tile_i=AJ_TILE_I, stage=STEP_STAGE, fill=AJ_FILL_BLOCKS)


def f64_splits(m: int, n: int) -> int:
    """S of the double step, force, accel + jerk and potential kernels at
    M i-rows, N j-bodies."""
    return one_sided_splits(m, n, tile_i=F64_TILE_I, stage=STEP_STAGE, fill=F64_FILL_BLOCKS)


def mxu_splits(m: int, n: int) -> int:
    """S of the tensor-core step kernels (``mxu``, ``mxu_bf16``) at M i-rows,
    N j-bodies."""
    return one_sided_splits(m, n, tile_i=MXU_TILE_I, stage=MXU_STAGE, fill=MXU_FILL_BLOCKS)


def ds_aj_splits(m: int, n: int) -> int:
    """S of the ds one-sided accel + jerk kernel at M i-rows, N j-bodies."""
    return one_sided_splits(m, n, tile_i=DS_AJ_TILE_I, stage=DS_AJ_STAGE,
                            fill=DS_AJ_FILL_BLOCKS)


def ds_splits(m: int, n: int) -> int:
    """S of the ds step, force and leapfrog kernels at M i-rows, N j-bodies:
    one rule for the three, so that the force followed by the ds Euler
    update gives the fused step's bits, and a leapfrog step from zero
    velocity the force's."""
    return one_sided_splits(m, n, tile_i=DS_AJ_TILE_I, stage=DS_STAGE, fill=DS_AJ_FILL_BLOCKS)


def compute_accel_jerk_cuda(pos_i, vel_i, pos_j, vel_j, softening,
                            *, block_size: int = DEFAULT_BLOCK_SIZE):
    """(acc, jerk), each (M,3), on the i-set (M,4) due to the j-set (N,4):
    the one-sided accel + jerk kernel (``_accel_jerk_kernel``) in
    ``aj_splits(M, N)`` j-chunks; for float64 states the double kernel in
    ``f64_splits(M, N)``."""
    return _accel_jerk(pos_i, vel_i, pos_j, vel_j, softening, block_size)


def _accel_jerk(pos_i, vel_i, pos_j, vel_j, softening, block_size, splits=None, lib=None):
    """``compute_accel_jerk_cuda`` in `splits` j-chunks (``aj_splits`` by
    default). `lib` is the port's library by default, or another build of
    the kernel (``scripts/torch_aj_dispatch.py --against``), whose launches
    are not counted; with splits = 1 only its one-chunk entry point is
    called, which every build has."""
    device = pos_i.device if isinstance(pos_i, torch.Tensor) else None
    _check_pair("pos_i", pos_i, "vel_i", vel_i, device, FP32_FP64)
    _check_pair("pos_j", pos_j, "vel_j", vel_j, device, FP32_FP64)
    dtype = _one_dtype(pos_i=pos_i, vel_i=vel_i, pos_j=pos_j, vel_j=vel_j)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return reference.compute_accel_jerk_vs(pos_i, vel_i, pos_j, vel_j, softening)

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    m, n = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty((m, 3), dtype=dtype, device=device)
    jerk = torch.empty((m, 3), dtype=dtype, device=device)
    if m == 0:
        return acc, jerk
    f64 = dtype == torch.float64
    entry, key = (("nbody_accel_jerk_f64", "accel_jerk_f64") if f64
                  else ("nbody_accel_jerk_f32", "accel_jerk"))
    s = int(splits) if splits is not None else (f64_splits if f64 else aj_splits)(m, n)
    args = (pos_i.data_ptr(), vel_i.data_ptr(), pos_j.data_ptr(), vel_j.data_ptr(),
            acc.data_ptr(), jerk.data_ptr(), m, n, *_scalars(dtype, float(softening) ** 2), bs)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, entry, s, (6, m), device, args)
    _raise_on_error(lib, err, f"{entry} launch")
    if counted:
        LAUNCHES[key] += 1
    return acc, jerk


def potential_energy_per_row_cuda(pos, softening, *, block_size: int = DEFAULT_BLOCK_SIZE):
    """(N,) per-row pair-potential sums of the set (N,4), row i holding
    sum_{j != i} m_i m_j / sqrt(r^2 + eps^2), the self pair dropped by its
    index: the potential kernel (``_potential_kernel``) in ``step_splits(N,
    N)`` j-chunks (for a float64 set the double kernel in ``f64_splits(N,
    N)``), the same bits at every block size. The potential energy is -1/2
    of their sum."""
    return _potential(pos, softening, block_size)


def _potential(pos, softening, block_size, splits=None, lib=None):
    """``potential_energy_per_row_cuda`` in `splits` j-chunks
    (``step_splits(N, N)`` by default) through `lib`, as ``_mxu_step``."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_state("pos", pos, device, FP32_FP64)
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return energy.potential_energy_per_row(pos, softening)

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    n = pos.shape[0]
    per_row = torch.empty((n,), dtype=pos.dtype, device=device)
    if n == 0:
        return per_row
    f64 = pos.dtype == torch.float64
    entry, key = (("nbody_potential_f64", "potential_f64") if f64
                  else ("nbody_potential_f32", "potential"))
    s = int(splits) if splits is not None else (f64_splits if f64 else step_splits)(n, n)
    args = (pos.data_ptr(), per_row.data_ptr(), n, *_scalars(pos.dtype, float(softening) ** 2),
            bs)
    with torch.cuda.device(device):
        err = _launch_chunks(lib, entry, s, (n,), device, args)
    _raise_on_error(lib, err, f"{entry} launch")
    if counted:
        LAUNCHES[key] += 1
    return per_row


# ---- each pair once: csrc/symmetric_kernels.cu ----

# The dispatch table of the blocked composition, measured on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit by scripts/torch_sym_dispatch.py (PERF.md,
# Findings, PR 18: the walk sym_walk, unrolled twice), force ms per call at
# N = 65536 / 135168 / 262144, medians of two rounds:
#   tile 1024, one triangle        1.533 / 6.187 / 22.787
#   tile 1024, cap 131072          1.533 / 6.421 / 23.444
#   tile 1024, cap 65536           1.533 / 6.732 / 24.404
#   tile 512,  cap 131072          1.634 / 6.879 / 25.428
#   tile 256 / 128, cap 65536      1.979 / 2.926 at 65536
# The widest tile wins everywhere (ROWS = 8 i-bodies a thread share each
# staged j-body and its three reaction shuffles). One triangle is fastest,
# but its scratch grows as 12 N^2 / tile bytes (805 MB at 262144, 13 GB at
# N = 2^20); cap 131072 costs 3-4 % at 135168 and 262144 and bounds each
# launch's scratch at 201 MB. The walk unrolled once, 4 or 8 times, or held
# to 96 registers (5 blocks an SM), ran 1.8-6.0 % behind at 65536.
DEFAULT_SYM_TILE = 1024
SYM_BLOCK_CAP = 131072
# The walk's constants the table was measured with (csrc/symmetric_kernels.cu:
# kSub, the columns of a staged sub-tile, and kUnroll, the steps unrolled).
SYM_SUB = 128
SYM_UNROLL = 2


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
    return _sym(pos, softening, tile, out)


def _sym(pos, softening, tile, out, lib=None):
    """``sym_accel_cuda``. `lib` is the port's library by default, or another
    build of the same source (``scripts/torch_sym_dispatch.py --against``),
    whose launches are not counted."""
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

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    scratch = torch.empty((_cdiv(n, tile), 3, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_sym_accel_f32(
            pos.data_ptr(), n, ctypes.c_float(float(softening) ** 2), tile,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_sym_accel_f32 launch")
    if counted:
        LAUNCHES["sym"] += 1
    return out


def sym_cross_cuda(pos_i, pos_j, softening, *, tile: int = DEFAULT_SYM_TILE, out=None):
    """The rectangle of the i-set (Bi,4) and the j-set (Bj,4), each pair once
    and with no mask (the kernel of ``_sym_cross_kernel``): returns
    (acc_i (Bi,4) with w = 0, react_j (3,Bj)), the JAX package's layout.
    ``out=(acc_i, react_j)`` are preallocated tensors of those shapes."""
    return _sym_cross(pos_i, pos_j, softening, tile, out)


def _sym_cross(pos_i, pos_j, softening, tile, out, lib=None):
    """``sym_cross_cuda``; `lib` as in ``_sym``."""
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

    counted = lib is None
    if counted:
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
    if counted:
        LAUNCHES["sym_cross"] += 1
    return acc_i, react_j


def compute_accel_symmetric_blocked_cuda(pos, softening, *, block_cap: int | None = None,
                                         tile: int | None = None):
    """(N,4) -> (N,3), each pair once at any N: one triangle launch for
    N <= block_cap, else k triangle and k(k-1)/2 cross launches summed in a
    fixed order (``reference.compose_symmetric_blocked``). Defaults from
    ``sym_default_dispatch``."""
    return _sym_blocked(pos, softening, block_cap, tile)


def _sym_blocked(pos, softening, block_cap, tile, lib=None):
    """``compute_accel_symmetric_blocked_cuda``; `lib` as in ``_sym``."""
    cap, t = sym_default_dispatch(pos.shape[0])
    cap = cap if block_cap is None else int(block_cap)
    t = check_sym_tile(t if tile is None else tile)
    (acc,) = reference.compose_symmetric_blocked(
        (pos,), softening, block_cap=cap, tile_j=t,
        triangle=lambda p, soft: (_sym(p, soft, t, None, lib),),
        cross=lambda p_i, p_j, soft: _sym_cross(p_i, p_j, soft, t, None, lib))
    return acc


def sym_ablated_accel_cuda(pos, softening, *, reaction: str, tile: int = DEFAULT_SYM_TILE,
                           with_total: bool = False):
    """The sym triangle of the set (N,4) with its reaction tail ablated (the
    kernel of ``scripts/tpu_r4_sym_budget.py``'s ``_ablate_kernel``, a
    timing experiment): ``reaction`` "full" (the production tail), "none"
    (no reaction) or "tree_small" (its arithmetic and shuffles kept, each
    tile pair's total written to one slot). Returns (acc (N,3), react): acc
    the action sum_{j>i} m_j c_ij d_ij in every variant; react None for
    "none", the reaction (3,N) for "full" (acc + react.T is the
    each-pair-once force), the tile pairs' reaction totals (P,3), P =
    R(R+1)/2 for R = ceil(N / tile), in the kernel's block order, for
    "tree_small". ``with_total`` (full only) adds a third output, the force
    (N,3) summed in ``sym_accel_cuda``'s order, so with its bits. A CPU
    tensor takes ``reference.sym_ablated_accel`` (and, for the total,
    ``reference.compute_accel_symmetric``)."""
    return _sym_ablated(pos, softening, reaction, tile, with_total)


def _sym_ablated(pos, softening, reaction, tile, with_total, lib=None):
    """``sym_ablated_accel_cuda``; `lib` as in ``_sym``."""
    device = pos.device if isinstance(pos, torch.Tensor) else None
    _check_state("pos", pos, device)
    tile = check_sym_tile(tile)
    reaction = reference.check_sym_reaction(reaction)
    if with_total and reaction != "full":
        raise ValueError("with_total needs reaction='full'")
    if device.type != "cuda":
        acc, react = reference.sym_ablated_accel(pos, softening, reaction=reaction, tile=tile)
        if with_total:
            return acc, react, reference.compute_accel_symmetric(pos, softening)
        return acc, react
    n = pos.shape[0]
    tiles = _cdiv(n, tile)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    full, tree = reaction == "full", reaction == "tree_small"
    acc = empty(n, 3)
    react = empty(3, n) if full else empty(tiles * (tiles + 1) // 2, 3) if tree else None
    total = empty(n, 3) if with_total else None
    outs = (acc, react, total) if with_total else (acc, react)
    if n == 0:
        return outs

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    scratch = empty(tiles, 3, n)
    side = empty(3, n) if full else None
    with torch.cuda.device(device):
        err = lib.nbody_sym_ablate_f32(
            pos.data_ptr(), n, ctypes.c_float(float(softening) ** 2), tile,
            reference.SYM_REACTIONS.index(reaction), scratch.data_ptr(),
            side.data_ptr() if full else None, react.data_ptr() if tree else None,
            acc.data_ptr(), react.data_ptr() if full else None,
            total.data_ptr() if with_total else None,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_sym_ablate_f32 launch")
    if counted:
        LAUNCHES[f"sym_ablate_{reaction}"] += 1
    return outs


# ---- accel + jerk, each pair once: csrc/symmetric_aj_kernels.cu ----

# The dispatch table of the blocked accel + jerk composition, its own and
# not the force's: the reaction scratch is 6 N^2 / tile floats, twice the
# force's, and the kernels' registers differ (ptxas, no spills: 56 / 80 /
# 128 / 168 at tile 128 / 256 / 512 / 1024; 4 blocks an SM at 512). Measured
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit by
# scripts/torch_aj_dispatch.py (PERF.md, Findings), ms per call at
# N = 65536 / 135168 / 262144:
#   tile 512,  cap 65536           3.169 / 13.405 / 49.378
#   tile 512,  cap 131072          3.169 / 13.207 / 49.092
#   tile 512,  one triangle        3.169 / 13.224 / 49.931
#   tile 1024, cap 65536           3.229 / 13.910 / 50.565
#   tile 1024, one triangle        3.229 / 13.142 / 48.851
#   tile 256 / 128, cap 65536      3.501 / 5.109 at 65536
#   one-sided accel + jerk         6.228 / 24.319 / 90.129 (block 256)
# Tile 512 is the fastest at 65536 and within 2 % of the fastest choice at
# the larger N; cap 65536 bounds a launch's scratch at 201 MB, as the
# force's table does.
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
    return _aj_sym(pos, vel, softening, tile, out)


def _aj_sym(pos, vel, softening, tile, out, lib=None):
    """``aj_sym_cuda``. `lib` is the port's library by default, or another
    build of the same source (``scripts/torch_aj_dispatch.py --against``),
    whose launches are not counted."""
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

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    scratch = torch.empty((_cdiv(n, tile), 6, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_aj_sym_f32(
            pos.data_ptr(), vel.data_ptr(), n, ctypes.c_float(float(softening) ** 2), tile,
            scratch.data_ptr(), acc.data_ptr(), jerk.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_aj_sym_f32 launch")
    if counted:
        LAUNCHES["aj_sym"] += 1
    return acc, jerk


def aj_sym_cross_cuda(pos_i, vel_i, pos_j, vel_j, softening, *, tile: int = AJ_SYM_TILE,
                      out=None):
    """The accel + jerk rectangle of the i-set (Bi,4) and the j-set (Bj,4),
    each pair once and with no mask (the kernel of ``_aj_sym_cross_kernel``):
    returns (acc_i (Bi,4), jerk_i (Bi,4), both with w = 0, react_acc (3,Bj),
    react_jerk (3,Bj)), the JAX package's layout. ``out`` holds four
    preallocated tensors of those shapes."""
    return _aj_sym_cross(pos_i, vel_i, pos_j, vel_j, softening, tile, out)


def _aj_sym_cross(pos_i, vel_i, pos_j, vel_j, softening, tile, out, lib=None):
    """``aj_sym_cross_cuda``; `lib` as in ``_aj_sym``."""
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

    counted = lib is None
    if counted:
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
    if counted:
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
# `scal` is the (2,4) float32 block of ops/ds.py::scal_ds (Euler) or
# scal_ds_leapfrog (leapfrog), (2,8) scal_ds_hermite for the Hermite glue,
# which the kernels read as hi/lo pairs from device memory at their start: a
# host block is copied there at each launch (ds.scal_on; a ds system uploads
# its fixed-dt block once a call), and a block built on the device
# (ds.ds_scal_with_dt, the adaptive steps') is read where it is, so that a
# step whose dt was chosen on the device never waits on the host.

_PLANES = ("pos_hi", "pos_lo", "vel_hi", "vel_lo")


def _check_scal(scal, device, widths=(4,), *, head: bool = False) -> torch.Tensor:
    """`scal`: a contiguous (2, w) float32 block of ops/ds.py, w in
    `widths`, on the host or on `device`. Returns it on `device` (a host
    block copied there, ds.scal_on), or with `head` its (2,4) head, the
    layout of the kernels that read eps^2 alone (column 1)."""
    if (not isinstance(scal, torch.Tensor) or scal.dtype != torch.float32
            or scal.dim() != 2 or scal.shape[0] != 2 or scal.shape[1] not in widths
            or scal.device.type not in ("cpu", device.type) or not scal.is_contiguous()):
        shapes = " or ".join(f"(2, {w})" for w in widths)
        raise ValueError(f"scal must be the contiguous {shapes} float32 tensor of "
                         "ops/ds.py::scal_ds, scal_ds_leapfrog or scal_ds_hermite, on the "
                         "host or the planes' device")
    if head and scal.shape[1] != 4:
        scal = scal[:, :4].contiguous()
    return ds.scal_on(scal, device)


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
    (jpos_hi, jpos_lo (N,4)): the kernel of ``_ds_step_kernel`` in
    ``ds_splits(M, N)`` j-chunks. Returns the four new (M,4) planes;
    ``out`` holds four preallocated ones, which must not overlap any
    input."""
    return _ds_step(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, scal, block_size, out)


def _ds_step(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, scal, block_size, out,
             splits=None, lib=None):
    """``nbody_step_ds_cuda_vs`` in `splits` j-chunks (``ds_splits`` by
    default). `lib` is the port's library by default, or another build of
    the kernel (``scripts/torch_ds_dispatch.py --against``), whose launches
    are not counted; with splits = 1 only its one-chunk entry point is
    called, which every build has."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(("jpos_hi", "jpos_lo"), (jpos_hi, jpos_lo), device)
    scal = _check_scal(scal, device)
    bs = check_block_size(block_size)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, jpos_hi, jpos_lo))
    if device.type != "cuda":
        for t, r in zip(out, ds.nbody_step_ds_vs(*planes, jpos_hi, jpos_lo, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = ds_splits(m, n) if splits is None else int(splits)
    args = (*(t.data_ptr() for t in (*planes, jpos_hi, jpos_lo, *out)), m, n, scal.data_ptr(),
            bs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if s == 1:
            err = lib.nbody_ds_step(*args, stream)
        else:
            parts = torch.empty((s, 6, m), dtype=torch.float32, device=device)
            err = lib.nbody_ds_step_split(*args, s, parts.data_ptr(), stream)
    _raise_on_error(lib, err, "nbody_ds_step launch")
    if counted:
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
    ``_ds_leapfrog_kernel`` in ``ds_splits(M, N)`` j-chunks. `scal` from
    ``scal_ds_leapfrog``. Returns the four new (M,4) planes."""
    return _ds_leapfrog(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo, scal,
                        block_size, out)


def _ds_leapfrog(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo, scal,
                 block_size, out, splits=None, lib=None):
    """``nbody_step_ds_leapfrog_cuda_vs`` in `splits` j-chunks (``ds_splits``
    by default), through `lib` as ``_ds_step``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    jplanes = (jpos_hi, jpos_lo, jvel_hi, jvel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(tuple("j" + name for name in _PLANES), jplanes, device)
    scal = _check_scal(scal, device)
    bs = check_block_size(block_size)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.nbody_step_ds_leapfrog_vs(*planes, *jplanes, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = ds_splits(m, n) if splits is None else int(splits)
    args = (*(t.data_ptr() for t in (*planes, *jplanes, *out)), m, n, scal.data_ptr(), bs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if s == 1:
            err = lib.nbody_ds_leapfrog(*args, stream)
        else:
            parts = torch.empty((s, 6, m), dtype=torch.float32, device=device)
            err = lib.nbody_ds_leapfrog_split(*args, s, parts.data_ptr(), stream)
    _raise_on_error(lib, err, "nbody_ds_leapfrog launch")
    if counted:
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
# and with the j-split (ds_splits):
#   ds step, block 64 / 128 / 256     2.171 / 2.122 / 2.150 at 16384,
#                                     32.989 / 32.961 / 33.331 at 65536
#   ds sym, tile 256, one triangle    1.473 /  5.625 / 22.026 /  87.711
#   ds sym, tile 512, one triangle    1.687 /  5.749 / 21.732 /  85.184
#   ds sym, tile 512, cap 65536           - /      - / 21.732 /  87.090
#   ds sym, tile 128 / 1024, one triangle: 1.556 / 3.897 at 16384
# A thread owns one i-body (one-sided) or ROWS of them (sym), so up to
# N = 32768 the smaller block and tile put more blocks on the 132 SMs; from
# 65536 on the wider ones win. The split fills the card at any block: the
# one-sided block size then moves the step by 2.3 % at most, and stays as
# the unsplit kernels had it (the ds accel + jerk kernel shares it). Cap
# 65536 bounds a launch's scratch (ceil(N/512) * 6 * N floats) at 201 MB,
# as the fp32 tables do, for 2.2 % against one triangle at N = 131072.
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
    scal = _check_scal(scal, device)
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
    scal = _check_scal(scal, device)
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


def _acc_stride(names, fields, n: int, device) -> int:
    """The row stride, 3 or 4 floats, of ds acceleration fields (N,3): each
    contiguous, or the (N,3) view of a contiguous (N,4) tensor (the rows of
    ``compute_accel_ds_cuda_vs``), all with one stride."""
    strides = set()
    for name, t in zip(names, fields):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 torch.Tensor")
        if tuple(t.shape) != (n, 3):
            raise ValueError(f"{name} must have shape {(n, 3)}; got {tuple(t.shape)}")
        stride = 3 if n <= 1 and t.is_contiguous() else t.stride(0)
        if t.stride(1) != 1 or stride not in (3, 4):
            raise ValueError(f"{name} must have rows of 3 floats, 3 or 4 floats apart")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        strides.add(stride)
    if len(strides) > 1:
        raise ValueError(f"{', '.join(names)} must have one row stride")
    return strides.pop() if strides else 3


def ds_integrate_cuda(pos_hi, pos_lo, vel_hi, vel_lo, acc_hi, acc_lo, scal, *, out=None):
    """The damped Euler update in ds after a force-only evaluation (one
    launch of ``ds_integrate_kernel``, csrc/ds_symmetric_kernels.cu; glue,
    not a TPU kernel): the four new (N,4) planes from the state and the ds
    acceleration (N,3), whose rows may be 3 floats apart (the each-pair-once
    composition) or 4 (the ds accel kernel). Its plain version is
    ``ds.ds_integrate``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    _check_planes(_PLANES, planes, device)
    scal = _check_scal(scal, device)
    n = pos_hi.shape[0]
    stride = _acc_stride(("acc_hi", "acc_lo"), (acc_hi, acc_lo), n, device)
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
            *(t.data_ptr() for t in (*planes, acc_hi, acc_lo)), stride,
            *(t.data_ptr() for t in out), n, scal.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, "nbody_ds_integrate launch")
    LAUNCHES["ds_integrate"] += 1
    return out


def compute_accel_ds_cuda_vs(pos_hi, pos_lo, jpos_hi, jpos_lo, scal, *,
                             block_size: int | None = None, out=None,
                             splits: int | None = None):
    """(acc_hi, acc_lo), each (M,3): the ds acceleration of the i-set (M,4
    planes) under the j-set (N,4 planes), the kernel of
    ``_ds_accel_kernel`` (``compute_accel_pallas_ds``) in `splits`
    j-chunks: by default ``ds_splits(M, N)``, the fused ds step's and
    leapfrog step's. The kernel writes
    (M,4) rows with w = 0 into ``out``, two preallocated (M,4) tensors that
    must not overlap any input (allocated when None), and this returns their
    (M,3) views, the shape of its plain version ``ds.ds_accel_vs``; rows 4
    floats apart, as ``ds_integrate_cuda`` takes them. `scal` is a (2,4) or
    (2,8) block of ops/ds.py, eps^2 in column 1. ``block_size`` defaults to
    ``ds_default_block_size``."""
    return _ds_accel(pos_hi, pos_lo, jpos_hi, jpos_lo, scal, block_size, out, splits)


def _ds_accel(pos_hi, pos_lo, jpos_hi, jpos_lo, scal, block_size, out, splits=None, lib=None):
    """``compute_accel_ds_cuda_vs``, through `lib` as ``_ds_step``."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    _check_planes(_PLANES[:2], (pos_hi, pos_lo), device)
    _check_planes(("jpos_hi", "jpos_lo"), (jpos_hi, jpos_lo), device)
    scal = _check_scal(scal, device, (4, 8), head=True)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    bs = check_block_size(ds_default_block_size(m) if block_size is None else block_size)
    out = _ds_outs(out, [(m, 4)] * 2, device, (pos_hi, pos_lo, jpos_hi, jpos_lo))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_accel_vs(pos_hi, pos_lo, jpos_hi, jpos_lo, scal)):
            t[:, :3] = r
            t[:, 3] = 0.0
        return out[0][:, :3], out[1][:, :3]
    if m == 0:
        return out[0][:, :3], out[1][:, :3]

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = ds_splits(m, n) if splits is None else int(splits)
    args = (*(t.data_ptr() for t in (pos_hi, pos_lo, jpos_hi, jpos_lo, *out)), m, n,
            scal.data_ptr(), bs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if s == 1:
            err = lib.nbody_ds_accel(*args, stream)
        else:
            parts = torch.empty((s, 6, m), dtype=torch.float32, device=device)
            err = lib.nbody_ds_accel_split(*args, s, parts.data_ptr(), stream)
    _raise_on_error(lib, err, "nbody_ds_accel launch")
    if counted:
        LAUNCHES["ds_accel"] += 1
    return out[0][:, :3], out[1][:, :3]


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


def compute_accel_jerk_ds_cuda_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi,
                                  jvel_lo, scal, *, block_size: int | None = None, out=None):
    """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (M,4) with w = 0: the ds
    accel + jerk of the i-set (M,4 planes) under the j-set (N,4 planes),
    the kernel of ``_ds_accel_jerk_kernel`` in ``ds_aj_splits(M, N)``
    j-chunks. ``block_size`` defaults to ``ds_default_block_size``; ``out``
    holds four preallocated (M,4) tensors, which must not overlap any
    input."""
    return _ds_accel_jerk(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo,
                          scal, block_size, out)


def _ds_accel_jerk(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo, scal,
                   block_size, out, splits=None, lib=None):
    """``compute_accel_jerk_ds_cuda_vs`` in `splits` j-chunks
    (``ds_aj_splits`` by default). `lib` is the port's library by default,
    or another build of the kernel (``scripts/torch_ds_aj_dispatch.py
    --against``), whose launches are not counted; with splits = 1 only its
    one-chunk entry point is called, which every build has."""
    device = pos_hi.device if isinstance(pos_hi, torch.Tensor) else None
    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    jplanes = (jpos_hi, jpos_lo, jvel_hi, jvel_lo)
    _check_planes(_PLANES, planes, device)
    _check_planes(tuple("j" + name for name in _PLANES), jplanes, device)
    scal = _check_scal(scal, device, (4, 8), head=True)
    m, n = pos_hi.shape[0], jpos_hi.shape[0]
    bs = check_block_size(ds_default_block_size(m) if block_size is None else block_size)
    out = _ds_outs(out, [(m, 4)] * 4, device, (*planes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_accel_jerk_vs(*planes, *jplanes, scal)):
            t.copy_(r)
        return out
    if m == 0:
        return out

    counted = lib is None
    if counted:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    s = ds_aj_splits(m, n) if splits is None else int(splits)
    args = (*(t.data_ptr() for t in (*planes, *jplanes, *out)), m, n, scal.data_ptr(), bs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if s == 1:
            err = lib.nbody_ds_accel_jerk(*args, stream)
        else:
            parts = torch.empty((s, 12, m), dtype=torch.float32, device=device)
            err = lib.nbody_ds_accel_jerk_split(*args, s, parts.data_ptr(), stream)
    _raise_on_error(lib, err, "nbody_ds_accel_jerk launch")
    if counted:
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
    scal = _check_scal(scal, device, (4, 8), head=True)
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
    scratch = torch.empty((_cdiv(n, tile), 12, n), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_aj_sym(
            *(t.data_ptr() for t in planes), n, scal.data_ptr(), tile, scratch.data_ptr(),
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
    scal = _check_scal(scal, device, (4, 8), head=True)
    tile = check_sym_tile(tile, DS_AJ_TILES)
    bi, bj = pos_hi_i.shape[0], pos_hi_j.shape[0]
    out = _ds_outs(None, [(bi, 4)] * 4 + [(3, bj)] * 4, device, (*iplanes, *jplanes))
    if device.type != "cuda":
        for t, r in zip(out, ds.ds_aj_sym_cross(*iplanes, *jplanes, scal)):
            t.copy_(r)
        return out

    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    scratch_i = torch.empty((_cdiv(bj, tile), 12, bi), dtype=torch.float32, device=device)
    scratch_j = torch.empty((_cdiv(bi, tile), 12, bj), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.nbody_ds_aj_cross(
            *(t.data_ptr() for t in iplanes), bi, *(t.data_ptr() for t in jplanes), bj,
            scal.data_ptr(), tile, scratch_i.data_ptr(), scratch_j.data_ptr(),
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
    scal = _check_scal(scal, device, (8,))
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
    scal = _check_scal(scal, device, (8,))
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


def p3m_sr_launch(tables, lib=None, rng=None):
    """Check the tables of ``p3m.pair_tables`` and launch ``nbody_p3m_sr_f32``
    (the pair kernel and its per-row totals) over them on the current
    stream: the (R, 4) short-range sums of the padded rows (w = 0; rows of
    inert i-rows hold nothing of use). With `rng`, a rank's range of
    ``p3m.item_range`` ((4,) int32 on the device), ``nbody_p3m_sr_range_f32``
    over that range: the rows of its clusters, zeros elsewhere. `lib` is the
    port's library by default, or another build of the same source
    (``scripts/torch_p3m_bench.py``). Does not count: see
    ``p3m_sr_pairs_cuda`` and ``p3m_sr_range_cuda``."""
    padded = tables.padded
    device = padded.device
    _check_state("padded", padded, device)
    if tables.blk not in P3M_BLKS:
        raise ValueError(f"blk must be one of {P3M_BLKS}; got {tables.blk}")
    if device.type != "cuda":
        raise ValueError("p3m_sr_pairs_cuda launches the CUDA pair kernel; the tables are on "
                         f"{device}")
    clusters, items, cells = padded.shape[0] // 32, tables.it_cl.shape[0], tables.gc ** 3
    sizes = {"cfirst": cells, "ncl": cells, "cl_cell": clusters, "it_cl": items,
             "it_k0": items, "it_k1": items, "cl_item0": clusters, "cl_nitem": clusters}
    ints = tuple(getattr(tables, name) for name in sizes)
    for (name, size), t in zip(sizes.items(), ints):
        if (t.dtype != torch.int32 or not t.is_contiguous() or t.device != device
                or t.shape != (size,)):
            raise ValueError(f"the pair tables' {name} must be ({size},) contiguous int32 on "
                             f"{device}")
    box = tables.box
    if (padded.shape[0] % 32 or box.shape != (clusters, 8) or box.dtype != torch.float32
            or not box.is_contiguous() or box.device != device):
        raise ValueError("the pair tables' box must be (rows / 32, 8) float32, rows a "
                         "multiple of 32")
    if tables.meta.dtype != torch.float32 or tables.meta.shape != (4,):
        raise ValueError("the pair tables' meta must be (4,) float32")
    if lib is None:
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
    acc_pad = torch.empty_like(padded)
    partial = torch.empty((items, 3, 32), dtype=torch.float64, device=device)
    if rng is None:
        next_item = torch.zeros(1, dtype=torch.int32, device=device)
        ranged = ()
        entry = "nbody_p3m_sr_f32"
    else:
        if rng.dtype != torch.int32 or rng.shape != (4,) or rng.device != device:
            raise ValueError(f"the range must be (4,) int32 on {device}")
        rng = rng.contiguous()
        next_item = rng[:1].clone()  # the counter starts at item_lo
        ranged = (rng.data_ptr(),)
        entry = "nbody_p3m_sr_range_f32"
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            padded.data_ptr(), box.data_ptr(), *(t.data_ptr() for t in ints),
            tables.meta.data_ptr(), *ranged, partial.data_ptr(), next_item.data_ptr(),
            acc_pad.data_ptr(), items, padded.shape[0], tables.gc, tables.blk,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, err, f"{entry} launch")
    return acc_pad


def p3m_sr_pairs_cuda(tables):
    """One launch of the pair kernel ``nbody_p3m_sr_f32`` over the tables of
    ``p3m.pair_tables`` (``p3m_sr_launch``), counted: the (R, 4) short-range
    sums of the padded rows. CUDA tensors only: the CPU has no counterpart
    of the padded rows' sums (its plain version of the whole short range is
    ``reference.p3m_short_range``)."""
    acc_pad = p3m_sr_launch(tables)
    LAUNCHES["p3m_sr"] += 1
    return acc_pad


def p3m_sr_range_cuda(tables, rng):
    """One launch of the pair kernel over a rank's range of the tables'
    work (``nbody_p3m_sr_range_f32``; `rng` from ``p3m.item_range``),
    counted: the (R, 4) sums of the range's padded rows, zeros elsewhere,
    each row bit-equal to the whole launch's. CUDA tensors only: the plain
    version of a range is ``p3m.short_range_part`` on a CPU tensor."""
    acc_pad = p3m_sr_launch(tables, rng=rng)
    LAUNCHES["p3m_sr_range"] += 1
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
    with annotate("nbody.p3m.pairs"):
        return p3m.short_range_from_tables(p3m_sr_pairs_cuda(tables), tables), tables.overflow


# ---- the fused ring force: csrc/ring_kernels.cu ----

# the bound of every wait in the ring kernel: past it the kernel gives up
# and the wrapper raises
RING_TIMEOUT_S = 10.0
# the most ranks one launch holds (an emulated ring's D)
RING_MAX_LAUNCH_RANKS = 16
_RING_WAITS = {1: "its left neighbour's shard", 2: "its right neighbour's credit for a slot"}


def step_rows(block_size: int) -> int:
    """i-rows a thread of the step walk's kernels at `block_size` threads
    (rows_a_thread, csrc/allpairs_common.cuh)."""
    return STEP_ROWS if block_size <= 512 else 1


def ring_items(m: int, block_size: int) -> int:
    """The work items of a fused ring hop over shards of m bodies: the force
    kernel's blocks at (m, m), i-tiles of step_rows * block_size rows times
    ``step_splits(m, m)`` j-chunks."""
    return _cdiv(m, step_rows(block_size) * block_size) * step_splits(m, m)


def ring_coresident_blocks(device, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """Blocks of the ring kernel at `block_size` threads that the card holds
    at once: the most one cooperative launch may have."""
    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    out = ctypes.c_int64()
    with torch.cuda.device(device):
        err = lib.nbody_ring_coresident_blocks(check_block_size(block_size), ctypes.byref(out))
    _raise_on_error(lib, err, "nbody_ring_coresident_blocks")
    return int(out.value)


def ring_groups(m: int, launch_ranks: int, block_size: int, device) -> int:
    """Blocks a rank for shards of m bodies when one launch holds
    `launch_ranks` ranks: one a work item of a hop (``ring_items``), as many
    as all the ranks' blocks can be resident together. Raises rather than
    give a grid the card cannot hold, whose spinning blocks would wait on
    blocks that never run."""
    fits = ring_coresident_blocks(device, block_size) // launch_ranks
    if fits < 1:
        raise RuntimeError(f"{launch_ranks} ring ranks of block size {block_size} do not fit "
                           "on the card together; the ring kernel's blocks wait on each other")
    return min(ring_items(m, block_size), fits)


def _release_ring(device, base: int, peers: list) -> None:
    """Unmap the peers' regions and free a ring's own (a finalizer: the
    codes are not checked, the process may be ending)."""
    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        for p in peers:
            lib.nbody_ring_ipc_close(p)
        lib.nbody_ring_free(base)


class FusedRing:
    """One rank's side of a fused ring of `ring_size` ranks for shards of
    `m` bodies: on a card, its region (two j-slots and the flags of
    ``csrc/ring_kernels.cu``) from cudaMalloc in the library, not from
    PyTorch's caching allocator (an IPC handle of a cached block would name
    its segment's base), and its neighbours' regions once ``connect`` has
    them; ``calls`` counts its launches, the epoch of the flags; ``splits``
    is the j-chunks of a hop, ``step_splits(m, m)``, so that a hop is the
    force kernel's at (m, m). On the CPU it holds no buffers, only
    ``hops``: a function of a shard that yields the ring's j-shards in hop
    order (the mesh's exchanges), from which the wrapper takes the plain
    version. ``close()`` frees the region (so does garbage collection); a
    ring whose launch failed or timed out is broken and raises on use."""

    def __init__(self, m: int, ring_size: int, rank: int, *, device,
                 block_size: int = DEFAULT_BLOCK_SIZE, groups: int | None = None,
                 hops=None):
        self.m, self.ring_size, self.rank = int(m), int(ring_size), int(rank)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.block_size = check_block_size(block_size)
        self.splits = step_splits(self.m, self.m)
        self.calls = 0
        self.broken = None
        self.hops = hops
        if self.m < 1 or not 0 <= self.rank < self.ring_size:
            raise ValueError(f"a ring needs m >= 1 and 0 <= rank < ring_size; got m={m}, "
                             f"rank={rank}, ring_size={ring_size}")
        if self.device.type != "cuda":
            if hops is None:
                raise ValueError("a fused ring on the CPU needs `hops`, the mesh's exchanges")
            self.groups = self.base = None
            return
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
        self.groups = (ring_groups(self.m, 1, self.block_size, self.device) if groups is None
                       else int(groups))
        base = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            err = lib.nbody_ring_alloc(self.m, self.groups, ctypes.byref(base))
        _raise_on_error(lib, err, "nbody_ring_alloc")
        self.base = self.left = self.right = base.value
        self._peers = []  # regions mapped from other processes, unmapped on close
        self._release = weakref.finalize(self, _release_ring, self.device, self.base,
                                         self._peers)

    def ipc_handle(self) -> bytes:
        """The 64-byte CUDA IPC handle of this rank's region."""
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
        buf = ctypes.create_string_buffer(lib.nbody_ring_ipc_handle_bytes())
        with torch.cuda.device(self.device):
            err = lib.nbody_ring_ipc_handle(self.base, buf)
        _raise_on_error(lib, err, "cudaIpcGetMemHandle")
        return buf.raw

    def connect(self, left, right) -> None:
        """Take the neighbours' regions: each a FusedRing of this process (an
        emulated ring), or the IPC handle of another process's region, which
        is mapped here (once a peer, also when left and right are one)."""
        from nbody_tpu_torch.ops._build import load_library

        lib = load_library()
        opened = {}

        def region(peer):
            if isinstance(peer, FusedRing):
                return peer.base
            if peer not in opened:
                base = ctypes.c_void_p()
                with torch.cuda.device(self.device):
                    err = lib.nbody_ring_ipc_open(bytes(peer), ctypes.byref(base))
                _raise_on_error(lib, err, "cudaIpcOpenMemHandle")
                opened[peer] = base.value
                self._peers.append(base.value)
            return opened[peer]

        self.left, self.right = region(left), region(right)

    def close(self) -> None:
        """Free the region now. A launch returns only after the peers' last
        writes into it, so this is safe between calls; no rank of the ring
        may launch again."""
        if self.base is not None:
            self._release()
            self.base = None
            self.broken = "the ring was closed"


def _ring_launch(entries, softening, timeout_s: float) -> None:
    """One launch of the ring kernel over `entries`, (pos, acc, ring) for
    each rank it holds (the rings of one launch share their count of calls,
    the epoch), and its finish, which adds each rank's hops' chunk sums
    (scratch of D * S * 3 * M floats a rank) into acc; then the launch's
    error word is read, which synchronises the stream, and a timeout
    raises."""
    rings = [ring for _, _, ring in entries]
    for ring in rings:
        if ring.broken:
            raise RuntimeError(f"ring_fused: this ring is unusable ({ring.broken})")
    r0 = rings[0]
    from nbody_tpu_torch.ops._build import load_library

    lib = load_library()
    parts = torch.empty((len(entries), r0.ring_size, r0.splits, 3, r0.m), dtype=torch.float32,
                        device=r0.device)
    rows = []
    for (pos, acc, ring), part in zip(entries, parts):
        rows += [pos.data_ptr(), acc.data_ptr(), part.data_ptr(), ring.base, ring.right,
                 ring.left, ring.rank]
    table = (ctypes.c_int64 * len(rows))(*rows)
    epoch = r0.calls + 1
    word = ctypes.c_uint64()
    with torch.cuda.device(r0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nbody_ring_accel_f32(
            table, len(entries), r0.ring_size, r0.m, r0.groups, r0.splits,
            ctypes.c_float(float(softening) ** 2), r0.block_size, epoch,
            int(timeout_s * 1e9), stream)
        for ring in rings:
            ring.calls = epoch
        if err:
            for ring in rings:
                ring.broken = f"launch {epoch} failed"
        _raise_on_error(lib, err, "nbody_ring_accel_f32 launch")
        LAUNCHES["ring_fused"] += 1
        err = lib.nbody_ring_read_error(r0.base, r0.m, r0.groups, stream, ctypes.byref(word))
    _raise_on_error(lib, err, "nbody_ring_accel_f32")
    if word.value:
        kind, rank, hop = word.value >> 48, (word.value >> 24) & 0xFFFFFF, word.value & 0xFFFFFF
        for ring in rings:
            ring.broken = f"launch {epoch} timed out"
        raise RuntimeError(
            f"ring_fused: rank {rank} gave up at hop {hop} of launch {epoch} after waiting "
            f"{timeout_s} s for {_RING_WAITS.get(kind, f'wait kind {kind}')}")


def ring_accel_fused_cuda(pos_shard, softening, ring: FusedRing, *,
                          timeout_s: float = RING_TIMEOUT_S):
    """The (M,3) acceleration of this rank's (M,4) shard under every shard of
    the ring, all D hops in one launch of the ring kernel (the kernel of
    ``ring_kernel.py::_kernel``), the j-shards carried between the ranks'
    regions inside it; every rank of the ring must call it, once a call. On
    a CUDA tensor the kernel runs, or this raises (also when a wait of the
    kernel timed out after `timeout_s`). On a CPU tensor (and a CPU ring)
    the plain version: the ring's exchanges (``ring.hops``), each hop's force
    by ``reference.compute_accel_vs``, summed in hop order."""
    device = pos_shard.device if isinstance(pos_shard, torch.Tensor) else None
    _check_state("pos_shard", pos_shard, ring.device)
    if pos_shard.shape[0] != ring.m:
        raise ValueError(f"the ring carries shards of {ring.m} bodies; pos_shard has "
                         f"{pos_shard.shape[0]}")
    if device.type != "cuda":
        total = None
        for j in ring.hops(pos_shard):
            part = reference.compute_accel_vs(pos_shard, j, softening)
            total = part if total is None else total + part
        return total
    acc = torch.empty((ring.m, 3), dtype=torch.float32, device=device)
    _ring_launch([(pos_shard, acc, ring)], softening, timeout_s)
    return acc


def emulated_ring(device, d: int, m: int, block_size: int = DEFAULT_BLOCK_SIZE) -> list:
    """The D FusedRings of an emulated ring on one card: D virtual ranks in
    one launch, each rank's region in that card's memory, rank r's right
    neighbour r+1 and its left r-1. Pass them to successive calls of
    ``ring_accel_fused_emulated_cuda``, as a real ring's ranks keep theirs,
    and close them when done."""
    device = torch.device(device)
    groups = ring_groups(m, d, block_size, device)
    rings = [FusedRing(m, d, r, device=device, block_size=block_size, groups=groups)
             for r in range(d)]
    for r, ring in enumerate(rings):
        ring.connect(rings[(r - 1) % d], rings[(r + 1) % d])
    return rings


def ring_accel_fused_emulated_cuda(shards, softening, *, rings: list | None = None,
                                   block_size: int = DEFAULT_BLOCK_SIZE,
                                   timeout_s: float = RING_TIMEOUT_S):
    """The fused ring on one card: the list of D (M,4) shards (D virtual
    ranks) to their D (M,3) accelerations, in one cooperative launch of the
    ring kernel whose block groups are the ranks; it runs the copies, the
    double buffer, the credits and the hop order of a real ring of D cards.
    `rings` are the ranks' buffers (``emulated_ring``), kept across calls as
    a real ring keeps them; without them the call makes its own and frees
    them after. On a CUDA tensor the kernel runs, or this raises; on CPU
    tensors the plain version, ``reference.ring_accel_fused_plain``."""
    shards = list(shards)
    d = len(shards)
    if not 1 <= d <= RING_MAX_LAUNCH_RANKS:
        raise ValueError(f"an emulated ring has 1 to {RING_MAX_LAUNCH_RANKS} ranks; got {d}")
    device = shards[0].device if isinstance(shards[0], torch.Tensor) else None
    for k, s in enumerate(shards):
        _check_state(f"shards[{k}]", s, device)
        if s.shape[0] != shards[0].shape[0]:
            raise ValueError(f"the shards must have one length; shards[{k}] has "
                             f"{s.shape[0]} rows, shards[0] {shards[0].shape[0]}")
    bs = check_block_size(block_size)
    if device.type != "cuda":
        return reference.ring_accel_fused_plain(shards, softening)
    m = shards[0].shape[0]
    accs = [torch.empty((m, 3), dtype=torch.float32, device=device) for _ in shards]
    if m == 0:
        return accs
    own = rings is None
    if own:
        rings = emulated_ring(device, d, m, bs)
    elif len(rings) != d or any(r.m != m or r.block_size != bs for r in rings):
        raise ValueError(f"the rings carry {len(rings)} ranks' shards; the call has {d} shards "
                         f"of {m} bodies at block size {bs}")
    try:
        _ring_launch(list(zip(shards, accs, rings)), softening, timeout_s)
    finally:
        if own:
            for ring in rings:
                ring.close()
    return accs
