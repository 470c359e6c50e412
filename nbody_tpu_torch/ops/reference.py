"""Plain PyTorch all-pairs N-body step: the port's portable path.

Counterpart of ``nbody_tpu/ops/reference.py`` (the XLA path). It runs on any
torch device and dtype, and it is the plain version that the hand-written
CUDA kernels (``ops/cuda_kernel.py``) are held to, on the CPU in the tests
and on the card in ``chip_smoke.py``. It also holds the leapfrog step, the
accel + jerk evaluation and the Hermite step, and the each-pair-once
(symmetric) force and accel + jerk with their rectangles and blocked
composition, and the P3M short-range force (``p3m_short_range``).

Physics (the reference CUDA sample's bodyBodyInteraction + integrateBodies):

    d_ij = p_j - p_i
    s_ij = m_j * (|d_ij|^2 + softening^2) ** (-3/2)      (Plummer)
    a_i  = sum_j s_ij * d_ij        (the self pair adds 0 because d_ii = 0)
    v'   = (v + a * dt) * damping   (damped semi-implicit Euler)
    p'   = p + v' * dt

Memory: the broadcast over one chunk of i-rows holds a few (C, N) tensors.
Rows are zero-padded up to a multiple of the chunk, so every chunk has the
same shape and no divisor of N is searched for.
"""

from __future__ import annotations

import functools
import math
import operator

import torch

DEFAULT_CHUNK = 4096


def _chunk_and_pad(n: int, chunk_size: int | None) -> tuple[int, int]:
    """(chunk, padded_n) for n rows; padded_n is a multiple of chunk."""
    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK
    c = max(1, min(n, int(chunk_size)))
    return c, ((n + c - 1) // c) * c


def _accel_rows(rows_p, all_p, all_m, eps2):
    """Acceleration (C,3) on rows_p (C,3) due to all_p (N,3) with masses (N,)."""
    dx = all_p[None, :, 0] - rows_p[:, 0:1]  # (C, N)
    dy = all_p[None, :, 1] - rows_p[:, 1:2]
    dz = all_p[None, :, 2] - rows_p[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    s = all_m[None, :] * (inv * inv * inv)
    return torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)


def compute_accel_vs(pos_i, pos_j, softening, *, chunk_size: int | None = None):
    """Acceleration (M,3) on the i-set (M,4) due to the j-set (N,4)."""
    m_rows = pos_i.shape[0]
    ri = pos_i[:, :3]
    p3 = pos_j[:, :3]
    m = pos_j[:, 3]
    eps2 = float(softening) ** 2
    if m_rows == 0:
        return pos_i.new_zeros((0, 3))
    c, m_pad = _chunk_and_pad(m_rows, chunk_size)
    if c == m_rows:
        return _accel_rows(ri, p3, m, eps2)
    if m_pad != m_rows:
        ri = torch.cat([ri, ri.new_zeros((m_pad - m_rows, 3))])
    acc = torch.cat([_accel_rows(r, p3, m, eps2) for r in ri.split(c)])
    return acc[:m_rows]


def compute_accel(pos, softening, *, chunk_size: int | None = None):
    """Gravitational acceleration (N,3) for the AoS state pos (N,4)=[x,y,z,m]."""
    return compute_accel_vs(pos, pos, softening, chunk_size=chunk_size)


def integrate(pos, vel, acc, dt, damping):
    """Damped semi-implicit Euler update; the mass and the velocity w-lane
    pass through untouched."""
    v3 = (vel[:, :3] + acc * dt) * damping
    p3 = pos[:, :3] + v3 * dt
    return torch.cat([p3, pos[:, 3:4]], dim=1), torch.cat([v3, vel[:, 3:4]], dim=1)


def nbody_step_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                  *, chunk_size: int | None = None):
    """Step the i-set under forces from the j-set (the general sharded form)."""
    acc = compute_accel_vs(pos_i, pos_j, softening, chunk_size=chunk_size)
    return integrate(pos_i, vel_i, acc, dt, damping)


def nbody_step(pos, vel, dt, softening, damping, *, chunk_size: int | None = None):
    """One integration step; returns (new_pos, new_vel) in the same (N,4) layout."""
    return nbody_step_vs(pos, vel, pos, dt, softening, damping, chunk_size=chunk_size)


def rollout(pos, vel, dt, softening, damping, *, steps: int,
            chunk_size: int | None = None):
    """`steps` integration steps, one after another."""
    for _ in range(steps):
        pos, vel = nbody_step(pos, vel, dt, softening, damping, chunk_size=chunk_size)
    return pos, vel


# ---- the force reduction as a matrix product (variant "mxu" / "mxu_bf16") ----
#
# The algebra of nbody_tpu/ops/pallas_kernel.py::_mxu_accumulate_tile and
# _mxu_step_kernel's finalize (:125-199), which is not the one-sided force
# in other words:
#   s_ij  = rsqrt(|p_j - p_i|^2 + eps^2)^3      (no mass, no d, no self mask)
#   P_j   = [x_j m_j, y_j m_j, z_j m_j, m_j]
#   acc4  = s @ P;   a_i = acc4[:, :3] - p_i * acc4[:, 3]
# "mxu" takes the product in float32; "mxu_bf16" rounds s and P to bfloat16
# (round to nearest even) and sums their products in float32. The product
# here is a float32 matmul of the (rounded) values: on the card that needs
# torch.backends.cuda.matmul.allow_tf32 False (PyTorch's default), or the
# yardstick itself rounds to TF32; a bf16 matmul is avoided because cuBLAS
# may reduce it in lower precision. A zero-mass body adds exactly 0 to acc4,
# so the JAX package's zero-mass j-padding needs no counterpart.

MXU_VARIANTS = ("mxu", "mxu_bf16")
MXU_DTYPES = {"mxu": torch.float32, "mxu_bf16": torch.bfloat16}

# The error model of an mxu force, per row i and component k,
#   E_ik = sum_j |s_ij| (|P_jk| + |p_ik| |m_j|),
# and the coefficient C of a bound C * E_ik on the difference of two
# evaluations of the same algebra (kernel and plain version, or the port and
# nbody_tpu):
#   mxu_bf16: 2 * 2^-8. Each side rounds s_ij to bf16 (error <= 2^-8 |s_ij|
#     each), and the two float32 s_ij may differ in their last bits (rsqrtf
#     against torch.rsqrt), so the two may round to neighbouring bf16
#     values, at most 2^-7 |s_ij| apart; P_j is rounded identically. The
#     float32 sums add < 2^-15 relative, below that.
#   mxu: 16 * 2^-20. The float32 s_ij differ by a few ulp (<= 2^-21); the
#     card's 3xTF32 products drop terms of <= 3 * 2^-22 relative; the
#     rounding of the float32 sums grows as a random walk over the j-tiles
#     (sqrt(N/128) * 2^-24 <= 2^-19.5 at N=65536), on each side. About
#     4 * 2^-20 in all; C keeps a factor 4 above it.
# Against the oracle's one-sided force, the same model bounds what the
# algebra adds, on top of the one-sided rule (compute.py).
MXU_ERROR_COEF = {"mxu": 16 * 2.0 ** -20, "mxu_bf16": 2 * 2.0 ** -8}


def check_mxu_variant(variant: str) -> str:
    if variant not in MXU_VARIANTS:
        raise ValueError(f"unknown mxu variant {variant!r}; expected one of {MXU_VARIANTS}")
    return variant


def _mxu_fold(pos_j):
    """P (N,4) = [x m, y m, z m, m] of the j-set, in float32."""
    m = pos_j[:, 3:4]
    return torch.cat([pos_j[:, :3] * m, m], dim=1)


def _mxu_s_rows(rows_p, all_p, eps2):
    """s (C,N) = rsqrt(|p_j - p_i|^2 + eps^2)^3 of rows_p (C,3) against
    all_p (N,3), in the arithmetic of _mxu_accumulate_tile."""
    dx = all_p[None, :, 0] - rows_p[:, 0:1]
    dy = all_p[None, :, 1] - rows_p[:, 1:2]
    dz = all_p[None, :, 2] - rows_p[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    return inv * inv * inv


def _check_no_tf32(t) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the plain mxu step takes a float32 product; on the card that needs "
            "torch.backends.cuda.matmul.allow_tf32 = False (PyTorch's default)")


def _by_row_chunks(fn, rows, chunk_size):
    """fn over the (C,3) row chunks of rows (M,3), zero-padded to equal
    chunks, concatenated and cut back to M rows."""
    m_rows = rows.shape[0]
    c, m_pad = _chunk_and_pad(m_rows, chunk_size)
    if m_pad != m_rows:
        rows = torch.cat([rows, rows.new_zeros((m_pad - m_rows, 3))])
    return torch.cat([fn(r) for r in rows.split(c)])[:m_rows]


def _mxu_rows(rows_p, pos_j, eps2, variant, *, chunk_size):
    """acc4 (C,4) = s @ P of the rows rows_p (C,3), chunked over the rows."""
    P = _mxu_fold(pos_j)
    if variant == "mxu_bf16":
        P = P.to(torch.bfloat16).float()
    _check_no_tf32(P)
    p3 = pos_j[:, :3]

    def acc4(r):
        s = _mxu_s_rows(r, p3, eps2)
        if variant == "mxu_bf16":
            s = s.to(torch.bfloat16).float()
        return s @ P

    return _by_row_chunks(acc4, rows_p, chunk_size)


def compute_accel_mxu_vs(pos_i, pos_j, softening, *, variant: str,
                         chunk_size: int | None = None):
    """Acceleration (M,3) on the i-set (M,4) due to the j-set (N,4) in the
    mxu algebra: acc4[:, :3] - p_i * acc4[:, 3]."""
    check_mxu_variant(variant)
    if pos_i.shape[0] == 0:
        return pos_i.new_zeros((0, 3))
    eps2 = float(softening) ** 2
    sp = _mxu_rows(pos_i[:, :3], pos_j, eps2, variant, chunk_size=chunk_size)
    return sp[:, :3] - pos_i[:, :3] * sp[:, 3:4]


def nbody_step_mxu_vs(pos_i, vel_i, pos_j, dt, softening, damping, *, mxu_dtype,
                      chunk_size: int | None = None):
    """The fused Euler step of ``_mxu_step_kernel``: the i-set (M,4) under
    the j-set (N,4), the force reduced as a matrix product. `mxu_dtype` is
    torch.float32 (variant "mxu") or torch.bfloat16 ("mxu_bf16")."""
    variant = {v: k for k, v in MXU_DTYPES.items()}.get(mxu_dtype)
    if variant is None:
        raise ValueError(f"mxu_dtype must be torch.float32 or torch.bfloat16; got {mxu_dtype}")
    acc = compute_accel_mxu_vs(pos_i, pos_j, softening, variant=variant,
                               chunk_size=chunk_size)
    return integrate(pos_i, vel_i, acc, dt, damping)


def nbody_step_mxu(pos, vel, dt, softening, damping, *, mxu_dtype,
                   chunk_size: int | None = None):
    """Single-device mxu step: the whole set on itself."""
    return nbody_step_mxu_vs(pos, vel, pos, dt, softening, damping, mxu_dtype=mxu_dtype,
                             chunk_size=chunk_size)


def mxu_error_scale(pos_i, pos_j, softening, *, chunk_size: int | None = None):
    """E (M,3), E_ik = sum_j |s_ij| (|P_jk| + |p_ik| |m_j|), with the float32
    s of the plain version: the scale of the mxu error model
    (MXU_ERROR_COEF)."""
    if pos_i.shape[0] == 0:
        return pos_i.new_zeros((0, 3))
    absP = _mxu_fold(pos_j).abs()
    _check_no_tf32(absP)
    p3 = pos_j[:, :3]
    eps2 = float(softening) ** 2

    def scale(r):
        sp = _mxu_s_rows(r, p3, eps2).abs() @ absP
        return sp[:, :3] + r.abs() * sp[:, 3:4]

    return _by_row_chunks(scale, pos_i[:, :3], chunk_size)


def mxu_step_tolerance(pos_i, vel_i, pos_j, step, dt, softening, damping, *, variant: str):
    """(tol_pos, tol_vel), each (M,3): the bound on the difference of two
    evaluations of the mxu step from the same state, given one of them,
    step = (new_pos, new_vel). The force's MXU_ERROR_COEF[variant] * E is
    carried through v' = (v + a dt) damping and p' = p + v' dt, plus 2^-22
    of each operand of the update for its own rounding (once the forces
    differ, the two may round apart; |a| <= E bounds the a dt operand)."""
    e = mxu_error_scale(pos_i, pos_j, softening)
    new_pos, new_vel = step
    ulp = 2.0 ** -22
    tol_vel = (abs(float(damping)) * float(dt) * MXU_ERROR_COEF[check_mxu_variant(variant)] * e
               + ulp * (vel_i[:, :3].abs() + float(dt) * e + new_vel[:, :3].abs()))
    tol_pos = float(dt) * tol_vel + ulp * (pos_i[:, :3].abs() + new_pos[:, :3].abs())
    return tol_pos, tol_vel


def integrate_into(pos, vel, acc, dt, damping, out) -> None:
    """`integrate` written into out=(new_pos, new_vel), preallocated (N,4)
    tensors that do not overlap the inputs: the step of the ping-pong
    buffers, in five elementwise passes."""
    new_pos, new_vel = out
    new_vel.copy_(vel)
    new_vel[:, :3].add_(acc * dt).mul_(damping)
    new_pos.copy_(pos)
    new_pos[:, :3].add_(new_vel[:, :3] * dt)


def nbody_step_leapfrog(pos, vel, dt, softening, damping, *, accel_fn=None,
                        chunk_size: int | None = None):
    """Symplectic drift-kick-drift (leapfrog) step, line for line the JAX
    package's ``ops/reference.py::nbody_step_leapfrog``:

        p½ = p + v·dt/2
        v' = (v + a(p½)·dt) · damping
        p' = p½ + v'·dt/2

    `accel_fn(pos4) -> (N,3)` plugs in a force kernel; it defaults to the
    plain one-sided force."""
    if accel_fn is None:
        def accel_fn(p4):
            return compute_accel(p4, softening, chunk_size=chunk_size)

    p_half = pos[:, :3] + vel[:, :3] * (dt / 2)
    pos_half = torch.cat([p_half, pos[:, 3:4]], dim=1)
    acc = accel_fn(pos_half)
    v3 = (vel[:, :3] + acc * dt) * damping
    p3 = p_half + v3 * (dt / 2)
    return torch.cat([p3, pos[:, 3:4]], dim=1), torch.cat([v3, vel[:, 3:4]], dim=1)


# ---- accel + jerk (the Hermite scheme's force evaluation) ----
#
#   a_i = sum_j m_j d / r^3
#   j_i = sum_j m_j [ dv / r^3 - 3 (d . dv) d / r^5 ]
# with d = p_j - p_i, dv = v_j - v_i and the softened r^2. Only the xyz
# lanes of vel enter: vel.w is not a velocity.


def _accel_jerk_rows(rp, rv, pj, vj, mj, eps2):
    """(acc (C,3), jerk (C,3)) on rows rp, rv (C,3) due to pj, vj (N,3) with
    masses mj (N,), in the arithmetic of ``_accel_jerk_kernel``."""
    dx = pj[None, :, 0] - rp[:, 0:1]  # (C, N)
    dy = pj[None, :, 1] - rp[:, 1:2]
    dz = pj[None, :, 2] - rp[:, 2:3]
    dvx = vj[None, :, 0] - rv[:, 0:1]
    dvy = vj[None, :, 1] - rv[:, 1:2]
    dvz = vj[None, :, 2] - rv[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    s = mj[None, :] * (inv * inv2)  # m_j / r^3
    rv3 = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv2
    acc = torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)
    jerk = torch.stack([(s * (dvx - rv3 * dx)).sum(1), (s * (dvy - rv3 * dy)).sum(1),
                        (s * (dvz - rv3 * dz)).sum(1)], dim=1)
    return acc, jerk


def compute_accel_jerk_vs(pos_i, vel_i, pos_j, vel_j, softening,
                          *, chunk_size: int | None = None):
    """(acc, jerk), each (M,3), on the i-set (M,4) due to the j-set (N,4)."""
    m_rows = pos_i.shape[0]
    if m_rows == 0:
        return pos_i.new_zeros((0, 3)), pos_i.new_zeros((0, 3))
    ri, rv = pos_i[:, :3], vel_i[:, :3]
    pj, vj, mj = pos_j[:, :3], vel_j[:, :3], pos_j[:, 3]
    eps2 = float(softening) ** 2
    c, m_pad = _chunk_and_pad(m_rows, chunk_size)
    if c == m_rows:
        return _accel_jerk_rows(ri, rv, pj, vj, mj, eps2)
    if m_pad != m_rows:
        ri = torch.cat([ri, ri.new_zeros((m_pad - m_rows, 3))])
        rv = torch.cat([rv, rv.new_zeros((m_pad - m_rows, 3))])
    parts = [_accel_jerk_rows(a, b, pj, vj, mj, eps2) for a, b in zip(ri.split(c), rv.split(c))]
    acc = torch.cat([a for a, _ in parts])[:m_rows]
    jerk = torch.cat([j for _, j in parts])[:m_rows]
    return acc, jerk


def compute_accel_jerk(pos, vel, softening, *, chunk_size: int | None = None):
    """(acc, jerk), each (N,3), of the set on itself."""
    return compute_accel_jerk_vs(pos, vel, pos, vel, softening, chunk_size=chunk_size)


def hermite_predict(x0, v0, a0, j0, dt):
    """Hermite P(EC) predictor: the Taylor expansion through the jerk."""
    xp = x0 + v0 * dt + a0 * (dt * dt / 2) + j0 * (dt * dt * dt / 6)
    vp = v0 + a0 * dt + j0 * (dt * dt / 2)
    return xp, vp


def hermite_correct(x0, v0, a0, j0, a1, j1, dt, damping):
    """Hermite P(EC) corrector, with the reference's damping multiplier on
    the corrected velocity."""
    v1 = (v0 + (dt / 2) * (a0 + a1) + (dt * dt / 12) * (j0 - j1)) * damping
    x1 = x0 + (dt / 2) * (v0 + v1) + (dt * dt / 12) * (a0 - a1)
    return x1, v1


def nbody_step_hermite(pos, vel, dt, softening, damping, *, accel_jerk_fn=None,
                       chunk_size: int | None = None):
    """4th-order Hermite predictor-corrector step, P(EC), line for line the
    JAX package's ``ops/reference.py::nbody_step_hermite``:

        predict:  x_p = x + v dt + a0 dt^2/2 + j0 dt^3/6
                  v_p = v + a0 dt + j0 dt^2/2
        evaluate: (a1, j1) at the predicted state
        correct:  v1 = (v + dt/2 (a0+a1) + dt^2/12 (j0-j1)) * damping
                  x1 = x + dt/2 (v+v1) + dt^2/12 (a0-a1)

    Two accel+jerk evaluations a step, the first at the start of the step:
    (a1, j1) are not carried into the next step, as the JAX package does
    not carry them. `accel_jerk_fn(pos4, vel4) -> (acc, jerk)` plugs in a
    kernel; it defaults to the plain one-sided evaluation."""
    if accel_jerk_fn is None:
        def accel_jerk_fn(p4, v4):
            return compute_accel_jerk(p4, v4, softening, chunk_size=chunk_size)

    x0, v0 = pos[:, :3], vel[:, :3]
    a0, j0 = accel_jerk_fn(pos, vel)
    xp, vp = hermite_predict(x0, v0, a0, j0, dt)
    a1, j1 = accel_jerk_fn(torch.cat([xp, pos[:, 3:4]], dim=1),
                           torch.cat([vp, vel[:, 3:4]], dim=1))
    x1, v1 = hermite_correct(x0, v0, a0, j0, a1, j1, dt, damping)
    return torch.cat([x1, pos[:, 3:4]], dim=1), torch.cat([v1, vel[:, 3:4]], dim=1)


# ---- each pair once (Newton's third law) ----
#
# Counterparts of nbody_tpu/ops/symmetric_kernel.py's public functions, with
# its layouts: each pair (i, j) is evaluated once, with
#   d = x_j - x_i,  c = (|d|^2 + eps^2)^(-3/2),
# the i-side taking +m_j c d and the reaction on j taking -m_i c d.


def _sym_rows(ri, mi, pj, mj, eps2, keep=None):
    """(action (C,3) on the rows, reaction (M,3) on the columns) of the pairs
    of rows ri (C,3) x columns pj (M,3); `keep` (C,M) masks pairs out."""
    dx = pj[None, :, 0] - ri[:, 0:1]  # (C, M)
    dy = pj[None, :, 1] - ri[:, 1:2]
    dz = pj[None, :, 2] - ri[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    c = inv * inv * inv
    if keep is not None:
        # a select, not a product: the masked self pair is inf at eps = 0
        c = torch.where(keep, c, torch.zeros((), dtype=c.dtype, device=c.device))
    s = mj[None, :] * c
    t = mi[:, None] * c
    act = torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)
    react = -torch.stack([(t * dx).sum(0), (t * dy).sum(0), (t * dz).sum(0)], dim=1)
    return act, react


def compute_accel_symmetric(pos, softening, *, chunk_size: int | None = None):
    """(N,4) -> (N,3) accelerations of the set on itself, each pair once over
    the strict upper triangle j > i (which drops the self pair). Row chunk
    [r0, r1) meets the columns [r0, N), so no N x N slab is held."""
    n = pos.shape[0]
    p3, m = pos[:, :3], pos[:, 3]
    eps2 = float(softening) ** 2
    act = pos.new_zeros((n, 3))
    react = pos.new_zeros((n, 3))
    c = max(1, min(n, int(chunk_size or DEFAULT_CHUNK)))
    cols = torch.arange(n, device=pos.device)
    for r0 in range(0, n, c):
        r1 = min(n, r0 + c)
        keep = cols[None, r0:] > cols[r0:r1, None]
        a, r = _sym_rows(p3[r0:r1], m[r0:r1], p3[r0:], m[r0:], eps2, keep)
        act[r0:r1] += a
        react[r0:] += r
    return act + react


def sym_cross(pos_i, pos_j, softening, *, chunk_size: int | None = None):
    """The mask-free rectangle of two sets, each (i, j) pair once: returns
    (acc_i (Bi,4) with w = 0, react_j (3,Bj)), the layout of the JAX
    package's ``_sym_cross``; the j-set is AoS (Bj,4)."""
    bi, bj = pos_i.shape[0], pos_j.shape[0]
    eps2 = float(softening) ** 2
    acc = pos_i.new_zeros((bi, 4))
    react = pos_i.new_zeros((bj, 3))
    c = max(1, min(max(bi, 1), int(chunk_size or DEFAULT_CHUNK)))
    for r0 in range(0, bi, c):
        r1 = min(bi, r0 + c)
        a, r = _sym_rows(pos_i[r0:r1, :3], pos_i[r0:r1, 3], pos_j[:, :3], pos_j[:, 3], eps2)
        acc[r0:r1, :3] = a
        react += r
    return acc, react.t()


def sym_blocking(n: int, tile_j: int, block_cap: int) -> tuple[int, int]:
    """(k, B): the superblock count and size of the blocked composition for
    N bodies, the fewest blocks with B <= block_cap, B a tile_j multiple
    (the JAX package's ``sym_blocking``)."""
    cap_t = (block_cap // tile_j) * tile_j
    if cap_t <= 0:
        raise ValueError(
            f"blocked sym needs tile_j <= block_cap: got tile_j={tile_j}, "
            f"block_cap={block_cap}")
    k = -(-n // cap_t)
    per = -(-n // k)
    return k, -(-per // tile_j) * tile_j


def _add_fields(x, y):
    return tuple(map(operator.add, x, y))


def compose_symmetric_blocked(states, softening, *, block_cap: int, tile_j: int,
                              triangle, cross, add=_add_fields):
    """Each pair once at any N: the triangle of N bodies as k superblock
    triangles plus k(k-1)/2 mask-free cross rectangles,

        triangle(N) = sum_a triangle(block a) + sum_{a<b} rectangle(a x b),

    summed per block in a fixed order (the triangle, then the rectangles
    in loop order), as ``compute_accel_symmetric_blocked`` and
    ``compute_accel_jerk_symmetric_blocked`` of the JAX package do. N <=
    block_cap is one triangle. The last block is ragged instead of
    zero-mass padded; padding is inert, so the sums are the same.

    `states` is the tuple of (N,4) arrays a pair reads: (pos,) for the
    force, (pos, vel) for accel + jerk, (pos_hi, pos_lo) for the ds force.
    `triangle(*states, softening)` returns the tuple of (n,3) fields;
    `cross(*states_i, *states_j, softening)` returns each field's i-side
    (Bi,4) and then each field's j-side (3,Bj). Both are the plain versions
    or the kernels' wrappers; `softening` is passed to them as it is (the ds
    force takes its scalar block there). `add(total, part)` adds two tuples
    of fields: field by field with ``operator.add`` by default, ``ds_add``
    on the (hi, lo) pair for ds. Returns the tuple of (N,3) fields."""
    n = states[0].shape[0]
    if n <= block_cap:
        return tuple(triangle(*states, softening))
    k, blk = sym_blocking(n, tile_j, block_cap)
    blocks = [tuple(s[a * blk:min(n, (a + 1) * blk)] for s in states) for a in range(k)]
    contrib = [[tuple(triangle(*b, softening))] for b in blocks]
    for a in range(k):
        for b in range(a + 1, k):
            sides = cross(*blocks[a], *blocks[b], softening)
            nf = len(sides) // 2
            contrib[a].append(tuple(f[:, :3] for f in sides[:nf]))
            contrib[b].append(tuple(f.t() for f in sides[nf:]))
    totals = []
    for parts in contrib:
        total = parts[0]
        for p in parts[1:]:
            total = add(total, p)
        totals.append(total)
    return tuple(torch.cat([t[f] for t in totals]) for f in range(len(totals[0])))


def compute_accel_symmetric_blocked(pos, softening, *, block_cap: int, tile_j: int = 256,
                                    chunk_size: int | None = None):
    """The plain blocked composition: (N,4) -> (N,3), each pair once."""
    (acc,) = compose_symmetric_blocked(
        (pos,), softening, block_cap=block_cap, tile_j=tile_j,
        triangle=lambda p, soft: (compute_accel_symmetric(p, soft, chunk_size=chunk_size),),
        cross=functools.partial(sym_cross, chunk_size=chunk_size))
    return acc


# ---- accel + jerk, each pair once ----
#
# The jerk bracket q = dv/r^3 - 3 (d . dv) d / r^5 is mass-free and
# antisymmetric under i <-> j (d -> -d, dv -> -dv, d . dv unchanged), so
# the i-side takes +m_j q and the reaction on j takes -m_i q, as the
# acceleration's +m_j c d and -m_i c d (symmetric_kernel.py:557-563).


def _aj_sym_rows(ri, vi, mi, pj, vj, mj, eps2, keep=None):
    """((acc, jerk) (C,3) each on the rows, (react_acc, react_jerk) (M,3)
    each on the columns) of the pairs of rows ri, vi (C,3) x columns pj, vj
    (M,3), in the arithmetic of ``_aj_sym_kernel``; `keep` (C,M) masks
    pairs out."""
    dx = pj[None, :, 0] - ri[:, 0:1]  # (C, M)
    dy = pj[None, :, 1] - ri[:, 1:2]
    dz = pj[None, :, 2] - ri[:, 2:3]
    dvx = vj[None, :, 0] - vi[:, 0:1]
    dvy = vj[None, :, 1] - vi[:, 1:2]
    dvz = vj[None, :, 2] - vi[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    inv3 = inv2 * inv
    c3p = 3.0 * (dx * dvx + dy * dvy + dz * dvz) * inv2 * inv3  # 3 (d.dv) / r^5
    if keep is not None:
        # a select, not a product: the masked self pair is inf at eps = 0
        zero = torch.zeros((), dtype=inv3.dtype, device=inv3.device)
        inv3 = torch.where(keep, inv3, zero)
        c3p = torch.where(keep, c3p, zero)
    qx = inv3 * dvx - c3p * dx
    qy = inv3 * dvy - c3p * dy
    qz = inv3 * dvz - c3p * dz
    s = mj[None, :] * inv3
    t = mi[:, None] * inv3
    mjq = mj[None, :]
    miq = mi[:, None]
    acc = torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)
    jerk = torch.stack([(mjq * qx).sum(1), (mjq * qy).sum(1), (mjq * qz).sum(1)], dim=1)
    r_acc = -torch.stack([(t * dx).sum(0), (t * dy).sum(0), (t * dz).sum(0)], dim=1)
    r_jerk = -torch.stack([(miq * qx).sum(0), (miq * qy).sum(0), (miq * qz).sum(0)], dim=1)
    return acc, jerk, r_acc, r_jerk


def compute_accel_jerk_symmetric(pos, vel, softening, *, chunk_size: int | None = None):
    """(acc, jerk), each (N,3), of the set on itself, each pair once over
    the strict upper triangle j > i. Row chunk [r0, r1) meets the columns
    [r0, N)."""
    n = pos.shape[0]
    p3, v3, m = pos[:, :3], vel[:, :3], pos[:, 3]
    eps2 = float(softening) ** 2
    acc, jerk = pos.new_zeros((n, 3)), pos.new_zeros((n, 3))
    r_acc, r_jerk = pos.new_zeros((n, 3)), pos.new_zeros((n, 3))
    c = max(1, min(n, int(chunk_size or DEFAULT_CHUNK)))
    cols = torch.arange(n, device=pos.device)
    for r0 in range(0, n, c):
        r1 = min(n, r0 + c)
        keep = cols[None, r0:] > cols[r0:r1, None]
        a, j, ra, rj = _aj_sym_rows(p3[r0:r1], v3[r0:r1], m[r0:r1],
                                    p3[r0:], v3[r0:], m[r0:], eps2, keep)
        acc[r0:r1] += a
        jerk[r0:r1] += j
        r_acc[r0:] += ra
        r_jerk[r0:] += rj
    return acc + r_acc, jerk + r_jerk


def aj_sym_cross(pos_i, vel_i, pos_j, vel_j, softening, *, chunk_size: int | None = None):
    """The mask-free accel + jerk rectangle of two sets, each (i, j) pair
    once: returns (acc_i (Bi,4), jerk_i (Bi,4), both with w = 0,
    react_acc (3,Bj), react_jerk (3,Bj)), the layout of the JAX package's
    ``_aj_sym_cross``; the j-set is AoS (Bj,4)."""
    bi, bj = pos_i.shape[0], pos_j.shape[0]
    eps2 = float(softening) ** 2
    acc, jerk = pos_i.new_zeros((bi, 4)), pos_i.new_zeros((bi, 4))
    r_acc, r_jerk = pos_i.new_zeros((bj, 3)), pos_i.new_zeros((bj, 3))
    c = max(1, min(max(bi, 1), int(chunk_size or DEFAULT_CHUNK)))
    for r0 in range(0, bi, c):
        r1 = min(bi, r0 + c)
        a, j, ra, rj = _aj_sym_rows(pos_i[r0:r1, :3], vel_i[r0:r1, :3], pos_i[r0:r1, 3],
                                    pos_j[:, :3], vel_j[:, :3], pos_j[:, 3], eps2)
        acc[r0:r1, :3] = a
        jerk[r0:r1, :3] = j
        r_acc += ra
        r_jerk += rj
    return acc, jerk, r_acc.t(), r_jerk.t()


def compute_accel_jerk_symmetric_blocked(pos, vel, softening, *, block_cap: int,
                                         tile_j: int = 256, chunk_size: int | None = None):
    """The plain blocked accel + jerk composition: (N,4), (N,4) -> (acc,
    jerk), each (N,3), each pair once."""
    return compose_symmetric_blocked(
        (pos, vel), softening, block_cap=block_cap, tile_j=tile_j,
        triangle=functools.partial(compute_accel_jerk_symmetric, chunk_size=chunk_size),
        cross=functools.partial(aj_sym_cross, chunk_size=chunk_size))


# ---- the P3M short-range force (the plain version of csrc/p3m_kernels.cu) ----

# pair elements a chunk of i-rows may hold, so a (chunk, N) intermediate
# stays near 64 MB in float32
_P3M_CHUNK_ELEMS = 1 << 24


def p3m_short_range(pos, softening, *, grid: int, capacity: int, rows=None):
    """The P3M short-range force (N, 3) of the (N, 4) state, as a masked
    all-pairs sum in chunks of i-rows, independent of the pair kernel's
    padded layout; with ``rows`` (an index tensor) only those bodies'
    forces, (len(rows), 3), each against all N bodies. Pair (i, j) counts
    when

      * both bodies are kept: among the first `capacity` of their cell in
        the stable (cell, massless last) order of the reference
        (``nbody_tpu/ops/p3m.py:179-190``);
      * j's cell is in i's 27-stencil (cell coordinates differ by at most 1);
      * r^2 < rcut^2,

    and adds (rsqrt(r^2 + eps^2)^3 - s_lr(r^2)) * m_j * d, s_lr the
    polynomial ``p3m._SLR_POLY`` by Horner's rule in y = r^2 / (2 sigma^2),
    times 1/(sqrt2 sigma)^3 (``nbody_tpu/ops/p3m_kernel.py::_s_lr_kernel``
    divides by (sqrt2 sigma)^3; the pair kernel multiplies, and rounds every
    term as this function does, each op on its own). A dropped body gets 0.
    The mask is a select: where r^2 overflows, s_lr is inf."""
    from nbody_tpu_torch.ops import p3m  # p3m imports this module

    n = pos.shape[0]
    pos3, mass, lo, h, rcut, gc, cell = p3m._cells(pos, grid)
    if n == 0:
        return pos3.new_zeros((0, 3))
    order = torch.argsort(cell * 2 + (mass <= 0).to(torch.int64), stable=True)
    sorted_cell = cell[order]
    rank = torch.arange(n, device=pos.device) - torch.searchsorted(sorted_cell, sorted_cell)
    kept = torch.empty(n, dtype=torch.bool, device=pos.device)
    kept[order] = rank < capacity
    cxyz = torch.stack([cell // (gc * gc), (cell // gc) % gc, cell % gc], dim=1)

    eps2 = p3m.soft2_f32(softening)
    rcut2 = rcut * rcut
    sigma = p3m.SIGMA_CELLS * h
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    sq2s = math.sqrt(2.0) * sigma
    inv_sq2s3 = 1.0 / (sq2s * sq2s * sq2s)

    def block(ri, ci, keep_i):
        dx = pos3[None, :, 0] - ri[:, 0:1]  # (C, N)
        dy = pos3[None, :, 1] - ri[:, 1:2]
        dz = pos3[None, :, 2] - ri[:, 2:3]
        r2 = dx * dx + dy * dy + dz * dz
        inv = torch.rsqrt(r2 + eps2)
        y = r2 * inv_2s2
        g = torch.full_like(y, p3m._SLR_POLY[-1])
        for c in p3m._SLR_POLY[-2::-1]:
            g = g * y + c
        near = ((ci[:, None, :] - cxyz[None, :, :]).abs() <= 1).all(dim=2)
        near &= kept[None, :] & keep_i[:, None] & (r2 < rcut2)
        s = torch.where(near, inv * inv * inv - g * inv_sq2s3, 0.0) * mass[None, :]
        return torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)

    pi, ci, ki = pos3, cxyz, kept
    if rows is not None:
        pi, ci, ki = pos3[rows], cxyz[rows], kept[rows]
        if pi.shape[0] == 0:
            return pos3.new_zeros((0, 3))
    c = max(1, min(pi.shape[0], _P3M_CHUNK_ELEMS // n))
    return torch.cat([block(*args) for args in zip(pi.split(c), ci.split(c), ki.split(c))])
