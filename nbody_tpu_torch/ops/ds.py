"""Double-single ("ds") arithmetic and the plain versions of the ds kernels.

Counterpart of ``nbody_tpu/ops/ds_kernel.py``'s arithmetic (``_two_sum`` to
``reduce_ds_lanes``, :75-185) and of the plain form of each ds kernel the
port runs: every value is an unevaluated sum hi + lo of two float32s (a
~49-bit significand), carried through error-free transformations. These are
the versions the hand-written kernels (``csrc/ds_kernels.cu``,
``csrc/ds_symmetric_kernels.cu``, ``csrc/ds_aj_kernels.cu``,
``csrc/ds_symmetric_aj_kernels.cu``) are held to, on the CPU in the tests
and on the card in ``chip_smoke.py``.

Every operation is a separate eager PyTorch op, so each intermediate is
rounded to float32 where the transformation expects it: no ``addcmul``,
``torch.compile`` or other fused op may enter this module, since a fused
multiply-add breaks the identities the error terms rest on
(``ds_kernel.py:50-58``). Scalars enter as 0-d float32 tensors, never as
Python floats, which would be split in double precision.

State layout, the JAX package's: four (N,4) float32 planes pos_hi, pos_lo,
vel_hi, vel_lo (columns x, y, z, mass / vx, vy, vz, w), and a (2,4) float32
``scal`` block, row 0 the hi and row 1 the lo parts of [dt, eps^2, damping,
dt/2] (``scal_ds`` / ``scal_ds_leapfrog``), or for Hermite the (2,8) block
of ``scal_ds_hermite``.

Physics, per pair in ds (``_ds_accumulate_tile``, ds_kernel.py:190-219):
    d = p_j - p_i;  r2 = (dx^2 + dy^2) + (dz^2 + eps^2)
    inv = ds_rsqrt(r2);  inv3 = (inv * inv) * inv;  a_i += (m_j * inv3) * d
and the damped Euler update v' = (v + a dt) * damping, p' = p + v' dt; the
Hermite step adds the jerk and the predictor-corrector (ds_kernel.py:756-1032).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_tpu_torch.ops.reference import compose_symmetric_blocked

_SPLITTER = 4097.0  # 2^12 + 1, Dekker's split constant

# elements of one (rows, columns) pair block of the plain versions: 2^22
# float32s (16 MB) a temporary
_CHUNK_ELEMS = 1 << 22


def _f32(v, device=None) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


# ---- error-free transformations (element-wise, any shape) ----


def _two_sum(a, b):
    """Knuth: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Exact a + b assuming |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker: p + err == a * b exactly (no fused multiply-add here; the
    kernels take the same err from one hardware FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---- double-single arithmetic on (hi, lo) pairs ----


def ds_add(x, y):
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    return _quick_two_sum(s, e)


def ds_sub(x, y):
    yh, yl = y
    return ds_add(x, (-yh, -yl))


def ds_mul(x, y):
    xh, xl = x
    yh, yl = y
    p, e = _two_prod(xh, yh)
    e = e + xh * yl + xl * yh
    return _quick_two_sum(p, e)


def ds_mul_f32(x, c):
    """ds times a float32 (tensor or 0-d tensor)."""
    xh, xl = x
    p, e = _two_prod(xh, c)
    e = e + xl * c
    return _quick_two_sum(p, e)


def ds_rsqrt(x):
    """1/sqrt(x): a float32 rsqrt seed and one Newton step evaluated in ds,
    y1 = y0 (3 - x y0^2) / 2, which doubles the seed's ~24 accurate bits."""
    xh, _ = x
    y0 = torch.rsqrt(xh)
    y0ds = (y0, torch.zeros_like(y0))
    t = ds_mul(x, ds_mul(y0ds, y0ds))
    three = (_f32(3.0, xh.device), _f32(0.0, xh.device))
    corr = ds_sub(three, t)
    return ds_mul_f32(ds_mul(y0ds, corr), _f32(0.5, xh.device))


def ds_neg(x):
    return -x[0], -x[1]


def ds_where(keep, x):
    """x where `keep`, else ds 0: a select, so a masked inf or NaN is dropped."""
    zero = torch.zeros((), dtype=x[0].dtype, device=x[0].device)
    return torch.where(keep, x[0], zero), torch.where(keep, x[1], zero)


def ds_from_f64(arr64):
    """A float64 array or tensor -> (hi, lo) float32 CPU tensors, hi + lo
    exact to ds (``ds_kernel.py::ds_from_f64``)."""
    if isinstance(arr64, torch.Tensor):
        arr64 = arr64.detach().cpu().numpy()
    a = np.asarray(arr64, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def ds_to_f64(hi, lo) -> np.ndarray:
    """(hi, lo) float32 arrays or tensors -> float64 numpy, hi + lo."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, np.float64)

    return host(hi) + host(lo)


def ds_sum(x, dim: int):
    """Sum IN ds along `dim` (the counterpart of ``reduce_ds_lanes``): a
    pairwise tree of ds_adds, first half plus second half at each level,
    the width zero-padded to a power of two. A float32 sum of the hi plane
    would bring back the summation error ds exists to avoid."""
    h = x[0].movedim(dim, -1)
    lo = x[1].movedim(dim, -1)
    w = h.shape[-1]
    if w == 0:
        zeros = h.new_zeros(h.shape[:-1])
        return zeros, zeros.clone()
    p = 1 << (w - 1).bit_length()
    if p != w:
        pad = h.new_zeros((*h.shape[:-1], p - w))
        h = torch.cat([h, pad], dim=-1)
        lo = torch.cat([lo, pad], dim=-1)
    while p > 1:
        half = p // 2
        h, lo = ds_add((h[..., :half], lo[..., :half]), (h[..., half:p], lo[..., half:p]))
        p = half
    return h[..., 0], lo[..., 0]


# ---- the scalar block ----


def _scal_block(values, width: int = 4) -> torch.Tensor:
    vals = np.zeros((2, width), np.float32)
    for c, v in enumerate(values):
        hi = np.float32(v)
        vals[0, c] = hi
        vals[1, c] = np.float32(np.float64(v) - np.float64(hi))
    return torch.from_numpy(vals)


def scal_ds(dt, softening, damping) -> torch.Tensor:
    """(2,4) float32 CPU tensor: row 0 the hi, row 1 the lo parts of
    [dt, eps^2, damping, 0], split on the host in float64
    (``ds_kernel.py::_scal_ds``)."""
    return _scal_block((dt, float(softening) ** 2, damping))


def scal_ds_leapfrog(dt, softening, damping) -> torch.Tensor:
    """(2,4) hi/lo block of [dt, eps^2, damping, dt/2]
    (``ds_kernel.py::_scal_ds_leapfrog``)."""
    return _scal_block((dt, float(softening) ** 2, damping, float(dt) / 2.0))


def scal_ds_hermite(dt, softening, damping) -> torch.Tensor:
    """(2,8) hi/lo block of [dt, eps^2, damping, dt/2, dt^2/2, dt^3/6,
    dt^2/12, 0], every power of dt computed in float64 on the host and split
    exactly, so the ds predictor and corrector see full-precision
    coefficients (``ds_kernel.py::_scal_ds_hermite``)."""
    d = np.float64(dt)
    return _scal_block((d, np.float64(softening) ** 2, np.float64(damping), d / 2.0,
                        d * d / 2.0, d * d * d / 6.0, d * d / 12.0), width=8)


_SIXTH = 1.0 / 6.0
_SIXTH_PAIR = (float(np.float32(_SIXTH)), float(np.float32(_SIXTH - float(np.float32(_SIXTH)))))


def ds_scal_with_dt(base, dt, *, integrator: str = "euler") -> torch.Tensor:
    """The scalar block `base` (``scal_ds`` / ``scal_ds_leapfrog`` /
    ``scal_ds_hermite`` of the run's softening and damping, on the device
    the steps run on) with its dt columns rebuilt from the float32 0-d
    tensor `dt` (``ds_kernel.py::ds_scal_with_dt``): dt itself is exact (hi
    dt, lo 0), dt/2 too, and for Hermite dt^2/2, dt^3/6 and dt^2/12 are
    error-free ds products (``_two_prod``, ``ds_mul``). Built on the device
    from tensors there, with no host copy, so that an adaptive step needs no
    host round trip."""
    dt = dt.to(torch.float32)
    # every value assigned is a tensor on the device: a Python scalar would
    # be copied from the host, and wait for it
    z = torch.zeros((), dtype=torch.float32, device=dt.device)
    out = base.clone()
    out[0, 0] = dt
    out[1, 0] = z
    if integrator == "euler":
        return out
    out[0, 3] = dt * 0.5  # exact
    out[1, 3] = z
    if integrator == "leapfrog":
        return out
    sixth = tuple(torch.full((), v, dtype=torch.float32, device=dt.device) for v in _SIXTH_PAIR)
    d2h, d2l = _two_prod(dt, dt)  # exact dt^2
    dt2_2 = (d2h * 0.5, d2l * 0.5)  # /2 exact
    dt3 = ds_mul((d2h, d2l), (dt, z))
    for c, (vh, vl) in ((4, dt2_2), (5, ds_mul(dt3, sixth)), (6, ds_mul(dt2_2, sixth))):
        out[0, c] = vh
        out[1, c] = vl
    return out


def scal_on(scal, device) -> torch.Tensor:
    """The scalar block `scal` on `device`, where the ds kernels read it: the
    block itself if it is there, else its copy there, a host block's by a
    non-blocking copy from pinned memory, so that no later call waits on
    the host for it."""
    device = torch.device(device)
    if scal.device == device:
        return scal
    if scal.device.type == "cpu" and device.type == "cuda":
        return scal.contiguous().pin_memory().to(device, non_blocking=True)
    return scal.to(device)


def _scal(scal, device, cols=(0, 1, 2, 3)):
    """The ds scalars in columns `cols` of `scal` as pairs of 0-d float32
    tensors on `device`; by default (dt, eps2, damping, dt/2)."""
    s = scal.to(device=device, dtype=torch.float32)
    return tuple((s[0, c], s[1, c]) for c in cols)


def _col(hi, lo, c):
    return hi[:, c], lo[:, c]


def _chunk_rows(n_cols: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, n_cols))


# ---- the pair arithmetic ----


def _pair_geometry(xi, yi, zi, xj, yj, zj, eps2):
    """(dx, dy, dz, inv2, inv3) of rows (C,1) against columns (1,N), each
    ds: inv2 = inv * inv and inv3 = inv2 * inv."""
    dx = ds_sub(xj, xi)
    dy = ds_sub(yj, yi)
    dz = ds_sub(zj, zi)
    r2 = ds_add(ds_add(ds_mul(dx, dx), ds_mul(dy, dy)), ds_add(ds_mul(dz, dz), eps2))
    inv = ds_rsqrt(r2)
    inv2 = ds_mul(inv, inv)
    return dx, dy, dz, inv2, ds_mul(inv2, inv)


def _pair_terms(xi, yi, zi, xj, yj, zj, eps2):
    """(dx, dy, dz, inv3) of rows (C,1) against columns (1,N), each ds."""
    dx, dy, dz, _, inv3 = _pair_geometry(xi, yi, zi, xj, yj, zj, eps2)
    return dx, dy, dz, inv3


def _rows(h, lo, c):
    return h[:, c:c + 1], lo[:, c:c + 1]  # (C, 1)


def _cols(h, lo, c):
    return h[None, :, c], lo[None, :, c]  # (1, N)


def _ds_accel_rows(ih, il, jh, jl, eps2):
    """ds acceleration (hi (C,3), lo (C,3)) on the rows ih/il (C,4) due to
    the columns jh/jl (N,4), each pair's terms summed by ``ds_sum``."""
    dx, dy, dz, inv3 = _pair_terms(*(_rows(ih, il, c) for c in range(3)),
                                   *(_cols(jh, jl, c) for c in range(3)), eps2)
    s = ds_mul(_cols(jh, jl, 3), inv3)  # m_j / r^3, with m_j's lo part
    parts = [ds_sum(ds_mul(s, d), 1) for d in (dx, dy, dz)]
    return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)


def ds_accel_vs(pos_hi, pos_lo, jpos_hi, jpos_lo, scal):
    """(acc_hi, acc_lo), each (M,3): the ds acceleration of the i-set under
    the j-set, the arithmetic of ``compute_accel_pallas_ds``
    (``_ds_accel_kernel``), chunked over i-rows."""
    m = pos_hi.shape[0]
    _, eps2, _, _ = _scal(scal, pos_hi.device)
    if m == 0 or jpos_hi.shape[0] == 0:
        z = pos_hi.new_zeros((m, 3))
        return z, z.clone()
    c = _chunk_rows(jpos_hi.shape[0])
    parts = [_ds_accel_rows(pos_hi[r0:r0 + c], pos_lo[r0:r0 + c], jpos_hi, jpos_lo, eps2)
             for r0 in range(0, m, c)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def ds_kick_drift(pos_hi, pos_lo, vel_hi, vel_lo, acc, *, dt, damping, dt_pos):
    """Per coordinate column, v' = (v + a dt) damping and p' = p + v' dt_pos
    in ds, the mass and vel.w columns carried through from hi and lo
    (``ds_kernel.py::_ds_kick_drift``). Returns the four new planes."""
    nph, npl, nvh, nvl = [], [], [], []
    for c in range(3):
        a_c = (acc[0][:, c], acc[1][:, c])
        vnew = ds_mul(ds_add(_col(vel_hi, vel_lo, c), ds_mul(a_c, dt)), damping)
        pnew = ds_add(_col(pos_hi, pos_lo, c), ds_mul(vnew, dt_pos))
        nph.append(pnew[0])
        npl.append(pnew[1])
        nvh.append(vnew[0])
        nvl.append(vnew[1])
    nph.append(pos_hi[:, 3])
    npl.append(pos_lo[:, 3])
    nvh.append(vel_hi[:, 3])
    nvl.append(vel_lo[:, 3])
    return tuple(torch.stack(cols, 1) for cols in (nph, npl, nvh, nvl))


def ds_integrate(pos_hi, pos_lo, vel_hi, vel_lo, acc, scal):
    """The damped semi-implicit Euler update in ds (``_ds_integrate``):
    `acc` = (acc_hi, acc_lo), each (N,3). Returns the four new planes."""
    dt, _, damping, _ = _scal(scal, pos_hi.device)
    return ds_kick_drift(pos_hi, pos_lo, vel_hi, vel_lo, acc, dt=dt, damping=damping, dt_pos=dt)


def nbody_step_ds_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, scal):
    """One ds Euler step of the i-set under the j-set: ``_ds_step_kernel``
    and its finalize (ds_kernel.py:190-257). Returns the four new planes."""
    acc = ds_accel_vs(pos_hi, pos_lo, jpos_hi, jpos_lo, scal)
    return ds_integrate(pos_hi, pos_lo, vel_hi, vel_lo, acc, scal)


def nbody_step_ds(pos_hi, pos_lo, vel_hi, vel_lo, scal):
    """One ds Euler step of the set on itself (``nbody_step_pallas_ds``)."""
    return nbody_step_ds_vs(pos_hi, pos_lo, vel_hi, vel_lo, pos_hi, pos_lo, scal)


def ds_half_drift(pos_hi, pos_lo, vel_hi, vel_lo, scal):
    """pos + vel dt/2 in ds on the coordinate columns, the mass carried
    (``ds_kernel.py::ds_half_drift``); `scal` from ``scal_ds_leapfrog``."""
    _, _, _, dt_half = _scal(scal, pos_hi.device)
    h, lo = [], []
    for c in range(3):
        p = ds_add(_col(pos_hi, pos_lo, c), ds_mul(_col(vel_hi, vel_lo, c), dt_half))
        h.append(p[0])
        lo.append(p[1])
    h.append(pos_hi[:, 3])
    lo.append(pos_lo[:, 3])
    return torch.stack(h, 1), torch.stack(lo, 1)


def ds_leapfrog_finish(half_hi, half_lo, vel_hi, vel_lo, acc, scal):
    """The kick and the second half-drift of the DKD step
    (``ds_kernel.py::ds_leapfrog_finish``): v' = (v + a dt) damping,
    p' = p_half + v' dt/2."""
    dt, _, damping, dt_half = _scal(scal, half_hi.device)
    return ds_kick_drift(half_hi, half_lo, vel_hi, vel_lo, acc, dt=dt, damping=damping,
                         dt_pos=dt_half)


def nbody_step_ds_leapfrog_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo,
                              jvel_hi, jvel_lo, scal):
    """One fused ds drift-kick-drift step of the i-set under the j-set
    (``_ds_leapfrog_kernel``, ds_kernel.py:575-655): both sides are
    half-drifted from the start-of-step state, the force is taken at the
    half-step positions. `scal` from ``scal_ds_leapfrog``."""
    hh, hl = ds_half_drift(pos_hi, pos_lo, vel_hi, vel_lo, scal)
    jh, jl = ds_half_drift(jpos_hi, jpos_lo, jvel_hi, jvel_lo, scal)
    acc = ds_accel_vs(hh, hl, jh, jl, scal)
    return ds_leapfrog_finish(hh, hl, vel_hi, vel_lo, acc, scal)


def nbody_step_ds_leapfrog(pos_hi, pos_lo, vel_hi, vel_lo, scal):
    """One fused ds DKD step of the set on itself
    (``nbody_step_pallas_ds_leapfrog``)."""
    return nbody_step_ds_leapfrog_vs(pos_hi, pos_lo, vel_hi, vel_lo, pos_hi, pos_lo,
                                     vel_hi, vel_lo, scal)


# ---- each pair once (Newton's third law) in ds ----


def _ds_sym_rows(ih, il, jh, jl, eps2, keep=None):
    """(action on the rows (hi (C,3), lo (C,3)), reaction on the columns
    (hi (M,3), lo (M,3))) of the pairs rows ih/il (C,4) x columns jh/jl
    (M,4), in the arithmetic of ``_ds_sym_kernel``: the i-side takes
    +(m_j inv3) d, the reaction -(m_i inv3) d; `keep` (C,M) masks pairs out."""
    dx, dy, dz, inv3 = _pair_terms(*(_rows(ih, il, c) for c in range(3)),
                                   *(_cols(jh, jl, c) for c in range(3)), eps2)
    s = ds_mul(_cols(jh, jl, 3), inv3)
    t = ds_mul(_rows(ih, il, 3), inv3)
    if keep is not None:
        s = ds_where(keep, s)
        t = ds_where(keep, t)
    act = [ds_sum(ds_mul(s, d), 1) for d in (dx, dy, dz)]
    react = [ds_neg(ds_sum(ds_mul(t, d), 0)) for d in (dx, dy, dz)]

    def stack(parts):
        return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)

    return stack(act), stack(react)


def ds_accel_symmetric(pos_hi, pos_lo, scal):
    """(acc_hi, acc_lo), each (N,3): the set's ds acceleration on itself,
    each pair once over the strict upper triangle j > i, the i-side and the
    reaction merged in ds (``compute_accel_pallas_ds_sym``,
    ds_kernel.py:1059-1268). Row chunk [r0, r1) meets the columns [r0, N)."""
    n = pos_hi.shape[0]
    _, eps2, _, _ = _scal(scal, pos_hi.device)
    act = (pos_hi.new_zeros((n, 3)), pos_hi.new_zeros((n, 3)))
    react = (pos_hi.new_zeros((n, 3)), pos_hi.new_zeros((n, 3)))
    c = _chunk_rows(n)
    idx = torch.arange(n, device=pos_hi.device)
    for r0 in range(0, n, c):
        r1 = min(n, r0 + c)
        keep = idx[None, r0:] > idx[r0:r1, None]
        a, r = _ds_sym_rows(pos_hi[r0:r1], pos_lo[r0:r1], pos_hi[r0:], pos_lo[r0:], eps2, keep)
        act[0][r0:r1] = a[0]
        act[1][r0:r1] = a[1]
        rh, rl = ds_add((react[0][r0:], react[1][r0:]), r)
        react[0][r0:] = rh
        react[1][r0:] = rl
    return ds_add(act, react)


def ds_sym_cross(pos_hi_i, pos_lo_i, pos_hi_j, pos_lo_j, scal):
    """The mask-free ds rectangle of the i-set (Bi,4) and the j-set (Bj,4),
    each pair once (``_ds_sym_cross``, ds_kernel.py:1339-1474): returns
    (acc_hi (Bi,4), acc_lo (Bi,4), both with w = 0, react_hi (3,Bj),
    react_lo (3,Bj)); the j-set is AoS, not transposed."""
    bi, bj = pos_hi_i.shape[0], pos_hi_j.shape[0]
    _, eps2, _, _ = _scal(scal, pos_hi_i.device)
    acc_h, acc_l = pos_hi_i.new_zeros((bi, 4)), pos_hi_i.new_zeros((bi, 4))
    react = (pos_hi_i.new_zeros((bj, 3)), pos_hi_i.new_zeros((bj, 3)))
    c = _chunk_rows(bj)
    for r0 in range(0, bi if bj else 0, c):
        r1 = min(bi, r0 + c)
        a, r = _ds_sym_rows(pos_hi_i[r0:r1], pos_lo_i[r0:r1], pos_hi_j, pos_lo_j, eps2)
        acc_h[r0:r1, :3] = a[0]
        acc_l[r0:r1, :3] = a[1]
        react = ds_add(react, r)
    return acc_h, acc_l, react[0].t(), react[1].t()


def ds_accel_symmetric_blocked(pos_hi, pos_lo, scal, *, block_cap: int, tile_j: int = 256):
    """(acc_hi, acc_lo), each (N,3), each pair once at any N: k superblock
    triangles and k(k-1)/2 rectangles, summed per block in ds in a fixed
    order (``compute_accel_pallas_ds_sym_blocked``, ds_kernel.py:1479-1551,
    through ``reference.compose_symmetric_blocked``)."""
    return compose_symmetric_blocked(
        (pos_hi, pos_lo), scal, block_cap=block_cap, tile_j=tile_j,
        triangle=ds_accel_symmetric, cross=ds_sym_cross,
        add=ds_add)


# ---- accel + jerk in ds (the Hermite scheme's force evaluation) ----
#
#   a_i = sum_j m_j d / r^3,   j_i = sum_j m_j [dv / r^3 - 3 (d . dv) d / r^5]
# with d = p_j - p_i, dv = v_j - v_i (vel.w is not a velocity) and the
# softened r^2, every step in ds.


def _three(device):
    return _f32(3.0, device)


def _ds_dot(a, b):
    """(a0 b0 + a1 b1) + a2 b2 in ds, the op order of ds_kernel.py:807-808."""
    return ds_add(ds_add(ds_mul(a[0], b[0]), ds_mul(a[1], b[1])), ds_mul(a[2], b[2]))


def _stack_pairs(parts):
    return torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1)


def _ds_accel_jerk_rows(ph, pl, vh, vl, jph, jpl, jvh, jvl, eps2):
    """(acc (hi, lo), jerk (hi, lo)), each (C,3), on the rows (C,4 planes)
    due to the columns (N,4 planes), in the arithmetic of
    ``_ds_accel_jerk_kernel`` (ds_kernel.py:795-823)."""
    dx, dy, dz, inv2, inv3 = _pair_geometry(*(_rows(ph, pl, c) for c in range(3)),
                                            *(_cols(jph, jpl, c) for c in range(3)), eps2)
    d = (dx, dy, dz)
    dv = tuple(ds_sub(_cols(jvh, jvl, c), _rows(vh, vl, c)) for c in range(3))
    s = ds_mul(_cols(jph, jpl, 3), inv3)  # m_j / r^3
    c3 = ds_mul_f32(ds_mul(ds_mul(s, _ds_dot(d, dv)), inv2), _three(ph.device))
    acc = [ds_sum(ds_mul(s, dc), 1) for dc in d]
    jerk = [ds_sum(ds_sub(ds_mul(s, dvc), ds_mul(c3, dc)), 1) for dvc, dc in zip(dv, d)]
    return _stack_pairs(acc), _stack_pairs(jerk)


def ds_accel_jerk_vs(pos_hi, pos_lo, vel_hi, vel_lo, jpos_hi, jpos_lo, jvel_hi, jvel_lo, scal):
    """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (M,4) with column 3 zero:
    the ds accel + jerk of the i-set (M,4 planes) under the j-set (N,4
    planes), in the i-vs-j form of ``compute_accel_jerk_pallas_ds``
    (``_ds_accel_jerk_kernel``), chunked over i-rows. `scal` is any (2, >=2)
    hi/lo block with eps^2 in column 1."""
    m = pos_hi.shape[0]
    (eps2,) = _scal(scal, pos_hi.device, (1,))
    out = tuple(pos_hi.new_zeros((m, 4)) for _ in range(4))
    if m == 0 or jpos_hi.shape[0] == 0:
        return out
    c = _chunk_rows(jpos_hi.shape[0])
    for r0 in range(0, m, c):
        rows = slice(r0, r0 + c)
        acc, jerk = _ds_accel_jerk_rows(pos_hi[rows], pos_lo[rows], vel_hi[rows], vel_lo[rows],
                                        jpos_hi, jpos_lo, jvel_hi, jvel_lo, eps2)
        for t, v in zip(out, (*acc, *jerk)):
            t[rows, :3] = v
    return out


def _ds_aj_sym_rows(ih, il, ivh, ivl, jh, jl, jvh, jvl, eps2, keep=None):
    """((acc, jerk) on the rows, each a (hi, lo) pair of (C,3); (react_acc,
    react_jerk) on the columns, pairs of (M,3)) of the pairs rows (C,4
    planes) x columns (M,4 planes), in the arithmetic of ``_ds_aj_sym_kernel``
    (ds_kernel.py:1629-1691): the mass-free bracket
    q = inv3 dv - 3 (d . dv) inv2 inv3 d is odd in d, so the i-side takes
    +m_j inv3 d and +m_j q, the reaction -m_i inv3 d and -m_i q. `keep`
    (C,M) masks pairs out by a select on inv3 and the c3 term, so a masked
    inf or NaN (the self pair at eps = 0) is dropped."""
    dx, dy, dz, inv2, inv3 = _pair_geometry(*(_rows(ih, il, c) for c in range(3)),
                                            *(_cols(jh, jl, c) for c in range(3)), eps2)
    d = (dx, dy, dz)
    dv = tuple(ds_sub(_cols(jvh, jvl, c), _rows(ivh, ivl, c)) for c in range(3))
    c3p = ds_mul_f32(ds_mul(ds_mul(_ds_dot(d, dv), inv2), inv3), _three(ih.device))
    if keep is not None:
        inv3 = ds_where(keep, inv3)
        c3p = ds_where(keep, c3p)
    q = [ds_sub(ds_mul(inv3, dvc), ds_mul(c3p, dc)) for dvc, dc in zip(dv, d)]
    mj, mi = _cols(jh, jl, 3), _rows(ih, il, 3)
    s = ds_mul(mj, inv3)
    t = ds_mul(mi, inv3)
    acc = [ds_sum(ds_mul(s, dc), 1) for dc in d]
    jerk = [ds_sum(ds_mul(mj, qc), 1) for qc in q]
    r_acc = [ds_neg(ds_sum(ds_mul(t, dc), 0)) for dc in d]
    r_jerk = [ds_neg(ds_sum(ds_mul(mi, qc), 0)) for qc in q]
    return tuple(_stack_pairs(p) for p in (acc, jerk, r_acc, r_jerk))


def ds_add_aj(x, y):
    """ds_add of two (acc_hi, acc_lo, jerk_hi, jerk_lo) tuples, field by field."""
    return (*ds_add(x[:2], y[:2]), *ds_add(x[2:], y[2:]))


def ds_accel_jerk_symmetric(pos_hi, pos_lo, vel_hi, vel_lo, scal):
    """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (N,3): the set's ds accel +
    jerk on itself, each pair once over the strict upper triangle j > i,
    the i-side and the reaction merged in ds (``compute_accel_jerk_pallas_ds_sym``,
    ds_kernel.py:1728-1815). Row chunk [r0, r1) meets the columns [r0, N)."""
    n = pos_hi.shape[0]
    (eps2,) = _scal(scal, pos_hi.device, (1,))
    act = [pos_hi.new_zeros((n, 3)) for _ in range(4)]
    react = [pos_hi.new_zeros((n, 3)) for _ in range(4)]
    c = _chunk_rows(n)
    idx = torch.arange(n, device=pos_hi.device)
    for r0 in range(0, n, c):
        r1 = min(n, r0 + c)
        keep = idx[None, r0:] > idx[r0:r1, None]
        parts = _ds_aj_sym_rows(pos_hi[r0:r1], pos_lo[r0:r1], vel_hi[r0:r1], vel_lo[r0:r1],
                                pos_hi[r0:], pos_lo[r0:], vel_hi[r0:], vel_lo[r0:], eps2, keep)
        for k, (h, lo) in enumerate(parts[:2]):
            act[2 * k][r0:r1] = h
            act[2 * k + 1][r0:r1] = lo
        for k, r in enumerate(parts[2:]):
            rh, rl = ds_add((react[2 * k][r0:], react[2 * k + 1][r0:]), r)
            react[2 * k][r0:] = rh
            react[2 * k + 1][r0:] = rl
    return ds_add_aj(act, react)


def ds_aj_sym_cross(pos_hi_i, pos_lo_i, vel_hi_i, vel_lo_i, pos_hi_j, pos_lo_j, vel_hi_j,
                    vel_lo_j, scal):
    """The mask-free ds accel + jerk rectangle of the i-set (Bi,4 planes)
    and the j-set (Bj,4 planes), each pair once (``_ds_aj_sym_cross``,
    ds_kernel.py:1974-2016): returns (acc_hi, acc_lo, jerk_hi, jerk_lo),
    each (Bi,4) with w = 0, then (react_acc_hi, react_acc_lo,
    react_jerk_hi, react_jerk_lo), each (3,Bj); the j-set is AoS."""
    bi, bj = pos_hi_i.shape[0], pos_hi_j.shape[0]
    (eps2,) = _scal(scal, pos_hi_i.device, (1,))
    act = [pos_hi_i.new_zeros((bi, 4)) for _ in range(4)]
    react = tuple(pos_hi_i.new_zeros((bj, 3)) for _ in range(4))
    c = _chunk_rows(bj)
    for r0 in range(0, bi if bj else 0, c):
        r1 = min(bi, r0 + c)
        parts = _ds_aj_sym_rows(pos_hi_i[r0:r1], pos_lo_i[r0:r1], vel_hi_i[r0:r1],
                                vel_lo_i[r0:r1], pos_hi_j, pos_lo_j, vel_hi_j, vel_lo_j, eps2)
        for k, v in enumerate((*parts[0], *parts[1])):
            act[k][r0:r1, :3] = v
        react = ds_add_aj(react, (*parts[2], *parts[3]))
    return (*act, *(r.t() for r in react))


def ds_accel_jerk_symmetric_blocked(pos_hi, pos_lo, vel_hi, vel_lo, scal, *, block_cap: int,
                                    tile_j: int = 256):
    """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (N,3), each pair once at any
    N: k superblock triangles and k(k-1)/2 rectangles, each block's parts
    ds-added in the JAX order, the triangle and then the rectangles in loop
    order (``compute_accel_jerk_pallas_ds_sym_blocked``, ds_kernel.py:2019-2105,
    through ``reference.compose_symmetric_blocked``)."""
    return compose_symmetric_blocked(
        (pos_hi, pos_lo, vel_hi, vel_lo), scal, block_cap=block_cap, tile_j=tile_j,
        triangle=ds_accel_jerk_symmetric, cross=ds_aj_sym_cross, add=ds_add_aj)


# ---- the ds Hermite predictor-corrector (ds_kernel.py:936-1032) ----


def hermite_planes(hi, lo):
    """(N,4) hi/lo AoS (or an (N,3) field) -> the (N,3) coordinate planes
    as a ds pair."""
    return hi[:, :3], lo[:, :3]


def hermite_assemble(vec, w_hi, w_lo):
    """A ds pair of (N,3) planes and the carried (N,1) w column, hi and lo
    -> (N,4) hi/lo AoS."""
    return torch.cat([vec[0], w_hi], 1), torch.cat([vec[1], w_lo], 1)


def hermite_predict(x0, v0, a0, j0, scal):
    """x_p = x + v dt + a0 dt^2/2 + j0 dt^3/6, v_p = v + a0 dt + j0 dt^2/2
    on ds pairs of (N,3) planes; `scal` from ``scal_ds_hermite``."""
    dt, dt2_2, dt3_6 = _scal(scal, x0[0].device, (0, 4, 5))
    xp = ds_add(ds_add(x0, ds_mul(v0, dt)), ds_add(ds_mul(a0, dt2_2), ds_mul(j0, dt3_6)))
    vp = ds_add(v0, ds_add(ds_mul(a0, dt), ds_mul(j0, dt2_2)))
    return xp, vp


def hermite_correct(x0, v0, a0, j0, a1, j1, scal):
    """v1 = (v + dt/2 (a0 + a1) + dt^2/12 (j0 - j1)) damping,
    x1 = x + dt/2 (v + v1) + dt^2/12 (a0 - a1). Returns (x1, v1)."""
    damping, dt_half, dt2_12 = _scal(scal, x0[0].device, (2, 3, 6))
    v1 = ds_mul(ds_add(v0, ds_add(ds_mul(ds_add(a0, a1), dt_half),
                                  ds_mul(ds_sub(j0, j1), dt2_12))), damping)
    x1 = ds_add(x0, ds_add(ds_mul(ds_add(v0, v1), dt_half), ds_mul(ds_sub(a0, a1), dt2_12)))
    return x1, v1


def _assemble_state(x, v, pos_hi, pos_lo, vel_hi, vel_lo):
    """The four (N,4) planes of positions x and velocities v (ds (N,3)),
    the mass and vel.w carried from the given planes, hi and lo."""
    return (*hermite_assemble(x, pos_hi[:, 3:4], pos_lo[:, 3:4]),
            *hermite_assemble(v, vel_hi[:, 3:4], vel_lo[:, 3:4]))


def ds_hermite_predict(pos_hi, pos_lo, vel_hi, vel_lo, acc, jerk, scal):
    """The four predicted (N,4) planes from the state and its ds acc and
    jerk, (hi, lo) pairs of (N,3) or (N,4): the plain version of the
    predictor kernel, mass and vel.w carried."""
    xp, vp = hermite_predict(hermite_planes(pos_hi, pos_lo), hermite_planes(vel_hi, vel_lo),
                             hermite_planes(*acc), hermite_planes(*jerk), scal)
    return _assemble_state(xp, vp, pos_hi, pos_lo, vel_hi, vel_lo)


def ds_hermite_correct(pos_hi, pos_lo, vel_hi, vel_lo, acc0, jerk0, acc1, jerk1, scal):
    """The four corrected (N,4) planes from the start-of-step state, its
    (acc0, jerk0) and the predicted state's (acc1, jerk1): the plain
    version of the corrector kernel."""
    x1, v1 = hermite_correct(hermite_planes(pos_hi, pos_lo), hermite_planes(vel_hi, vel_lo),
                             *(hermite_planes(*f) for f in (acc0, jerk0, acc1, jerk1)), scal)
    return _assemble_state(x1, v1, pos_hi, pos_lo, vel_hi, vel_lo)


def nbody_step_ds_hermite(pos_hi, pos_lo, vel_hi, vel_lo, scal, *, sym: bool = False,
                          block_cap: int | None = None, tile_j: int = 256):
    """One 4th-order Hermite P(EC) step in ds (``nbody_step_pallas_ds_hermite``,
    ds_kernel.py:981-1032): accel + jerk at the start, the predictor, accel
    + jerk at the predicted state, the corrector. `sym` takes each pair once
    (the triangle, or the blocked composition when `block_cap` is given),
    else the one-sided evaluation. `scal` from ``scal_ds_hermite``."""
    def aj(*state):
        if not sym:
            return ds_accel_jerk_vs(*state, *state, scal)
        if block_cap is None:
            return ds_accel_jerk_symmetric(*state, scal)
        return ds_accel_jerk_symmetric_blocked(*state, scal, block_cap=block_cap, tile_j=tile_j)

    planes = (pos_hi, pos_lo, vel_hi, vel_lo)
    a0h, a0l, j0h, j0l = aj(*planes)
    pred = ds_hermite_predict(*planes, (a0h, a0l), (j0h, j0l), scal)
    a1h, a1l, j1h, j1l = aj(*pred)
    return ds_hermite_correct(*planes, (a0h, a0l), (j0h, j0l), (a1h, a1l), (j1h, j1l), scal)
