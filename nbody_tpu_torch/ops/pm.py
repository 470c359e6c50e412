"""Particle-mesh (PM) gravity in PyTorch: plain PM and the long range of P3M.

The port's copy of ``nbody_tpu/ops/pm.py``: the particle-fitting box,
cloud-in-cell (CIC, 8 points) and triangular-shaped-cloud (TSC, 27 points)
assignment, the deposit, the open-space Green's function (1/r for plain PM,
the Gaussian-smoothed one for the P3M split), the three spectrum corrections
(raw, the naive 1/W^2 division, the Hockney-Eastwood optimal influence), the
isolated-boundary Poisson solve on the zero-padded 2G mesh with spectral
gradients, the gather, ``pm_accel`` / ``nbody_step_pm``, and the sharded PM
step (``make_sharded_pm_step``) with its replicated and slab (distributed
FFT) solves. The reference's solve is XLA, not a Pallas kernel, so this is
plain PyTorch on the state's device.

One solve serves every decomposition: the padded grid is transformed as
x-slabs (rfft on z, fft on y, a transpose, fft on x) and back in the mirror
order. On one device, or a replicated mesh, the slab is the whole grid and
the transpose is the identity; with ``fft="slab"`` each of D ranks holds
2G/D x-planes and the transpose is one ``all_to_all`` each way. So a slab
solve on one rank gives the one-device solve's bits.

Every function keeps the reference's float32 order of operations where it
decides bits (the box fit). The deposit sums its contributions in a fixed
order on every device: ``index_add_`` on a CUDA tensor adds with atomics,
whose order changes from run to run, so the deposit runs it under
``torch.use_deterministic_algorithms(True)`` (sorted indices, each run of
equal indices summed in input order) and restores the setting after
(``utils.ordered.index_add_ordered``). Across ranks nothing is summed by the
collective library: the density grid of a replicated mesh and the slab
gathers' partial forces are summed by ``parallel.sharded.ring_reduce_scatter``
in its fixed order, the box's extremes by MIN / MAX all-reduces, which are
exact in any order.
"""

from __future__ import annotations

import functools
import math
import os
import pathlib

import numpy as np
import torch
import torch.distributed as dist

from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.utils.ordered import index_add_ordered
from nbody_tpu_torch.utils.profiling import annotate

# the influence tables' disk cache, beside the port's other build outputs
_CACHE_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build"


def _fit_box(pos3, grid: int, *, mesh=None):
    """Particle-fitting bounding box -> (lo corner (3,), cell size h), both
    float32 tensors on pos3's device, with the bits of the reference's
    compiled ``_fit_box`` (cell ids downstream must equal its exactly). Its
    source divides the span by grid - 4, but XLA compiles a division by a
    constant into a multiplication by the constant's float32 reciprocal,
    which differs from the division in the last ulp for some spans (one
    body of 2048 changed cell at G=32); so this multiplies. With `mesh`
    (pos3 a shard), the extremes are reduced over its ranks (MIN / MAX, the
    reference's pmin / pmax) so that every rank fits one box."""
    lo_raw = pos3.amin(dim=0)
    hi_raw = pos3.amax(dim=0)
    if mesh is not None and mesh.size > 1:
        dist.all_reduce(lo_raw, op=dist.ReduceOp.MIN, group=mesh.group)
        dist.all_reduce(hi_raw, op=dist.ReduceOp.MAX, group=mesh.group)
    span = (hi_raw - lo_raw).amax()
    recip = float(np.float32(1.0) / np.float32(grid - 4))
    h = span * recip + 1e-30  # 2-cell margin each side
    center = (lo_raw + hi_raw) / 2.0
    lo = center - h * float(grid) / 2.0
    return lo, h


def _cic_components(pos3, lo, h, grid: int):
    """CIC: 8 stencil points per particle on a grid^3 lattice; (ix, iy, iz,
    w), each (8, N): per-axis node indices (clipped) and trilinear weights
    summing to 1."""
    rel = (pos3 - lo[None, :]) / h  # in cell units
    base = torch.floor(rel)
    frac = rel - base
    base = base.to(torch.int64)

    ixs, iys, izs, weights = [], [], [], []
    for dx in (0, 1):
        wx = (1.0 - frac[:, 0]) if dx == 0 else frac[:, 0]
        ix = torch.clamp(base[:, 0] + dx, 0, grid - 1)
        for dy in (0, 1):
            wy = (1.0 - frac[:, 1]) if dy == 0 else frac[:, 1]
            iy = torch.clamp(base[:, 1] + dy, 0, grid - 1)
            for dz in (0, 1):
                wz = (1.0 - frac[:, 2]) if dz == 0 else frac[:, 2]
                iz = torch.clamp(base[:, 2] + dz, 0, grid - 1)
                ixs.append(ix)
                iys.append(iy)
                izs.append(iz)
                weights.append(wx * wy * wz)
    return (torch.stack(ixs), torch.stack(iys), torch.stack(izs),
            torch.stack(weights))


def _cic_indices_weights(pos3, lo, h, grid: int):
    """CIC: 8 (flat index, weight) pairs per particle on a grid^3 lattice."""
    ix, iy, iz, w = _cic_components(pos3, lo, h, grid)
    return (ix * grid + iy) * grid + iz, w


def _tsc_components(pos3, lo, h, grid: int):
    """TSC (triangular-shaped cloud, Hockney & Eastwood order 3): 27 stencil
    points per particle; (ix, iy, iz, w), each (27, N). Per axis, around the
    nearest node with frac in [-0.5, 0.5): w(-1) = (1/2)(1/2 - frac)^2,
    w(0) = 3/4 - frac^2, w(+1) = (1/2)(1/2 + frac)^2 (sum 1)."""
    rel = (pos3 - lo[None, :]) / h
    base = torch.floor(rel + 0.5)    # nearest node
    frac = rel - base                # in [-0.5, 0.5)
    base = base.to(torch.int64)

    def w1(fr, off):
        if off == -1:
            return 0.5 * ((0.5 - fr) * (0.5 - fr))
        if off == 0:
            return 0.75 - fr * fr
        return 0.5 * ((0.5 + fr) * (0.5 + fr))

    ixs, iys, izs, weights = [], [], [], []
    for dx in (-1, 0, 1):
        wx = w1(frac[:, 0], dx)
        ix = torch.clamp(base[:, 0] + dx, 0, grid - 1)
        for dy in (-1, 0, 1):
            wy = w1(frac[:, 1], dy)
            iy = torch.clamp(base[:, 1] + dy, 0, grid - 1)
            for dz in (-1, 0, 1):
                wz = w1(frac[:, 2], dz)
                iz = torch.clamp(base[:, 2] + dz, 0, grid - 1)
                ixs.append(ix)
                iys.append(iy)
                izs.append(iz)
                weights.append(wx * wy * wz)
    return (torch.stack(ixs), torch.stack(iys), torch.stack(izs),
            torch.stack(weights))


def _tsc_indices_weights(pos3, lo, h, grid: int):
    """TSC: 27 (flat index, weight) pairs per particle."""
    ix, iy, iz, w = _tsc_components(pos3, lo, h, grid)
    return (ix * grid + iy) * grid + iz, w


# assignment scheme -> ((idx, w) builder, per-axis Fourier-window exponent:
# the order-p B-spline window is sinc^p per axis)
ASSIGNMENTS = {
    "cic": (_cic_indices_weights, 2),
    "tsc": (_tsc_indices_weights, 3),
}

# assignment scheme -> per-axis component builder (the slab decomposition)
ASSIGNMENT_COMPONENTS = {
    "cic": (_cic_components, 2),
    "tsc": (_tsc_components, 3),
}

# influence option -> the solve's `deconvolve` (nbody_tpu/ops/pm.py:505)
DECONVOLVE = {"none": False, "naive": True, "optimal": "optimal"}


def check_assignment(assignment: str) -> str:
    if assignment not in ASSIGNMENTS:
        raise ValueError(f"unknown pm_assignment {assignment!r}")
    return assignment


def _deposit(idx, w, mass, grid: int):
    """Scatter-add -> flat (grid^3,) density grid, summed in the same order
    on every run (see the module docstring)."""
    rho = torch.zeros(grid * grid * grid, dtype=torch.float32, device=mass.device)
    return index_add_ordered(rho, idx.reshape(-1), (w * mass[None, :]).reshape(-1))


def _greens_kernel(r2, sigma=None):
    """Open-space Green's function values on a grid of squared distances:
    1/r with K(0) = 0 (plain PM), or the Gaussian-smoothed erf(r/(sqrt2
    sigma))/r with K(0) = sqrt(2/pi)/sigma (the P3M split)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    if sigma is None:
        return torch.where(r2 > 0, 1.0 / r, 0.0)
    k0 = math.sqrt(2.0 / math.pi) / sigma
    u = r / (math.sqrt(2.0) * sigma)
    return torch.where(r2 > 0, torch.special.erf(u) / r, k0)


@functools.lru_cache(maxsize=8)
def _optimal_influence_factor(grid: int, sigma_cells, window_exp: int):
    """Hockney-Eastwood optimal-influence correction factor, as a constant
    (2G, 2G, G+1) half-spectrum table in UNIT-CELL k-space; a copy of
    ``nbody_tpu/ops/pm.py::_optimal_influence_factor`` (numpy, float64
    inside, float32 out) with its own disk cache.

    H&E (Computer Simulation Using Particles, eq. 8-22) minimize the
    position-averaged mean-square force error over the influence function,
    accounting for ALIASING of the assignment window. With exact spectral
    differentiation D(k) = i k and the reference force spectrum
    R(k') = -i k' g(k') (g = 4pi e^{-sigma^2 k'^2/2}/k'^2), the optimum is

        G_opt(k) = [ sum_m U^2(k_m) (k.k_m) g(k_m) ] / [ k^2 S(k)^2 ]

    over alias images k_m = k + 2pi m (unit cell), with U the per-axis
    sinc^p B-spline window and S = sum_m U^2(k_m). The solve multiplies the
    sampled isolated-BC kernel spectrum by the ratio F(k) = G_opt(k) / g(k)
    returned here. Images are truncated at m in {-1,0,1}^3.

    The table is pure math keyed by (grid, sigma/h, p), so it is cached on
    disk under ``build/nbody_tpu_torch/influence`` ($NBODY_COMPILE_CACHE_DIR
    in place of ``build``), a directory of the port's own, never
    ``nbody_tpu``'s; NBODY_NO_COMPILE_CACHE=1 turns the cache off.
    """
    gp = 2 * grid
    nz = gp // 2 + 1
    sc = float(sigma_cells) if sigma_cells is not None else 0.0
    p = int(window_exp)

    cache_file = None
    if not os.environ.get("NBODY_NO_COMPILE_CACHE"):
        cache_dir = os.path.join(
            os.environ.get("NBODY_COMPILE_CACHE_DIR") or _CACHE_ROOT,
            "nbody_tpu_torch", "influence")
        cache_file = os.path.join(cache_dir, f"g{grid}_s{sc!r}_p{p}_v1.npy")
        try:
            tab = np.load(cache_file)
            if tab.shape == (gp, gp, nz) and tab.dtype == np.float32:
                return tab
        except (OSError, ValueError):
            pass
    fx = np.fft.fftfreq(gp)                      # dimensionless in [-0.5, 0.5)
    fz = np.fft.rfftfreq(gp)

    def g_hat(q2):
        with np.errstate(divide="ignore", invalid="ignore"):
            g = 4.0 * np.pi * np.exp(-0.5 * sc * sc * q2) / q2
        return np.where(q2 > 0, g, 0.0)

    # x-plane chunks bound the float64 temporaries of the 27-image loop
    cx = max(1, min(gp, (1 << 22) // max(1, gp * nz)))
    out = np.empty((gp, gp, nz), np.float32)
    for x0 in range(0, gp, cx):
        f3 = (fx[x0 : x0 + cx, None, None], fx[None, :, None],
              fz[None, None, :])
        k0 = [2.0 * np.pi * f for f in f3]
        k0_sq = sum(k * k for k in k0)
        num = np.zeros((f3[0].shape[0], gp, nz))
        s_sum = np.zeros_like(num)
        for mx in (-1, 0, 1):
            for my in (-1, 0, 1):
                for mz in (-1, 0, 1):
                    km = [2.0 * np.pi * (f3[0] + mx),
                          2.0 * np.pi * (f3[1] + my),
                          2.0 * np.pi * (f3[2] + mz)]
                    u2 = (np.sinc(f3[0] + mx) * np.sinc(f3[1] + my)
                          * np.sinc(f3[2] + mz)) ** (2 * p)
                    km_sq = sum(k * k for k in km)
                    k_dot = sum(a * b for a, b in zip(k0, km))
                    num += u2 * k_dot * g_hat(km_sq)
                    s_sum += u2
        denom = k0_sq * s_sum * s_sum * g_hat(k0_sq)
        with np.errstate(divide="ignore", invalid="ignore"):
            f_opt = num / denom
        # k=0: forces carry no DC component (i*k kills it); 1.0 keeps the
        # kernel's own DC convention
        out[x0 : x0 + cx] = np.where(denom > 0, f_opt, 1.0)
    if cache_file is not None:
        try:  # the cache is an optimization, never a failure mode
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{cache_file}.tmp{os.getpid()}.npy"
            np.save(tmp, out)
            os.replace(tmp, cache_file)
        except OSError:
            pass
    return out


@functools.lru_cache(maxsize=None)
def _influence_table(grid: int, sigma_cells, window_exp: int, device: torch.device):
    """The optimal-influence table as a float32 tensor on `device`, copied
    there once per process (from pinned memory, so that the copy does not
    wait on the host). Never evicted: a captured force
    (``ops/force_graph.py``) reads the table's memory at every replay."""
    with annotate("nbody.pm.influence_table"):
        table = torch.from_numpy(_optimal_influence_factor(grid, sigma_cells, window_exp))
        if torch.device(device).type == "cuda":
            return table.pin_memory().to(device, non_blocking=True)
        return table.to(device)


def _ipow(x, p: int):
    """x**p for a small positive int p as repeated products."""
    out = x
    for _ in range(p - 1):
        out = out * x
    return out


def _apply_deconvolution(conv_k, deconvolve, grid: int, h, window_exp: int, sigma_cells=None,
                         *, f1, fz, fy=None, y_slice=None):
    """The spectrum correction shared by every solve (conv_k is a y-pencil
    (2G, len(fy), G+1) of the half spectrum, the whole spectrum on one
    rank): False leaves it raw; True divides by the squared assignment
    window W(k)^2, sinc^p per axis, one factor each for deposit and gather;
    "optimal" multiplies by the H&E optimal-influence ratio
    (``_optimal_influence_factor``), sliced to the pencil's y-range
    `y_slice` = (y0, length)."""
    if deconvolve is False:
        return conv_k
    if deconvolve == "optimal":
        table = _influence_table(grid, sigma_cells, window_exp, conv_k.device)
        if y_slice is not None:
            table = table[:, y_slice[0]:y_slice[0] + y_slice[1]]
        return conv_k * table
    if deconvolve is not True:
        raise ValueError(f"unknown deconvolution {deconvolve!r}")
    wx = _ipow(torch.sinc(f1 * h), window_exp)
    wz = _ipow(torch.sinc(fz * h), window_exp)
    wy = wx if fy is None else _ipow(torch.sinc(fy * h), window_exp)
    win = wx[:, None, None] * wy[None, :, None] * wz[None, None, :]
    return conv_k / (win * win)


def _transpose(mesh, f, *, forward: bool):
    """The slab transpose: forward, this rank's (2G/D, 2G, n) x-slab of a
    spectrum to its (2G, 2G/D, n) y-pencil (``jax.lax.all_to_all(f, axis,
    split_axis=1, concat_axis=0, tiled=True)``); backward, the mirror. One
    ``all_to_all_single`` of the float32 view; it moves data and sums
    nothing. The identity on one rank."""
    if mesh is None or mesh.size == 1:
        return f
    d = mesh.size
    if forward:
        gl, gp, nz = f.shape
        send = f.reshape(gl, d, gp // d, nz).transpose(0, 1)
    else:
        gp, gl, nz = f.shape
        send = f.reshape(d, gp // d, gl, nz)
    send = torch.view_as_real(send.contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    recv = torch.view_as_complex(recv)
    if forward:  # x-blocks in source order
        return recv.reshape(gp, gp // d, nz)
    return recv.transpose(0, 1).reshape(gp // d, gp, nz)  # y-blocks in source order


def _slab_fft3(slab, mesh=None):
    """(2G/D, 2G, 2G) real x-slab -> (2G, 2G/D, G+1) y-pencil of the half
    spectrum: rfft on z, fft on y, the transpose, fft on x."""
    f = torch.fft.rfft(slab, dim=2)
    f = torch.fft.fft(f, dim=1)
    f = _transpose(mesh, f, forward=True)
    return torch.fft.fft(f, dim=0)


def _slab_ifft3_real(spec, mesh=None):
    """The inverse of ``_slab_fft3``: the real x-slab."""
    gp = spec.shape[0]
    f = torch.fft.ifft(spec, dim=0)
    f = _transpose(mesh, f, forward=False)
    f = torch.fft.ifft(f, dim=1)
    return torch.fft.irfft(f, n=gp, dim=2).to(torch.float32)


def _solve_force_grids_slab(rho_slab, h, grid: int, *, mesh=None, sigma=None,
                            deconvolve=False, window_exp: int = 2, sigma_cells=None):
    """Isolated-BC Poisson solve on x-slabs of the zero-padded 2G grid:
    rho_slab (2G/D, 2G, 2G) is this rank's x-planes (planes >= G hold the
    padding zeros); returns three (2G/D, 2G, 2G) acceleration slabs.

    phi = -conv(rho, K) and a = -grad(phi) = +grad(conv), the gradient
    applied spectrally (i*k multiply) with the Nyquist bin of the
    differentiation operator zeroed (its sign is ambiguous). K is 1/r, or
    with ``sigma`` (length units) the Gaussian-smoothed kernel of the P3M
    split, its values analytic per plane; ``deconvolve`` as in
    ``_apply_deconvolution`` for the window sinc^p, p = ``window_exp``.
    `mesh` None (or one rank) is the whole grid on this device."""
    dev = rho_slab.device
    d, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    gp = 2 * grid
    gl = gp // d
    n_full = torch.arange(gp, device=dev)
    gx = rank * gl + torch.arange(gl, device=dev)
    dx1 = torch.minimum(gx, gp - gx).to(torch.float32) * h
    d1 = torch.minimum(n_full, gp - n_full).to(torch.float32) * h
    r2 = dx1[:, None, None] ** 2 + d1[None, :, None] ** 2 + d1[None, None, :] ** 2
    kernel = _greens_kernel(r2, sigma)

    conv_k = _slab_fft3(rho_slab, mesh) * _slab_fft3(kernel, mesh)
    # fftfreq(gp, d=h) = k / (gp h), with h a device scalar
    f1 = torch.fft.fftfreq(gp, device=dev) / h
    fz = torch.fft.rfftfreq(gp, device=dev) / h
    fy = f1[rank * gl:(rank + 1) * gl]
    conv_k = _apply_deconvolution(conv_k, deconvolve, grid, h, window_exp, sigma_cells,
                                  f1=f1, fz=fz, fy=fy, y_slice=(rank * gl, gl))
    k1 = (2.0 * math.pi) * f1
    kz = (2.0 * math.pi) * fz
    # fills, not item assignments, which would copy a Python scalar from the
    # host and wait for it every step
    k1 = k1.masked_fill(torch.arange(k1.shape[0], device=dev) == gp // 2, 0.0)
    kz = kz.masked_fill(torch.arange(kz.shape[0], device=dev) == gp // 2, 0.0)
    ky = (2.0 * math.pi) * torch.where((fy * h).abs() >= 0.5 - 1e-7, 0.0, fy)
    kvs = (k1[:, None, None], ky[None, :, None], kz[None, None, :])
    return [_slab_ifft3_real(conv_k * (1j * kv), mesh) for kv in kvs]


def _solve_force_grids(rho_flat, h, grid: int, sigma=None, deconvolve=False,
                       window_exp: int = 2, sigma_cells=None):
    """Isolated-BC Poisson solve of the whole (grid^3,) density on this
    device (``_solve_force_grids_slab`` with one slab); returns three flat
    (grid^3,) acceleration grids."""
    gp = 2 * grid
    rho_p = torch.zeros((gp, gp, gp), dtype=torch.float32, device=rho_flat.device)
    rho_p[:grid, :grid, :grid] = rho_flat.reshape(grid, grid, grid)
    grids = _solve_force_grids_slab(rho_p, h, grid, sigma=sigma, deconvolve=deconvolve,
                                    window_exp=window_exp, sigma_cells=sigma_cells)
    return [g[:grid, :grid, :grid].reshape(-1) for g in grids]


def _gather(force_grids, idx, w):
    """Gather of the three force grids at the stencil points; (N, 3)."""
    return torch.stack([(g[idx] * w).sum(dim=0) for g in force_grids], dim=1)


def _slab_index(ix, iy, iz, x0, gl: int, grid: int):
    """(ok, flat): which stencil points lie in the x-planes [x0, x0 + gl),
    and their flat index in the (gl, 2G, 2G) slab."""
    gp = 2 * grid
    lx = ix - x0
    ok = (lx >= 0) & (lx < gl)
    return ok, (lx * gp + iy) * gp + iz


def _deposit_slab(ix, iy, iz, w, mass, grid: int, x0, gl: int):
    """Scatter-add of the stencil points this x-slab owns into a (gl, 2G,
    2G) padded-density slab, in the fixed order of ``_deposit``. The other
    points are left out before the scatter: a slot that took them all
    would be one run of (D-1)/D of them, which the ordered scatter sums in
    sequence (a second a step at 2^20 on four H100s)."""
    gp = 2 * grid
    ok, flat = _slab_index(ix, iy, iz, x0, gl, grid)
    rho = torch.zeros(gl * gp * gp, dtype=torch.float32, device=mass.device)
    return index_add_ordered(rho, flat[ok], (w * mass[None, :])[ok]).reshape(gl, gp, gp)


def _gather_slab(grids, ix, iy, iz, w, x0, gl: int, grid: int):
    """Gather from this rank's slab grids; off-slab stencil points give 0
    (the sum over the ranks completes them); (N, 3)."""
    ok, flat = _slab_index(ix, iy, iz, x0, gl, grid)
    flat = torch.where(ok, flat, 0)
    return torch.stack([(torch.where(ok, g.reshape(-1)[flat], 0.0) * w).sum(dim=0)
                        for g in grids], dim=1)


def pm_accel(pos, *, grid: int = 64, assignment: str = "cic", influence: str = "none"):
    """(N, 4) [x,y,z,m] -> (N, 3) far-field accelerations on one device.

    assignment: "cic" (8-point trilinear) or "tsc" (27-point quadratic).
    influence: "none" (the raw 1/r kernel; a naive 1/W^2 deconvolution of
    it amplifies sub-cell error, so plain PM defaults off), "naive" or
    "optimal" (the H&E alias-aware influence function)."""
    if pos.shape[-1] != 4:
        raise ValueError("pm_accel expects (N, 4) [x,y,z,m]")
    if influence not in DECONVOLVE:
        raise ValueError(f"unknown influence {influence!r}")
    return long_range(pos, grid=grid, assignment=assignment, deconvolve=DECONVOLVE[influence])


def nbody_step_pm(pos, vel, dt, softening, damping, *, grid: int = 64, assignment: str = "cic"):
    """PM step with the reference's damped semi-implicit Euler update.
    `softening` is accepted for the interface: PM's effective softening is
    the cell scale."""
    del softening
    acc = pm_accel(pos, grid=grid, assignment=assignment)
    return reference.integrate(pos, vel, acc.to(pos.dtype), dt, damping)


# ---- the sharded PM step ----


def fixed_order_sum(mesh, x):
    """The sum over the mesh's ranks of the float32 tensor `x` (any shape),
    on every rank: ``ring_reduce_scatter`` of its flat values (zero-padded
    to D chunks), then an all-gather. Its bits depend on D alone; one rank
    returns `x`."""
    if mesh.size == 1:
        return x
    from nbody_tpu_torch.parallel.mesh import all_gather_rows
    from nbody_tpu_torch.parallel.sharded import ring_reduce_scatter

    d, flat = mesh.size, x.reshape(-1)
    m = -(-flat.numel() // d)
    parts = torch.cat([flat, flat.new_zeros(m * d - flat.numel())]).view(d * m, 1)
    (chunk,) = ring_reduce_scatter(mesh, (parts,), reference.add_fields)
    return all_gather_rows(mesh, chunk).view(-1)[:flat.numel()].view_as(x)


def check_slab(fft: str, grid: int, ndev: int) -> None:
    """nbody_tpu's checks of the FFT decomposition (ops/pm.py:580-586)."""
    if fft not in ("replicated", "slab"):
        raise ValueError(f"unknown fft {fft!r}")
    if fft == "slab" and (2 * grid) % ndev:
        raise ValueError(
            f"fft='slab' needs the device count ({ndev}) to divide the "
            f"padded grid 2*{grid}")


def long_range(pos, *, grid: int, assignment: str = "cic", deconvolve=False,
               sigma_cells=None, mesh=None, fft: str = "replicated", pos_all=None):
    """The mesh's force on the (N, 4) state `pos`: the box fit, the
    deposit, the solve with the spectrum correction `deconvolve`, the
    gather; ``sigma_cells`` (None for plain PM) scales the smoothed kernel
    of the P3M split with the cell size h.

    With `mesh` (a 1-D mesh; `pos` this rank's shard), the PM part of
    ``_pm_accel_local_factory`` / ``_p3m_accel_local_factory``
    (nbody_tpu/ops/pm.py:532-566, p3m.py:487-527). Replicated: the box's
    extremes by MIN / MAX all-reduces, the shard's local deposit, the
    density grid summed by ``fixed_order_sum``, a redundant solve, the
    shard's gather: (nloc, 3). Slab: the gathered bodies (`pos_all`, or
    gathered here) deposit into this rank's x-slab, the distributed solve,
    and the slab's gather of every body: an (N, 3) partial that the
    caller sums over the ranks (``ring_reduce_scatter``)."""
    assign, wexp = ASSIGNMENTS[check_assignment(assignment)]
    comp, _ = ASSIGNMENT_COMPONENTS[assignment]
    if mesh is not None and fft == "slab":
        if pos_all is None:
            from nbody_tpu_torch.parallel.mesh import all_gather_rows

            pos_all = all_gather_rows(mesh, pos)
        pos3 = pos_all[:, :3].to(torch.float32)
        mass = pos_all[:, 3].to(torch.float32)
        gl = 2 * grid // mesh.size
        x0 = mesh.rank * gl
        with annotate("nbody.pm.deposit"):
            lo, h = _fit_box(pos3, grid)  # gathered: the same on every rank
            sigma = None if sigma_cells is None else sigma_cells * h
            ix, iy, iz, w = comp(pos3, lo, h, grid)
            rho = _deposit_slab(ix, iy, iz, w, mass, grid, x0, gl)
        with annotate("nbody.pm.solve"):
            grids = _solve_force_grids_slab(rho, h, grid, mesh=mesh, sigma=sigma,
                                            deconvolve=deconvolve, window_exp=wexp,
                                            sigma_cells=sigma_cells)
        with annotate("nbody.pm.gather"):
            return _gather_slab(grids, ix, iy, iz, w, x0, gl, grid)
    pos3 = pos[:, :3].to(torch.float32)
    mass = pos[:, 3].to(torch.float32)
    with annotate("nbody.pm.deposit"):
        lo, h = _fit_box(pos3, grid, mesh=mesh)
        sigma = None if sigma_cells is None else sigma_cells * h
        idx, w = assign(pos3, lo, h, grid)
        rho = _deposit(idx, w, mass, grid)
        if mesh is not None:
            rho = fixed_order_sum(mesh, rho)
    with annotate("nbody.pm.solve"):
        grids = _solve_force_grids(rho, h, grid, sigma=sigma, deconvolve=deconvolve,
                                   window_exp=wexp, sigma_cells=sigma_cells)
    with annotate("nbody.pm.gather"):
        return _gather(grids, idx, w)


class ShardedMeshStep:
    """The body-sharded step of a mesh solver on a 1-D mesh: (pos, vel, dt,
    softening, damping) -> (pos, vel), each this rank's (N/D, 4) shard, new
    tensors; ``accel(pos, softening)`` gives the shard's force. The force
    is evaluated from the float32 positions, as ``nbody_tpu``'s mesh
    solvers cast them, and the update runs in the state's type."""

    def __init__(self, mesh, accel, integrator: str):
        if integrator not in ("euler", "leapfrog"):
            raise ValueError(f"unknown integrator {integrator!r}")
        self.mesh = mesh
        self._accel = accel
        self.integrator = integrator

    def accel(self, pos, softening):
        return self._accel(pos, softening).to(pos.dtype)

    def __call__(self, pos, vel, dt, softening, damping):
        if self.integrator == "leapfrog":
            return reference.nbody_step_leapfrog(
                pos, vel, dt, softening, damping, accel_fn=lambda p: self.accel(p, softening))
        return reference.integrate(pos, vel, self.accel(pos, softening), dt, damping)


def make_sharded_pm_accel(mesh, *, grid: int = 64, axis: str = "bodies",
                          assignment: str = "cic", fft: str = "replicated"):
    """The sharded PM force: accel(pos_sh, softening=None) -> (nloc, 3) of
    this rank's shard (``nbody_tpu/ops/pm.py:569-589``); the raw 1/r kernel
    with no spectrum correction, as there. Replicated or slab, as in
    ``long_range``; the slab's partials are summed onto their owners
    by ``ring_reduce_scatter``."""
    from nbody_tpu_torch.parallel.sharded import ring_reduce_scatter

    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    check_assignment(assignment)
    check_slab(fft, grid, mesh.size)

    def accel(pos_sh, softening=None):
        acc = long_range(pos_sh, grid=grid, assignment=assignment, mesh=mesh, fft=fft)
        if fft == "slab":
            (acc,) = ring_reduce_scatter(mesh, (acc,), reference.add_fields)
        return acc

    return accel


def make_sharded_pm_step(mesh, *, grid: int = 64, axis: str = "bodies",
                         integrator: str = "euler", assignment: str = "cic",
                         fft: str = "replicated") -> ShardedMeshStep:
    """Body-sharded PM step over a 1-D mesh (``nbody_tpu/ops/pm.py:592-664``):
    (pos, vel, dt, softening, damping) -> (pos, vel) of this rank's shard,
    Euler or leapfrog. fft="replicated": the shard's local deposit, one
    fixed-order sum of the G^3 density grid, a redundant solve, the local
    gather. fft="slab": the distributed-FFT pipeline, the padded grid as
    x-slabs (needs D | 2G)."""
    if integrator not in ("euler", "leapfrog"):
        raise ValueError(f"unknown integrator {integrator!r}")
    return ShardedMeshStep(mesh, make_sharded_pm_accel(mesh, grid=grid, axis=axis,
                                                       assignment=assignment, fft=fft),
                           integrator)
