"""Particle-mesh (PM) pieces of the P3M long-range force, in PyTorch.

The port's copy of what ``ops/p3m.py`` needs from ``nbody_tpu/ops/pm.py``:
the particle-fitting box, cloud-in-cell (CIC) assignment, the deposit, the
Gaussian-smoothed open-space Green's function, the Hockney-Eastwood
optimal-influence table, and the isolated-boundary Poisson solve on the
zero-padded 2G mesh with half-spectrum FFTs (``torch.fft.rfftn`` /
``irfftn``) and spectral gradients, then the CIC gather. The reference's
solve is plain XLA, not a Pallas kernel, so this is plain PyTorch too.

Every function runs on any torch device and keeps the reference's float32
order of operations where it decides bits (the box fit). The deposit sums
its 8N contributions in a fixed order on every device: ``index_add_`` on a
CUDA tensor adds with atomics, whose order changes from run to run, so the
deposit runs it under ``torch.use_deterministic_algorithms(True)`` (sorted
indices, each run of equal indices summed in input order) and restores the
setting after (``utils.ordered.index_add_ordered``). Plain PM (``--kernel
pm``), TSC assignment, the naive deconvolution and the slab-decomposed solve
are not ported yet (ROADMAP.md Queue 1 #16).
"""

from __future__ import annotations

import functools
import math
import os
import pathlib

import numpy as np
import torch

from nbody_tpu_torch.utils.ordered import index_add_ordered

# the influence tables' disk cache, beside the port's other build outputs
_CACHE_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build"


def _fit_box(pos3, grid: int):
    """Particle-fitting bounding box -> (lo corner (3,), cell size h), both
    float32 tensors on pos3's device, with the bits of the reference's
    compiled ``_fit_box`` (cell ids downstream must equal its exactly). Its
    source divides the span by grid - 4, but XLA compiles a division by a
    constant into a multiplication by the constant's float32 reciprocal,
    which differs from the division in the last ulp for some spans (one
    body of 2048 changed cell at G=32); so this multiplies."""
    lo_raw = pos3.amin(dim=0)
    hi_raw = pos3.amax(dim=0)
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


def _deposit(idx, w, mass, grid: int):
    """CIC scatter-add -> flat (grid^3,) density grid, summed in the same
    order on every run (see the module docstring)."""
    rho = torch.zeros(grid * grid * grid, dtype=torch.float32, device=mass.device)
    return index_add_ordered(rho, idx.reshape(-1), (w * mass[None, :]).reshape(-1))


def _greens_kernel(r2, sigma):
    """The Gaussian-smoothed open-space Green's function erf(r/(sqrt2
    sigma))/r on a grid of squared distances, K(0) = sqrt(2/pi)/sigma (the
    P3M split; plain PM's 1/r comes with Queue 1 #16)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
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


@functools.lru_cache(maxsize=8)
def _influence_table(grid: int, sigma_cells, window_exp: int, device: torch.device):
    """The optimal-influence table as a float32 tensor on `device`, copied
    there once per process."""
    return torch.from_numpy(_optimal_influence_factor(grid, sigma_cells, window_exp)).to(device)


def _apply_deconvolution(conv_k, grid: int, window_exp: int, sigma_cells):
    """The "optimal" spectrum correction: multiply by the H&E
    optimal-influence ratio (the naive 1/W^2 division comes with Queue 1
    #16)."""
    return conv_k * _influence_table(grid, sigma_cells, window_exp, conv_k.device)


def _solve_force_grids(rho_flat, h, grid: int, sigma, *, window_exp: int = 2,
                       sigma_cells=None):
    """Isolated-BC Poisson solve; returns 3 flat (grid^3,) acceleration
    grids.

    phi = -conv(rho, K) on the 2G zero-padded mesh, a = -grad(phi) =
    +grad(conv); the gradient applied spectrally (i*k multiply) on the half
    spectrum, with the Nyquist bin of the differentiation operator zeroed
    (its sign is ambiguous). K is the Gaussian-smoothed kernel of the P3M
    split (``sigma`` in length units), and the spectrum is corrected by the
    optimal-influence table for the assignment window sinc^p
    (p = ``window_exp``)."""
    dev = rho_flat.device
    rho = rho_flat.reshape(grid, grid, grid)
    gp = 2 * grid
    rho_p = torch.zeros((gp, gp, gp), dtype=torch.float32, device=dev)
    rho_p[:grid, :grid, :grid] = rho

    n = torch.arange(gp, device=dev)
    d = torch.minimum(n, gp - n).to(torch.float32) * h
    r2 = d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2
    kernel = _greens_kernel(r2, sigma)

    conv_k = torch.fft.rfftn(rho_p) * torch.fft.rfftn(kernel)
    conv_k = _apply_deconvolution(conv_k, grid, window_exp, sigma_cells)
    # fftfreq(gp, d=h) = k / (gp h), with h a device scalar
    f1 = torch.fft.fftfreq(gp, device=dev) / h
    fz = torch.fft.rfftfreq(gp, device=dev) / h
    k1 = (2.0 * math.pi) * f1
    kz = (2.0 * math.pi) * fz
    k1[gp // 2] = 0.0
    kz[gp // 2] = 0.0
    grids = []
    for axis in range(3):
        if axis == 2:
            kv = kz[None, None, :]
        else:
            shape = [1, 1, 1]
            shape[axis] = gp
            kv = k1.reshape(shape)
        grad = torch.fft.irfftn(conv_k * (1j * kv), s=(gp, gp, gp)).to(torch.float32)
        grids.append(grad[:grid, :grid, :grid].reshape(-1))
    return grids


def _gather(force_grids, idx, w):
    """CIC gather of the three force grids at the 8 stencil points; (N, 3)."""
    return torch.stack([(g[idx] * w).sum(dim=0) for g in force_grids], dim=1)
