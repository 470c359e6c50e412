"""The plain P3M reference: the force that the configuration's P3M solver
defines, worked out again from the state in float64.

The solver splits the softened Plummer force at a Gaussian of width
sigma = 1.5 h (h the mesh cell of the particle-fitting box, span / (G - 4),
centred):

  long range   CIC assignment of the masses on the G^3 mesh; the isolated
               Poisson solve on the zero-padded (2G)^3 mesh with the
               Gaussian-smoothed Green's function erf(r / (sqrt2 sigma)) / r
               (sqrt(2 / pi) / sigma at r = 0), its spectrum times the
               Hockney-Eastwood optimal influence over the 27 nearest alias
               images (CIC window sinc^2 per axis), the gradient by i k with
               the Nyquist bins zeroed; CIC interpolation back to the bodies;
  short range  every pair with r^2 < rcut^2, rcut = 4 sigma, adding
               m_j d (R^-3 - s_lr(r^2)), with s_lr the solver's degree-10
               polynomial in y = r^2 / (2 sigma^2) over (sqrt2 sigma)^3.

The box, the deposit, the padded solve and the gather are the PM
reference's (``pm.py``), given this Green's function and influence.
The polynomial is part of the solver's definition (its coefficients are the
published pair kernel's), so it is kept here; the rest is written from the
equations. Nothing of the program under test is imported, and nothing it
made (its box, tables or influence) is read.

``precision="fp64"`` is the reference; ``"tf32"`` the control: float32
throughout, with the positions and masses rounded to TF32 at the start.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.pm import fit_box, long_range, typed

SIGMA_CELLS = 1.5
RCUT_SIGMAS = 4.0
SLR_POLY = (
    0.7522514718300537,
    -0.4513297496782609,
    0.1611063215380149,
    -0.04162870626770713,
    0.008389008230325833,
    -0.0013517520799301759,
    0.0001720653915474035,
    -1.6553017193590822e-05,
    1.1152261980593794e-06,
    -4.625102305643162e-08,
    8.792217886009483e-10,
)
# elements of one (i-rows x j-candidates) block of the short range's screen
_BLOCK = 1 << 26


def optimal_influence(grid: int, device, dtype=torch.float64):
    """The H&E optimal-influence ratio G_opt(k) / g(k) on the (2G, 2G, G+1)
    half spectrum of the padded mesh, in unit-cell k-space, CIC window:

        G_opt(k) = sum_m U^2(k_m) (k . k_m) g(k_m) / (k^2 S(k)^2),
        k_m = k + 2 pi m, m in {-1, 0, 1}^3, U = sinc^2 per axis,
        S = sum_m U^2(k_m), g(q) = 4 pi exp(-sigma^2 q^2 / 2) / q^2;

    1 where the denominator vanishes (k = 0)."""
    gp = 2 * grid
    sc = SIGMA_CELLS
    f = [torch.fft.fftfreq(gp, device=device, dtype=dtype)[:, None, None],
         torch.fft.fftfreq(gp, device=device, dtype=dtype)[None, :, None],
         torch.fft.rfftfreq(gp, device=device, dtype=dtype)[None, None, :]]

    def g_hat(q2):
        return torch.where(q2 > 0, 4.0 * math.pi * torch.exp(-0.5 * sc * sc * q2)
                           / torch.where(q2 > 0, q2, 1.0), 0.0)

    k0 = [2.0 * math.pi * a for a in f]
    k0_sq = k0[0] ** 2 + k0[1] ** 2 + k0[2] ** 2
    num = torch.zeros(k0_sq.shape, dtype=dtype, device=device)
    s_sum = torch.zeros_like(num)
    for m in range(27):
        mm = (m // 9 - 1, (m // 3) % 3 - 1, m % 3 - 1)
        km = [2.0 * math.pi * (a + b) for a, b in zip(f, mm)]
        u2 = (torch.sinc(f[0] + mm[0]) * torch.sinc(f[1] + mm[1])
              * torch.sinc(f[2] + mm[2])) ** 4
        km_sq = km[0] ** 2 + km[1] ** 2 + km[2] ** 2
        k_dot = k0[0] * km[0] + k0[1] * km[1] + k0[2] * km[2]
        num = num + u2 * k_dot * g_hat(km_sq)
        s_sum = s_sum + u2
    denom = k0_sq * s_sum * s_sum * g_hat(k0_sq)
    return torch.where(denom > 0, num / torch.where(denom > 0, denom, 1.0), 1.0)


def smoothed_green(r2, r, h):
    """The Gaussian-smoothed Green's function erf(r / (sqrt2 sigma)) / r,
    sqrt(2 / pi) / sigma at r = 0, sigma = 1.5 h."""
    sigma = SIGMA_CELLS * h
    return torch.where(r2 > 0, torch.special.erf(r / (math.sqrt(2.0) * sigma)) / r,
                       math.sqrt(2.0 / math.pi) / sigma)


def _s_sr(r2, eps2, sigma):
    """R^-3 - s_lr(r^2): the short-range force shape."""
    y = r2 / (2.0 * sigma * sigma)
    g = torch.full_like(y, SLR_POLY[-1])
    for c in SLR_POLY[-2::-1]:
        g = g * y + c
    return (r2 + eps2).rsqrt() ** 3 - g / (math.sqrt(2.0) * sigma) ** 3


def _cell_lists(p3, rcut):
    """Bodies sorted into cubes of edge rcut: (order, dims, start and count
    of each cube on the host)."""
    c = torch.floor((p3 - p3.amin(0)) / rcut).to(torch.int64)
    dims = (c.amax(0) + 1).tolist()
    flat = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=dims[0] * dims[1] * dims[2])
    starts = torch.cumsum(counts, 0) - counts
    return order, dims, starts.tolist(), counts.tolist()


def _neighbours(cell: int, dims, starts, counts, device):
    """The sorted rows of the 27 cubes around `cell`: nine runs, z fastest."""
    gx, gy, gz = dims
    cx, cy, cz = cell // (gy * gz), (cell // gz) % gy, cell % gz
    z0, z1 = max(cz - 1, 0), min(cz + 1, gz - 1)
    runs = []
    for x in range(max(cx - 1, 0), min(cx + 2, gx)):
        for y in range(max(cy - 1, 0), min(cy + 2, gy)):
            first, last = (x * gy + y) * gz + z0, (x * gy + y) * gz + z1
            lo, hi = starts[first], starts[last] + counts[last]
            if hi > lo:
                runs.append(torch.arange(lo, hi, device=device))
    return torch.cat(runs)


def short_range(p3, mass, eps2, rcut, sigma, *, forces: bool = True):
    """((N, 3) short-range accelerations or None, ordered pairs i != j with
    r^2 < rcut^2), by a cell list of cubes of edge rcut (every such pair lies
    in neighbouring cubes). Each block of candidates is screened in float32
    with a margin of 1e-4 rcut^2 (far above its rounding); the pairs that
    pass are worked out in the state's type."""
    order, dims, starts, counts = _cell_lists(p3, rcut)
    sp, sm = p3[order], mass[order]
    s32 = sp.to(torch.float32)
    dev = p3.device
    acc = torch.zeros_like(sp) if forces else None
    rcut2 = rcut * rcut
    screen = rcut2 * (1.0 + 1e-4)
    near = torch.zeros((), dtype=torch.int64, device=dev)
    for cell, n_i in enumerate(counts):
        if not n_i:
            continue
        jdx = _neighbours(cell, dims, starts, counts, dev)
        s0 = starts[cell]
        centre = s32[s0:s0 + n_i].mean(0)
        b = s32[jdx] - centre
        bb = (b * b).sum(1)
        step = max(1, _BLOCK // jdx.shape[0])
        for i0 in range(s0, s0 + n_i, step):
            i1 = min(s0 + n_i, i0 + step)
            a = s32[i0:i1] - centre
            r2 = torch.addmm(bb[None, :], a, b.T, alpha=-2.0).add_((a * a).sum(1)[:, None])
            ii, jj = torch.nonzero(r2 < screen, as_tuple=True)
            del r2
            gi, gj = ii + i0, jdx[jj]
            d = sp[gj] - sp[gi]
            d2 = (d * d).sum(1)
            keep = (d2 < rcut2) & (gi != gj)
            near += keep.sum()
            if forces:
                s = torch.where(keep, _s_sr(d2, eps2, sigma), 0.0) * sm[gj]
                acc.index_add_(0, gi, s[:, None] * d)
    if forces:
        out = torch.empty_like(acc)
        out[order] = acc
        acc = out
    return acc, int(near)


def force(pos, softening, *, grid: int, precision: str = "fp64"):
    """(N, 3) P3M accelerations of the (N, 4) state `pos`."""
    p = typed(pos, precision)
    p3, mass = p[:, :3], p[:, 3]
    _, h = fit_box(p3, grid)
    sigma = SIGMA_CELLS * h
    rcut = float(RCUT_SIGMAS * sigma)
    acc_sr, _ = short_range(p3, mass, float(softening) ** 2, rcut, sigma)
    return long_range(p3, mass, grid, smoothed_green,
                      optimal_influence(grid, p3.device, p3.dtype)) + acc_sr


def accel(pos, config: dict, *, precision: str = "fp64", rows=None):
    """The solver's entry point: the (N, 3) accelerations of the (N, 4)
    state under `config` (its rows `rows` when given: the cell lists and
    the mesh need every body, so the whole force is worked out)."""
    a = force(pos, config["params"]["softening"], grid=config["pm_grid"],
              precision=precision)
    return a if rows is None else a[rows]


def near_pairs(pos, *, grid: int) -> int:
    """Ordered body pairs (i != j) within the solver's rcut of the state."""
    p3 = pos[:, :3].to(torch.float32)
    _, h = fit_box(p3, grid)
    rcut = float(RCUT_SIGMAS * SIGMA_CELLS * h)
    return short_range(p3, pos[:, 3].to(torch.float32), 0.0, rcut, None, forces=False)[1]
