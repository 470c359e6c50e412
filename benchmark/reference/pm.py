"""The plain PM reference: the force that the configuration's plain
particle-mesh solver defines, worked out again from the state in float64
(Hockney and Eastwood, Computer Simulation Using Particles, 1988: the
isolated-boundary PM method):

  box      the particle-fitting box: cell h = span / (G - 4), centred, so
           two empty cells of margin lie on each side of the bodies;
  deposit  CIC assignment of the masses on the G^3 mesh;
  solve    the isolated Poisson solve on the zero-padded (2G)^3 mesh with
           the raw Green's function 1/r (K(0) = 0) and no influence
           correction (the solver's default, ``influence="none"``);
  force    the gradient by i k with the Nyquist bins zeroed, then CIC
           interpolation back to the bodies.

No softening enters: the cell is the solver's smoothing scale. The box, the
deposit, the padded solve and the gather are shared with the P3M reference
(``p3m.py``), which passes its own Green's function and influence. Nothing
of the program under test is imported, and nothing it made is read.

``precision="fp64"`` is the reference; ``"tf32"`` the control: float32
throughout, with the positions and masses rounded to TF32 at the start.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.allpairs import round_tf32


def typed(pos, precision: str):
    """The (N, 4) state in the reference's type: float64, or float32 with
    every element rounded to TF32 (the control)."""
    if precision == "fp64":
        return pos.to(torch.float64)
    if precision == "tf32":
        return round_tf32(pos)
    raise ValueError(f"unknown precision {precision!r}")


def fit_box(p3, grid: int):
    """(lo corner (3,), cell size h) of the particle-fitting box: two empty
    cells of margin on each side of the bodies' span."""
    lo_raw, hi_raw = p3.amin(0), p3.amax(0)
    h = (hi_raw - lo_raw).amax() / (grid - 4) + 1e-30
    return (lo_raw + hi_raw) / 2 - h * grid / 2, h


def cic(p3, lo, h, grid: int):
    """The 8 CIC stencil points of each body: (flat indices (8, N) on the
    G^3 mesh, trilinear weights (8, N))."""
    rel = (p3 - lo) / h
    base = torch.floor(rel)
    frac = rel - base
    base = base.to(torch.int64)
    idx, w = [], []
    for corner in range(8):
        off = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
        flat = 0
        weight = 1.0
        for axis in range(3):
            i = (base[:, axis] + off[axis]).clamp(0, grid - 1)
            flat = flat * grid + i
            f = frac[:, axis]
            weight = weight * (f if off[axis] else 1.0 - f)
        idx.append(flat)
        w.append(weight)
    return torch.stack(idx), torch.stack(w)


def long_range(p3, mass, grid: int, green, influence=None):
    """(N, 3) mesh accelerations of bodies at p3 with masses `mass`: the box,
    the CIC deposit, the isolated solve with the Green's function
    `green(r2, r, h)` (its values at the padded mesh's squared distances
    r2 and distances r, h the cell) times the half-spectrum factor
    `influence` (None: none), the gradient, the CIC gather."""
    dev, dt = p3.device, p3.dtype
    lo, h = fit_box(p3, grid)
    idx, w = cic(p3, lo, h, grid)
    rho = torch.zeros(grid ** 3, dtype=dt, device=dev).index_add_(
        0, idx.reshape(-1), (w * mass[None, :]).reshape(-1))
    gp = 2 * grid
    rho_p = torch.zeros((gp, gp, gp), dtype=dt, device=dev)
    rho_p[:grid, :grid, :grid] = rho.reshape(grid, grid, grid)
    n = torch.arange(gp, device=dev)
    d1 = torch.minimum(n, gp - n).to(dt) * h
    r2 = d1[:, None, None] ** 2 + d1[None, :, None] ** 2 + d1[None, None, :] ** 2
    r = r2.clamp(min=1e-300).sqrt()
    conv_k = torch.fft.rfftn(rho_p) * torch.fft.rfftn(green(r2, r, h))
    if influence is not None:
        conv_k = conv_k * influence
    k1 = 2.0 * math.pi * torch.fft.fftfreq(gp, device=dev, dtype=dt) / h
    kz = 2.0 * math.pi * torch.fft.rfftfreq(gp, device=dev, dtype=dt) / h
    k1[gp // 2] = 0.0
    kz[gp // 2] = 0.0
    kvs = (k1[:, None, None], k1[None, :, None], kz[None, None, :])
    out = []
    for kv in kvs:
        g = torch.fft.irfftn(conv_k * (1j * kv), s=(gp, gp, gp))[:grid, :grid, :grid]
        out.append((g.reshape(-1)[idx] * w).sum(0))
    return torch.stack(out, 1)


def newton(r2, r, h):
    """The raw open-space Green's function 1/r, 0 at r = 0."""
    return torch.where(r2 > 0, 1.0 / r, 0.0)


def force(pos, *, grid: int, precision: str = "fp64"):
    """(N, 3) plain-PM accelerations of the (N, 4) state `pos`."""
    p = typed(pos, precision)
    return long_range(p[:, :3], p[:, 3], grid, newton)


def accel(pos, config: dict, *, precision: str = "fp64", rows=None):
    """The solver's entry point: the (N, 3) accelerations of the (N, 4)
    state under `config` (its rows `rows` when given: the mesh needs every
    body, so the whole force is worked out)."""
    if config.get("pm_assignment", "cic") != "cic" or config.get("pm_influence",
                                                                "none") != "none":
        raise ValueError("the PM reference is CIC with no influence correction")
    a = force(pos, grid=config["pm_grid"], precision=precision)
    return a if rows is None else a[rows]
