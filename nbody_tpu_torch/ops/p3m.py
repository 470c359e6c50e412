"""P3M (particle-particle particle-mesh): near-exact forces at mesh speed.

Counterpart of ``nbody_tpu/ops/p3m.py`` with CIC assignment and the
optimal-influence long range, on one device, in float32. The softened
Plummer force splits into a smooth long-range part solved on the PM mesh
and an exact short-range correction summed over neighbours only:

  long-range:  the PM pipeline (``ops/pm.py``) with the Gaussian-smoothed
               kernel erf(r / sqrt(2) sigma) / r, sigma = SIGMA_CELLS mesh
               cells, in plain PyTorch (deposit, FFT solve, gather);
  short-range: s_sr(r) = (r^2 + eps^2)^{-3/2} - s_lr(r), with s_lr the
               degree-10 polynomial _SLR_POLY of the reference's pair kernel
               (``nbody_tpu/ops/p3m_kernel.py:65``), truncated at
               r_cut = RCUT_SIGMAS sigma. On a CUDA tensor it runs the
               hand-written pair kernel ``csrc/p3m_kernels.cu`` over the
               tables built here (``pair_tables``); on the CPU its plain
               version, ``reference.p3m_short_range``.

The capacity contract is the reference's: bodies sort stably into
rcut-sized cells by (cell, massless last); a cell keeps its first
``capacity`` bodies, the rest drop out of the short-range sums and get a
short-range force of 0, and ``p3m_accel`` returns how many MASSIVE bodies
were dropped (the overflow), which callers treat as a failed assertion.

There is no pair budget. The TPU kernel walks a flat, prefetched list of
(blk, blk) block pairs, because a Pallas grid needs static block indices,
and pairs beyond its budget are dropped (``p3m_kernel.py:25-29``). Here one
thread block takes one (cell, i-subtile) entry and loops over the
neighbour cells' j-blocks itself, so every pair of kept bodies is summed
whatever the state: the contract of the reference's own off-TPU engine
(``p3m_short_range="xla"``), which has no budget either. There is no
``p3m_pair_count`` and no budget breach; the only contract is capacity.

Not ported yet (ROADMAP.md Queue 1 #16): plain PM, TSC assignment, the
naive deconvolution, ``refresh_p3m_contract`` / auto refresh, the XLA
cell-list engine and the sharded forms.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.ops.pm import (
    _cic_indices_weights,
    _deposit,
    _fit_box,
    _gather,
    _solve_force_grids,
)

# Gaussian split scale, in PM-mesh cells, and the short-range truncation
# radius, in sigmas (the reference's values, nbody_tpu/ops/p3m.py:59-60)
SIGMA_CELLS = 1.5
RCUT_SIGMAS = 4.0

# s_lr(r2) = f(y) / (sqrt2 sigma)^3 with y = r2 / (2 sigma^2): f is smooth on
# the masked domain y in [0, 8], so the pair sum evaluates it as this
# degree-10 polynomial, coefficients lowest order first (a copy of
# nbody_tpu/ops/p3m_kernel.py::_SLR_POLY; |abs err| <= 7e-6 against f(0)=0.752)
_SLR_POLY = (
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

# CIC's per-axis Fourier window is sinc^2
_CIC_WINDOW_EXP = 2


def p3m_kernel_blk(capacity: int) -> int:
    """Rows of a cell block of the padded layout, and threads of a pair
    kernel block: the reference's compile-time ladder
    (``nbody_tpu/ops/p3m_kernel.py:104``), so the padded layout is the same;
    a tile tuned for the card comes with the port's tuner (ROADMAP.md Queue
    1 #12)."""
    if capacity > 4096:
        return 512
    return 256 if capacity > 192 else 128


def soft2_f32(softening) -> float:
    """softening^2 rounded as the float32 product f32(eps) * f32(eps), the
    reference's ``jnp.asarray(softening, f32) ** 2``."""
    eps = np.float32(softening)
    return float(eps * eps)


def _cell_rcut(h):
    """Short-range cell edge, ONE formula everywhere (probes and engines
    must bin identically; 6*h and 4*(1.5*h) differ in the last ulp)."""
    return RCUT_SIGMAS * (SIGMA_CELLS * h)


def _cell_grid_size(grid: int) -> int:
    """Short-range cells per axis: rcut is a fixed multiple of the mesh
    cell h, so this is static."""
    return max(1, math.ceil(grid / (RCUT_SIGMAS * SIGMA_CELLS)))


def _bin_cells(pos3, lo, rcut, gc: int):
    """Per-body short-range cell ids (int64) on the gc^3 lattice (clipped):
    floor((pos3 - lo) / rcut), a division as in the reference."""
    ci = torch.floor((pos3 - lo[None, :]) / rcut).clamp(0, gc - 1).to(torch.int64)
    return (ci[:, 0] * gc + ci[:, 1]) * gc + ci[:, 2]


def _neighbor_stencil(gc: int, device=None):
    """The static 27-stencil over the cell grid: (nid, nvalid), each
    (ncell, 27), neighbours in (dx, dy, dz) order with dz fastest;
    out-of-lattice neighbours are flagged invalid (and given id 0)."""
    ncell = gc * gc * gc
    cc = torch.arange(ncell, dtype=torch.int64, device=device)
    cx, cy, cz = cc // (gc * gc), (cc // gc) % gc, cc % gc
    offs = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)], dtype=torch.int64, device=device)
    nx = cx[:, None] + offs[None, :, 0]
    ny = cy[:, None] + offs[None, :, 1]
    nz = cz[:, None] + offs[None, :, 2]
    nvalid = ((nx >= 0) & (nx < gc) & (ny >= 0) & (ny < gc)
              & (nz >= 0) & (nz < gc))
    return torch.where(nvalid, (nx * gc + ny) * gc + nz, 0), nvalid


def _cells(pos, grid: int):
    """(pos3, mass, lo, h, rcut, gc, cell ids) of an (N, 4) state."""
    pos3 = pos[:, :3].to(torch.float32)
    mass = pos[:, 3].to(torch.float32)
    lo, h = _fit_box(pos3, grid)
    rcut = _cell_rcut(h)
    gc = _cell_grid_size(grid)
    return pos3, mass, lo, h, rcut, gc, _bin_cells(pos3, lo, rcut, gc)


def _massive_occupancy(pos, grid: int):
    """Per-cell count of MASSIVE bodies (zero-mass padding is inert)."""
    *_, gc, cell = _cells(pos, grid)
    massive = (pos[:, 3] > 0).to(torch.int32)
    # integer sums: the same counts in any order
    return torch.zeros(gc ** 3, dtype=torch.int32, device=pos.device).index_add_(0, cell, massive)


def p3m_max_occupancy(pos, *, grid: int = 64):
    """Largest number of MASSIVE bodies in any short-range cell, a 0-d
    tensor on pos's device: what capacity auto-sizing needs."""
    return _massive_occupancy(pos, grid).amax()


def p3m_overflow_count(pos, *, grid: int = 64, capacity: int = 128):
    """How many MASSIVE bodies exceed their cell's capacity, a 0-d tensor
    on pos's device: no FFT, no pair math, no host synchronisation."""
    return (_massive_occupancy(pos, grid) - int(capacity)).clamp(min=0).sum()


@dataclasses.dataclass
class PairTables:
    """The cell-aligned padded layout of ``_build_pair_tables``
    (``nbody_tpu/ops/p3m_kernel.py:151``) and the pair kernel's entries.

    ``padded`` (M + blk, 4): each cell's kept bodies start at a block
    boundary (block ``ablk[c]``, ``tpc[c]`` blocks), inert rows (1e30,
    1e30, 1e30, 0) in between and after, M = blk * (ncell + ceil(N/blk)).
    ``e_cell`` / ``e_t`` (L,), L = ncell + ceil(N/blk): entry e is i-block
    ``e_t[e]`` of cell ``e_cell[e]``, or inert (``e_cell`` -1) past the live
    ones. ``body_row`` (N,): each body's padded row, M + blk if dropped.
    ``meta`` (4,) on the device: eps^2, rcut^2, 1/(2 sigma^2), 1/(sqrt2
    sigma)^3. ``overflow``: dropped massive bodies, a 0-d tensor."""

    padded: torch.Tensor
    ablk: torch.Tensor
    tpc: torch.Tensor
    e_cell: torch.Tensor
    e_t: torch.Tensor
    body_row: torch.Tensor
    meta: torch.Tensor
    overflow: torch.Tensor
    gc: int
    blk: int


def pair_tables(pos, softening, *, grid: int, capacity: int, blk: int) -> PairTables:
    """Bin, sort and lay out the state for the short-range pair kernel, in
    torch ops on pos's device with no host synchronisation. The sort is
    stable by (cell, massless last), as the reference's ``jnp.argsort``, so
    a full cell drops the same bodies."""
    n = pos.shape[0]
    dev = pos.device
    pos3, mass, lo, h, rcut, gc, cell = _cells(pos, grid)
    ncell = gc ** 3
    massive = mass > 0

    order = torch.argsort(cell * 2 + (~massive).to(torch.int64), stable=True)
    sorted_cell = cell[order]
    bounds = torch.searchsorted(sorted_cell, torch.arange(ncell + 1, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    rank = torch.arange(n, device=dev) - starts[sorted_cell]
    overflow = ((rank >= capacity) & massive[order]).sum()

    tpc = (counts.clamp(max=capacity) + blk - 1) // blk     # blocks per cell
    cum = torch.cumsum(tpc, 0)                               # inclusive
    ablk = cum - tpc                                         # first block
    mb_bound = ncell + -(-n // blk)                          # static block bound
    m_pad = mb_bound * blk

    kept = rank < capacity
    body_row_sorted = torch.where(kept, ablk[sorted_cell] * blk + rank, m_pad + blk)
    padded = torch.zeros((m_pad + blk, 4), dtype=torch.float32, device=dev)
    padded[:, :3] = 1e30
    rows = torch.cat([pos3[order], mass[order][:, None]], dim=1)
    # dropped bodies write the inert row into the last (inert) block
    padded[body_row_sorted.clamp(max=m_pad + blk - 1)] = torch.where(
        kept[:, None], rows, padded[-1])
    body_row = torch.empty_like(body_row_sorted)
    body_row[order] = body_row_sorted

    slot = torch.arange(mb_bound, device=dev)
    e_cell = torch.searchsorted(cum, slot, right=True).clamp(max=ncell - 1)
    e_t = slot - ablk[e_cell]
    e_cell = torch.where(slot < cum[-1], e_cell, -1)

    sigma = SIGMA_CELLS * h
    sq2s = math.sqrt(2.0) * sigma
    # a fill, not a copy from the host: no synchronisation
    meta = torch.stack([h.new_full((), soft2_f32(softening)), rcut * rcut,
                        1.0 / (2.0 * sigma * sigma), 1.0 / (sq2s * sq2s * sq2s)])
    i32 = torch.int32
    return PairTables(padded=padded, ablk=ablk.to(i32), tpc=tpc.to(i32),
                      e_cell=e_cell.to(i32), e_t=e_t.to(i32), body_row=body_row,
                      meta=meta, overflow=overflow, gc=gc, blk=blk)


def pair_work(tables: PairTables) -> dict:
    """What the short-range sum over these tables amounts to, as ints, for
    reports and the pair kernel's bound (synchronises with the device):

      * ``entries``: the pair kernel's thread blocks that do work;
      * ``tiles``: the (blk, blk) block pairs they sum, the reference's
        ``p3m_pair_count``; the kernel visits tiles * blk^2 row pairs;
      * ``candidates``: pairs of kept bodies in neighbouring cells, what a
        cell list must look at (self pairs included);
      * ``near``: those with r^2 < rcut^2, the pairs whose force term a
        cell list must compute (r^2 rounded as the kernel rounds it).
    """
    nid, nvalid = _neighbor_stencil(tables.gc, tables.tpc.device)
    tpc = tables.tpc.to(torch.int64)
    padded, blk = tables.padded, tables.blk
    # a cell's kept bodies are the first rows of its blocks; inert rows are
    # at 1e30
    real = (padded[:, 0] < 1e29).to(torch.int64)
    first = tables.ablk.to(torch.int64) * blk
    csum = torch.cat([real.new_zeros(1), torch.cumsum(real, 0)])
    kept = csum[first + tpc * blk] - csum[first]
    nkept = torch.where(nvalid, kept[nid], 0).sum(dim=1)
    out = {"entries": int((tables.e_cell >= 0).sum()),
           "tiles": int((tpc * torch.where(nvalid, tpc[nid], 0).sum(dim=1)).sum()),
           "candidates": int((kept * nkept).sum())}
    rcut2 = tables.meta[1]
    near = torch.zeros((), dtype=torch.int64, device=padded.device)
    chunk = 1 << 26
    for c in torch.nonzero(kept).flatten().tolist():
        ri = padded[first[c]:first[c] + kept[c], :3]
        rj = torch.cat([padded[first[n]:first[n] + kept[n], :3]
                        for n, ok in zip(nid[c].tolist(), nvalid[c].tolist()) if ok])
        step = max(1, chunk // max(1, rj.shape[0]))
        for i0 in range(0, ri.shape[0], step):
            d = rj[None, :, :] - ri[i0:i0 + step, None, :]
            r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            near += (r2 < rcut2).sum()
    out["near"] = int(near)
    return out


def short_range_from_tables(acc_pad, tables: PairTables):
    """(N, 3) short-range forces in body order from the padded rows the
    pair kernel wrote; dropped bodies get 0 (``p3m_kernel.py:396-401``)."""
    rows = acc_pad.shape[0]
    kept = tables.body_row < rows
    return torch.where(kept[:, None], acc_pad[tables.body_row.clamp(max=rows - 1), :3], 0.0)


def _check_options(assignment: str, influence: str) -> None:
    if assignment == "cic" and influence == "optimal":
        return
    from nbody_tpu_torch.models.body_system import not_ported

    if assignment != "cic":
        raise not_ported("assignment", assignment, key="pm")
    raise not_ported("influence", influence, key="pm")


def p3m_long_range(pos, *, grid: int = 64):
    """(N, 3) long-range accelerations: CIC deposit, the smoothed-kernel
    solve with the optimal-influence correction, CIC gather."""
    pos3 = pos[:, :3].to(torch.float32)
    mass = pos[:, 3].to(torch.float32)
    lo, h = _fit_box(pos3, grid)
    sigma = SIGMA_CELLS * h
    idx, w = _cic_indices_weights(pos3, lo, h, grid)
    rho = _deposit(idx, w, mass, grid)
    grids = _solve_force_grids(rho, h, grid, sigma, window_exp=_CIC_WINDOW_EXP,
                               sigma_cells=SIGMA_CELLS)
    return _gather(grids, idx, w)


def p3m_accel(pos, softening, *, grid: int = 64, capacity: int = 128,
              blk: int | None = None, backend: str = "auto",
              assignment: str = "cic", influence: str = "optimal"):
    """(N, 4) [x,y,z,m] -> ((N, 3) accelerations, overflow count, a 0-d
    tensor on pos's device).

    Equals the softened all-pairs Plummer force up to the mesh error of the
    smooth field (sub-percent). A nonzero overflow means some short-range
    pairs were dropped. ``backend="cuda"`` runs the short range on the pair
    kernel (``cuda_kernel.p3m_short_range_cuda``; the plain version for a
    CPU tensor), ``"torch"`` on the plain version on any device, ``"auto"``
    the kernel on a CUDA tensor. ``blk`` defaults to
    ``p3m_kernel_blk(capacity)``."""
    if pos.shape[-1] != 4:
        raise ValueError("p3m_accel expects (N, 4) [x,y,z,m]")
    _check_options(assignment, influence)
    if backend == "auto":
        backend = "cuda" if pos.device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    acc_lr = p3m_long_range(pos, grid=grid)
    if backend == "cuda":
        acc_sr, overflow = cuda_kernel.p3m_short_range_cuda(
            pos, softening, grid=grid, capacity=capacity, blk=blk)
    else:
        acc_sr = reference.p3m_short_range(pos, softening, grid=grid, capacity=capacity)
        overflow = p3m_overflow_count(pos, grid=grid, capacity=capacity)
    return acc_lr + acc_sr, overflow


def nbody_step_p3m(pos, vel, dt, softening, damping, *, grid: int = 64,
                   capacity: int = 128, blk: int | None = None, backend: str = "auto"):
    """P3M step with the reference's damped semi-implicit Euler update;
    returns (pos, vel, overflow)."""
    a, overflow = p3m_accel(pos, softening, grid=grid, capacity=capacity, blk=blk,
                            backend=backend)
    new_pos, new_vel = reference.integrate(pos, vel, a, dt, damping)
    return new_pos, new_vel, overflow
