"""P3M (particle-particle particle-mesh): near-exact forces at mesh speed.

Counterpart of ``nbody_tpu/ops/p3m.py``, in float32, on one device or a
1-D mesh (``make_sharded_p3m_step``). The softened Plummer force splits
into a smooth long-range part solved on the PM mesh and an exact
short-range correction summed over neighbours only:

  long-range:  the PM pipeline (``ops/pm.py``) with the Gaussian-smoothed
               kernel erf(r / sqrt(2) sigma) / r, sigma = SIGMA_CELLS mesh
               cells, CIC or TSC assignment, the optimal or the naive
               influence, in plain PyTorch (deposit, FFT solve, gather);
  short-range: s_sr(r) = (r^2 + eps^2)^{-3/2} - s_lr(r), with s_lr the
               degree-10 polynomial _SLR_POLY of the reference's pair kernel
               (``nbody_tpu/ops/p3m_kernel.py:65``), truncated at
               r_cut = RCUT_SIGMAS sigma. On a CUDA tensor it runs the
               hand-written pair kernel ``csrc/p3m_kernels.cu`` over the
               tables built here (``pair_tables``); on the CPU its plain
               version, ``reference.p3m_short_range``. ``short_range="xla"``
               runs the reference's sorted cell-list engine instead
               (``cell_list_short_range``, below), with s_lr in its closed
               form and Taylor series (``_s_lr``).

The capacity contract is the reference's: bodies sort stably into
rcut-sized cells by (cell, massless last); a cell keeps its first
``capacity`` bodies, the rest drop out of the short-range sums and get a
short-range force of 0, and ``p3m_accel`` returns how many MASSIVE bodies
were dropped (the overflow), which callers treat as a failed assertion.

There is no pair budget. The TPU kernel walks a flat, prefetched list of
(blk, blk) block pairs, because a Pallas grid needs static block indices,
and pairs beyond its budget are dropped (``p3m_kernel.py:25-29``). Here
``pair_tables`` orders each cell's kept bodies by sub-cell, pads the cell
to whole clusters of 32 rows with a bounding box each, and cuts each
i-cluster's j-clusters (those of its 27 neighbour cells) into work items of
bounded length; the kernel skips a j-cluster or j-row only where every pair
it would sum has r^2 >= rcut^2, so every pair of kept bodies within rcut is
summed whatever the state: the contract of the reference's own off-TPU
engine (``short_range="xla"``), which has no budget either. There is no
``p3m_pair_count`` and no budget breach; the only contract is capacity.

The cell-list engine (``short_range="xla"``, ``nbody_tpu/ops/p3m.py:
153-348``) is XLA in the reference, not Pallas, so its port is plain
PyTorch on any device: the bodies sort into rcut-cells (massive first), a
worklist of i-subtiles of at most 128 rows a cell is classed by the largest
of its 27 neighbour occupancies (powers of two up to the capacity), and
each class runs in batches of dense (rows, 27 * class) tiles. The class
bounds are read on the host once a force call (``HOST_READS["p3m_xla"]``),
and each live sorted row is written by the one entry that holds it, so the
force has the same bits on every run.

On a mesh (``make_sharded_p3m_step``, the reference's ``short_range=
"pallas"`` decomposition) the long range is the sharded PM's (replicated or
slab, ``pm.long_range``). For the short range every rank all-gathers
the positions and builds the tables of the whole state, as every TPU chip
does; it then runs the pair kernel over its own contiguous range of
i-clusters, cut at cluster boundaries so that the ranks' work items balance
(``item_range``), and ``parallel.sharded.ring_reduce_scatter`` brings the
rows to their owners. A padded row's items all run on one rank and are
totalled in item order, so every rank's rows equal the one-device launch's
bit for bit. With ``short_range="xla"`` every rank builds the cell tables of
the whole state and runs the cells d, d + D, d + 2D, ... (the reference's
round robin); its partial, unsorted to body order, reaches the owners by
the same reduce-scatter.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.utils.profiling import annotate
from nbody_tpu_torch.ops.pm import (
    DECONVOLVE,
    ShardedMeshStep,
    _fit_box,
    check_assignment,
    check_slab,
    long_range,
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

def p3m_kernel_blk(capacity: int) -> int:
    """Threads of a pair kernel block (blk / 32 warps, each computing its
    own work items), the ``blk`` keyword's default: the port's tuner's
    winner for this capacity bucket on this card (``nbody-tune-torch
    --family p3m``), else the reference's compile-time ladder of its block
    rows (``nbody_tpu/ops/p3m_kernel.py:104``). The layout no longer
    depends on it (cells pad to 32 rows)."""
    tuned = _tuned_blk(int(capacity))
    if tuned is not None:
        return tuned
    if capacity > 4096:
        return 512
    return 256 if capacity > 192 else 128


@functools.lru_cache(maxsize=64)
def _tuned_blk(capacity: int):
    """The tuner's cached blk for `capacity`, or None; memoized (the cache
    is a file), cleared by ``tune.autotune(save=True)``."""
    from nbody_tpu_torch import tune

    winner = tune.best_config(capacity, family="p3m")
    return int(winner["blk"]) if winner and "blk" in winner else None


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
    # the offsets made on the device: no copy from the host
    s = torch.arange(27, dtype=torch.int64, device=device)
    nx = cx[:, None] + (s // 9 - 1)[None, :]
    ny = cy[:, None] + ((s // 3) % 3 - 1)[None, :]
    nz = cz[:, None] + (s % 3 - 1)[None, :]
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


# Rows of a cluster of the pair kernel's layout: the lanes of a warp (CL in
# csrc/p3m_kernels.cu)
CLUSTER = 32
# a cell's kept bodies are ordered by the Morton code of their sub-cell on a
# (2^SUB_BITS)^3 lattice inside the cell (_sub_cell_key spreads 4 bits)
SUB_BITS = 4
# the j-range of an i-cluster is cut into work items of at least CHUNK_MIN
# j-clusters, and of as many more as keep the items within
# ITEMS_PER_CLUSTER * ceil(N / CLUSTER) beyond one an i-cluster
CHUNK_MIN = 32
ITEMS_PER_CLUSTER = 4


@dataclasses.dataclass
class PairTables:
    """The pair kernel's layout (``csrc/p3m_kernels.cu``) and its work items.

    ``padded`` (R, 4), R = CLUSTER * nclb with nclb = ceil(N / CLUSTER) +
    ncell + 1, a static bound on the clusters whose last one is always
    inert: the ``nkept[c]`` kept bodies of cell c, in sub-cell Morton order,
    fill clusters ``cfirst[c]`` .. ``cfirst[c] + ncl[c] - 1``; inert rows
    (1e30, 1e30, 1e30, 0) elsewhere. ``box`` (nclb, 8): each cluster's (lo,
    0, hi, 0) over its real rows. ``cl_cell`` (nclb,): each cluster's cell,
    -1 past the live ones; ``cl_item0`` / ``cl_nitem`` its first work item
    and its item count. ``it_cl`` / ``it_k0`` / ``it_k1`` (items,): item w is
    i-cluster ``it_cl[w]`` (-1 past the live items, which come first)
    against j-clusters [k0, k1) of its 27 neighbour cells, numbered in
    stencil order; ``chunk`` (0-d) the longest j-range of an item.
    ``body_row`` (N,): each body's padded row, R if dropped. ``meta`` (4,) on
    the device: eps^2, rcut^2, 1/(2 sigma^2), 1/(sqrt2 sigma)^3.
    ``overflow``: dropped massive bodies, a 0-d tensor. ``blk``: the pair
    kernel's threads a block."""

    padded: torch.Tensor
    box: torch.Tensor
    cfirst: torch.Tensor
    ncl: torch.Tensor
    nkept: torch.Tensor
    cl_cell: torch.Tensor
    cl_item0: torch.Tensor
    cl_nitem: torch.Tensor
    it_cl: torch.Tensor
    it_k0: torch.Tensor
    it_k1: torch.Tensor
    chunk: torch.Tensor
    body_row: torch.Tensor
    meta: torch.Tensor
    overflow: torch.Tensor
    gc: int
    blk: int


def _sub_cell_key(pos3, lo, rcut, gc: int):
    """The Morton code of each body's sub-cell on the 16^3 lattice
    (SUB_BITS = 4) inside its (clipped) rcut-cell: an order of a cell's
    bodies in which consecutive ones lie close. Each coordinate's 4 bits
    spread to every third bit by two shift-or-mask steps, a few device ops
    for all three axes at once."""
    t = (pos3 - lo[None, :]) / rcut
    side = 1 << SUB_BITS
    sub = torch.floor((t - torch.floor(t).clamp(0, gc - 1)) * side).clamp(0, side - 1)
    sub = sub.to(torch.int64)
    sub = (sub | (sub << 4)) & 0x0C3  # bits 0, 1 stay; bits 2, 3 go to 6, 7
    sub = (sub | (sub << 2)) & 0x249  # bits 0, 1, 6, 7 go to 0, 3, 6, 9
    return (sub[:, 0] << 2) | (sub[:, 1] << 1) | sub[:, 2]


def _cell_order(cell, massive, ncell: int, cap: int):
    """The reference's stable sort of the bodies by (cell, massless last)
    (``nbody_tpu/ops/p3m.py:179-188``): (order, sorted_cell, starts,
    counts, kept, overflow). ``kept`` (in the sorted frame) marks the first
    `cap` bodies of each cell; ``overflow`` (0-d) counts the MASSIVE bodies
    beyond them. Integers are int64, on the device, with no host
    synchronisation."""
    dev = cell.device
    order = torch.argsort(cell * 2 + (~massive).to(torch.int64), stable=True)
    sorted_cell = cell[order]
    bounds = torch.searchsorted(sorted_cell, torch.arange(ncell + 1, device=dev))
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    kept = torch.arange(cell.shape[0], device=dev) - starts[sorted_cell] < cap
    return order, sorted_cell, starts, counts, kept, (~kept & massive[order]).sum()


def pair_tables(pos, softening, *, grid: int, capacity: int, blk: int) -> PairTables:
    """Bin, sort and lay out the state for the short-range pair kernel and
    cut its work into items, in torch ops on pos's device with no host
    synchronisation. Which bodies a cell keeps follows the reference's
    stable (cell, massless last) order, so a full cell drops the same
    bodies; the kept ones are then ordered inside their cell by sub-cell."""
    with annotate("nbody.p3m.tables"):
        n = pos.shape[0]
        dev = pos.device
        i32 = torch.int32
        pos3, mass, lo, h, rcut, gc, cell = _cells(pos, grid)
        ncell = gc ** 3
        order, sorted_cell, _, counts, kept, overflow = _cell_order(cell, mass > 0, ncell, capacity)
        # the kept bodies by (cell, sub-cell), stably; the dropped ones last
        sub = _sub_cell_key(pos3[order], lo, rcut, gc)
        key = torch.where(kept, (sorted_cell << (3 * SUB_BITS)) | sub, ncell << (3 * SUB_BITS))
        again = torch.argsort(key, stable=True)
        order, kept, sorted_cell = order[again], kept[again], sorted_cell[again]

        nkept = counts.clamp(max=capacity)
        ncl = (nkept + CLUSTER - 1) // CLUSTER                   # clusters a cell
        cfirst = torch.cumsum(ncl, 0) - ncl
        kfirst = torch.cumsum(nkept, 0) - nkept
        nclb = -(-n // CLUSTER) + ncell + 1                      # static cluster bound
        rows = nclb * CLUSTER
        rank = torch.arange(n, device=dev) - kfirst[sorted_cell]
        body_row_sorted = torch.where(kept, cfirst[sorted_cell] * CLUSTER + rank, rows)
        # dropped bodies write the inert row into the last (inert) cluster
        dst = body_row_sorted.clamp(max=rows - 1)
        padded = torch.zeros((rows, 4), dtype=torch.float32, device=dev)
        padded[:, :3].fill_(1e30)
        padded[dst] = torch.where(kept[:, None],
                                  torch.cat([pos3[order], mass[order][:, None]], dim=1), padded[-1])
        real = torch.zeros(rows, dtype=torch.bool, device=dev)
        real[dst] = kept
        body_row = torch.empty_like(body_row_sorted)
        body_row[order] = body_row_sorted

        # each cluster's box over its real rows (zero-mass bodies included)
        xyz = padded[:, :3].view(nclb, CLUSTER, 3)
        inside = real.view(nclb, CLUSTER, 1)
        box = torch.zeros((nclb, 8), dtype=torch.float32, device=dev)
        box[:, 0:3] = torch.where(inside, xyz, math.inf).amin(dim=1)
        box[:, 4:7] = torch.where(inside, xyz, -math.inf).amax(dim=1)

        # work items: each live i-cluster's j-clusters (those of its cell's
        # stencil, in stencil order) in chunks; sum_k ceil(J_k / chunk) <=
        # sum_k J_k / chunk + live clusters <= max_items + nclb - 1
        ccum = torch.cumsum(ncl, 0)
        cl = torch.arange(nclb, device=dev)
        live = cl < ccum[-1]
        cl_cell = torch.searchsorted(ccum, cl, right=True).clamp(max=ncell - 1)
        nid, nvalid = _neighbor_stencil(gc, dev)
        jcl = torch.where(nvalid, ncl[nid], 0).sum(dim=1)       # j-clusters of a cell's stencil
        max_items = ITEMS_PER_CLUSTER * max(1, -(-n // CLUSTER))
        chunk = (((ncl * jcl).sum() + max_items - 1) // max_items).clamp(min=CHUNK_MIN)
        jlen = jcl[cl_cell]
        nitem = torch.where(live, (jlen + chunk - 1) // chunk, 0)
        icum = torch.cumsum(nitem, 0)
        item0 = icum - nitem
        slot = torch.arange(max_items + nclb, device=dev)
        it_cl = torch.searchsorted(icum, slot, right=True).clamp(max=nclb - 1)
        alive = slot < icum[-1]
        it_k0 = torch.where(alive, (slot - item0[it_cl]) * chunk, 0)
        it_k1 = torch.where(alive, torch.minimum(it_k0 + chunk, jlen[it_cl]), 0)

        sigma = SIGMA_CELLS * h
        sq2s = math.sqrt(2.0) * sigma
        # a fill, not a copy from the host: no synchronisation
        meta = torch.stack([h.new_full((), soft2_f32(softening)), rcut * rcut,
                            1.0 / (2.0 * sigma * sigma), 1.0 / (sq2s * sq2s * sq2s)])
        return PairTables(
            padded=padded, box=box, cfirst=cfirst.to(i32), ncl=ncl.to(i32), nkept=nkept.to(i32),
            cl_cell=torch.where(live, cl_cell, -1).to(i32), cl_item0=item0.to(i32),
            cl_nitem=nitem.to(i32), it_cl=torch.where(alive, it_cl, -1).to(i32),
            it_k0=it_k0.to(i32), it_k1=it_k1.to(i32), chunk=chunk, body_row=body_row, meta=meta,
            overflow=overflow, gc=gc, blk=blk)


def _box_d2(alo, ahi, blo, bhi):
    """The box distance^2 as the pair kernel computes it: per axis the
    float32 gap max(blo - ahi, alo - bhi, 0), then (x^2 + y^2) + z^2, each
    operation rounded (a lower bound on the rounded r^2 of any pair of
    points of the two boxes; csrc/p3m_kernels.cu)."""
    g = torch.maximum(blo - ahi, alo - bhi).clamp(min=0)
    g2 = g * g
    return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def pair_work(tables: PairTables) -> dict:
    """What the short-range sum over these tables amounts to, as ints, for
    reports and the pair kernel's bound (synchronises with the device):

      * ``clusters`` / ``items``: the live i-clusters and work items;
        ``chunk``: the longest j-range of an item, in j-clusters;
      * ``cluster_pairs``: (i-cluster, j-cluster) pairs of neighbouring
        cells, what the box tests look at; ``boxed``: those the box test
        keeps, whose j-rows the kernel loads (``visited`` = boxed * 32^2
        row pairs);
      * ``tested``: row pairs whose pair test runs, 32 for each (i-cluster,
        j-row) that the box and the row tests keep;
      * ``termed``: row pairs whose warp runs the term, 32 for each
        (i-cluster, j-row) with a pair within rcut;
      * ``candidates``: pairs of kept bodies in neighbouring cells, what a
        cell list must look at (self pairs included);
      * ``near``: those with r^2 < rcut^2, the pairs whose force term the
        function needs (r^2 rounded as the kernel rounds it).

    termed / near is the pruning's efficiency (1: no pair past rcut is
    computed)."""
    cw = CLUSTER
    padded, box = tables.padded, tables.box
    dev = padded.device
    nid, nvalid = _neighbor_stencil(tables.gc, dev)
    ncl = tables.ncl.to(torch.int64)
    nkept = tables.nkept.to(torch.int64)
    out = {"clusters": int(ncl.sum()), "items": int((tables.it_cl >= 0).sum()),
           "chunk": int(tables.chunk),
           "cluster_pairs": int((ncl * torch.where(nvalid, ncl[nid], 0).sum(dim=1)).sum()),
           "candidates": int((nkept * torch.where(nvalid, nkept[nid], 0).sum(dim=1)).sum())}
    rcut2 = tables.meta[1]
    xyz = padded[:, :3]
    counts = torch.zeros(4, dtype=torch.int64, device=dev)  # boxed, tested, termed, near
    cf, nc, nk = tables.cfirst.tolist(), ncl.tolist(), nkept.tolist()
    lane = torch.arange(cw, device=dev)
    for c in (c for c, m in enumerate(nc) if m):
        js = [n for n, ok in zip(nid[c].tolist(), nvalid[c].tolist()) if ok and nc[n]]
        jcl = torch.cat([torch.arange(cf[n], cf[n] + nc[n], device=dev) for n in js])
        jrow = (jcl[:, None] * cw + lane).flatten()
        jreal = torch.cat([torch.arange(nc[n] * cw, device=dev) < nk[n] for n in js])
        jp, jlo, jhi = xyz[jrow], box[jcl, 0:3], box[jcl, 4:7]
        step = max(1, (1 << 25) // (cw * jrow.shape[0]))
        for i0 in range(0, nc[c], step):
            ic = torch.arange(cf[c] + i0, cf[c] + min(nc[c], i0 + step), device=dev)
            ilo, ihi = box[ic, None, 0:3], box[ic, None, 4:7]
            keep = _box_d2(ilo, ihi, jlo[None], jhi[None]) < rcut2
            rowk = (_box_d2(ilo, ihi, jp[None], jp[None]) < rcut2) & keep.repeat_interleave(
                cw, dim=1)
            ireal = (ic[:, None] - cf[c]) * cw + lane < nk[c]
            d = jp[None, None] - xyz[ic[:, None] * cw + lane][:, :, None]
            r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
            near = (r2 < rcut2) & ireal[:, :, None] & jreal
            counts += torch.stack([keep.sum(), rowk.sum() * cw, near.any(dim=1).sum() * cw,
                                   near.sum()])
    boxed, tested, termed, near = counts.tolist()
    out.update(boxed=boxed, visited=boxed * cw * cw, tested=tested, termed=termed, near=near)
    return out


def short_range_from_tables(acc_pad, tables: PairTables):
    """(N, 3) short-range forces in body order from the padded rows the
    pair kernel wrote; dropped bodies get 0 (``p3m_kernel.py:396-401``)."""
    rows = acc_pad.shape[0]
    kept = tables.body_row < rows
    return torch.where(kept[:, None], acc_pad[tables.body_row.clamp(max=rows - 1), :3], 0.0)


def check_influence(influence: str) -> str:
    if influence not in ("naive", "optimal"):
        raise ValueError(f"unknown influence {influence!r}")
    return influence


def p3m_long_range(pos, *, grid: int = 64, assignment: str = "cic",
                   influence: str = "optimal"):
    """(N, 3) long-range accelerations: the deposit, the smoothed-kernel
    solve with the influence's correction, the gather."""
    return long_range(pos, grid=grid, assignment=assignment, sigma_cells=SIGMA_CELLS,
                      deconvolve=DECONVOLVE[check_influence(influence)])


def check_short_range(short_range: str) -> str:
    """"auto" and "pallas" (the reference's names) run the pair kernel (its
    plain version on the CPU); "xla" the reference's cell-list engine."""
    if short_range not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown short_range {short_range!r}")
    return short_range


# ---- the cell-list engine (short_range="xla"), plain PyTorch ----

# i-rows of a worklist entry, and the smallest j-capacity class
# (nbody_tpu/ops/p3m.py:205, 264)
XLA_I_TILE = 128
XLA_MIN_CLASS = 128
# the reference's batching bound: a class's batch holds about
# chunk * 27 * capacity pair elements in each float32 intermediate
XLA_CHUNK = 2048


def _s_lr(r2, sigma):
    """The long-range force shape s_lr(r), F_lr = m * s_lr * r_vec, in
    float32 as ``nbody_tpu/ops/p3m.py::_s_lr`` computes it: the closed form
    [erf(u) - (2/sqrt(pi)) u exp(-u^2)] / r^3, u = r / (sqrt2 sigma), and
    below u^2 = 0.0625, where the closed form cancels, its Taylor series
    (2/sqrt(pi)) / (sqrt2 sigma)^3 (2/3 - 2u^2/5 + u^4/7); the same clamps
    (1e-30). Not the pair kernel's polynomial ``_SLR_POLY``. Written with
    in-place operations on the (rows, columns) planes, each in the
    reference's order, to hold few of them at once."""
    c = 2.0 / math.sqrt(math.pi)
    sq2s = sigma * math.sqrt(2.0)
    s2 = sq2s * sq2s
    u2 = r2 / s2
    u = u2.clamp(min=1e-30).sqrt_()
    closed = torch.erf(u)
    closed.sub_(u.mul_(c).mul_(torch.exp(-u2)))
    del u
    closed.div_(r2.clamp(min=1e-30).sqrt_().mul_(r2).clamp_(min=1e-30))
    series = (u2 * (2.0 / 5.0)).neg_().add_(2.0 / 3.0)
    series.add_((u2 * (1.0 / 7.0)).mul_(u2)).mul_(c / (s2 * sq2s))
    return torch.where(u2 < 0.0625, series, closed)


def _sorted_cell_tables(pos3, mass, lo, rcut, gc: int, cap: int):
    """Sort the bodies into rcut-cells and build the contiguous range tables
    of the cell-list pass (``nbody_tpu/ops/p3m.py::_sorted_cell_tables``):
    (order, sorted_pos4, starts, counts, n_starts, n_counts, overflow).
    The sort is stable by cell * 2 + massless, so a cell's massive bodies
    come first and its zero-mass padding fills the capacity slots last;
    ``sorted_pos4`` is (N + cap, 4) with cap inert rows (1e30, 1e30, 1e30,
    0) at the end, so a (start, cap) range stays in bounds; ``n_starts`` /
    ``n_counts`` (ncell, 27) hold each neighbour cell's range in stencil
    order, start N and count 0 outside the lattice; ``overflow`` (0-d)
    counts the MASSIVE bodies beyond their cell's cap slots. Integers are
    int64, on pos3's device, with no host synchronisation."""
    n = pos3.shape[0]
    order, _, starts, counts, _, overflow = _cell_order(
        _bin_cells(pos3, lo, rcut, gc), mass > 0, gc ** 3, cap)
    pad = pos3.new_zeros((cap, 4))
    pad[:, :3].fill_(1e30)
    sorted_pos4 = torch.cat([torch.cat([pos3[order], mass[order][:, None]], dim=1), pad])
    nid, nvalid = _neighbor_stencil(gc, pos3.device)
    n_starts = torch.where(nvalid, starts[nid], n)
    n_counts = torch.where(nvalid, counts[nid], 0)
    return order, sorted_pos4, starts, counts, n_starts, n_counts, overflow


def _xla_classes(cap: int) -> list:
    """The j-capacity classes: powers of two from min(128, cap) below cap,
    then cap itself."""
    classes, jc = [], min(XLA_MIN_CLASS, cap)
    while jc < cap:
        classes.append(jc)
        jc *= 2
    return classes + [cap]


def _cell_tiles(sorted_pos4, bs, bc, bnst, bnct, *, jcap: int, cap_s: int, eps2: float,
                sigma, rcut2):
    """The short-range force of a batch of worklist entries, (b, cap_s, 3):
    entry e's rows bs[e] .. bs[e] + cap_s (the first bc[e] live) against the
    first min(bnct[e, k], jcap) rows from bnst[e, k] of its 27 neighbour
    cells, as the reference's ``one_tile`` (nbody_tpu/ops/p3m.py:283-304):
    s = rsqrt(r^2 + eps^2)^3 - s_lr(r^2) where r^2 < rcut^2 (a select: far
    and padding pairs give 0, whatever s_lr is there), each column's mass
    masked past its cell's count, summed over the 27 * jcap columns."""
    dev = sorted_pos4.device
    b = bs.shape[0]
    lane_i = torch.arange(cap_s, device=dev)
    lane_j = torch.arange(jcap, device=dev)
    rows = sorted_pos4[bs[:, None] + lane_i]                       # (b, cap_s, 4)
    cols = sorted_pos4[bnst[:, :, None] + lane_j]                  # (b, 27, jcap, 4)
    mj = torch.where(lane_j < bnct.clamp(max=jcap)[:, :, None], cols[..., 3], 0.0)
    mj = mj.reshape(b, 1, 27 * jcap)
    pj = cols[..., :3].reshape(b, 1, 27 * jcap, 3)
    del cols
    d = [pj[..., k] - rows[:, :, None, k] for k in range(3)]     # (b, cap_s, 27 jcap)
    r2 = d[0] * d[0]
    r2.add_(d[1] * d[1]).add_(d[2] * d[2])
    s = torch.rsqrt(r2 + eps2)
    s = (s * s).mul_(s)
    s = torch.where(r2 < rcut2, s.sub_(_s_lr(r2, sigma)), 0.0)
    del r2
    s.mul_(mj)
    acc = torch.stack([(s * dk).sum(dim=-1) for dk in d], dim=-1)
    ivalid = lane_i < bc.clamp(max=cap_s)[:, None]
    return torch.where(ivalid[..., None], acc, 0.0)


def _short_range_cells(sorted_pos4, starts, counts, n_starts, n_counts, *, eps2: float,
                       sigma, rcut, cap: int, chunk: int, n: int, i_tile: int = XLA_I_TILE):
    """The cell-list pass over the given per-cell range tables
    (``nbody_tpu/ops/p3m.py::_short_range_cells``): (n, 3) forces in the
    SORTED frame, rows of cells outside the tables zero. The tables may
    cover any number of cells (all of them, or a rank's round robin, padded
    cells inert: start n, count 0).

    The worklist has one entry for each i-subtile of at most cap_s =
    min(i_tile, cap) of a cell's first min(count, cap) rows, static length
    L = ncl + ceil(n / cap_s) with the live entries first. Each entry is
    classed by the largest of its 27 neighbour occupancies (``_xla_classes``);
    the entries sort stably by class, and a class of width jcap runs in
    batches of b = max(1, min(L, chunk * cap // (cap_s * jcap))) entries
    (``_cell_tiles``). The reference's ``fori_loop`` runs a data-dependent
    number of batches a class; here the len(classes) + 1 class bounds are
    read on the host once a call (``timing.host_read(..., "p3m_xla")``, the
    call's one synchronisation), and a class's last batch holds only its
    remaining entries. Each live sorted row belongs to exactly one entry,
    so the batches write rows (``index_copy_``), never sum them: a lane past
    its entry's rows writes a scratch row of its own past row n, which is
    cut off. So a call's bits do not depend on the order of the writes."""
    from nbody_tpu_torch.utils import timing

    dev = sorted_pos4.device
    cap_s = min(i_tile, cap)
    ncl = starts.shape[0]
    rows_c = counts.clamp(max=cap)
    t_c = (rows_c + cap_s - 1) // cap_s                     # subtiles a cell
    big_l = ncl + -(-n // cap_s)                            # static bound on sum(t_c)
    cum = torch.cumsum(t_c, 0)                              # inclusive
    slot = torch.arange(big_l, device=dev)
    cell = torch.searchsorted(cum, slot, right=True).clamp(0, ncl - 1)
    t_within = slot - (cum[cell] - t_c[cell])
    live = slot < cum[-1]
    e_start = torch.where(live, starts[cell] + t_within * cap_s, n)
    e_count = torch.where(live, rows_c[cell] - t_within * cap_s, 0)
    e_nst = torch.where(live[:, None], n_starts[cell], n)
    e_nct = torch.where(live[:, None], n_counts[cell], 0)

    classes = _xla_classes(cap)
    jmax = e_nct.clamp(max=cap).amax(dim=1)
    # searchsorted(classes, jmax, side="left"): the classes below jmax
    ecls = sum((jmax > jc).to(torch.int64) for jc in classes)
    ecls = torch.where(live, ecls, len(classes))            # inert entries last
    eorder = torch.argsort(ecls, stable=True)
    e_start, e_count = e_start[eorder], e_count[eorder]
    e_nst, e_nct = e_nst[eorder], e_nct[eorder]
    bounds = torch.searchsorted(ecls[eorder], torch.arange(len(classes) + 1, device=dev))
    bounds = timing.host_read(bounds, "p3m_xla")

    b_of = {jc: max(1, min(big_l, (chunk * cap) // (cap_s * jc))) for jc in classes}
    lane_i = torch.arange(cap_s, device=dev)
    scratch = n + lane_i                                    # + an entry's cap_s * index
    buf = torch.zeros((n + max(b_of.values()) * cap_s, 3), dtype=torch.float32, device=dev)
    for k, jcap in enumerate(classes):
        b = b_of[jcap]
        for o in range(bounds[k], bounds[k + 1], b):
            sl = slice(o, min(o + b, bounds[k + 1]))
            bs, bc = e_start[sl], e_count[sl]
            acc = _cell_tiles(sorted_pos4, bs, bc, e_nst[sl], e_nct[sl], jcap=jcap,
                              cap_s=cap_s, eps2=eps2, sigma=sigma, rcut2=rcut * rcut)
            within = lane_i < bc.clamp(max=cap_s)[:, None]
            dest = torch.where(within, bs[:, None] + lane_i,
                               scratch + cap_s * torch.arange(bs.shape[0], device=dev)[:, None])
            buf.index_copy_(0, dest.reshape(-1), acc.reshape(-1, 3))
    return buf[:n]


def cell_list_short_range(pos, softening, *, grid: int = 64, capacity: int = 128,
                          chunk: int = XLA_CHUNK, rank: int = 0, ndev: int = 1):
    """The short-range force (N, 3) of the (N, 4) state by the cell-list
    engine, in body order, and the overflow (a 0-d tensor): the reference's
    ``short_range="xla"`` (nbody_tpu/ops/p3m.py:424-432), plain PyTorch on
    pos's device, one counted host read a call. With ``ndev`` > 1 only the
    cells rank, rank + ndev, rank + 2 ndev, ... of the gc^3 lattice padded to
    a multiple of ndev (``_p3m_accel_local_factory``'s round robin): the
    bodies of other ranks' cells get 0, and the ranks' results sum to the
    whole force, each row from one rank."""
    if not 0 <= rank < ndev:
        raise ValueError(f"rank {rank} is not one of {ndev}")
    with annotate("nbody.p3m.tables"):
        pos3, mass, lo, h, rcut, gc, _ = _cells(pos, grid)
        n = pos3.shape[0]
        order, sorted_pos4, starts, counts, n_starts, n_counts, overflow = _sorted_cell_tables(
            pos3, mass, lo, rcut, gc, int(capacity))
    if ndev > 1:
        ncell = gc ** 3
        ncell_loc = -(-ncell // ndev)
        cell_ids = rank + ndev * torch.arange(ncell_loc, device=pos3.device)
        pad = ncell_loc * ndev - ncell

        def mine(x, fill):
            return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)])[cell_ids]

        starts, counts = mine(starts, n), mine(counts, 0)
        n_starts, n_counts = mine(n_starts, n), mine(n_counts, 0)
    with annotate("nbody.p3m.pairs"):
        acc_sorted = _short_range_cells(
            sorted_pos4, starts, counts, n_starts, n_counts, eps2=soft2_f32(softening),
            sigma=SIGMA_CELLS * h, rcut=rcut, cap=int(capacity), chunk=int(chunk), n=n)
        return torch.empty_like(acc_sorted).index_copy_(0, order, acc_sorted), overflow


def p3m_accel(pos, softening, *, grid: int = 64, capacity: int = 128,
              blk: int | None = None, backend: str = "auto",
              assignment: str = "cic", influence: str = "optimal",
              short_range: str = "auto", chunk: int = XLA_CHUNK):
    """(N, 4) [x,y,z,m] -> ((N, 3) accelerations, overflow count, a 0-d
    tensor on pos's device).

    Equals the softened all-pairs Plummer force up to the mesh error of the
    smooth field (sub-percent). A nonzero overflow means some short-range
    pairs were dropped. ``short_range`` "auto" or "pallas" runs the pair
    kernel, as ``backend`` says: ``"cuda"`` the kernel
    (``cuda_kernel.p3m_short_range_cuda``; the plain version for a CPU
    tensor), ``"torch"`` the plain version on any device, ``"auto"`` the
    kernel on a CUDA tensor; ``blk`` defaults to
    ``p3m_kernel_blk(capacity)``. ``short_range="xla"`` runs the cell-list
    engine (``cell_list_short_range``, batched by ``chunk``) on any device,
    whatever the backend."""
    if pos.shape[-1] != 4:
        raise ValueError("p3m_accel expects (N, 4) [x,y,z,m]")
    check_assignment(assignment)
    check_influence(influence)
    check_short_range(short_range)
    if backend == "auto":
        backend = "cuda" if pos.device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    acc_lr = p3m_long_range(pos, grid=grid, assignment=assignment, influence=influence)
    if short_range == "xla":
        acc_sr, overflow = cell_list_short_range(pos, softening, grid=grid, capacity=capacity,
                                                 chunk=chunk)
    elif backend == "cuda":
        acc_sr, overflow = cuda_kernel.p3m_short_range_cuda(
            pos, softening, grid=grid, capacity=capacity, blk=blk)
    else:
        with annotate("nbody.p3m.pairs"):
            acc_sr = reference.p3m_short_range(pos, softening, grid=grid, capacity=capacity)
            overflow = p3m_overflow_count(pos, grid=grid, capacity=capacity)
    return acc_lr + acc_sr, overflow


def nbody_step_p3m(pos, vel, dt, softening, damping, *, grid: int = 64,
                   capacity: int = 128, blk: int | None = None, backend: str = "auto",
                   assignment: str = "cic", influence: str = "optimal",
                   short_range: str = "auto", chunk: int = XLA_CHUNK):
    """P3M step with the reference's damped semi-implicit Euler update;
    returns (pos, vel, overflow)."""
    a, overflow = p3m_accel(pos, softening, grid=grid, capacity=capacity, blk=blk,
                            backend=backend, assignment=assignment, influence=influence,
                            short_range=short_range, chunk=chunk)
    new_pos, new_vel = reference.integrate(pos, vel, a.to(pos.dtype), dt, damping)
    return new_pos, new_vel, overflow


# ---- a rank's range of the pair kernel's work, and the sharded step ----


def item_range(tables: PairTables, rank: int, ndev: int) -> torch.Tensor:
    """Rank `rank` of `ndev`'s share of the pair kernel's work, a (4,) int32
    tensor on the tables' device (no host synchronisation): [item_lo,
    item_hi, c0, c1], the i-clusters [c0, c1) and their work items
    [cl_item0[c0], cl_item0[c1]). The cuts fall at cluster boundaries,
    cluster c1 of rank d being the first whose first item is at least
    (d + 1) / ndev of the live items; the last rank's range ends past the
    last cluster. Every item of a cluster thus runs on one rank."""
    if not 0 <= rank < ndev:
        raise ValueError(f"rank {rank} is not one of {ndev}")
    item0 = tables.cl_item0.to(torch.int64)
    nclb = item0.shape[0]
    total = tables.cl_nitem.to(torch.int64).sum()
    cuts = torch.searchsorted(item0, torch.stack([total * rank // ndev,
                                                  total * (rank + 1) // ndev]))
    if rank == ndev - 1:
        cuts[1] = nclb
    item0_ext = torch.cat([item0, total[None]])
    return torch.cat([item0_ext[cuts], cuts]).to(torch.int32)


def short_range_part(pos, softening, *, grid: int, capacity: int, rank: int, ndev: int,
                     blk: int | None = None, backend: str = "auto", tables=None):
    """(N, 3): the short-range force of the bodies whose padded rows lie in
    rank `rank` of `ndev`'s range of i-clusters (``item_range``), 0 for the
    others; and the overflow. On a CUDA tensor with backend "cuda" or
    "auto", one ranged launch of the pair kernel
    (``cuda_kernel.p3m_sr_range_cuda``); else its plain version,
    ``reference.p3m_short_range`` restricted to those bodies. ``tables``
    are the state's ``pair_tables`` when the caller has them."""
    if backend == "auto":
        backend = "cuda" if pos.device.type == "cuda" else "torch"
    blk = p3m_kernel_blk(capacity) if blk is None else int(blk)
    if tables is None:
        tables = pair_tables(pos, softening, grid=grid, capacity=capacity, blk=blk)
    with annotate("nbody.p3m.pairs"):
        rng = item_range(tables, rank, ndev)
        if backend == "cuda" and pos.device.type == "cuda":
            acc_pad = cuda_kernel.p3m_sr_range_cuda(tables, rng)
            return short_range_from_tables(acc_pad, tables), tables.overflow
        lo_row, hi_row = (int(c) * CLUSTER for c in rng[2:].tolist())
        sel = torch.nonzero((tables.body_row >= lo_row) & (tables.body_row < hi_row)).flatten()
        out = pos.new_zeros((pos.shape[0], 3), dtype=torch.float32)
        out[sel] = reference.p3m_short_range(pos, softening, grid=grid, capacity=capacity,
                                             rows=sel)
        return out, tables.overflow


def make_sharded_p3m_accel(mesh, *, grid: int = 64, capacity: int = 128,
                           axis: str = "bodies", assignment: str = "cic",
                           fft: str = "replicated", influence: str = "optimal",
                           blk: int | None = None, backend: str = "auto",
                           short_range: str = "auto", chunk: int = XLA_CHUNK):
    """The sharded P3M force: accel(pos_sh, softening) -> (nloc, 3) of this
    rank's shard, the decomposition of ``_p3m_accel_local_factory``
    (nbody_tpu/ops/p3m.py:460-586):

    * long range: ``pm.long_range`` with the smoothed kernel, the
      influence's correction and the assignment's window (replicated: the
      shard's force; slab: every body's partial);
    * short range, the positions all-gathered: ``short_range`` "auto" or
      "pallas" (the reference's "pallas" path), ``pair_tables`` of the whole
      state on every rank and the pair kernel over this rank's range of
      i-clusters (``short_range_part``); "xla", the cell tables of the whole
      state on every rank and the cell-list engine over this rank's round
      robin of cells (``cell_list_short_range``), unsorted to body order;
    * the partials reach their owners by one ``ring_reduce_scatter``: the
      short range's (replicated; its long range is the shard's already),
      or the sum of both (slab), as the reference's psums do.

    backend: "cuda" or "auto" (the pair kernel on a CUDA mesh, its plain
    version on a CPU one), "torch" (the plain version); the engine is plain
    PyTorch whatever the backend."""
    from nbody_tpu_torch.parallel.mesh import all_gather_rows
    from nbody_tpu_torch.parallel.sharded import ring_reduce_scatter

    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    check_assignment(assignment)
    check_influence(influence)
    check_short_range(short_range)
    check_slab(fft, grid, mesh.size)
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    deconvolve = DECONVOLVE[influence]

    def accel(pos_sh, softening):
        pos_all = all_gather_rows(mesh, pos_sh)
        lr = long_range(pos_sh, grid=grid, assignment=assignment, sigma_cells=SIGMA_CELLS,
                        deconvolve=deconvolve, mesh=mesh, fft=fft, pos_all=pos_all)
        if short_range == "xla":
            sr, _ = cell_list_short_range(pos_all.to(torch.float32), softening, grid=grid,
                                          capacity=capacity, chunk=chunk, rank=mesh.rank,
                                          ndev=mesh.size)
        else:
            sr, _ = short_range_part(pos_all.to(torch.float32), softening, grid=grid,
                                     capacity=capacity, rank=mesh.rank, ndev=mesh.size,
                                     blk=blk, backend=backend)
        if fft == "slab":
            (acc,) = ring_reduce_scatter(mesh, (lr + sr,), reference.add_fields)
            return acc
        (sr,) = ring_reduce_scatter(mesh, (sr,), reference.add_fields)
        return lr + sr

    return accel


def make_sharded_p3m_step(mesh, *, grid: int = 64, capacity: int = 128, axis: str = "bodies",
                          integrator: str = "euler", assignment: str = "cic",
                          fft: str = "replicated", influence: str = "optimal",
                          blk: int | None = None, backend: str = "auto",
                          short_range: str = "auto", chunk: int = XLA_CHUNK) -> ShardedMeshStep:
    """Body-sharded P3M step over a 1-D mesh (``nbody_tpu/ops/p3m.py:
    625-718``): (pos, vel, dt, softening, damping) -> (pos, vel) of this
    rank's shard, Euler or leapfrog, the force of
    ``make_sharded_p3m_accel``. The overflow is not returned: callers check
    the capacity against their states (``BodySystem`` does, at every state
    set and every step)."""
    if integrator not in ("euler", "leapfrog"):
        raise ValueError(f"unknown integrator {integrator!r}")
    return ShardedMeshStep(mesh, make_sharded_p3m_accel(
        mesh, grid=grid, capacity=capacity, axis=axis, assignment=assignment, fft=fft,
        influence=influence, blk=blk, backend=backend, short_range=short_range,
        chunk=chunk), integrator)
