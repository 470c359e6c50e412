"""The port's P3M fast mode (nbody_tpu_torch.ops.pm / ops.p3m, the plain
short-range sum and BodySystem(kernel="p3m")) against nbody_tpu's.

The same numpy inputs go through both packages. Tolerances and why:
  * binning, occupancies, overflow counts and the auto-sized capacity:
    exact (the same float32 box fit, the same stable sort);
  * the long-range force: 1e-5 * max|a| (the FFTs are other libraries',
    with other rounding; measured ~7e-7 * max|a| at N=2048, G=64);
  * the short-range sum and the whole force: rtol 1e-4, atol 2e-4, the JAX
    suite's bound between its Pallas and XLA short-range engines
    (tests/test_p3m.py:367), since only the order of the sums differs;
  * a 3-step rollout: rtol 1e-4, atol 1e-4 on positions and velocities.
The CUDA pair kernel cannot run here: its wrapper takes the plain version
on a CPU tensor, and the kernel's layout is held by a numpy emulation of
the kernel over the port's tables (tests/test_torch_cuda.py holds the
kernel itself on the card)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import p3m as jax_p3m
from nbody_tpu.ops import pm as jax_pm
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch.cli import main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, p3m, pm, reference
from nbody_tpu_torch.params import NBodyParams

import p3m_states

SOFT = 0.1
RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Beside the suite's other worker processes, intra-op threads only
    wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cloud():
    """tests/test_p3m.py's cloud: 2048 shell bodies."""
    pos, _ = jax_ic.generate(JaxNBodyConfig.SHELL, 2048, 1.5, 2.0, seed=3)
    return pos


def _state(config, n, seed=3):
    pos, _ = jax_ic.generate(JaxNBodyConfig[config], n, 1.5, 2.0, seed=seed)
    return pos


def _rel_err(a, a_ref):
    num = np.sqrt(((np.asarray(a) - a_ref) ** 2).sum(1))
    den = np.maximum(np.sqrt((a_ref ** 2).sum(1)), 1e-12)
    return num / den


def _jax_cells(pos, grid):
    """nbody_tpu's cell ids, compiled as its callers run them."""
    gc = jax_p3m._cell_grid_size(grid)

    def cells(p):
        lo, h = jax_pm._fit_box(p[:, :3], grid)
        return jax_p3m._bin_cells(p[:, :3], lo, jax_p3m._cell_rcut(h), gc)

    return np.asarray(jax.jit(cells)(jnp.asarray(pos)))


@pytest.mark.parametrize("grid", [16, 32, 64])
@pytest.mark.parametrize("config", ["SHELL", "RANDOM", "PLUMMER"])
def test_binning_and_occupancy_equal_nbody_tpu(config, grid):
    pos = _state(config, 2048)
    t = torch.tensor(pos)
    np.testing.assert_array_equal(p3m._cells(t, grid)[-1].numpy(), _jax_cells(pos, grid))
    occ = int(p3m.p3m_max_occupancy(t, grid=grid))
    assert occ == int(jax_p3m.p3m_max_occupancy(jnp.asarray(pos), grid=grid))
    for cap in (2, max(1, occ // 2), occ):
        assert int(p3m.p3m_overflow_count(t, grid=grid, capacity=cap)) == \
            int(jax_p3m.p3m_overflow_count(jnp.asarray(pos), grid=grid, capacity=cap))


@pytest.mark.parametrize("gc", [1, 3, 11])
def test_neighbor_stencil_equals_nbody_tpu(gc):
    nid, nvalid = p3m._neighbor_stencil(gc)
    jid, jvalid = jax_p3m._neighbor_stencil(gc)
    np.testing.assert_array_equal(nid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(nvalid.numpy(), np.asarray(jvalid))


def _jax_long_range(pos, grid):
    """The long-range half of nbody_tpu's p3m_accel (deposit, smoothed solve
    with the optimal influence, gather), compiled."""
    def lr(p):
        pos3, mass = p[:, :3], p[:, 3]
        lo, h = jax_pm._fit_box(pos3, grid)
        sigma = jnp.float32(jax_p3m.SIGMA_CELLS) * h
        idx, w = jax_pm._cic_indices_weights(pos3, lo, h, grid)
        rho = jax_pm._deposit(idx, w, mass, grid)
        return jax_pm._gather(jax_pm._solve_force_grids(
            rho, h, grid, sigma=sigma, deconvolve="optimal", window_exp=2,
            sigma_cells=jax_p3m.SIGMA_CELLS), idx, w)

    return np.asarray(jax.jit(lr)(jnp.asarray(pos)))


@pytest.mark.parametrize("grid", [16, 64])
def test_long_range_matches_nbody_tpu(cloud, grid):
    ours = p3m.p3m_long_range(torch.tensor(cloud), grid=grid).numpy()
    theirs = _jax_long_range(cloud, grid)
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()


def test_deposit_restores_the_determinism_setting(cloud):
    t = torch.tensor(cloud)
    lo, h = pm._fit_box(t[:, :3], 16)
    idx, w = pm._cic_indices_weights(t[:, :3], lo, h, 16)
    assert not torch.are_deterministic_algorithms_enabled()
    rho = pm._deposit(idx, w, t[:, 3], 16)
    assert not torch.are_deterministic_algorithms_enabled()
    np.testing.assert_allclose(float(rho.sum()), float(t[:, 3].sum()), rtol=1e-5)


def test_plain_short_range_matches_pallas_interpret():
    """At capacity 64 on a G=16 mesh 31 bodies overflow: both drop the same."""
    from nbody_tpu.ops.p3m_kernel import p3m_pair_count, p3m_short_range_pallas

    pos = _state("SHELL", 512)
    pc = int(p3m_pair_count(jnp.asarray(pos), grid=16, capacity=64))
    theirs, ovf, _ = p3m_short_range_pallas(jnp.asarray(pos), SOFT, grid=16, capacity=64,
                                            pair_budget=pc + 8, interpret=True)
    t = torch.tensor(pos)
    ours = reference.p3m_short_range(t, SOFT, grid=16, capacity=64)
    assert int(ovf) == int(p3m.p3m_overflow_count(t, grid=16, capacity=64)) > 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def _jax_xla_short_range(pos, grid, cap):
    """nbody_tpu's XLA cell-list short range (p3m_accel's xla branch)."""
    def sr(p):
        f32 = jnp.float32
        pos3, mass = p[:, :3], p[:, 3]
        lo, h = jax_pm._fit_box(pos3, grid)
        sigma = f32(jax_p3m.SIGMA_CELLS) * h
        rcut = f32(jax_p3m.RCUT_SIGMAS) * sigma
        gc = jax_p3m._cell_grid_size(grid)
        order, sp, starts, counts, nst, nct, ovf = jax_p3m._sorted_cell_tables(
            pos3, mass, lo, rcut, gc, cap)
        acc = jax_p3m._short_range_cells(sp, starts, counts, nst, nct, eps2=f32(SOFT) ** 2,
                                         sigma=sigma, rcut=rcut, cap=cap, chunk=2048,
                                         n=p.shape[0])
        return jnp.zeros((p.shape[0], 3), f32).at[order].set(acc), ovf

    acc, ovf = jax.jit(sr)(jnp.asarray(pos))
    return np.asarray(acc), int(ovf)


@pytest.mark.parametrize("cap", [8, 64])
def test_plain_short_range_matches_xla_engine(cloud, cap):
    theirs, ovf = _jax_xla_short_range(cloud, 32, cap)
    t = torch.tensor(cloud)
    ours = reference.p3m_short_range(t, SOFT, grid=32, capacity=cap)
    assert ovf == int(p3m.p3m_overflow_count(t, grid=32, capacity=cap))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cap", [8, 64])
def test_plain_short_range_of_sampled_rows(cloud, cap):
    """rows= gives those bodies' forces against all N, dropped ones (0) too:
    what the card's check of the N=1M state samples."""
    t = torch.tensor(cloud)
    full = reference.p3m_short_range(t, SOFT, grid=32, capacity=cap)
    rows = torch.tensor(np.random.default_rng(5).choice(len(cloud), 300, replace=False))
    sampled = reference.p3m_short_range(t, SOFT, grid=32, capacity=cap, rows=rows)
    assert sampled.shape == (300, 3)
    np.testing.assert_allclose(sampled.numpy(), full[rows].numpy(), rtol=1e-6, atol=1e-7)
    if cap == 8:  # overflowing: some sampled bodies are dropped
        assert int((sampled == 0).all(dim=1).sum()) > 0
    empty = reference.p3m_short_range(t, SOFT, grid=32, capacity=cap, rows=rows[:0])
    assert empty.shape == (0, 3)


def _box_d2(alo, ahi, blo, bhi):
    """The kernel's box distance^2, in numpy float32: per axis the rounded
    gap max(blo - ahi, alo - bhi, 0), then (x^2 + y^2) + z^2."""
    g = np.maximum(np.maximum(blo - ahi, alo - bhi), np.float32(0))
    with np.errstate(over="ignore"):
        g2 = g * g
        return (g2[..., 0] + g2[..., 1]) + g2[..., 2]


def _r2(pj, pi):
    """(len(pi), len(pj)) r^2 of (., 3) float32 rows, rounded as the kernel
    rounds it."""
    with np.errstate(over="ignore"):
        d = pj[None, :, :] - pi[:, None, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _stencil_clusters(tables, c):
    """The j-clusters of cell c's 27 neighbours, in stencil order (dz
    fastest): the numbering of the items' [k0, k1)."""
    gc = tables.gc
    cfirst, ncl = tables.cfirst.numpy(), tables.ncl.numpy()
    cx, cy, cz = c // (gc * gc), (c // gc) % gc, c % gc
    out = []
    for nx in (cx - 1, cx, cx + 1):
        for ny in (cy - 1, cy, cy + 1):
            for nz in (cz - 1, cz, cz + 1):
                if min(nx, ny, nz) >= 0 and max(nx, ny, nz) < gc:
                    nc = (nx * gc + ny) * gc + nz
                    out.extend(range(cfirst[nc], cfirst[nc] + ncl[nc]))
    return out


def _emulate_pair_kernel(tables):
    """What csrc/p3m_kernels.cu computes, in numpy: each work item (an
    i-cluster and the j-clusters [k0, k1) of its stencil) skips the
    j-clusters whose box distance^2 to the i-cluster's box is >= rcut^2,
    then the j-rows whose distance^2 to it is; sums each j-cluster's terms
    (the mask a select) in float32 and the j-clusters in float64; the items
    of an i-cluster add in item order."""
    cw = p3m.CLUSTER
    pad, box = tables.padded.numpy(), tables.box.numpy()
    eps2, rcut2, inv_2s2, inv_sq2s3 = tables.meta.numpy()
    it_cl, k0s, k1s = (t.numpy() for t in (tables.it_cl, tables.it_k0, tables.it_k1))
    cl_cell = tables.cl_cell.numpy()
    partial = np.zeros((len(it_cl), cw, 3))
    for w, ic in enumerate(it_cl):
        if ic < 0:
            break
        pi = pad[ic * cw:(ic + 1) * cw]
        ilo, ihi = box[ic, 0:3], box[ic, 4:7]
        for jc in _stencil_clusters(tables, cl_cell[ic])[k0s[w]:k1s[w]]:
            if _box_d2(ilo, ihi, box[jc, 0:3], box[jc, 4:7]) >= rcut2:
                continue
            pj = pad[jc * cw:(jc + 1) * cw]
            pj = pj[_box_d2(ilo, ihi, pj[:, :3], pj[:, :3]) < rcut2]
            with np.errstate(over="ignore", invalid="ignore"):
                d = pj[None, :, :3] - pi[:, None, :3]
                r2 = _r2(pj[:, :3], pi[:, :3])
                y = r2 * inv_2s2
                g = np.full_like(y, p3m._SLR_POLY[-1])
                for coef in p3m._SLR_POLY[-2::-1]:
                    g = g * y + np.float32(coef)
                s = np.where(r2 < rcut2, ((r2 + eps2) ** -1.5 - g * inv_sq2s3)
                             * pj[None, :, 3], 0.0)
            partial[w] += (s[:, :, None] * d).sum(1, dtype=np.float32)
    out = np.zeros_like(pad)
    for k, (t0, nt) in enumerate(zip(tables.cl_item0.numpy(), tables.cl_nitem.numpy())):
        out[k * cw:(k + 1) * cw, :3] = partial[t0:t0 + nt].sum(0)
    return torch.tensor(out)


def _check_layout(tables, pos, cap):
    """The invariants of the layout (the reference's
    test_pallas_pair_tables_properties, for clusters): the kept bodies are
    the reference's, each on its own row, in its cell's clusters; every
    other row inert; boxes over the real rows; the work items cover each
    live i-cluster's stencil once, in chunks of at most ``chunk``."""
    cw = p3m.CLUSTER
    pos3, mass, _, _, _, gc, cell = (x.numpy() if isinstance(x, torch.Tensor) else x
                                     for x in p3m._cells(torch.tensor(pos), 32))
    order = np.argsort(cell * 2 + (mass <= 0), kind="stable")
    rank = np.arange(len(pos)) - np.searchsorted(cell[order], cell[order])
    kept = np.empty(len(pos), bool)
    kept[order] = rank < cap
    rows = tables.body_row.numpy()
    padded = tables.padded.numpy()
    assert padded.shape[0] % cw == 0
    assert ((rows < padded.shape[0]) == kept).all()
    live = rows[kept]
    assert len(np.unique(live)) == len(live)
    np.testing.assert_array_equal(padded[live], pos[kept])
    assert (padded[np.setdiff1d(np.arange(len(padded)), live), :3] == 1e30).all()
    cfirst, ncl, nkept = tables.cfirst.numpy(), tables.ncl.numpy(), tables.nkept.numpy()
    np.testing.assert_array_equal(nkept, np.minimum(np.bincount(cell, minlength=gc ** 3), cap))
    np.testing.assert_array_equal(ncl, -(-nkept // cw))
    kc = cell[kept]
    assert ((live // cw >= cfirst[kc]) & (live // cw < cfirst[kc] + ncl[kc])).all()
    # in its cell, a body's row follows the sub-cell order
    _, _, lo, _, rcut, _, _ = p3m._cells(torch.tensor(pos), 32)
    sub = p3m._sub_cell_key(torch.tensor(pos3[kept]), lo, rcut, gc).numpy()
    by_row = np.argsort(live)
    same = kc[by_row][1:] == kc[by_row][:-1]
    assert (np.diff(sub[by_row])[same] >= 0).all()
    box = tables.box.numpy()
    for k in np.unique(live // cw):
        real = padded[k * cw:(k + 1) * cw][padded[k * cw:(k + 1) * cw, 0] < 1e29, :3]
        np.testing.assert_array_equal(box[k, 0:3], real.min(0))
        np.testing.assert_array_equal(box[k, 4:7], real.max(0))
    cl_cell, chunk = tables.cl_cell.numpy(), int(tables.chunk)
    nlive = int(ncl.sum())
    assert (cl_cell[:nlive] >= 0).all() and (cl_cell[nlive:] == -1).all()
    it_cl, k0s, k1s = (t.numpy() for t in (tables.it_cl, tables.it_k0, tables.it_k1))
    items = int((it_cl >= 0).sum())
    assert (it_cl[items:] == -1).all()
    assert len(it_cl) == p3m.ITEMS_PER_CLUSTER * -(-len(pos) // cw) + len(cl_cell)
    for k in range(nlive):
        t0, nt = tables.cl_item0.numpy()[k], tables.cl_nitem.numpy()[k]
        assert (it_cl[t0:t0 + nt] == k).all()
        assert k0s[t0] == 0 and k1s[t0 + nt - 1] == len(_stencil_clusters(tables, cl_cell[k]))
        np.testing.assert_array_equal(k0s[t0 + 1:t0 + nt], k1s[t0:t0 + nt - 1])
        assert (k1s[t0:t0 + nt] - k0s[t0:t0 + nt] <= chunk).all()
    return pos3, cell, kept, gc


@pytest.mark.parametrize("blk", [128, 256])
@pytest.mark.parametrize("cap", [16, 64])
def test_pair_tables_feed_the_kernel_the_plain_sum(cloud, blk, cap):
    """The port's cluster layout and work items, run through an emulation of
    the kernel, give the plain short-range sum; at capacity 16 bodies are
    dropped, at 64 j-ranges split into several items. 77 zero-mass bodies
    at the origin share cells, clusters and boxes with real ones."""
    pos = np.concatenate([cloud, np.zeros((77, 4), np.float32)])
    t = torch.tensor(pos)
    tables = p3m.pair_tables(t, SOFT, grid=32, capacity=cap, blk=blk)
    assert tables.blk == blk
    got = p3m.short_range_from_tables(_emulate_pair_kernel(tables), tables)
    want = reference.p3m_short_range(t, SOFT, grid=32, capacity=cap)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert int(tables.overflow) == int(p3m.p3m_overflow_count(t, grid=32, capacity=cap))
    assert (int(tables.overflow) > 0) == (cap == 16)

    pos3, cell, kept, gc = _check_layout(tables, pos, cap)
    work = p3m.pair_work(tables)
    assert work["clusters"] == int(tables.ncl.sum())
    assert work["items"] == int((tables.it_cl >= 0).sum()) >= work["clusters"]
    if cap == 64:
        assert work["items"] > work["clusters"]
    assert work["near"] <= work["termed"] <= work["tested"] <= work["visited"]
    assert work["boxed"] <= work["cluster_pairs"]

    # the candidate and near pairs, counted over all pairs of kept bodies
    rcut = float(p3m._cells(t, 32)[4])
    cxyz = np.stack([cell // (gc * gc), (cell // gc) % gc, cell % gc], 1)[kept]
    cand = (np.abs(cxyz[:, None, :] - cxyz[None, :, :]) <= 1).all(axis=2)
    r2 = _r2(pos3[kept], pos3[kept])
    assert work["candidates"] == int(cand.sum())
    assert work["near"] == int((cand & (r2 < np.float32(rcut) ** 2)).sum())


def _auto_capacity(t, grid):
    return max(8, -(-int(int(p3m.p3m_max_occupancy(t, grid=grid)) * 1.5 + 1) // 8) * 8)


@pytest.mark.parametrize("kind", p3m_states.KINDS)
def test_pruning_is_conservative(kind):
    """Every (i-cluster, j-cluster) pair that the box test skips, and every
    j-row that the row test skips, has all its pairs' r^2, rounded as the
    kernel rounds it, >= rcut^2, where the plain version adds +0: so the
    kernel's pruning is exact. The states (tests/p3m_states.py) meet the
    tests at their edge: pairs at rcut * (1 +- 1e-7) across cell and
    cluster borders, a collapsed cell, bodies on cell and box faces, an odd
    N. pair_work counts the tests' outcomes as this does, and the emulated
    kernel gives the plain sum."""
    pos = p3m_states.state(kind)
    t = torch.tensor(pos)
    grid = p3m_states.GRID
    cap = _auto_capacity(t, grid)
    tables = p3m.pair_tables(t, SOFT, grid=grid, capacity=cap, blk=128)
    cw = p3m.CLUSTER
    pad, box = tables.padded.numpy(), tables.box.numpy()
    rcut2 = tables.meta.numpy()[1]
    cfirst, nkept, cl_cell = tables.cfirst.numpy(), tables.nkept.numpy(), tables.cl_cell.numpy()

    def real(k):
        c = cl_cell[k]
        return pad[k * cw:k * cw + min(cw, nkept[c] - (k - cfirst[c]) * cw), :3]

    edge = np.float32(1e-5) * rcut2
    skipped = rows_skipped = boxed = tested = edge_skipped = edge_kept = 0
    for ic in np.nonzero(cl_cell >= 0)[0]:
        pi, ilo, ihi = real(ic), box[ic, 0:3], box[ic, 4:7]
        for jc in _stencil_clusters(tables, cl_cell[ic]):
            pj = real(jc)
            r2 = _r2(pj, pi)
            if _box_d2(ilo, ihi, box[jc, 0:3], box[jc, 4:7]) >= rcut2:
                assert (r2 >= rcut2).all(), (ic, jc, r2.min(), rcut2)
                skipped += 1
                edge_skipped += int((r2 < rcut2 + edge).sum())
                continue
            out = _box_d2(ilo, ihi, pj, pj) >= rcut2
            assert (r2[:, out] >= rcut2).all(), (ic, jc, r2[:, out].min(), rcut2)
            boxed += 1
            tested += cw * int((~out).sum())
            rows_skipped += int(out.sum())
            edge_skipped += int((r2[:, out] < rcut2 + edge).sum())
            edge_kept += int(((r2[:, ~out] < rcut2) & (r2[:, ~out] >= rcut2 - edge)).sum())
    assert skipped + rows_skipped > 0
    if kind in ("rcut_pairs", "collapsed"):  # the tests decide pairs at the cutoff
        assert edge_skipped > 0 and edge_kept > 0
    work = p3m.pair_work(tables)
    assert (work["boxed"], work["tested"]) == (boxed, tested)

    got = p3m.short_range_from_tables(_emulate_pair_kernel(tables), tables)
    want = reference.p3m_short_range(t, SOFT, grid=grid, capacity=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cap", [64, 2])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_p3m_accel_matches_nbody_tpu(cloud, cap, backend):
    """The whole force on tests/test_p3m.py's cloud (G=64); at capacity 2
    most bodies overflow, and both report the same count and forces."""
    theirs, ovf = jax_p3m.p3m_accel(jnp.asarray(cloud), SOFT, grid=64, capacity=cap)
    before = dict(cuda_kernel.LAUNCHES)
    ours, ours_ovf = p3m.p3m_accel(torch.tensor(cloud), SOFT, grid=64, capacity=cap,
                                   backend=backend)
    assert cuda_kernel.LAUNCHES == before  # a CPU tensor takes the plain version
    assert int(ours_ovf) == int(ovf) and (int(ovf) > 0) == (cap == 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def test_p3m_step_matches_nbody_tpu(cloud):
    vel = np.random.default_rng(1).standard_normal((len(cloud), 4)).astype(np.float32)
    theirs = jax_p3m.nbody_step_p3m(jnp.asarray(cloud), jnp.asarray(vel), 0.001, SOFT, 0.999,
                                    grid=32, capacity=64)
    ours = p3m.nbody_step_p3m(torch.tensor(cloud), torch.tensor(vel), 0.001, SOFT, 0.999,
                              grid=32, capacity=64)
    assert int(ours[2]) == int(theirs[2]) == 0
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ours[0][:, 3].numpy(), cloud[:, 3])


def test_p3m_accuracy_envelope(cloud):
    """tests/test_p3m.py:29-41: sub-percent median force error against the
    exact force, and ~4x tighter than plain PM on the same mesh."""
    t = torch.tensor(cloud)
    a_ref = reference.compute_accel(t, SOFT).numpy()
    a, ovf = p3m.p3m_accel(t, SOFT, grid=64, capacity=64)
    assert int(ovf) == 0
    rel = _rel_err(a.numpy(), a_ref)
    assert np.median(rel) < 0.008, np.median(rel)
    assert np.percentile(rel, 90) < 0.02
    rel_pm = _rel_err(jax_pm.pm_accel(jnp.asarray(cloud), grid=64), a_ref)
    assert np.median(rel) < np.median(rel_pm) / 4


def test_p3m_conserves_momentum(cloud):
    a, ovf = p3m.p3m_accel(torch.tensor(cloud), SOFT, grid=64, capacity=64)
    assert int(ovf) == 0
    m = cloud[:, 3:4]
    ma = m * a.numpy()
    assert np.abs(ma.sum(0)).max() / np.abs(ma).sum() < 1e-5


def test_p3m_accel_repeats_bit_for_bit(cloud):
    t = torch.tensor(cloud)
    a1, _ = p3m.p3m_accel(t, SOFT, grid=32, capacity=64)
    a2, _ = p3m.p3m_accel(t, SOFT, grid=32, capacity=64)
    assert torch.equal(a1, a2)


# TSC and the naive influence were refused here until they were ported
# (tests/test_torch_pm.py), and the reference's XLA cell-list engine until
# #16 brought it (tests/test_torch_p3m_xla.py): the whole force of each
# configuration now matches nbody_tpu's, at the file's bound for the whole
# force, on a grid of 27 cells
@pytest.mark.parametrize("kw", [{"short_range": "xla"},
                                {"short_range": "xla", "assignment": "tsc"}])
def test_unported_options_raise_naming_roadmap_item(cloud, kw):
    ours, ovf = p3m.p3m_accel(torch.tensor(cloud), SOFT, grid=16, capacity=128, **kw)
    theirs, tovf = jax_p3m.p3m_accel(jnp.asarray(cloud), SOFT, grid=16, capacity=128, **kw)
    assert int(ovf) == int(tovf)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def test_short_range_wrappers_on_the_cpu(cloud):
    t = torch.tensor(cloud)
    before = dict(cuda_kernel.LAUNCHES)
    acc, ovf = cuda_kernel.p3m_short_range_cuda(t, SOFT, grid=32, capacity=64)
    assert cuda_kernel.LAUNCHES == before
    assert torch.equal(acc, reference.p3m_short_range(t, SOFT, grid=32, capacity=64))
    assert int(ovf) == 0
    tables = p3m.pair_tables(t, SOFT, grid=32, capacity=64, blk=128)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernel.p3m_sr_pairs_cuda(tables)
    with pytest.raises(ValueError, match="blk"):
        cuda_kernel.p3m_short_range_cuda(t, SOFT, grid=32, capacity=64, blk=64)
    with pytest.raises(TypeError):
        cuda_kernel.p3m_short_range_cuda(t.double(), SOFT, grid=32, capacity=64)


def _params():
    return NBodyParams()


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_body_system_matches_nbody_tpu(integrator):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 512, 1.54, 8.0, seed=0)
    theirs = JaxBodySystem(512, JaxNBodyParams(), backend="p3m", pm_grid=32,
                           p3m_short_range="xla", integrator=integrator, state=(pos, vel))
    ours = BodySystem(512, _params(), device="cpu", kernel="p3m", pm_grid=32,
                      integrator=integrator, state=(pos, vel))
    assert ours.p3m_capacity == theirs.p3m_capacity
    theirs.update_many(3)
    ours.update_many(3)
    np.testing.assert_allclose(ours.positions, np.asarray(theirs.positions), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours.velocities, np.asarray(theirs.velocities),
                               rtol=1e-4, atol=1e-4)
    # the variant is ignored by the P3M step, as in nbody_tpu
    sym = BodySystem(512, _params(), device="cpu", kernel="p3m", pm_grid=32, variant="sym",
                     integrator=integrator, state=(pos, vel))
    sym.update_many(3)
    np.testing.assert_array_equal(sym.positions, ours.positions)
    assert sym.mxu_force is None


@pytest.mark.parametrize("grid", [32, 64])
def test_capacity_auto_sizes_as_nbody_tpu(grid):
    theirs = JaxBodySystem(2048, JaxNBodyParams(), backend="p3m", pm_grid=grid, seed=3)
    ours = BodySystem(2048, _params(), device="cpu", kernel="p3m", pm_grid=grid, seed=3)
    assert ours.p3m_capacity == theirs.p3m_capacity
    assert ours.p3m_capacity % 8 == 0
    assert ours.p3m_capacity >= int(p3m.p3m_max_occupancy(ours.state[0], grid=grid))


def test_undersized_capacity_raises():
    with pytest.raises(ValueError, match="capacity"):
        BodySystem(2048, _params(), device="cpu", kernel="p3m", pm_grid=64, p3m_capacity=2,
                   seed=0)
    s = BodySystem(2048, _params(), device="cpu", kernel="p3m", pm_grid=64, seed=0)
    with pytest.raises(ValueError, match="overflows"):
        s.set_state(*(np.tile(a[:1], (2048, 1)) for a in (s.positions, s.velocities)))


def test_zero_mass_padding_is_ignored():
    """tests/test_p3m.py:123-146: zero-mass pads at the origin neither trip
    the capacity probe nor crowd massive bodies out of their cell."""
    pos, vel = jax_ic.generate(JaxNBodyConfig.RANDOM, 500, 1.5, 2.0, seed=2)
    s = BodySystem(2048, _params(), device="cpu", kernel="p3m", pm_grid=32, p3m_capacity=64,
                   state=(pos, vel))
    padded = s.state[0]
    assert int(p3m.p3m_overflow_count(padded, grid=32, capacity=64)) == 0
    a_pad, ovf = p3m.p3m_accel(padded, SOFT, grid=32, capacity=64)
    assert int(ovf) == 0
    a_raw, _ = p3m.p3m_accel(torch.tensor(pos), SOFT, grid=32, capacity=64)
    np.testing.assert_allclose(a_pad.numpy()[:500], a_raw.numpy(), rtol=2e-2, atol=2e-2)
    # and equals nbody_tpu's on the padded state; its forces reach ~150, so
    # elements that cancel to ~0 carry float32 sum-order noise of ~1e-6 of
    # that (measured 2.1e-4): atol is 1e-5 * max|a| here
    theirs = np.asarray(jax_p3m.p3m_accel(jnp.asarray(padded.numpy()), SOFT, grid=32,
                                          capacity=64)[0])
    np.testing.assert_allclose(a_pad.numpy(), theirs, rtol=RTOL, atol=1e-5 * np.abs(theirs).max())


def _collapsing_state():
    """tests/test_p3m.py's radially infalling shell: cell occupancy grows
    every step, so the auto-sized capacity breaches mid-run."""
    n = 512
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.9, 1.1, size=(n, 1))
    pos = np.concatenate([dirs * radii, np.ones((n, 1))], 1).astype(np.float32)
    vel = np.concatenate([-dirs * 2.0, np.zeros((n, 1))], 1).astype(np.float32)
    return pos, vel


def test_breach_step_equals_nbody_tpus_probed_rollout():
    pos, vel = _collapsing_state()
    kw = dict(time_step=0.01, softening=0.05, damping=1.0)
    theirs = JaxBodySystem(512, JaxNBodyParams(**kw), backend="p3m", pm_grid=16,
                           p3m_short_range="xla", state=(pos, vel))
    first = theirs._update_many_inner(60, 0.01)
    assert first >= 1
    ours = BodySystem(512, NBodyParams(**kw), device="cpu", kernel="p3m", pm_grid=16,
                      state=(pos, vel))
    assert ours.p3m_capacity == theirs.p3m_capacity
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ours.update_many(60, 0.01)
    msgs = [str(x.message) for x in w if "contract broken" in str(x.message)]
    assert msgs == [msgs[0]] and f"first breach at step {first} of 60" in msgs[0]
    # once per breach episode: the next call, still breached, stays quiet
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        ours.update_many(2, 0.01)
    assert not any("contract broken" in str(x.message) for x in w2)


def test_hermite_and_ds_are_refused(capsys):
    with pytest.raises(ValueError, match="jerk"):
        BodySystem(64, _params(), device="cpu", kernel="p3m", integrator="hermite")
    with pytest.raises(ValueError, match="precision='ds'"):
        Compute(num_bodies=64, device="cpu", kernel="p3m", precision="ds")
    assert main(["--kernel", "p3m", "--cpu", "--integrator", "hermite", "--qatest"]) == 2
    # the ds measurement modes run without --kernel, as nbody_tpu's _run_ds
    assert main(["--kernel", "p3m", "--cpu", "--precision", "ds", "--qatest",
                 "--numbodies", "64"]) == 0
    out = capsys.readouterr().out
    assert "--kernel p3m (the all-pairs ds kernels run) has no effect" in out and "-> OK" in out
    # plain PM is ported (tests/test_torch_pm.py), and since the XLA engine
    # was ported too, PM with p3m_short_range="xla" runs, the option unused,
    # as in nbody_tpu
    s = BodySystem(64, _params(), device="cpu", kernel="pm", p3m_short_range="xla")
    s.update_many(1)
    assert s.kernel == "pm" and np.isfinite(s.positions).all()


def test_compute_qa_gates_positions_only():
    lines = []
    c = Compute(num_bodies=1024, device="cpu", kernel="p3m", pm_grid=32, log=lines.append)
    assert c.compare_results()
    assert "not gated" in lines[-1] and "max |dacc|" not in lines[-1]


def test_cli_p3m_on_the_cpu(capsys):
    assert main(["--kernel", "p3m", "--pm-grid", "32", "--cpu", "--qatest",
                 "--numbodies", "1024"]) == 0
    assert "-> OK" in capsys.readouterr().out
    assert main(["--kernel", "p3m", "--cpu", "--benchmark", "--numbodies", "1024", "-i", "2",
                 "--integrator", "leapfrog", "--p3m-capacity", "64"]) == 0
    out = capsys.readouterr().out
    assert "pairwise-equivalent rate" in out and "cell capacity 64" in out
    assert main(["--kernel", "p3m", "--cpu", "--drift-check", "2", "--numbodies", "512"]) == 0
    assert "exit-code gate applies to exact kernels only" in capsys.readouterr().out
