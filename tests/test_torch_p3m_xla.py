"""The port's cell-list engine (ops/p3m.py, ``short_range="xla"``:
``_sorted_cell_tables``, ``_short_range_cells``, ``cell_list_short_range``)
against nbody_tpu's XLA engine on the CPU.

Inputs are made with numpy from a seed: odd N, masses from [0.5, 2], one
body in nine of zero mass (padding), damping 0.5; a uniform cloud and a
clustered one whose capacity exceeds 128, so that its worklist has several
j-classes and a cell of more than 128 rows (several i-subtiles).
Tolerances, with their reasons:

* the tables (order, starts, counts, the neighbour ranges, the overflow):
  equal as integers, the sorted positions bit for bit (the same float32
  box fit and the same stable sort);
* the short-range force: per row |delta a_i| <= 1e-5 * sum_j |term_ij|,
  ROADMAP's hazard "Float32 short-range terms": a term carries ~1e-5 of
  the sum of |terms| however it is rounded, and the two engines round the
  terms in their own orders (and their own erf);
* a P3M step (CIC and TSC): rtol / atol 1e-5, the JAX suite's bound for its
  sharded P3M step against one device (tests/test_p3m.py:182-206);
* two runs, and a batch size against another: bit for bit (each sorted row
  is written by the one worklist entry that holds it, never summed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import p3m as jax_p3m
from nbody_tpu.ops import pm as jax_pm
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import p3m
from nbody_tpu_torch.params import NBodyParams
from nbody_tpu_torch.utils import timing

SOFT, DT, DAMP = 0.1, 1e-3, 0.5
TERM_RTOL = 1e-5
STEP_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _masses(rng, n):
    m = rng.uniform(0.5, 2.0, n)
    m[::9] = 0.0  # zero-mass padding among the bodies
    return m


def uniform_state(n=777, seed=4):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-1.0, 1.0, (n, 3)), _masses(rng, n)].astype(np.float32)
    vel = np.c_[rng.standard_normal((n, 3)), rng.standard_normal(n)].astype(np.float32)
    return pos, vel


def clustered_state(n=501, seed=6):
    """A uniform cloud with 181 of its bodies in a ball of radius 0.02: at
    grid 20 that ball's cell holds more than 128 bodies (two i-subtiles),
    and the auto capacity (occupancy * 1.5) gives the classes 128, 256 and
    cap."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.0, 1.0, (n, 3))
    xyz[:181] = 0.3 + 0.02 * rng.standard_normal((181, 3)).clip(-1, 1)
    pos = np.c_[xyz, _masses(rng, n)].astype(np.float32)
    vel = np.c_[rng.standard_normal((n, 3)), rng.standard_normal(n)].astype(np.float32)
    return pos, vel


STATES = {"uniform": (uniform_state, 16), "clustered": (clustered_state, 20)}


def _case(name):
    make, grid = STATES[name]
    pos, vel = make()
    # the system's auto-sizing: occupancy + 50 %, a multiple of 8
    occ = int(p3m.p3m_max_occupancy(torch.tensor(pos), grid=grid))
    return pos, vel, grid, max(8, -(-int(occ * 1.5 + 1) // 8) * 8)


@pytest.fixture(scope="module")
def ours():
    """cell_list_short_range of a test state at a capacity, once a module:
    ours(name, cap=None) -> (force, overflow)."""
    made = {}

    def get(name, cap=None):
        pos, _, grid, auto_cap = _case(name)
        key = (name, cap or auto_cap)
        if key not in made:
            made[key] = p3m.cell_list_short_range(torch.tensor(pos), SOFT, grid=grid,
                                                  capacity=key[1])
        return made[key]

    return get


def test_clustered_state_has_several_classes_and_subtiles():
    pos, _, grid, cap = _case("clustered")
    assert cap > 256 and p3m._xla_classes(cap) == [128, 256, cap]
    *_, gc, cell = p3m._cells(torch.tensor(pos), grid)
    assert int(torch.bincount(cell).max()) > p3m.XLA_I_TILE


def _jax_tables(pos, grid, cap):
    f32 = jnp.float32
    p = jnp.asarray(pos)
    pos3, mass = p[:, :3], p[:, 3]
    lo, h = jax_pm._fit_box(pos3, grid)
    rcut = f32(jax_p3m.RCUT_SIGMAS) * (f32(jax_p3m.SIGMA_CELLS) * h)
    return jax_p3m._sorted_cell_tables(pos3, mass, lo, rcut, jax_p3m._cell_grid_size(grid), cap)


def _jax_short_range(pos, grid, cap, chunk=2048):
    """nbody_tpu's short range by its XLA engine, in body order, and the
    overflow (p3m_accel's xla branch, nbody_tpu/ops/p3m.py:424-432)."""
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
                                         sigma=sigma, rcut=rcut, cap=cap, chunk=chunk,
                                         n=p.shape[0])
        return jnp.zeros((p.shape[0], 3), f32).at[order].set(acc), ovf

    acc, ovf = jax.jit(sr)(jnp.asarray(pos))
    return np.asarray(acc), int(ovf)


def _abs_terms(pos, grid, cap):
    """sum_j |term_ij| for each row i, in float64: |m_j s_sr(r_ij)| * |d_ij|
    over the pairs the engine sums (both bodies kept, j's cell in i's
    stencil, r < rcut); 0 for a dropped body."""
    t = torch.tensor(pos)
    _, mass, lo, h, rcut, gc, cell = p3m._cells(t, grid)
    n = t.shape[0]
    order = torch.argsort(cell * 2 + (mass <= 0).to(torch.int64), stable=True)
    sc = cell[order]
    rank = torch.arange(n) - torch.searchsorted(sc, sc)
    kept = torch.empty(n, dtype=torch.bool)
    kept[order] = rank < cap
    cxyz = torch.stack([cell // (gc * gc), (cell // gc) % gc, cell % gc], 1).numpy()
    x = pos[:, :3].astype(np.float64)
    m = pos[:, 3].astype(np.float64)
    sigma = float(p3m.SIGMA_CELLS * h)
    d = x[None, :, :] - x[:, None, :]
    r2 = (d * d).sum(-1)
    r = np.sqrt(r2)
    u = r / (np.sqrt(2.0) * sigma)
    with np.errstate(divide="ignore", invalid="ignore"):
        slr = (scipy.special.erf(u) - 2.0 / np.sqrt(np.pi) * u * np.exp(-u * u)) / r ** 3
    slr = np.where(u < 1e-3, 2.0 / np.sqrt(np.pi) * (2.0 / 3.0) / (np.sqrt(2.0) * sigma) ** 3,
                   slr)
    s = (r2 + np.float64(np.float32(SOFT)) ** 2) ** -1.5 - slr
    near = (np.abs(cxyz[:, None, :] - cxyz[None, :, :]) <= 1).all(-1)
    k = kept.numpy()
    near &= k[:, None] & k[None, :] & (r < float(rcut))
    return np.where(near, np.abs(m[None, :] * s) * r, 0.0).sum(1)


@pytest.mark.parametrize("name", sorted(STATES))
def test_tables_equal_nbody_tpus(name):
    pos, _, grid, cap = _case(name)
    theirs = _jax_tables(pos, grid, cap)
    pos3, mass, lo, h, rcut, gc, _ = p3m._cells(torch.tensor(pos), grid)
    ours = p3m._sorted_cell_tables(pos3, mass, lo, rcut, gc, cap)
    for a, b, what in zip(ours, theirs, ("order", "sorted_pos4", "starts", "counts",
                                         "n_starts", "n_counts", "overflow")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("name, cap", [("uniform", None), ("uniform", 8), ("clustered", None)])
def test_short_range_matches_nbody_tpus_engine(ours, name, cap):
    pos, _, grid, auto_cap = _case(name)
    cap = cap or auto_cap
    theirs, ovf = _jax_short_range(pos, grid, cap)
    force, overflow = ours(name, cap)
    assert int(overflow) == ovf
    assert (ovf > 0) == (cap == 8)
    bound = TERM_RTOL * _abs_terms(pos, grid, cap)
    err = np.abs(force.numpy().astype(np.float64) - theirs).max(axis=1)
    assert (err <= bound).all(), (err / np.maximum(bound, 1e-30)).max()
    assert (bound > 0).any()


@pytest.mark.parametrize("name", sorted(STATES))
def test_runs_and_batches_give_the_same_bits(ours, name):
    pos, _, grid, cap = _case(name)
    t = torch.tensor(pos)
    a, _ = ours(name)
    b, _ = p3m.cell_list_short_range(t, SOFT, grid=grid, capacity=cap)
    c, _ = p3m.cell_list_short_range(t, SOFT, grid=grid, capacity=cap, chunk=1)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("assignment", ["cic", "tsc"])
@pytest.mark.parametrize("name", sorted(STATES))
def test_step_matches_nbody_tpu(name, assignment):
    pos, vel, grid, cap = _case(name)
    p, v, ovf = p3m.nbody_step_p3m(torch.tensor(pos), torch.tensor(vel), DT, SOFT, DAMP,
                                   grid=grid, capacity=cap, assignment=assignment,
                                   short_range="xla")
    tp, tv, tovf = jax_p3m.nbody_step_p3m(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP,
                                          grid=grid, capacity=cap, assignment=assignment,
                                          short_range="xla")
    assert int(ovf) == int(tovf) == 0
    np.testing.assert_allclose(p.numpy(), np.asarray(tp), rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(tv), rtol=STEP_TOL, atol=STEP_TOL)


def test_one_counted_host_read_a_force_call():
    pos, vel, grid, cap = _case("uniform")
    t = torch.tensor(pos)
    before = timing.HOST_READS["p3m_xla"]
    for backend in ("auto", "torch"):  # the backend does not choose the engine
        p3m.p3m_accel(t, SOFT, grid=grid, capacity=cap, short_range="xla", backend=backend)
    assert timing.HOST_READS["p3m_xla"] - before == 2
    p3m.nbody_step_p3m(t, torch.tensor(vel), DT, SOFT, DAMP, grid=grid, capacity=cap,
                       short_range="xla")
    assert timing.HOST_READS["p3m_xla"] - before == 3
    p3m.p3m_accel(t, SOFT, grid=grid, capacity=cap)  # the pair kernel reads nothing
    assert timing.HOST_READS["p3m_xla"] - before == 3


def test_ranks_round_robin_sums_to_the_whole(ours):
    """Each rank's cells d, d + D, ... (the sharded step's partial) hold
    disjoint rows, and the D partials sum to the one-device force bit for
    bit."""
    pos, _, grid, cap = _case("clustered")
    t = torch.tensor(pos)
    whole, _ = ours("clustered")
    for d in (2, 3, 4):
        parts = [p3m.cell_list_short_range(t, SOFT, grid=grid, capacity=cap, rank=r,
                                           ndev=d)[0] for r in range(d)]
        nonzero = torch.stack([(x != 0).any(dim=1) for x in parts]).sum(0)
        assert int(nonzero.max()) == 1
        assert torch.equal(sum(parts[1:], parts[0]), whole)
    with pytest.raises(ValueError, match="rank"):
        p3m.cell_list_short_range(t, SOFT, grid=grid, capacity=cap, rank=2, ndev=2)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_body_system_matches_nbody_tpu(integrator):
    pos, vel, _, _ = _case("uniform")
    n = pos.shape[0]
    kw = dict(time_step=DT, softening=SOFT, damping=DAMP)
    ours = BodySystem(n, NBodyParams(**kw), device="cpu", kernel="p3m", pm_grid=16,
                      p3m_short_range="xla", integrator=integrator, state=(pos, vel))
    theirs = JaxBodySystem(n, JaxNBodyParams(**kw), backend="p3m", pm_grid=16,
                           p3m_short_range="xla", integrator=integrator, state=(pos, vel))
    assert ours.p3m_short_range == theirs.p3m_short_range == "xla"
    assert ours.p3m_capacity == theirs.p3m_capacity
    ours.update_many(3)
    theirs.update_many(3)
    np.testing.assert_allclose(ours.positions, np.asarray(theirs.positions), rtol=STEP_TOL,
                               atol=STEP_TOL)
    np.testing.assert_allclose(ours.velocities, np.asarray(theirs.velocities), rtol=STEP_TOL,
                               atol=STEP_TOL)


def test_auto_resolves_to_the_pair_kernel():
    pos, vel, _, _ = _case("uniform")
    s = BodySystem(pos.shape[0], NBodyParams(), device="cpu", kernel="p3m", pm_grid=16,
                   state=(pos, vel))
    assert s.p3m_short_range == "pallas"
    before = timing.HOST_READS["p3m_xla"]
    s.update_many(1)
    assert timing.HOST_READS["p3m_xla"] == before
    with pytest.raises(ValueError, match="unknown short_range"):
        p3m.p3m_accel(torch.tensor(pos), SOFT, short_range="cells")
