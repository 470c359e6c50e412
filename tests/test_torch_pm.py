"""The port's plain PM, TSC assignment and the naive influence
(nbody_tpu_torch.ops.pm, ops.p3m, BodySystem / Compute / CLI with
kernel="pm") against nbody_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through both packages.
Tolerances and why:
  * stencil indices, cell ids and capacities: exact (the same float32 box
    fit and arithmetic);
  * TSC weights: 1e-6 absolute (float32 products of the same factors); their
    sum 1 within 1e-5 (tests/test_pm.py:139);
  * forces of the mesh solvers: 1e-5 * max|a|, tests/test_torch_p3m.py's
    long-range bound (the FFTs are other libraries', with other rounding;
    measured 2e-7 to 9e-7 * max|a| at N=1024, G=32);
  * the whole P3M force with TSC or the naive influence: rtol 1e-4, atol
    2e-4, the bound between nbody_tpu's two short-range engines
    (tests/test_p3m.py:367), as tests/test_torch_p3m.py holds CIC;
  * the slab solve against the replicated one: rtol / atol 1e-4
    (tests/test_pm.py:182-204), and bit for bit on one rank, where both are
    the same solve;
  * a 3-step rollout: rtol 1e-4, atol 1e-4 (tests/test_torch_p3m.py), and
    in float64 the same: the force is float32 in both packages."""

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
from nbody_tpu_torch.ops import p3m, pm
from nbody_tpu_torch.params import NBodyParams

SOFT = 0.1
LR_TOL = 1e-5
RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cloud():
    pos, _ = jax_ic.generate(JaxNBodyConfig.SHELL, 1024, 1.54, 8.0, seed=3)
    return pos


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _close(ours, theirs, tol=LR_TOL):
    theirs = np.asarray(theirs)
    assert np.abs(np.asarray(ours) - theirs).max() <= tol * np.abs(theirs).max()


@pytest.mark.parametrize("influence", ["none", "naive", "optimal"])
@pytest.mark.parametrize("assignment", ["cic", "tsc"])
def test_pm_accel_matches_nbody_tpu(cloud, assignment, influence):
    ours = pm.pm_accel(torch.tensor(cloud), grid=32, assignment=assignment, influence=influence)
    _close(ours.numpy(), jax_pm.pm_accel(jnp.asarray(cloud), grid=32, assignment=assignment,
                                         influence=influence))


def test_tsc_components_match_nbody_tpu(cloud):
    t = torch.tensor(cloud)
    lo, h = pm._fit_box(t[:, :3], 32)
    jlo, jh = jax_pm._fit_box(jnp.asarray(cloud[:, :3]), 32)
    ours = pm._tsc_components(t[:, :3], lo, h, 32)
    theirs = jax_pm._tsc_components(jnp.asarray(cloud[:, :3]), jlo, jh, 32)
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ours[3].numpy(), np.asarray(theirs[3]), rtol=0, atol=1e-6)
    idx, _ = pm._tsc_indices_weights(t[:, :3], lo, h, 32)
    jidx, _ = jax_pm._tsc_indices_weights(jnp.asarray(cloud[:, :3]), jlo, jh, 32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_tsc_weights_sum_to_one():
    """tests/test_pm.py:129-142: 27 weights a body summing to 1, and the
    deposit keeps the total mass."""
    rng = np.random.default_rng(0)
    pos3 = torch.tensor(rng.uniform(-3, 3, (512, 3)), dtype=torch.float32)
    lo, h = pm._fit_box(pos3, 32)
    idx, w = pm._tsc_indices_weights(pos3, lo, h, 32)
    assert idx.shape == (27, 512) and w.shape == (27, 512)
    np.testing.assert_allclose(w.sum(0).numpy(), 1.0, atol=1e-5)
    rho = pm._deposit(idx, w, torch.ones(512), 32)
    np.testing.assert_allclose(float(rho.sum()), 512.0, rtol=1e-5)


def test_plain_greens_kernel():
    r2 = torch.tensor([0.0, 1.0, 4.0])
    np.testing.assert_array_equal(pm._greens_kernel(r2).numpy(), [0.0, 1.0, 0.5])
    np.testing.assert_allclose(pm._greens_kernel(r2).numpy(),
                               np.asarray(jax_pm._greens_kernel(jnp.asarray(r2.numpy()))))


@pytest.mark.parametrize("assignment", ["cic", "tsc"])
def test_one_slab_is_the_replicated_solve(cloud, assignment):
    """The slab pipeline on one rank (the whole padded grid, no transpose)
    is the replicated solve, bit for bit, deposit and gather included."""
    t = torch.tensor(cloud)
    pos3, mass = t[:, :3], t[:, 3]
    lo, h = pm._fit_box(pos3, 16)
    assign, wexp = pm.ASSIGNMENTS[assignment]
    comp, _ = pm.ASSIGNMENT_COMPONENTS[assignment]
    idx, w = assign(pos3, lo, h, 16)
    ix, iy, iz, wc = comp(pos3, lo, h, 16)
    for kw in ({}, {"sigma": 1.5 * h, "deconvolve": "optimal", "sigma_cells": 1.5},
               {"deconvolve": True}):
        rep = pm._gather(pm._solve_force_grids(pm._deposit(idx, w, mass, 16), h, 16,
                                               window_exp=wexp, **kw), idx, w)
        rho = pm._deposit_slab(ix, iy, iz, wc, mass, 16, 0, 32)
        slab = pm._gather_slab(pm._solve_force_grids_slab(rho, h, 16, window_exp=wexp, **kw),
                               ix, iy, iz, wc, 0, 32, 16)
        assert torch.equal(rep, slab), kw


@pytest.mark.parametrize("assignment", ["cic", "tsc"])
def test_replicated_solve_matches_nbody_tpu_slab(cloud, assignment):
    """nbody_tpu's own slab-against-replicated bound (tests/test_pm.py:
    182-204) between the port's solve and nbody_tpu's replicated solve."""
    ours = pm.pm_accel(torch.tensor(cloud), grid=16, assignment=assignment)
    theirs = np.asarray(jax_pm.pm_accel(jnp.asarray(cloud), grid=16, assignment=assignment))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("assignment, influence", [("cic", "naive"), ("tsc", "optimal"),
                                                   ("tsc", "naive")])
def test_p3m_options_match_nbody_tpu(cloud, assignment, influence):
    t = torch.tensor(cloud)
    _close(p3m.p3m_long_range(t, grid=32, assignment=assignment, influence=influence).numpy(),
           _jax_long_range(cloud, assignment, influence))
    ours, ovf = p3m.p3m_accel(t, SOFT, grid=32, capacity=64, assignment=assignment,
                              influence=influence)
    theirs, jovf = jax_p3m.p3m_accel(jnp.asarray(cloud), SOFT, grid=32, capacity=64,
                                     assignment=assignment, influence=influence)
    assert int(ovf) == int(jovf) == 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def _jax_long_range(pos, assignment, influence):
    def lr(p):
        pos3, mass = p[:, :3], p[:, 3]
        lo, h = jax_pm._fit_box(pos3, 32)
        assign, wexp = jax_pm.ASSIGNMENTS[assignment]
        idx, w = assign(pos3, lo, h, 32)
        rho = jax_pm._deposit(idx, w, mass, 32)
        return jax_pm._gather(jax_pm._solve_force_grids(
            rho, h, 32, sigma=jnp.float32(jax_p3m.SIGMA_CELLS) * h,
            deconvolve="optimal" if influence == "optimal" else True, window_exp=wexp,
            sigma_cells=jax_p3m.SIGMA_CELLS), idx, w)

    return np.asarray(jax.jit(lr)(jnp.asarray(pos)))


def test_options_are_checked(cloud):
    t = torch.tensor(cloud)
    with pytest.raises(ValueError, match="influence"):
        pm.pm_accel(t, influence="exact")
    with pytest.raises(ValueError, match="pm_assignment"):
        pm.pm_accel(t, assignment="pcs")
    with pytest.raises(ValueError, match="influence"):
        p3m.p3m_accel(t, SOFT, influence="none")
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 #16"):
        BodySystem(64, NBodyParams(), device="cpu", kernel="p3m", p3m_short_range="xla")
    with pytest.raises(ValueError, match="divide the padded grid"):
        pm.check_slab("slab", 16, 3)
    with pytest.raises(ValueError, match="kernel='pm'"):
        BodySystem(64, NBodyParams(), device="cpu", backend="pm")


def test_nbody_step_pm_matches_nbody_tpu():
    pos, vel = jax_ic.generate(JaxNBodyConfig.RANDOM, 256, 1.5, 2.0, seed=1)
    for assignment in ("cic", "tsc"):
        p1, v1 = pm.nbody_step_pm(torch.tensor(pos), torch.tensor(vel), 0.001, 0.1, 0.999,
                                  grid=32, assignment=assignment)
        q1, w1 = jax_pm.nbody_step_pm(jnp.asarray(pos), jnp.asarray(vel), 0.001, 0.1, 0.999,
                                      grid=32, assignment=assignment)
        np.testing.assert_array_equal(p1.numpy()[:, 3], pos[:, 3])
        np.testing.assert_allclose(p1.numpy(), np.asarray(q1), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(v1.numpy(), np.asarray(w1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("kernel, assignment", [("pm", "cic"), ("pm", "tsc"), ("p3m", "tsc")])
def test_body_system_matches_nbody_tpu(kernel, assignment, integrator):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 512, 1.54, 8.0, seed=0)
    theirs = JaxBodySystem(512, JaxNBodyParams(), backend=kernel, pm_grid=32,
                           pm_assignment=assignment, p3m_short_range="xla",
                           integrator=integrator, state=(pos, vel))
    ours = BodySystem(512, NBodyParams(), device="cpu", kernel=kernel, pm_grid=32,
                      pm_assignment=assignment, integrator=integrator, state=(pos, vel))
    assert ours.p3m_capacity == theirs.p3m_capacity
    theirs.update_many(3)
    ours.update_many(3)
    np.testing.assert_allclose(ours.positions, np.asarray(theirs.positions), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours.velocities, np.asarray(theirs.velocities),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["pm", "p3m"])
def test_float64_mesh_solver_matches_nbody_tpu(x64, kernel):
    """BodySystem(dtype=float64, kernel=pm|p3m) does what nbody_tpu's does:
    the force from the float32 positions, the update in float64."""
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 512, 1.54, 8.0, seed=0, dtype=np.float64)
    theirs = JaxBodySystem(512, JaxNBodyParams(), dtype=jnp.float64, backend=kernel, pm_grid=32,
                           p3m_short_range="xla", state=(pos, vel))
    ours = BodySystem(512, NBodyParams(), device="cpu", dtype=torch.float64, kernel=kernel,
                      pm_grid=32, state=(pos, vel))
    assert ours.kernel == kernel and ours.positions.dtype == np.float64
    theirs.update_many(3)
    ours.update_many(3)
    np.testing.assert_allclose(ours.positions, np.asarray(theirs.positions), rtol=1e-4, atol=1e-4)
    back = ours.switch_precision()
    assert back.kernel == kernel and back.dtype == torch.float32


def test_switch_precision_runs_the_exact_force_in_float64():
    """nbody_tpu's float64 hop runs its XLA all-pairs force
    (body_system.py:1375-1381); the way back restores the mesh solver."""
    s = BodySystem(256, NBodyParams(), device="cpu", kernel="p3m", pm_grid=32, seed=1)
    f64 = s.switch_precision()
    assert f64.kernel == "auto" and f64.dtype == torch.float64
    back = f64.switch_precision()
    assert back.kernel == "p3m" and back.dtype == torch.float32
    c = Compute(num_bodies=256, device="cpu", precision="fp64", kernel="p3m", log=lambda s: None)
    assert c.system.kernel == "auto" and c.system.dtype == torch.float64


def test_refresh_p3m_contract_resizes():
    """tests/test_p3m.py:514-525."""
    s = BodySystem(512, NBodyParams(), device="cpu", kernel="p3m", pm_grid=32, seed=0)
    theirs = JaxBodySystem(512, JaxNBodyParams(), backend="p3m", pm_grid=32, seed=0,
                           p3m_short_range="xla")
    cap0 = s.p3m_capacity
    s.p3m_capacity = theirs.p3m_capacity = 1
    s.refresh_p3m_contract()
    theirs.refresh_p3m_contract()
    assert s.p3m_capacity == theirs.p3m_capacity >= cap0
    s.update_many(2, 0.001)
    assert np.isfinite(s.positions).all()
    with pytest.raises(ValueError, match="kernel='p3m'"):
        BodySystem(64, NBodyParams(), device="cpu", kernel="pm").refresh_p3m_contract()


def _collapsing(**kw):
    """tests/test_p3m.py:528-545's infalling shell, in both packages."""
    n = 512
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.9, 1.1, size=(n, 1))
    pos = np.concatenate([dirs * radii, np.ones((n, 1))], 1).astype(np.float32)
    vel = np.concatenate([-dirs * 2.0, np.zeros((n, 1))], 1).astype(np.float32)
    params = dict(time_step=0.01, softening=0.05, damping=1.0)
    return ((n, JaxNBodyParams(**params)), (n, NBodyParams(**params)), (pos, vel))


def test_auto_refresh_matches_nbody_tpus():
    """tests/test_p3m.py:639-: a breached rollout rewinds to the breach step,
    re-sizes from that state and resumes: no warning, the capacity grown to
    nbody_tpu's, the last state within it."""
    (n, jparams), (_, params), state = _collapsing()
    theirs = JaxBodySystem(n, jparams, backend="p3m", pm_grid=16, p3m_short_range="xla",
                           p3m_auto_refresh=True, state=state)
    ours = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, p3m_auto_refresh=True,
                      state=state)
    cap0 = ours.p3m_capacity
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        theirs.update_many(60, 0.01)
        ours.update_many(60, 0.01)
    assert not any("contract broken" in str(x.message) for x in w)
    assert ours.p3m_capacity > cap0 and ours.p3m_refreshes
    assert ours.p3m_capacity == theirs.p3m_capacity
    assert int(p3m.p3m_overflow_count(ours.state[0], grid=16,
                                      capacity=ours.p3m_capacity)) == 0
    # the shell collapses through its centre: past the breach the two
    # trajectories part by float32 rounding, so only the contract is compared
    assert np.isfinite(ours.positions).all()
    steps = [s for s, _, _ in ours.p3m_refreshes]
    assert steps == sorted(steps) and steps[-1] < 60


def test_rewind_resumes_from_the_breached_state():
    """The rewind keeps every step up to the first breached one: a run with
    the auto-refresh equals, up to that step, the same steps without it."""
    (n, _), (_, params), state = _collapsing()
    plain = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state)
    first = plain._probed_steps(60, 0.01)
    assert first >= 1
    a = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.update_many(first + 1, 0.01)
    b = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state,
                   p3m_auto_refresh=True)
    b.update_many(first + 1, 0.01)
    assert b.p3m_refreshes == [(first, a.p3m_capacity, b.p3m_capacity)]
    np.testing.assert_array_equal(a.positions, b.positions)


def test_compute_qa_of_pm_gates_positions_only():
    lines = []
    c = Compute(num_bodies=1024, device="cpu", kernel="pm", pm_grid=32, log=lines.append)
    assert c.compare_results()
    assert "pm force against the all-pairs force (not gated)" in lines[-1]
    assert "max |dacc|" not in lines[-1]


def test_cli_pm_and_p3m_options_on_the_cpu(capsys):
    assert main(["--kernel", "pm", "--pm-grid", "32", "--cpu", "--qatest",
                 "--numbodies", "512"]) == 0
    assert "-> OK" in capsys.readouterr().out
    assert main(["--kernel", "pm", "--pm-assignment", "tsc", "--cpu", "--benchmark",
                 "--numbodies", "512", "-i", "2", "--integrator", "leapfrog"]) == 0
    out = capsys.readouterr().out
    assert "pairwise-equivalent rate: the pm solver" in out and "force pm (grid 64, tsc)" in out
    assert main(["--kernel", "p3m", "--pm-assignment", "tsc", "--p3m-short-range", "pallas",
                 "--p3m-auto-refresh", "--cpu", "--qatest", "--numbodies", "512"]) == 0
    assert "-> OK" in capsys.readouterr().out
    assert main(["--kernel", "pm", "--cpu", "--drift-check", "2", "--numbodies", "256"]) == 0
    assert "exit-code gate applies to exact kernels only" in capsys.readouterr().out
    assert main(["--kernel", "pm", "--cpu", "--frames", "2", "--numbodies", "256",
                 "--no-cycle"]) == 0
    # the XLA cell-list engine is the one option still refused
    assert main(["--kernel", "p3m", "--p3m-short-range", "xla", "--cpu", "--qatest",
                 "--numbodies", "256"]) == 2
    assert "ROADMAP.md Queue 1 #16" in capsys.readouterr().err
    # fp64 runs the exact force, as nbody_tpu's does, so the force is gated
    assert main(["--fp64", "--kernel", "p3m", "--cpu", "--qatest", "--numbodies", "256"]) == 0
    out = capsys.readouterr().out
    assert "max |dacc|" in out and "-> OK" in out
