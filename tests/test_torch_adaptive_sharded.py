"""The port's sharded adaptive rollouts (parallel/sharded.py:
``make_sharded_adaptive_rollout``, ``make_sharded_adaptive_rollout_2d``,
``make_sharded_ds_adaptive_rollout``, ``make_sharded_ds_adaptive_rollout_2d``,
and the systems' ``update_many_adaptive`` on a mesh) on 2 and 4 gloo ranks
(tests/test_torch_sharded_ranks.py), against the port's single-device
adaptive rollout, which tests/test_torch_adaptive.py holds to nbody_tpu, and
against nbody_tpu's sharded adaptive rollouts on its virtual devices.

Inputs are made with numpy from a seed. Tolerances, nbody_tpu's
(tests/test_adaptive.py:198-325, tests/test_ds_kernel.py:406-445, 961-998):

* fp32: allgather (and auto, which is allgather at these sizes) equal to
  one device bit for bit; ring at atol 1e-5 and stats at rtol 1e-5; sym at
  atol 1e-4 and stats at rtol 1e-4 (float32 summation order moves dt); the
  2-D grid at atol 1e-5, stats at rtol 1e-5;
* ds, 1-D: the criterion's rows are one device's, so the same dt sequence
  (stats at rtol 1e-6) and the planes within 1e-12 (Euler) or 1.5e-8
  (leapfrog, Hermite) of one device's; the 2x2 grid: dt at rtol 1e-5 (the
  criterion's column partials are summed across ranks) and positions within
  1e-6;
* pm on a mesh: positions at atol 1e-4 and stats at rtol 1e-4; P3M on a
  mesh: the auto-refresh rewinds and keeps the contract;
* against nbody_tpu's sharded rollouts: fp32 positions at atol 2e-5, stats
  at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.parallel import make_mesh as jax_make_mesh
from nbody_tpu.params import NBodyParams as JaxNBodyParams
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import p3m
from nbody_tpu_torch.parallel import (
    Mesh,
    make_sharded_adaptive_rollout,
    make_sharded_ds_adaptive_rollout,
)

P = dict(damping=1.0)
N = 256
STEPS = 12
AKW = dict(eta=0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"adaptive{d}") / "store"))
            for d in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(seed=10, n=N):
    s = JaxBodySystem(n, JaxNBodyParams(**P), backend="xla", seed=seed)
    return s.positions, s.velocities


def _single(kind, state, kw, steps=STEPS, akw=AKW, n=N):
    cls = DSBodySystem if kind == "ds" else BodySystem
    s = cls(n, NBodyParams(**P), device="cpu", state=state, **kw)
    stats = s.update_many_adaptive(steps, **akw)
    return s.positions, s.velocities, stats


def _stats_close(a, b, rtol):
    for k in ("t", "dt_lo", "dt_hi", "dt_last"):
        assert a[k] == pytest.approx(b[k], rel=rtol), k


def _ranks_agree(out):
    for pos, vel, stats, _ in out[1:]:
        np.testing.assert_array_equal(pos, out[0][0])
        assert stats == out[0][2]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("strategy, atol, rtol", [("allgather", 0.0, 0.0), ("auto", 0.0, 0.0),
                                                  ("ring", 1e-5, 1e-5), ("sym", 1e-4, 1e-4)])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_fp32_mesh_matches_one_device(pools, d, strategy, atol, rtol, integrator):
    state = _state()
    variant = "sym" if strategy == "sym" else "vpu"
    pos, vel, stats = _single("fp32", state, {"integrator": integrator, "variant": variant})
    out = pools[d].run("adaptive", "fp32", N, NBodyParams(**P),
                       {"integrator": integrator, "strategy": strategy}, state, STEPS, AKW)
    _ranks_agree(out)
    got_pos, got_vel, got_stats, resolved = out[0]
    assert resolved == ("allgather" if strategy == "auto" else strategy)
    np.testing.assert_allclose(got_pos, pos, rtol=0, atol=atol)
    np.testing.assert_allclose(got_vel, vel, rtol=0, atol=atol)
    if rtol:
        _stats_close(got_stats, stats, rtol)
    else:
        assert got_stats == stats


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_fp32_grid_matches_one_device(pools, integrator):
    state = _state()
    pos, _, stats = _single("fp32", state, {"integrator": integrator, "variant": "vpu"})
    out = pools[4].run("adaptive", "fp32", N, NBodyParams(**P), {"integrator": integrator},
                       state, STEPS, AKW, 2)
    _ranks_agree(out)
    assert out[0][3] == "2d"
    np.testing.assert_allclose(out[0][0], pos, atol=1e-5)
    _stats_close(out[0][2], stats, 1e-5)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_fp32_mesh_matches_nbody_tpu(pools, strategy):
    state = _state(seed=11)
    theirs = JaxBodySystem(N, JaxNBodyParams(**P), backend="xla", integrator="leapfrog",
                           state=state, mesh=jax_make_mesh(4), strategy=strategy)
    st = theirs.update_many_adaptive(STEPS, **AKW)
    out = pools[4].run("adaptive", "fp32", N, NBodyParams(**P),
                       {"integrator": "leapfrog", "strategy": strategy}, state, STEPS, AKW)
    np.testing.assert_allclose(out[0][0], theirs.positions, atol=2e-5)
    _stats_close(out[0][2], st, 1e-5)


def _ds_state():
    pos, vel = _state(seed=9, n=128)
    return pos.astype(np.float64), vel.astype(np.float64)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("integrator, strategy", [("euler", "allgather"), ("euler", "ring"),
                                                  ("leapfrog", "allgather"),
                                                  ("hermite", "allgather")])
def test_ds_mesh_matches_one_device(pools, d, integrator, strategy):
    """A 1-D mesh runs the allgather decomposition whatever its strategy
    (nbody_tpu/models/ds_system.py:387-402)."""
    state = _ds_state()
    akw = dict(eta=0.025, dt_min=1e-6, dt_max=0.016)
    pos, vel, stats = _single("ds", state, {"integrator": integrator, "variant": "one_sided"},
                              steps=3, akw=akw, n=128)
    out = pools[d].run("adaptive", "ds", 128, NBodyParams(**P),
                       {"integrator": integrator, "strategy": strategy}, state, 3, akw)
    _ranks_agree(out)
    tol = 1e-12 if integrator == "euler" else 3 * 5e-9
    assert np.abs(out[0][0] - pos).max() < tol
    assert np.abs(out[0][1] - vel).max() < tol
    _stats_close(out[0][2], stats, 1e-6)
    assert 1e-6 < stats["dt_last"] < 0.016


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_ds_grid_matches_one_device(pools, integrator):
    state = _ds_state()
    akw = dict(eta=0.02, dt_min=1e-5, dt_max=1e-3)
    pos, _, stats = _single("ds", state, {"integrator": integrator, "variant": "one_sided"},
                            steps=3, akw=akw, n=128)
    out = pools[4].run("adaptive", "ds", 128, NBodyParams(**P), {"integrator": integrator},
                       state, 3, akw, 2)
    _ranks_agree(out)
    _stats_close(out[0][2], stats, 1e-5)
    assert np.abs(out[0][0] - pos).max() < 1e-6


@pytest.mark.parametrize("kind, rows", [("fp32", None), ("fp32", 2), ("ds", None), ("ds", 2)])
def test_public_rollouts_match_one_device(pools, kind, rows):
    """The four public sharded adaptive rollouts, called as a user calls
    them on a rank's shard."""
    state = _ds_state()
    kw = dict(integrator="leapfrog", softening=0.1, damping=1.0, eta=0.02, dt_min=1e-5,
              dt_max=1e-3, steps=3)
    pos, _, stats = _single(kind, state, {"integrator": "leapfrog", **(
        {"variant": "one_sided"} if kind == "ds" else {})}, steps=3,
        akw=dict(eta=0.02, dt_min=1e-5, dt_max=1e-3), n=128)
    out = pools[4].run("adaptive_rollout", kind, kw, state, rows)
    got = np.concatenate([o[0] for o in out])
    for o in out[1:]:
        np.testing.assert_array_equal(o[1], out[0][1])
    tol = 1e-6 if kind == "ds" else 1e-5
    assert np.abs(got - pos).max() < tol
    np.testing.assert_allclose(out[0][1][0], stats["t"], rtol=1e-5)


def test_pm_mesh_matches_one_device(pools):
    s = JaxBodySystem(512, JaxNBodyParams(**P), backend="xla", seed=10)
    state = (s.positions, s.velocities)
    kw = {"kernel": "pm", "pm_grid": 16, "integrator": "leapfrog"}
    pos, _, stats = _single("fp32", state, kw, steps=10, n=512)
    out = pools[2].run("adaptive", "fp32", 512, NBodyParams(**P), kw, state, 10, AKW)
    _ranks_agree(out)
    np.testing.assert_allclose(out[0][0], pos, atol=1e-4)
    _stats_close(out[0][2], stats, 1e-4)


def test_p3m_mesh_auto_refresh_rewinds(pools):
    """The probe rides the adaptive steps on a mesh: with the auto-refresh
    the run rewinds, re-sizes and keeps the contract, every rank alike; a
    fixed window rewinds where one device's does."""
    n = 512
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.9, 1.1, size=(n, 1))
    pos = np.concatenate([dirs * radii, np.ones((n, 1))], 1).astype(np.float32)
    vel = np.concatenate([-dirs * 2.0, np.zeros((n, 1))], 1).astype(np.float32)
    params = NBodyParams(time_step=0.01, softening=0.05, damping=1.0)
    window = dict(dt_min=0.01, dt_max=0.01)
    out = pools[2].run("p3m_adaptive", n, params, {"pm_grid": 16}, (pos, vel), 40, True, window)
    one = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=(pos, vel),
                     p3m_auto_refresh=True)
    one.update_many_adaptive(40, **window)
    assert out[0][3] == one.p3m_refreshes
    for broken, cap0, cap, refreshes, stats, positions in out:
        assert not broken and cap > cap0 and refreshes and stats["t"] > 0
        assert int(p3m.p3m_overflow_count(torch.tensor(positions), grid=16, capacity=cap)) == 0
        np.testing.assert_array_equal(positions, out[0][5])


def _fake_mesh():
    return Mesh(axis="bodies", size=2, rank=0, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("build, match", [
    (lambda: BodySystem(64, NBodyParams(**P), device="cpu", mesh=_fake_mesh(),
                        strategy="ring_fused").update_many_adaptive(5), "ring_fused"),
    (lambda: make_sharded_adaptive_rollout(_fake_mesh(), softening=0.1, damping=1.0, eta=0.01,
                                           dt_min=1e-5, dt_max=1e-2, steps=3,
                                           strategy="ring_fused"), "'auto'/'sym'"),
    (lambda: make_sharded_adaptive_rollout(_fake_mesh(), softening=0.1, damping=1.0, eta=0.01,
                                           dt_min=1e-5, dt_max=1e-2, steps=3,
                                           integrator="rk4"), "unknown integrator"),
    (lambda: make_sharded_ds_adaptive_rollout(_fake_mesh(), softening=0.1, damping=1.0,
                                              eta=0.01, dt_min=0.1, dt_max=1e-2, steps=3),
     "dt_min"),
])
def test_refusals_in_nbody_tpus_words(build, match):
    with pytest.raises(ValueError, match=match):
        build()
