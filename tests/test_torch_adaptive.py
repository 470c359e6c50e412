"""The port's adaptive global timestep (ops/adaptive.py,
BodySystem.update_many_adaptive, DSBodySystem.update_many_adaptive,
ds.ds_scal_with_dt, Compute, the CLI) against nbody_tpu.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs ``BodySystem(backend="xla")`` (its float64 with x64 on) and its ds
system with Pallas in interpret mode, as tests/test_adaptive.py and
tests/test_ds_kernel.py run them; the port runs its plain versions, which
are what its kernels take on a CPU tensor. Tolerances:

* the criteria, rtol 1e-6;
* fp32 adaptive Euler, leapfrog and Hermite: positions and velocities at
  atol 2e-5 (tests/test_adaptive.py:142), the stats t, dt_lo, dt_hi at
  rtol 1e-5; a fixed window (dt_min = dt_max) equals fixed-dt
  ``update_many`` at atol 1e-6 (tests/test_adaptive.py:54-72);
* float64, 1e-12 of each output's largest value (tests/test_torch_fp64.py);
* ``ds_scal_with_dt``: bit for bit;
* ds: a fixed window of a power-of-two dt against ds ``update_many``, bit
  for bit for Euler and leapfrog and within 5e-13 for Hermite (the 1/6
  pair, tests/test_ds_kernel.py:874-897); a free window's dt sequence at
  rtol 1e-6 and the state at 1e-6 relative: the dt comes from a float32
  criterion, so an ulp of the force moves it;
* pm: positions at atol 1e-4 and stats at rtol 1e-4
  (tests/test_adaptive.py:298-325); P3M: the breach step of a fixed
  window equals the fixed-dt probe's, and the auto-refresh rewinds there.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.models.ds_system import DSBodySystem as JaxDSBodySystem
from nbody_tpu.ops import adaptive as jax_adaptive
from nbody_tpu.ops import ds_kernel as jax_dsk
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import adaptive, ds
from nbody_tpu_torch.utils import timing

P = dict(damping=1.0)
FP32_ATOL = 2e-5
STATS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(n, integrator, seed, **kw):
    """nbody_tpu's XLA system and the port's, from the same state."""
    theirs = JaxBodySystem(n, JaxNBodyParams(**P), backend="xla", integrator=integrator,
                           seed=seed)
    ours = BodySystem(n, NBodyParams(**P), device="cpu", integrator=integrator,
                      state=(theirs.positions, theirs.velocities), **kw)
    return theirs, ours


def _stats_close(a, b, rtol=STATS_RTOL):
    for k in ("t", "dt_lo", "dt_hi", "dt_last"):
        assert a[k] == pytest.approx(b[k], rel=rtol), k
    assert a["steps"] == b["steps"]


# ---- criteria ----


@pytest.mark.parametrize("seed, eta, window", [
    (0, 0.025, (1e-6, 1.0)), (1, 0.1, (1e-6, 0.01)), (2, 0.1, (0.08, 1.0)), (3, 0.01, (1e-9, 1.0)),
])
def test_criteria_match_nbody_tpu(seed, eta, window):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((300, 3)).astype(np.float32) * 10.0
    jerk = rng.standard_normal((300, 3)).astype(np.float32) * 100.0
    ours = adaptive.accel_timestep(torch.from_numpy(acc), 0.1, eta, *window)
    theirs = jax_adaptive.accel_timestep(acc, 0.1, eta, *window)
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)
    ours = adaptive.aarseth_timestep(torch.from_numpy(acc), torch.from_numpy(jerk), eta, *window)
    theirs = jax_adaptive.aarseth_timestep(acc, jerk, eta, *window)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_criteria_edges():
    """tests/test_adaptive.py:25-50: the formula, both clips, a zero force
    at dt_max, Aarseth's rule with zero jerks."""
    acc = torch.zeros((4, 3))
    acc[0, 0] = 4.0
    assert float(adaptive.accel_timestep(acc, 1.0, 0.1, 1e-6, 1.0)) == pytest.approx(0.05)
    assert float(adaptive.accel_timestep(acc, 1.0, 0.1, 0.08, 1.0)) == pytest.approx(0.08)
    assert float(adaptive.accel_timestep(acc, 1.0, 0.1, 1e-6, 0.01)) == pytest.approx(0.01)
    assert float(adaptive.accel_timestep(torch.zeros((8, 3)), 1.0, 0.1, 1e-6, 0.25)) == 0.25
    jerk = torch.zeros((3, 3))
    jerk[1] = 2.0
    dt = adaptive.aarseth_timestep(torch.ones((3, 3)), jerk, 0.2, 1e-6, 10.0)
    assert float(dt) == pytest.approx(0.1, rel=1e-6)


# ---- fp32 ----


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_adaptive_matches_nbody_tpu(integrator, variant):
    theirs, ours = _both(128, integrator, seed=2, variant=variant)
    st = theirs.update_many_adaptive(20, eta=0.01)
    so = ours.update_many_adaptive(20, eta=0.01)
    np.testing.assert_allclose(ours.positions, theirs.positions, atol=FP32_ATOL)
    np.testing.assert_allclose(ours.velocities, theirs.velocities, atol=FP32_ATOL)
    _stats_close(so, st)
    assert st["dt_lo"] < st["dt_hi"]  # the window is free, dt moved


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_fixed_window_equals_update_many(integrator):
    dt = 1e-3
    a = BodySystem(128, NBodyParams(**P), device="cpu", integrator=integrator, seed=3)
    b = BodySystem(128, NBodyParams(**P), device="cpu", integrator=integrator, seed=3)
    a.update_many(20, dt)
    stats = b.update_many_adaptive(20, dt_min=dt, dt_max=dt)
    np.testing.assert_allclose(b.positions, a.positions, atol=1e-6)
    np.testing.assert_allclose(b.velocities, a.velocities, atol=1e-6)
    assert stats["dt_lo"] == stats["dt_hi"] == pytest.approx(dt)
    assert stats["t"] == pytest.approx(20 * dt, rel=1e-5)


def test_segments_merge_and_read_the_stats_once_each(monkeypatch):
    """tests/test_adaptive.py:107-119: a run cut into segments equals the
    uncut run, and each segment reads its stats on the host once."""
    ref = BodySystem(64, NBodyParams(**P), device="cpu", seed=7)
    ref_stats = ref.update_many_adaptive(40, eta=0.01)
    monkeypatch.setattr(BodySystem, "_MAX_ROLLOUT_SEGMENT", 13)
    s = BodySystem(64, NBodyParams(**P), device="cpu", seed=7)
    before = timing.HOST_READS["adaptive_stats"]
    stats = s.update_many_adaptive(40, eta=0.01)
    assert timing.HOST_READS["adaptive_stats"] - before == 4
    np.testing.assert_array_equal(s.positions, ref.positions)
    _stats_close(stats, ref_stats)


def test_host_placement_equals_device():
    a = BodySystem(64, NBodyParams(**P), device="cpu", seed=8, placement="host",
                   integrator="leapfrog")
    b = BodySystem(64, NBodyParams(**P), device="cpu", seed=8, integrator="leapfrog")
    assert a.update_many_adaptive(10) == b.update_many_adaptive(10)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.velocities, b.velocities)


def test_float64_matches_nbody_tpu():
    import jax

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        theirs = JaxBodySystem(128, JaxNBodyParams(**P), backend="xla", integrator="hermite",
                               seed=4, dtype=jnp.float64)
        ours = BodySystem(128, NBodyParams(**P), device="cpu", integrator="hermite",
                          dtype=torch.float64, state=(theirs.positions, theirs.velocities))
        st = theirs.update_many_adaptive(10, eta=0.01)
        so = ours.update_many_adaptive(10, eta=0.01)
        tp = np.asarray(theirs.positions, np.float64)
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert ours.positions.dtype == np.float64
    np.testing.assert_allclose(ours.positions, tp, rtol=0, atol=1e-12 * np.abs(tp).max())
    _stats_close(so, st, rtol=1e-12)


def test_pm_matches_nbody_tpu():
    theirs = JaxBodySystem(512, JaxNBodyParams(**P), backend="pm", integrator="leapfrog",
                           seed=6, pm_grid=16)
    ours = BodySystem(512, NBodyParams(**P), device="cpu", kernel="pm", integrator="leapfrog",
                      pm_grid=16, state=(theirs.positions, theirs.velocities))
    st = theirs.update_many_adaptive(10, eta=0.01)
    so = ours.update_many_adaptive(10, eta=0.01)
    np.testing.assert_allclose(ours.positions, theirs.positions, atol=1e-4)
    _stats_close(so, st, rtol=1e-4)


def _collapsing():
    """tests/test_p3m.py:528-545's infalling shell (tests/test_torch_pm.py)."""
    n = 512
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.9, 1.1, size=(n, 1))
    pos = np.concatenate([dirs * radii, np.ones((n, 1))], 1).astype(np.float32)
    vel = np.concatenate([-dirs * 2.0, np.zeros((n, 1))], 1).astype(np.float32)
    return n, NBodyParams(time_step=0.01, softening=0.05, damping=1.0), (pos, vel)


def test_p3m_breach_warns_at_the_fixed_dt_probes_step():
    """A fixed window is the fixed-dt Euler step, so the contract probe
    carried through the adaptive steps breaches where ``_probed_steps``
    does, and warns once naming that step."""
    n, params, state = _collapsing()
    first = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16,
                       state=state)._probed_steps(60, 0.01)
    assert first >= 1
    s = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stats = s.update_many_adaptive(first + 3, dt_min=0.01, dt_max=0.01)
    broken = [str(x.message) for x in w if "contract broken" in str(x.message)]
    assert len(broken) == 1 and f"adaptive step {first} of {first + 3}" in broken[0]
    assert stats["t"] == pytest.approx((first + 3) * 0.01, rel=1e-5)


def test_p3m_auto_refresh_rewinds_to_the_breach():
    """With p3m_auto_refresh the run rewinds to the breached step, re-sizes
    there and resumes: the rewinds are the fixed-dt run's, the simulated
    time is the whole run's, the last state keeps the contract, and a
    free window runs it too (tests/test_adaptive.py:327-380)."""
    n, params, state = _collapsing()
    fixed = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state,
                       p3m_auto_refresh=True)
    fixed.update_many(40, 0.01)
    s = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state,
                   p3m_auto_refresh=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stats = s.update_many_adaptive(40, dt_min=0.01, dt_max=0.01)
        free = BodySystem(n, params, device="cpu", kernel="p3m", pm_grid=16, state=state,
                          p3m_auto_refresh=True)
        free_stats = free.update_many_adaptive(40, eta=0.2, dt_min=0.002, dt_max=0.05)
    assert not any("contract broken" in str(x.message) for x in w)
    assert s.p3m_refreshes and s.p3m_refreshes == fixed.p3m_refreshes
    assert stats["t"] == pytest.approx(40 * 0.01, rel=1e-5)
    for sys in (s, free):
        from nbody_tpu_torch.ops.p3m import p3m_overflow_count

        assert int(p3m_overflow_count(sys.state[0], grid=16, capacity=sys.p3m_capacity)) == 0
    assert free_stats["t"] > 0 and np.isfinite(free.positions).all()


def test_compute_steps_frames_adaptively():
    """Compute.set_adaptive (nbody_tpu/compute.py:240-290): frames step the
    adaptive rollout, and adaptive_stats sums the simulated time."""
    from nbody_tpu.compute import Compute as JaxCompute

    kw = dict(num_bodies=128, cycle_demo=False, seed=5)
    theirs = JaxCompute(backend="xla", **kw)
    ours = Compute(device="cpu", log=lambda *a: None, **kw)
    ours.system.set_state(theirs.system.positions, theirs.system.velocities)
    for c in (theirs, ours):
        c.set_adaptive(0.02)
        c.update_simulation(steps=3)
        c.update_simulation(steps=2)
    assert ours.adaptive_stats["steps"] == theirs.adaptive_stats["steps"] == 5
    _stats_close(ours.adaptive_stats, theirs.adaptive_stats)
    assert ours.steps_taken == 5
    np.testing.assert_allclose(ours.system.positions, theirs.system.positions, atol=FP32_ATOL)


@pytest.mark.parametrize("build, match", [
    (lambda: BodySystem(64, NBodyParams(**P), device="cpu").update_many_adaptive(
        5, dt_min=0.1, dt_max=0.01), "dt_min"),
    (lambda: BodySystem(64, NBodyParams(**P), device="cpu").update_many_adaptive(
        5, dt_min=0.0, dt_max=0.0), "dt_min"),
    (lambda: BodySystem(64, NBodyParams(**P), device="cpu").update_many_adaptive(
        5, eta=float("nan")), "eta"),
    (lambda: DSBodySystem(64, NBodyParams(**P), device="cpu").update_many_adaptive(
        5, eta=0.0), "eta"),
    (lambda: adaptive.make_adaptive_rollout("rk4", accel_fn=lambda p: p[:, :3], softening=0.1,
                                            damping=1.0, eta=0.1, dt_min=1e-5, dt_max=1e-2,
                                            steps=3), "unknown integrator"),
    (lambda: adaptive.make_adaptive_rollout("hermite", softening=0.1, damping=1.0, eta=0.1,
                                            dt_min=1e-5, dt_max=1e-2, steps=3),
     "accel_jerk_fn"),
    (lambda: adaptive.make_adaptive_rollout("leapfrog", softening=0.1, damping=1.0, eta=0.1,
                                            dt_min=1e-5, dt_max=1e-2, steps=3), "accel_fn"),
])
def test_refusals_in_nbody_tpus_words(build, match):
    with pytest.raises(ValueError, match=match):
        build()


# ---- ds ----


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_ds_scal_with_dt_is_nbody_tpus_bit_for_bit(integrator):
    blocks = {"euler": (ds.scal_ds, jax_dsk._scal_ds),
                "leapfrog": (ds.scal_ds_leapfrog, jax_dsk._scal_ds_leapfrog),
                "hermite": (ds.scal_ds_hermite, jax_dsk._scal_ds_hermite)}[integrator]
    base = blocks[0](0.0, 0.1, 0.5)
    np.testing.assert_array_equal(base.numpy(), np.asarray(blocks[1](0.0, 0.1, 0.5)))
    for dt in np.random.default_rng(1).uniform(1e-5, 0.05, 8).astype(np.float32):
        ours = ds.ds_scal_with_dt(base, torch.tensor(dt), integrator=integrator)
        theirs = jax_dsk.ds_scal_with_dt(jnp.asarray(base.numpy()), dt, integrator=integrator)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("integrator, variant", [("euler", "sym"), ("euler", "one_sided"),
                                                 ("leapfrog", "one_sided"),
                                                 ("hermite", "sym"), ("hermite", "one_sided")])
def test_ds_fixed_window_equals_update_many(integrator, variant):
    dt = 2.0 ** -6
    params = NBodyParams(time_step=dt, softening=0.1, damping=1.0)
    a = DSBodySystem(64, params, device="cpu", seed=11, integrator=integrator, variant=variant)
    b = DSBodySystem(64, params, device="cpu", seed=11, integrator=integrator, variant=variant)
    a.update_many(6, dt)
    stats = b.update_many_adaptive(6, dt_min=dt, dt_max=dt)
    assert stats["dt_lo"] == stats["dt_hi"] == pytest.approx(dt)
    assert stats["t"] == pytest.approx(6 * dt, rel=1e-6)
    tol = 0.0 if integrator != "hermite" else 5e-13
    np.testing.assert_allclose(b.positions, a.positions, rtol=0, atol=tol)
    np.testing.assert_allclose(b.velocities, a.velocities, rtol=0, atol=tol)


@pytest.mark.parametrize("integrator, variant", [("euler", "one_sided"), ("euler", "sym"),
                                                 ("leapfrog", "one_sided"),
                                                 ("hermite", "one_sided")])
def test_ds_adaptive_matches_nbody_tpu(integrator, variant):
    theirs = JaxDSBodySystem(64, JaxNBodyParams(**P), seed=3, interpret=True,
                             integrator=integrator, variant=variant)
    ours = DSBodySystem(64, NBodyParams(**P), device="cpu", integrator=integrator,
                        variant=variant)
    ours.set_ds_state(*theirs.get_ds_state())
    st = theirs.update_many_adaptive(4, eta=0.01)
    so = ours.update_many_adaptive(4, eta=0.01)
    _stats_close(so, st, rtol=1e-6)
    tp = theirs.positions
    assert np.abs(ours.positions - tp).max() <= 1e-6 * np.abs(tp).max()
    tv = theirs.velocities
    assert np.abs(ours.velocities - tv).max() <= 1e-6 * np.abs(tv).max()


def test_ds_adaptive_criterion_is_the_float32_formula():
    """tests/test_ds_kernel.py:900-930: the dt of a step is the float32
    criterion of the hi planes' force (and accel + jerk for Hermite)."""
    params = NBodyParams(time_step=1.0, softening=0.1, damping=1.0)
    s = DSBodySystem(64, params, device="cpu", seed=3)
    acc = s._criterion(s._planes[s._cur])[0]
    expect = float(adaptive.accel_timestep(acc, 0.1, 0.025, 1e-9, 1.0))
    stats = s.update_many_adaptive(1, eta=0.025, dt_min=1e-9, dt_max=1.0)
    assert stats["dt_last"] == expect and 1e-9 < expect < 1.0
    h = DSBodySystem(64, params, device="cpu", seed=3, integrator="hermite")
    acc, jerk = h._criterion(h._planes[h._cur])[0]
    expect = float(adaptive.aarseth_timestep(acc, jerk, 0.025, 1e-9, 1.0))
    stats = h.update_many_adaptive(1, eta=0.025, dt_min=1e-9, dt_max=1.0)
    assert stats["dt_last"] == expect and 1e-9 < expect < 1.0


def test_device_blocks_are_uploaded_once(monkeypatch):
    """ds.scal_on: a block on the device is used where it is and a host
    block is copied there; a ds system's update_many uploads its fixed-dt
    block once a call, not once a step."""
    scal = ds.scal_ds(0.01, 0.1, 1.0)
    assert ds.scal_on(scal, "cpu") is scal
    made = ds.scal_on(scal, torch.device("meta"))
    assert made.device.type == "meta" and tuple(made.shape) == (2, 4)
    uploads = []
    upload = ds.scal_on
    monkeypatch.setattr(ds, "scal_on", lambda s, d: uploads.append(d) or upload(s, d))
    DSBodySystem(64, NBodyParams(), device="cpu", seed=3).update_many(5)
    assert len(uploads) == 1


# ---- the CLI ----


def test_cli_adaptive_demo_reports_and_writes_metrics(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    assert main(["--cpu", "--numbodies", "128", "--frames", "3", "--no-cycle", "--adaptive-dt",
                 "0.01", "--energy", "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "energy: E0=" in out
    assert main(["--cpu", "--numbodies", "128", "--frames", "2", "--no-cycle",
                 "--precision", "ds", "--adaptive-dt", "0.02", "--integrator", "hermite"]) == 0
    assert "double-single" in capsys.readouterr().out


def test_cli_adaptive_report_line(monkeypatch, tmp_path, capsys):
    """The report's dt= and t= notes and the --metrics fields
    (nbody_tpu/cli.py:1024-1066), on a clock that reports every frame."""
    import json
    import time

    clock = iter(range(0, 1000, 2))
    monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
    metrics = tmp_path / "m.jsonl"
    assert main(["--cpu", "--numbodies", "128", "--frames", "2", "--no-cycle", "--adaptive-dt",
                 "--dt-max", "0.01", "--metrics", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "| dt=" in out and " t=0.0" in out
    record = json.loads(metrics.read_text().splitlines()[-1])
    assert 0 < record["dt_last"] <= 0.01 and record["sim_t"] > 0
