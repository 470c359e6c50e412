"""The port's per-body block timesteps (ops/block_timestep.py,
BodySystem.update_many_block, Compute.set_block, the CLI's --block-dt)
against nbody_tpu's (ops/block_timestep.py, BodySystem.update_many_block on
its XLA backend).

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain one-sided force, which its kernel takes on a CPU tensor.
Tolerances: ``block_schedule`` and ``classify`` equal; the stats rows,
global_rows, k_max and macro_steps equal and t equal, the padding of N to
nbody_tpu's 256-row tile included (N = 300); the state at rtol / atol 1e-5
(tests/test_block_timestep.py:177-192), K = 1 equal to the KDK leapfrog of
the adaptive rollout with its window fixed at dt_max
(tests/test_block_timestep.py:73-95); a force chained across calls equal to
one uninterrupted run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import block_timestep as jax_bt
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import adaptive, block_timestep, reference
from nbody_tpu_torch.parallel import Mesh
from nbody_tpu_torch.utils import timing

SOFT = 0.1
PRM = dict(time_step=2e-3, softening=SOFT, damping=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
def test_block_schedule_is_nbody_tpus(k):
    t, s = block_timestep.block_schedule(k)
    jt, js = jax_bt.block_schedule(k)
    assert s == js and t.dtype == jt.dtype
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classify_is_nbody_tpus(seed):
    rng = np.random.default_rng(seed)
    acc = (rng.standard_normal((2000, 3)) * 10.0 ** rng.uniform(-3, 3, (2000, 1)))
    acc = acc.astype(np.float32)
    acc[:5] = 0.0  # no force: dt_max's rung
    for eta, dt_max, k in ((0.025, 0.016, 4), (0.1, 0.25, 6), (1.0, 1.0, 1)):
        ours = block_timestep.classify(torch.from_numpy(acc), SOFT, eta, dt_max, k)
        theirs = jax_bt.classify(jnp.asarray(acc), SOFT, eta, dt_max, k)
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_classify_largest_rung_not_exceeding():
    """tests/test_block_timestep.py:51-70."""
    eta, dt_max, k = 1.0, 1.0, 4
    dts = [2.0, 1.0, 0.6, 0.5, 0.26, 0.01]
    acc = torch.zeros((len(dts), 3))
    acc[:, 0] = torch.tensor([SOFT * (eta / d) ** 2 for d in dts])
    got = block_timestep.classify(acc, SOFT, eta, dt_max, k)
    np.testing.assert_array_equal(got.numpy(), [0, 0, 1, 1, 2, 3])


@pytest.mark.parametrize("n, classes, eta", [(256, 3, 0.1), (300, 4, 0.05), (512, 4, 0.02),
                                             (300, 1, 0.1)])
def test_update_many_block_matches_nbody_tpu(n, classes, eta):
    theirs = JaxBodySystem(n, JaxNBodyParams(**PRM), backend="xla", seed=5)
    ours = BodySystem(n, NBodyParams(**PRM), device="cpu",
                      state=(theirs.positions, theirs.velocities))
    for macro in (3, 2):  # the second call chains the carried force
        st = theirs.update_many_block(macro, eta=eta, n_classes=classes)
        so = ours.update_many_block(macro, eta=eta, n_classes=classes)
        assert so == st
        np.testing.assert_allclose(ours.positions, theirs.positions, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours.velocities, theirs.velocities, rtol=1e-5, atol=1e-5)
    assert st["rows"] <= st["global_rows"]


def test_k1_is_the_kdk_leapfrog():
    """K = 1 is the KDK leapfrog at dt_max: the adaptive leapfrog with its
    window fixed there, force for force."""
    pos, vel = (torch.from_numpy(np.array(a)) for a in JaxBodySystem(
        256, JaxNBodyParams(**PRM), backend="xla", seed=7).state)
    dt = 1e-3

    def accel_vs(pi, pj):
        return reference.compute_accel_vs(pi, pj, SOFT)

    run = block_timestep.make_block_rollout(softening=SOFT, eta=1e9, dt_max=dt, n_classes=1,
                                            macro_steps=8, accel_vs_fn=accel_vs)
    bp, bv, _, stats = run(pos.clone(), vel.clone(), accel_vs(pos, pos))
    ref = adaptive.make_adaptive_rollout(
        "leapfrog", accel_fn=lambda p: accel_vs(p, p), softening=SOFT, damping=1.0, eta=1e9,
        dt_min=dt, dt_max=dt, steps=8)
    rp, rv, rstats = ref(pos.clone(), vel.clone())
    np.testing.assert_array_equal(bp.numpy(), rp.numpy())
    np.testing.assert_array_equal(bv.numpy(), rv.numpy())
    assert float(stats[0]) == pytest.approx(float(rstats[0]), rel=1e-6)
    assert float(stats[1]) == 8 * 256


def test_rows_scale_with_the_active_population():
    """tests/test_block_timestep.py:127-155: 256 tight bodies in a loose
    halo of 3840: the interior boundaries are charged about the tight
    prefix only, and the stats are nbody_tpu's."""
    n, n_tight = 4096, 256
    rng = np.random.default_rng(0)
    pos = np.zeros((n, 4), np.float32)
    pos[:, :3] = rng.normal(size=(n, 3)) * 50.0
    pos[:n_tight, :3] = rng.normal(size=(n_tight, 3)) * 0.05
    pos[:, 3] = 1.0 / n
    vel = np.zeros((n, 4), np.float32)
    prm = dict(time_step=0.25, softening=SOFT, damping=1.0)
    theirs = JaxBodySystem(n, JaxNBodyParams(**prm), backend="xla", state=(pos, vel))
    ours = BodySystem(n, NBodyParams(**prm), device="cpu", state=(pos, vel))
    st = theirs.update_many_block(1, eta=0.02, n_classes=4)
    so = ours.update_many_block(1, eta=0.02, n_classes=4)
    assert so == st
    assert so["k_max"] >= 1 and so["rows"] <= n + 7 * (2 * n_tight + 256)
    assert so["rows"] < 0.5 * so["global_rows"]


def test_force_is_chained_across_calls_until_the_state_changes(monkeypatch):
    """tests/test_block_timestep.py:225-256: a second call reuses the
    macro-end force of the first (one uninterrupted run's trajectory, bit
    for bit); a state set, a step or a softening change invalidates it."""
    a = BodySystem(256, NBodyParams(**PRM), device="cpu", seed=7)
    ref = BodySystem(256, NBodyParams(**PRM), device="cpu", seed=7)
    ref.update_many_block(4, eta=0.1, n_classes=3)
    a.update_many_block(2, eta=0.1, n_classes=3)
    calls = []
    real = BodySystem._accel

    def counted(self, pos):
        calls.append(pos.shape[0])
        return real(self, pos)

    monkeypatch.setattr(BodySystem, "_accel", counted)
    a.update_many_block(2, eta=0.1, n_classes=3)
    assert not calls
    np.testing.assert_array_equal(a.positions, ref.positions)
    np.testing.assert_array_equal(a.velocities, ref.velocities)
    for change in (lambda: a.set_state(a.positions, a.velocities), lambda: a.update(1e-4),
                   lambda: a.update_params(NBodyParams(time_step=2e-3, softening=0.2,
                                                       damping=1.0))):
        change()
        calls.clear()  # the step's own force
        a.update_many_block(1, eta=0.1, n_classes=3)
        assert len(calls) == 1
        calls.clear()


def test_one_count_read_a_macro_step():
    s = BodySystem(256, NBodyParams(**PRM), device="cpu", seed=3)
    before = timing.HOST_READS["block_counts"]
    s.update_many_block(5, eta=0.1, n_classes=3)
    assert timing.HOST_READS["block_counts"] - before == 5


def test_float64_and_host_placement():
    a = BodySystem(256, NBodyParams(**PRM), device="cpu", seed=3, dtype=torch.float64)
    b = BodySystem(256, NBodyParams(**PRM), device="cpu", seed=3, dtype=torch.float64,
                   placement="host")
    assert a.update_many_block(3, eta=0.1, n_classes=3) == b.update_many_block(
        3, eta=0.1, n_classes=3)
    assert a.positions.dtype == np.float64
    np.testing.assert_array_equal(a.positions, b.positions)


def _fake_mesh():
    return Mesh(axis="bodies", size=2, rank=0, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("build, match", [
    (lambda: BodySystem(256, NBodyParams(**PRM), device="cpu", mesh=_fake_mesh(), seed=1),
     "single-device"),
    (lambda: BodySystem(256, NBodyParams(**PRM), device="cpu", kernel="pm", pm_grid=16,
                        seed=1), "exact kernels"),
    (lambda: BodySystem(256, NBodyParams(**PRM), device="cpu", kernel="p3m", pm_grid=16,
                        seed=1), "pm/p3m take update_many_adaptive"),
    (lambda: BodySystem(256, NBodyParams(time_step=2e-3, softening=SOFT, damping=0.995),
                        device="cpu", seed=1), "damping"),
])
def test_refusals_in_nbody_tpus_words(build, match):
    with pytest.raises(ValueError, match=match):
        build().update_many_block(2)


@pytest.mark.parametrize("kw, match", [({"eta": 0.0}, "eta"), ({"n_classes": 0}, "n_classes"),
                                       ({"n_classes": 17}, "n_classes"),
                                       ({"dt_max": -1.0}, "dt_max")])
def test_bad_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        BodySystem(64, NBodyParams(**PRM), device="cpu", seed=1).update_many_block(2, **kw)


def test_compute_block_frames_and_rates():
    """Compute.set_block (nbody_tpu/compute.py:252-278): frames are macro
    steps, block_stats sums nbody_tpu's, and the rates charge the rows
    computed (nbody_tpu/compute.py:328-343)."""
    from nbody_tpu.compute import Compute as JaxCompute

    kw = dict(num_bodies=256, cycle_demo=False, seed=5)
    theirs = JaxCompute(backend="xla", **kw)
    ours = Compute(device="cpu", log=lambda *a: None, **kw)
    for c in (theirs, ours):
        c.update_params(damping=1.0)
    ours.system.set_state(theirs.system.positions, theirs.system.velocities)
    for c in (theirs, ours):
        c.set_block(0.05, n_classes=3)
        c.update_simulation(steps=2)
        c.update_simulation(steps=1)
        c.calculate_fps(3, 1000.0, steps_per_frame=1)
    assert ours.block_stats == theirs.block_stats and ours.block_stats["macro_steps"] == 3
    assert ours.interactions_per_second == pytest.approx(theirs.interactions_per_second)
    assert ours.g_flops == pytest.approx(theirs.g_flops)
    assert ours.steps_taken == 3


def test_cli_block_demo_closes_with_the_rows_line(capsys):
    assert main(["--cpu", "--numbodies", "300", "--frames", "2", "--no-cycle", "--block-dt",
                 "0.05", "--block-classes", "3", "--set", "velocity_damping=1.0"]) == 0
    out = capsys.readouterr().out
    assert "note: --block-dt integrates KDK leapfrog" in out
    line = [s for s in out.splitlines() if s.startswith("block-dt: rows=")]
    assert len(line) == 1 and "% of global k_max=" in line[0] and "t=0.0" in line[0]
