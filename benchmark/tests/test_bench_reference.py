"""The plain reference at small N against direct float64 NumPy sums, the
P3M and PM references against the program's own plain versions on the CPU
and the PM reference against Newton's force, each solver's reference found
by name, and its rows."""

import json

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.harness import inputs, spec
from benchmark.reference import allpairs, p3m, pm

SOFT = 0.1


def direct(pos, vel, eps2):
    """float64 NumPy all-pairs force and jerk, pair by pair over j."""
    x, v, m = pos[:, :3], vel[:, :3], pos[:, 3]
    acc = np.zeros_like(x)
    jerk = np.zeros_like(x)
    for j in range(len(x)):
        d = x[j] - x
        dv = v[j] - v
        r2 = (d * d).sum(1) + eps2
        w = m[j] * r2 ** -1.5
        acc += w[:, None] * d
        jerk += w[:, None] * dv - 3 * (m[j] * (d * dv).sum(1) * r2 ** -2.5)[:, None] * d
    return acc, jerk


@pytest.fixture(scope="module")
def state():
    pos, vel = inputs.shell(384, 1.54, 8.0, seed=5)
    pos = pos.astype(np.float64)
    pos[:, 3] = np.random.default_rng(1).uniform(0.5, 1.5, len(pos))
    pos[::7, :3] += 40.0  # bodies far from the others, for the centring
    return pos, vel.astype(np.float64)


def test_accel_and_jerk_match_direct_sums(state):
    pos, vel = state
    acc_ref, jerk_ref = direct(pos, vel, SOFT ** 2)
    acc = allpairs.force(torch.as_tensor(pos), SOFT).numpy()
    a2, j2 = (t.numpy() for t in allpairs.accel_jerk(torch.as_tensor(pos),
                                                      torch.as_tensor(vel), SOFT))
    scale_a, scale_j = np.abs(acc_ref).max(), np.abs(jerk_ref).max()
    assert np.abs(acc - acc_ref).max() <= 1e-11 * scale_a
    assert np.abs(a2 - acc_ref).max() <= 1e-11 * scale_a
    assert np.abs(j2 - jerk_ref).max() <= 1e-10 * scale_j
    rows = torch.arange(10, 90)
    assert np.array_equal(allpairs.force(torch.as_tensor(pos), SOFT, rows=rows).numpy(),
                          allpairs.force(torch.as_tensor(pos), SOFT)[rows].numpy())


def test_control_reads_tf32(state):
    pos, vel = state
    acc_ref, _ = direct(pos, vel, SOFT ** 2)
    acc = allpairs.force(torch.as_tensor(pos, dtype=torch.float32), SOFT,
                         precision="tf32").numpy()
    err = np.abs(acc - acc_ref).max() / np.abs(acc_ref).max()
    assert 1e-5 < err < 1e-1
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11])
    assert allpairs.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9]


def test_steps_follow_the_equations(state):
    pos, vel = (torch.as_tensor(a) for a in state)
    cfg = {"solver": "allpairs", "params": {"time_step": 0.01, "softening": SOFT,
                                            "damping": 0.99}}
    p1, v1 = reference.advance(pos, vel, 1, config=cfg, integrator="euler")
    a = allpairs.force(pos, SOFT)
    v = (vel[:, :3] + a * 0.01) * 0.99
    assert torch.equal(v1[:, :3], v)
    assert torch.equal(p1[:, :3], pos[:, :3] + v * 0.01)
    assert torch.equal(p1[:, 3], pos[:, 3]) and torch.equal(v1[:, 3], vel[:, 3])
    rows = reference.advance(pos, vel, 1, config=cfg, integrator="euler", rows=slice(5, 50))
    assert torch.allclose(rows, p1[5:50], rtol=0, atol=1e-13)
    ph, vh = reference.advance(pos, vel, 2, config=cfg, integrator="hermite")
    pe, _ = reference.advance(pos, vel, 2, config=cfg, integrator="euler")
    # fourth order against first: both near, Hermite nearer a finer Euler
    fine, _ = reference.advance(pos, vel, 200, config=dict(cfg, params=dict(
        cfg["params"], time_step=0.0001, damping=0.99 ** 0.01)), integrator="euler")
    assert (ph - fine).abs().max() < (pe - fine).abs().max()


def test_p3m_reference_is_the_programs_solver():
    from nbody_tpu_torch.ops.p3m import p3m_accel

    pos, _ = inputs.shell(3000, 1.54, 8.0, seed=9)
    p = torch.as_tensor(pos)
    ref = p3m.force(p, SOFT, grid=16).numpy()
    got, overflow = p3m_accel(p, SOFT, grid=16, capacity=4096, backend="torch")
    assert int(overflow) == 0
    scale = np.linalg.norm(ref, axis=1)
    rel = np.linalg.norm(got.numpy() - ref, axis=1) / scale
    assert rel.max() < 1e-4
    # and the solver against the exact force: its sub-percent mesh error
    exact = allpairs.force(p, SOFT).numpy()
    err = np.linalg.norm(ref - exact, axis=1) / np.linalg.norm(exact, axis=1)
    assert np.median(err) < 0.01


def test_near_pairs_count_by_brute_force():
    pos, _ = inputs.shell(1500, 1.54, 8.0, seed=3)
    p = torch.as_tensor(pos)
    _, h = p3m.fit_box(p[:, :3], 16)
    rcut = float(p3m.RCUT_SIGMAS * p3m.SIGMA_CELLS * h)
    d = p[:, None, :3] - p[None, :, :3]
    r2 = (d * d).sum(2)
    brute = int((r2 < rcut * rcut).sum()) - len(p)
    assert p3m.near_pairs(p, grid=16) == brute > 0


def test_pm_reference_is_the_programs_solver():
    from nbody_tpu_torch.ops.pm import pm_accel

    pos, _ = inputs.shell(3000, 1.54, 8.0, seed=9)
    p = torch.as_tensor(pos)
    ref = pm.force(p, grid=16).numpy()
    got = pm_accel(p, grid=16).numpy()
    # float32 rounding: the state and the box (2^-24 each), the deposit's
    # sums, the 32^3 FFTs' 15 stages each and the 8-point gather read 3.8e-7
    # to 4.8e-7 of the largest acceleration; 4e-6 leaves ten times that,
    # and the TF32 control reads 9e-4 here
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 4e-6 * scale
    assert np.abs(pm.force(p, grid=16, precision="tf32").numpy() - ref).max() > 4e-6 * scale


def test_pm_reference_against_newton():
    # two clumps of radius 1.5 cells, 27 cells apart: with only B's masses
    # (A's bodies massless, so the box is the same), the mesh's force on A
    # is B's pull, which plain PM gives within its mesh error of a percent
    # at such distances (0.23 % the widest body here)
    rng = np.random.default_rng(4)

    def clump(n, centre):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return centre + d * 0.6 * rng.uniform(0, 1, (n, 1)) ** (1 / 3)

    a, b = clump(60, np.zeros(3)), clump(40, np.array([10.0, 3.0, -2.0]))
    m = rng.uniform(0.5, 1.5, 40)
    pos = np.concatenate([np.concatenate([a, b]), np.r_[np.zeros(60), m][:, None]], 1)
    got = pm.force(torch.as_tensor(pos), grid=32).numpy()[:60]
    d = b[None, :, :] - a[:, None, :]
    newton = (m[None, :, None] * d / np.linalg.norm(d, axis=2)[..., None] ** 3).sum(1)
    err = np.linalg.norm(got - newton, axis=1) / np.linalg.norm(newton, axis=1)
    assert err.max() < 0.01


@pytest.mark.parametrize("name", ["cuda_sample_fp32", "p3m_cic_1m", "pm_cic_1m"])
def test_rows_are_the_whole_forces_rows(name):
    cfg = dict(json.loads((spec.BENCH / "configs" / f"{name}.json").read_text()), pm_grid=16)
    pos, vel = (torch.as_tensor(a) for a in inputs.shell(1200, 1.54, 8.0, seed=6))
    mod = reference.solver(cfg)
    whole = mod.accel(pos, cfg)
    for rows in (slice(300, 600), torch.arange(5, 1200, 7)):
        assert torch.equal(mod.accel(pos, cfg, rows=rows), whole[rows])
        one = reference.advance(pos, vel, 1, config=cfg, integrator="euler", rows=rows)
        assert torch.equal(one, reference.advance(pos, vel, 1, config=cfg,
                                                  integrator="euler")[0][rows])


def test_a_solver_with_no_module_raises():
    pos, vel = (torch.as_tensor(a) for a in inputs.shell(64, 1.54, 8.0, seed=1))
    cfg = {"solver": "tree", "params": {"time_step": 0.01, "softening": SOFT, "damping": 1.0}}
    with pytest.raises(FileNotFoundError):
        reference.advance(pos, vel, 1, config=cfg, integrator="euler")
