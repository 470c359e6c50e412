"""The plain reference at small N against direct float64 NumPy sums, and
the P3M reference against the program's own plain P3M on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.harness import inputs
from benchmark.reference import allpairs, p3m

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
    acc = allpairs.accel(torch.as_tensor(pos), SOFT).numpy()
    a2, j2 = (t.numpy() for t in allpairs.accel_jerk(torch.as_tensor(pos),
                                                      torch.as_tensor(vel), SOFT))
    scale_a, scale_j = np.abs(acc_ref).max(), np.abs(jerk_ref).max()
    assert np.abs(acc - acc_ref).max() <= 1e-11 * scale_a
    assert np.abs(a2 - acc_ref).max() <= 1e-11 * scale_a
    assert np.abs(j2 - jerk_ref).max() <= 1e-10 * scale_j
    rows = torch.arange(10, 90)
    assert np.array_equal(allpairs.accel(torch.as_tensor(pos), SOFT, rows=rows).numpy(),
                          allpairs.accel(torch.as_tensor(pos), SOFT)[rows].numpy())


def test_control_reads_tf32(state):
    pos, vel = state
    acc_ref, _ = direct(pos, vel, SOFT ** 2)
    acc = allpairs.accel(torch.as_tensor(pos, dtype=torch.float32), SOFT,
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
    a = allpairs.accel(pos, SOFT)
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
    ref = p3m.accel(p, SOFT, grid=16).numpy()
    got, overflow = p3m_accel(p, SOFT, grid=16, capacity=4096, backend="torch")
    assert int(overflow) == 0
    scale = np.linalg.norm(ref, axis=1)
    rel = np.linalg.norm(got.numpy() - ref, axis=1) / scale
    assert rel.max() < 1e-4
    # and the solver against the exact force: its sub-percent mesh error
    exact = allpairs.accel(p, SOFT).numpy()
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
