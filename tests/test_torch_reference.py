"""The port's plain PyTorch path (nbody_tpu_torch.ops.reference / .energy)
against nbody_tpu's XLA path and the CPU oracle, on numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import energy as jax_energy
from nbody_tpu.ops.reference import compute_accel_xla_vs, nbody_step_xla
from nbody_tpu.oracle import step_best

from conftest import assert_state_close
from nbody_tpu_torch.ops import energy, reference

DT, SOFT, DAMP = 0.001, 0.1, 1.0


@pytest.fixture(params=["random_state_tiny", "shell_state_small"])
def state(request):
    """N=512 random and N=4096 shell, the JAX suite's two fixtures."""
    return request.getfixturevalue(request.param)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_accel_matches_xla(state):
    pos, _ = state
    a_t = reference.compute_accel(_t(pos), SOFT)
    a_x = compute_accel_xla_vs(jnp.asarray(pos), jnp.asarray(pos), SOFT)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_x), rtol=1e-4, atol=1e-4)


def test_step_matches_xla(state):
    pos, vel = state
    p_t, v_t = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, DAMP)
    p_x, v_x = nbody_step_xla(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_x), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_x), atol=1e-6)


def test_step_passes_oracle_qa(state):
    """The reference's QA rule against the native (or NumPy) oracle."""
    pos, vel = state
    p_t, v_t = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, DAMP)
    ref_pos, ref_vel = step_best(pos, vel, DT, SOFT, DAMP)
    assert_state_close(p_t.numpy(), ref_pos)
    assert_state_close(v_t.numpy(), ref_vel)


@pytest.mark.parametrize("chunk", [1, 100, 333, 512])
def test_chunked_matches_dense(random_state_tiny, chunk):
    """Chunks pad the rows to a chunk multiple; the result must not move."""
    pos, _ = random_state_tiny
    p = _t(pos)
    dense = reference.compute_accel(p, SOFT, chunk_size=10**9)
    chunked = reference.compute_accel(p, SOFT, chunk_size=chunk)
    np.testing.assert_allclose(chunked.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)


def test_zero_mass_padding_exerts_no_force(random_state_tiny):
    pos, _ = random_state_tiny
    pad = np.zeros((77, 4), np.float32)
    pad[:, :3] = np.random.default_rng(1).normal(size=(77, 3))
    padded = np.concatenate([pos, pad])
    a = reference.compute_accel_vs(_t(pos), _t(pos), SOFT)
    a_pad = reference.compute_accel_vs(_t(pos), _t(padded), SOFT)
    np.testing.assert_array_equal(a.numpy(), a_pad.numpy())


def test_damping_matches_xla(random_state_tiny):
    pos, vel = random_state_tiny
    p_t, v_t = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, 0.5)
    p_x, v_x = nbody_step_xla(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, 0.5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_x), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_x), atol=1e-6)
    # damping 0.5 halves the kicked velocity
    p_1, v_1 = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, 1.0)
    np.testing.assert_allclose(v_t.numpy()[:, :3], 0.5 * v_1.numpy()[:, :3], rtol=1e-6)


def test_mass_and_w_lane_pass_through(random_state_tiny):
    pos, vel = random_state_tiny
    pos = pos.copy()
    vel = vel.copy()
    rng = np.random.default_rng(2)
    pos[:, 3] = rng.uniform(0.5, 2.0, len(pos)).astype(np.float32)
    vel[:, 3] = rng.normal(size=len(vel)).astype(np.float32)
    p_t, v_t = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, DAMP)
    np.testing.assert_array_equal(p_t.numpy()[:, 3], pos[:, 3])
    np.testing.assert_array_equal(v_t.numpy()[:, 3], vel[:, 3])


@pytest.mark.parametrize("n", [1, 7, 333])
def test_non_divisible_n(random_state_tiny, n):
    pos, vel = random_state_tiny
    pos, vel = pos[:n], vel[:n]
    p_t, v_t = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, DAMP, chunk_size=128)
    p_x, v_x = nbody_step_xla(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP)
    assert p_t.shape == (n, 4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_x), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_x), atol=1e-6)


def test_i_vs_j_sets(random_state_tiny):
    pos, vel = random_state_tiny
    a_t = reference.compute_accel_vs(_t(pos[:128]), _t(pos), SOFT)
    a_x = compute_accel_xla_vs(jnp.asarray(pos[:128]), jnp.asarray(pos), SOFT)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_x), rtol=1e-4, atol=1e-4)
    p_t, _ = reference.nbody_step_vs(_t(pos[:128]), _t(vel[:128]), _t(pos), DT, SOFT, DAMP)
    assert p_t.shape == (128, 4)


def test_rollout_matches_xla_steps(random_state_tiny):
    pos, vel = random_state_tiny
    p_t, v_t = reference.rollout(_t(pos), _t(vel), DT, SOFT, DAMP, steps=3)
    p_x, v_x = jnp.asarray(pos), jnp.asarray(vel)
    for _ in range(3):
        p_x, v_x = nbody_step_xla(p_x, v_x, DT, SOFT, DAMP)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_x), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_x), atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 100])
def test_energy_matches_jax(random_state_tiny, chunk):
    pos, vel = random_state_tiny
    e_t = energy.total_energy(_t(pos), _t(vel), SOFT, chunk_size=chunk)
    e_x = jax_energy.total_energy(jnp.asarray(pos), jnp.asarray(vel), SOFT, chunk_size=chunk)
    np.testing.assert_allclose(float(e_t), float(e_x), rtol=1e-5)
    k_t = energy.kinetic_energy(_t(pos), _t(vel))
    k_x = jax_energy.kinetic_energy(jnp.asarray(pos), jnp.asarray(vel))
    np.testing.assert_allclose(float(k_t), float(k_x), rtol=1e-6)


def test_zero_softening_gives_nan_like_jax(random_state_tiny):
    """softening = 0: the self pair gives rsqrt(0) * 0 = NaN, in both
    packages, as in the reference; no guard hides it."""
    pos, _ = random_state_tiny
    a_t = reference.compute_accel(_t(pos[:64]), 0.0)
    a_x = compute_accel_xla_vs(jnp.asarray(pos[:64]), jnp.asarray(pos[:64]), 0.0)
    assert np.isnan(a_t.numpy()).all() and np.isnan(np.asarray(a_x)).all()
