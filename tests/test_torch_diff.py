"""The port's differentiable stepping (``nbody_tpu_torch/ops/diff.py``)
against ``nbody_tpu.ops.diff`` on the CPU.

The same numpy state (``ic.generate(SHELL, n, 1.0, 1.0, seed=5)``) goes to
both packages. On the CPU both forwards are their plain steps and both
backwards the plain step's VJP, so the gradients agree to float32 rounding
of differently ordered sums: rtol 1e-5 for a scalar gradient of one step,
rtol 1e-4 / atol 1e-5 through a rollout (``tests/test_diff.py``'s own
tolerances), 1e-10 relative in float64.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops import diff as jax_diff
from nbody_tpu.ops.reference import nbody_step_xla

from nbody_tpu_torch.ops import diff, reference
from nbody_tpu_torch.utils import timing

SOFT, DT = 0.5, 0.01
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def x64():
    """JAX's x64 on for the test, restored after it."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _state(n=64, dtype=np.float32):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.0, 1.0, seed=5, dtype=dtype)
    return pos, vel


def _loss_t(p):
    return torch.sum(p[:, :3] ** 2)


def _loss_j(p):
    return jnp.sum(p[:, :3] ** 2)


def test_plain_step_is_differentiable_in_softening():
    pos, vel = (torch.tensor(a) for a in _state())
    soft = torch.tensor(SOFT, requires_grad=True)
    p, _ = diff.plain_step(pos, vel, DT, soft, 1.0)
    (g,) = torch.autograd.grad(_loss_t(p), soft)
    assert np.isfinite(float(g)) and float(g) != 0.0


@pytest.mark.parametrize("soft", [SOFT, 0.1, 0.0625])
def test_tensor_scalar_step_equals_reference_step(soft):
    """For float scalars the tensor-scalar step is the reference step: bit
    for bit where softening^2 rounds alike both ways (0.5, 0.0625), else
    within an ulp of eps^2 (float(0.1)^2 against f32(0.1)^2)."""
    pos, vel = (torch.tensor(a) for a in _state())
    got = diff.plain_step(pos, vel, DT, soft, 0.9)
    want = reference.nbody_step(pos, vel, DT, soft, 0.9)
    for g, w in zip(got, want):
        if soft == 0.1:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(g, w)


def test_softening_grad_matches_jax():
    pos, vel = _state()
    p, v = torch.tensor(pos), torch.tensor(vel)
    soft = torch.tensor(SOFT, requires_grad=True)
    out, _ = diff.nbody_step_diff(p, v, DT, soft, 1.0)
    (g,) = torch.autograd.grad(_loss_t(out), soft)
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    want = jax.grad(lambda s: _loss_j(jax_diff.nbody_step_diff(jp, jv, DT, s, 1.0)[0]))(
        jnp.float32(SOFT))
    np.testing.assert_allclose(float(g), float(want), rtol=1e-5)


def test_grad_matches_finite_difference():
    pos, vel = (torch.tensor(a) for a in _state(32))

    def loss(s):
        p, _ = diff.nbody_step_diff(pos, vel, DT, s, 1.0)
        return _loss_t(p)

    soft = torch.tensor(SOFT, requires_grad=True)
    (g,) = torch.autograd.grad(loss(soft), soft)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(SOFT + eps)) - float(loss(SOFT - eps))) / (2 * eps)
    # central differences of a float32 loss carry percent-level cancellation
    # noise: a check of sign and magnitude (tests/test_diff.py's rtol 0.1)
    np.testing.assert_allclose(float(g), fd, rtol=0.1)


def test_remat_rollout_grad_matches_loop():
    pos, vel = (torch.tensor(a) for a in _state(32))
    p0 = pos.clone().requires_grad_()
    p, _ = diff.rollout_diff(p0, vel, DT, SOFT, 1.0, steps=3)
    (g1,) = torch.autograd.grad(_loss_t(p), p0)
    p0 = pos.clone().requires_grad_()
    p, v = p0, vel
    for _ in range(3):
        p, v = diff.nbody_step_diff(p, v, DT, SOFT, 1.0)
    (g2,) = torch.autograd.grad(_loss_t(p), p0)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-4, atol=1e-5)


def test_position_grads_through_rollout_match_jax():
    """All four lanes, the mass too, as jax.grad gives them."""
    pos, vel = _state(32)
    p0 = torch.tensor(pos, requires_grad=True)
    p, _ = diff.rollout_diff(p0, torch.tensor(vel), DT, SOFT, 1.0, steps=3)
    (g,) = torch.autograd.grad(_loss_t(p), p0)
    jv = jnp.asarray(vel)
    want = jax.grad(lambda q: _loss_j(jax_diff.rollout_diff(q, jv, DT, SOFT, 1.0, steps=3)[0]))(
        jnp.asarray(pos))
    assert g.shape == pos.shape and np.isfinite(g.numpy()).all()
    assert np.abs(g.numpy()[:, 3]).max() > 0
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _all_grads_torch(pos, vel, dt, soft, damp, dtype):
    ts = [torch.tensor(a, requires_grad=True) for a in (pos, vel)]
    ts += [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (dt, soft, damp)]
    p, v = diff.nbody_step_diff(*ts)
    loss = _loss_t(p) + torch.sum(v[:, :3] * p[:, :3])
    return [g.detach().numpy() for g in torch.autograd.grad(loss, ts)]


def _all_grads_jax(pos, vel, dt, soft, damp, dtype):
    def loss(*args):
        p, v = jax_diff.nbody_step_diff(*args)
        return _loss_j(p) + jnp.sum(v[:, :3] * p[:, :3])

    args = [jnp.asarray(pos), jnp.asarray(vel)] + [jnp.asarray(x, dtype) for x in (dt, soft, damp)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]


@pytest.mark.parametrize("what", ["pos", "vel", "dt", "softening", "damping"])
def test_every_input_grad_matches_jax(what):
    """A loss of both outputs, every input a tensor that requires a grad."""
    pos, vel = _state()
    got = _all_grads_torch(pos, vel, DT, SOFT, 0.9, torch.float32)
    want = _all_grads_jax(pos, vel, DT, SOFT, 0.9, jnp.float32)
    k = ["pos", "vel", "dt", "softening", "damping"].index(what)
    assert got[k].shape == np.shape(want[k])
    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_float64_grads_match_jax(x64):
    pos, vel = _state(dtype=np.float64)
    got = _all_grads_torch(pos, vel, DT, SOFT, 0.9, torch.float64)
    want = _all_grads_jax(pos, vel, DT, SOFT, 0.9, jnp.float64)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10 * np.abs(w).max())


def test_second_derivative_in_softening_matches_jax():
    pos, vel = _state()
    p, v = torch.tensor(pos), torch.tensor(vel)
    soft = torch.tensor(SOFT, requires_grad=True)
    out, _ = diff.rollout_diff(p, v, DT, soft, 1.0, steps=2)
    (g,) = torch.autograd.grad(_loss_t(out), soft, create_graph=True)
    (h,) = torch.autograd.grad(g, soft)
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)

    def loss(s):
        return _loss_j(jax_diff.rollout_diff(jp, jv, DT, s, 1.0, steps=2)[0])

    want = jax.grad(jax.grad(loss))(jnp.float32(SOFT))
    assert np.isfinite(float(h)) and float(h) != 0.0
    np.testing.assert_allclose(float(h), float(want), rtol=1e-4)


def test_grads_equal_plain_autograd_for_given_cotangents():
    """The backward is the plain step's autograd: for the same cotangents
    the Function's gradients and the plain step's are the same bits."""
    pos, vel = _state()
    rng = np.random.default_rng(1)
    cot = [torch.tensor(rng.standard_normal(pos.shape), dtype=torch.float32) for _ in range(2)]

    def grads(step):
        ts = [torch.tensor(a, requires_grad=True) for a in (pos, vel)]
        ts += [torch.tensor(x, requires_grad=True) for x in (DT, SOFT, 0.9)]
        return torch.autograd.grad(step(*ts), ts, cot)

    for a, b in zip(grads(diff.nbody_step_diff), grads(diff.plain_step)):
        assert torch.equal(a, b)


def test_floats_get_no_grad_and_tensors_stay_on_the_host():
    """Python floats are allowed and get no gradient; on the CPU the tensor
    scalars are never read on the host."""
    pos, vel = (torch.tensor(a) for a in _state(32))
    p0 = pos.clone().requires_grad_()
    before = timing.HOST_READS["diff_scalars"]
    p, _ = diff.nbody_step_diff(p0, vel, torch.tensor(DT), torch.tensor(SOFT), 1.0)
    (g,) = torch.autograd.grad(_loss_t(p), p0)
    assert g.shape == pos.shape
    assert timing.HOST_READS["diff_scalars"] == before


def test_scalar_values_reads_tensors_once():
    before = timing.HOST_READS["diff_scalars"]
    assert diff.scalar_values(0.5, 1.0, 2.0) == (0.5, 1.0, 2.0)
    assert timing.HOST_READS["diff_scalars"] == before
    got = diff.scalar_values(torch.tensor(0.25), 1.0, torch.tensor(2.0, dtype=torch.float64))
    assert got == (0.25, 1.0, 2.0)
    assert timing.HOST_READS["diff_scalars"] == before + 1


@pytest.mark.parametrize("config, error", [
    ((("tile_i", 256),), "unknown config keys"),
    ((("variant", "sym"),), "unknown variant"),
])
def test_config_is_checked(config, error):
    pos, vel = (torch.tensor(a) for a in _state(32))
    with pytest.raises(ValueError, match=error):
        diff.nbody_step_diff(pos, vel, DT, SOFT, 1.0, config)


def test_mxu_config_runs_the_plain_step_on_the_cpu():
    """As nbody_tpu's diff runs its XLA step off the TPU, whatever the
    config: the mxu variants name a card kernel."""
    pos, vel = (torch.tensor(a) for a in _state(32))
    got = diff.nbody_step_diff(pos, vel, DT, SOFT, 1.0, (("variant", "mxu_bf16"),))
    want = diff.plain_step(pos, vel, DT, SOFT, 1.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_fit_recovers_softening():
    """examples/fit_softening_torch.py: N = 256, 8 steps, 30 Newton
    iterations recover 0.30 from 0.10 to 5e-3, as examples/fit_softening.py
    does with JAX."""
    spec = importlib.util.spec_from_file_location("fit_softening_torch",
                                                  REPO / "examples" / "fit_softening_torch.py")
    fit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fit)
    s = fit.fit(torch.device("cpu"), log=lambda *a: None)
    assert abs(s - fit.TRUE_SOFTENING) < 5e-3
