"""The port's each-pair-once force and leapfrog step against nbody_tpu.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its Pallas sym kernels in interpret mode, as
tests/test_symmetric.py runs them; the port's side runs the plain versions
(ops/reference.py), which are what its CUDA kernels take on a CPU tensor
and what they are held to on the card. Tolerances, with their reasons:

* force, 1e-5 of max|a|: the bound of tests/test_symmetric.py:31 for the
  sym kernel against the XLA force; the two differ only in the order of
  the fp32 sums;
* one step of dt = 0.01 after BodySystem, atol 1e-5: tests/test_symmetric.py:107;
* leapfrog against the JAX leapfrog, atol 1e-6: one dt = 0.001 step of the
  same arithmetic, the bound of tests/test_torch_reference.py's Euler step;
* against the oracle, the reference's QA rule, |dpos| <= 5e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import symmetric_kernel as jsym
from nbody_tpu.ops.pallas_kernel import compute_accel_pallas
from nbody_tpu.ops.reference import nbody_step_leapfrog as jax_leapfrog
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from conftest import assert_state_close
from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.oracle import step_best

SOFT = 0.1
DT = 0.001


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(n, config="shell", seed=1, masses=False):
    cfg = JaxNBodyConfig(config)
    pos, vel = jax_ic.generate(cfg, n, 1.52, 2.0 if config == "shell" else 8.0, seed=seed)
    if masses:
        rng = np.random.default_rng(seed + 100)
        pos[:, 3] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        vel[:, 3] = rng.standard_normal(n).astype(np.float32)
    return pos, vel


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [128, 1000])
def test_accel_matches_jax_sym_kernel(n):
    pos, _ = _state(n)
    got = reference.compute_accel_symmetric(_t(pos), SOFT).numpy()
    want = jsym.compute_accel_symmetric(jnp.asarray(pos), SOFT, tile_i=64, tile_j=256,
                                        interpret=True)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n", [333, 1000])
def test_random_masses_match_jax_sym_kernel(n):
    # shell ICs have unit masses and cannot tell m_i from m_j
    pos, _ = _state(n, masses=True)
    got = reference.compute_accel_symmetric(_t(pos), SOFT).numpy()
    want = jsym.compute_accel_symmetric(jnp.asarray(pos), SOFT, tile_i=64, tile_j=256,
                                        interpret=True)
    assert _rel(got, want) < 1e-5
    # and the one-sided Pallas force, which weighs each pair by m_j alone
    one_sided = compute_accel_pallas(jnp.asarray(pos), jnp.asarray(pos), SOFT,
                                     tile_i=64, tile_j=256, interpret=True)
    assert _rel(got, one_sided) < 1e-5


def test_cross_matches_jax_both_outputs():
    pos, _ = _state(384, masses=True)
    pi, pj = pos[:128], pos[128:]
    acc, react = reference.sym_cross(_t(pi), _t(pj), SOFT)
    j_acc, j_react = jsym._sym_cross(jnp.asarray(pi), jnp.asarray(pj).T, SOFT,
                                     tile_i=64, tile_j=128, interpret=True)
    assert acc.shape == (128, 4) and react.shape == (3, 256)
    assert not acc[:, 3].any()
    assert _rel(acc.numpy(), j_acc) < 1e-5
    assert _rel(react.numpy(), j_react) < 1e-5


def test_blocked_matches_jax_blocked():
    pos, _ = _state(1000, masses=True)
    got = reference.compute_accel_symmetric_blocked(_t(pos), SOFT, block_cap=384, tile_j=128)
    want = jsym.compute_accel_symmetric_blocked(jnp.asarray(pos), SOFT, tile_j=128,
                                                block_cap=384, interpret=True)
    assert got.shape == (1000, 3)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("n, tj, cap", [(1000, 128, 384), (65536, 4096, 32768),
                                        (135168, 1024, 131072), (7, 128, 128)])
def test_sym_blocking_matches_jax(n, tj, cap):
    assert reference.sym_blocking(n, tj, cap) == jsym.sym_blocking(n, tj, cap)


def test_blocked_at_or_under_cap_is_one_triangle():
    pos, _ = _state(300)
    p = _t(pos)
    np.testing.assert_array_equal(
        reference.compute_accel_symmetric_blocked(p, SOFT, block_cap=300).numpy(),
        reference.compute_accel_symmetric(p, SOFT).numpy())


def test_zero_mass_padding_inert_on_both_sides():
    """Zero-mass bodies exert no action as j and no reaction as i, wherever
    they sit (tests/test_symmetric.py:44-55)."""
    pos, _ = _state(256, seed=3)
    pad = np.zeros((64, 4), np.float32)
    pad[:, :3] = np.random.default_rng(5).normal(size=(64, 3))
    padded = np.concatenate([pos, pad])
    a = reference.compute_accel_symmetric(_t(pos), SOFT).numpy()
    a_pad = reference.compute_accel_symmetric(_t(padded), SOFT).numpy()
    np.testing.assert_allclose(a_pad[:256], a, atol=1e-6)
    # the rectangle: padding on the i-side gives no reaction, on the j-side
    # no action
    acc, react = reference.sym_cross(_t(pos[:100]), _t(pos[100:]), SOFT)
    acc_p, react_p = reference.sym_cross(_t(np.concatenate([pos[:100], pad])),
                                         _t(np.concatenate([pos[100:], pad])), SOFT)
    np.testing.assert_allclose(acc_p[:100].numpy(), acc.numpy(), atol=1e-6)
    np.testing.assert_allclose(react_p[:, :156].numpy(), react.numpy(), atol=1e-6)


def test_momentum_antisymmetric():
    """Each pair adds +-m_i m_j c d once, so sum m a vanishes to rounding
    (tests/test_symmetric.py:58-66)."""
    pos, _ = _state(384, config="random", seed=4)
    acc = reference.compute_accel_symmetric(_t(pos), SOFT).numpy()
    net = (pos[:, 3:4] * acc).sum(axis=0)
    assert np.abs(net).max() / np.abs(pos[:, 3:4] * acc).sum() < 1e-6


@pytest.mark.parametrize("chunk", [1, 100, 333])
def test_chunks_do_not_move_the_result(chunk):
    pos, _ = _state(333, masses=True)
    dense = reference.compute_accel_symmetric(_t(pos), SOFT, chunk_size=10**9).numpy()
    got = reference.compute_accel_symmetric(_t(pos), SOFT, chunk_size=chunk).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)
    acc, react = reference.sym_cross(_t(pos[:100]), _t(pos[100:]), SOFT, chunk_size=chunk)
    acc_d, react_d = reference.sym_cross(_t(pos[:100]), _t(pos[100:]), SOFT)
    np.testing.assert_allclose(acc.numpy(), acc_d.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(react.numpy(), react_d.numpy(), rtol=1e-5, atol=1e-5)


def test_leapfrog_matches_jax_and_oracle():
    pos, vel = _state(512, config="random", seed=3, masses=True)
    vel[:, 3] = 0.0
    p_t, v_t = reference.nbody_step_leapfrog(_t(pos), _t(vel), DT, SOFT, 0.5)
    p_j, v_j = jax_leapfrog(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, 0.5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)
    p_o, v_o = step_best(pos, vel, DT, SOFT, 0.5, integrator="leapfrog")
    assert_state_close(p_t.numpy(), p_o)
    assert_state_close(v_t.numpy(), v_o)
    np.testing.assert_array_equal(p_t.numpy()[:, 3], pos[:, 3])


def test_leapfrog_with_sym_force_matches_jax_sym_leapfrog():
    pos, vel = _state(256, masses=True)
    vel[:, 3] = 0.0

    def sym(p4):
        return reference.compute_accel_symmetric(p4, SOFT)

    p_t, v_t = reference.nbody_step_leapfrog(_t(pos), _t(vel), DT, SOFT, 1.0, accel_fn=sym)
    p_j, v_j = jax_leapfrog(
        jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, 1.0,
        accel_fn=lambda p4: jsym.compute_accel_symmetric(p4, SOFT, tile_j=128, interpret=True))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-6)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_body_system_sym_matches_jax(integrator):
    """tests/test_symmetric.py:96-117 with the port on one side."""
    params = NBodyParams(softening=SOFT, damping=1.0)
    ours = BodySystem(256, params, device="cpu", variant="sym", integrator=integrator, seed=9)
    ref = JaxBodySystem(256, JaxNBodyParams(**dataclasses.asdict(params)), backend="pallas",
                        variant="sym", interpret=True, seed=9, tile_j=128,
                        integrator=integrator)
    assert ours.variant == "sym" and ours.integrator == integrator
    np.testing.assert_array_equal(ours.positions, ref.positions)
    ours.update(0.01)
    ref.update(0.01)
    np.testing.assert_allclose(ours.positions, ref.positions, atol=1e-5)
    np.testing.assert_allclose(ours.velocities, ref.velocities, atol=1e-5)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_body_system_sym_passes_oracle_qa(integrator):
    params = NBodyParams(softening=SOFT, damping=0.5)
    s = BodySystem(500, params, device="cpu", variant="sym", integrator=integrator, seed=2)
    pos0, vel0 = s.positions, s.velocities
    s.update(DT)
    p_o, v_o = step_best(pos0, vel0, DT, SOFT, 0.5, integrator=integrator)
    assert_state_close(s.positions, p_o)
    assert_state_close(s.velocities, v_o)


def test_body_system_sym_accelerations_and_vpu_leapfrog():
    params = NBodyParams(softening=SOFT)
    sym = BodySystem(300, params, device="cpu", variant="sym", seed=4)
    vpu = BodySystem(300, params, device="cpu", variant="vpu", integrator="leapfrog", seed=4)
    a_s = sym.accelerations().numpy()
    a_v = vpu.accelerations().numpy()
    assert _rel(a_s, a_v) < 1e-5
    pos, vel = vpu.positions, vpu.velocities
    vpu.update(DT)
    p_j, _ = jax_leapfrog(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, 1.0)
    np.testing.assert_allclose(vpu.positions, np.asarray(p_j), atol=1e-6)


def test_auto_is_vpu_on_the_cpu():
    s = BodySystem(64, NBodyParams(), device="cpu")
    assert s.variant == "vpu"
    assert BodySystem(64, NBodyParams(), device="cpu", variant="sym").variant == "sym"


def test_sym_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    pos, _ = _state(300, masses=True)
    p = _t(pos)
    before = dict(cuda_kernel.LAUNCHES)
    a = cuda_kernel.sym_accel_cuda(p, SOFT)
    acc, react = cuda_kernel.sym_cross_cuda(p[:100], p[100:], SOFT)
    blocked = cuda_kernel.compute_accel_symmetric_blocked_cuda(p, SOFT, block_cap=128, tile=128)
    assert cuda_kernel.LAUNCHES == before
    torch.testing.assert_close(a, reference.compute_accel_symmetric(p, SOFT), rtol=0, atol=0)
    ref_acc, ref_react = reference.sym_cross(p[:100], p[100:], SOFT)
    torch.testing.assert_close(acc, ref_acc, rtol=0, atol=0)
    torch.testing.assert_close(react, ref_react, rtol=0, atol=0)
    torch.testing.assert_close(
        blocked, reference.compute_accel_symmetric_blocked(p, SOFT, block_cap=128, tile_j=128),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["tile", "out_shape", "out_alias", "out_alignment",
                                 "out_overlap", "pos_shape"])
def test_sym_wrappers_refuse_bad_arguments(bad):
    pos, _ = _state(256)
    p = _t(pos)
    if bad == "tile":
        with pytest.raises(ValueError, match="tile"):
            cuda_kernel.sym_accel_cuda(p, SOFT, tile=96)
    elif bad == "out_shape":
        with pytest.raises(ValueError, match="shape"):
            cuda_kernel.sym_accel_cuda(p, SOFT, out=torch.empty((256, 4)))
    elif bad == "out_alias":
        # a (N,3) view over the positions themselves
        with pytest.raises(ValueError, match="overlaps"):
            cuda_kernel.sym_accel_cuda(p, SOFT, out=p.view(-1)[:768].view(256, 3))
    elif bad == "out_alignment":
        out = torch.empty(256 * 3 + 1)[1:].view(256, 3)
        with pytest.raises(ValueError, match="aligned"):
            cuda_kernel.sym_accel_cuda(p, SOFT, out=out)
    elif bad == "out_overlap":
        buf = torch.empty(1000)
        with pytest.raises(ValueError, match="overlaps"):
            cuda_kernel.sym_cross_cuda(p[:100], p[100:], SOFT,
                                       out=(buf[:400].view(100, 4), buf[:468].view(3, 156)))
    else:
        with pytest.raises(ValueError, match="shape"):
            cuda_kernel.sym_cross_cuda(p[:, :3].contiguous(), p, SOFT)


def test_dispatch_table():
    cap, tile = cuda_kernel.sym_default_dispatch(65536)
    assert tile in cuda_kernel.SYM_TILES and cap % tile == 0
    # the CLI's default N on an H100 is above the cap: the composition runs
    k, blk = reference.sym_blocking(4 * 256 * 132, tile, cap)
    assert k == 2 and blk <= cap
