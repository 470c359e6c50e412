"""The port's Hermite path (accel + jerk, one-sided and each pair once, the
Hermite step, BodySystem, Compute) against nbody_tpu.

Inputs are made with numpy from a seed (shell and random ICs; masses from
[0.5, 2] and a random vel.w in one case of each check) and handed to both
packages. The JAX side runs its Pallas kernels in interpret mode, as
tests/test_hermite.py and tests/test_symmetric.py run them; the port's side
runs the plain versions (ops/reference.py), which are what its CUDA kernels
take on a CPU tensor and what they are held to on the card. Tolerances are
the JAX suite's own:

* accel + jerk and a Hermite step, rtol 2e-5, atol 2e-6
  (tests/test_hermite.py:170-201), on small shell states as there: on a
  random 700-body state the JAX package's own Pallas and XLA accel + jerk
  differ by more, element by element, so there the bound is 1e-5 of the
  largest value, the suite's accel + jerk bound of
  tests/test_symmetric.py:325;
* the each-pair-once triangle, rectangle and blocked composition, 1e-5 of
  the largest value of each output (tests/test_symmetric.py:311-353), and
  sum m a, sum m j within 1e-6 of sum |m a|, sum |m j|;
* against the oracle, the reference's QA rule, |dpos| <= 5e-4;
* drift_check: the oracle drifts to 1e-12 (the same oracle library and a
  float64 functional on both sides), the device drifts within the gate of
  the JAX package's --drift-check.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.compute import Compute as JaxCompute
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import symmetric_kernel as jsym
from nbody_tpu.ops.pallas_kernel import compute_accel_jerk_pallas
from nbody_tpu.ops.reference import compute_accel_jerk_xla
from nbody_tpu.ops.reference import nbody_step_hermite as jax_hermite
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from conftest import assert_state_close
from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.cli import drift_failed
from nbody_tpu_torch.compute import Compute
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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-6)


def _pallas_and_xla(pos, vel):
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    return (compute_accel_jerk_pallas(p, v, p, v, SOFT, tile_i=64, tile_j=128, interpret=True),
            compute_accel_jerk_xla(p, v, SOFT))


@pytest.mark.parametrize("masses", [False, True])
def test_accel_jerk_matches_pallas_and_xla(masses):
    pos, vel = _state(333, masses=masses)
    acc, jerk = reference.compute_accel_jerk(_t(pos), _t(vel), SOFT)
    for want_acc, want_jerk in _pallas_and_xla(pos, vel):
        _close(acc.numpy(), want_acc)
        _close(jerk.numpy(), want_jerk)


def test_accel_jerk_random_state_matches_pallas_and_xla():
    pos, vel = _state(700, "random", masses=True)
    acc, jerk = reference.compute_accel_jerk(_t(pos), _t(vel), SOFT)
    for want_acc, want_jerk in _pallas_and_xla(pos, vel):
        assert _rel(acc.numpy(), want_acc) < 1e-5
        assert _rel(jerk.numpy(), want_jerk) < 1e-5


def test_accel_jerk_i_vs_j_matches_pallas():
    pos, vel = _state(700, "random", seed=2, masses=True)
    acc, jerk = reference.compute_accel_jerk_vs(_t(pos[:128]), _t(vel[:128]), _t(pos), _t(vel),
                                                SOFT, chunk_size=50)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    k_acc, k_jerk = compute_accel_jerk_pallas(p[:128], v[:128], p, v, SOFT, tile_i=64,
                                              tile_j=128, interpret=True)
    assert acc.shape == (128, 3) and jerk.shape == (128, 3)
    assert _rel(acc.numpy(), k_acc) < 1e-5
    assert _rel(jerk.numpy(), k_jerk) < 1e-5


def test_vel_w_does_not_enter_the_jerk():
    pos, vel = _state(333, masses=True)
    a1, j1 = reference.compute_accel_jerk(_t(pos), _t(vel), SOFT)
    vel0 = vel.copy()
    vel0[:, 3] = 0.0
    a0, j0 = reference.compute_accel_jerk(_t(pos), _t(vel0), SOFT)
    assert torch.equal(a1, a0) and torch.equal(j1, j0)
    s1 = reference.compute_accel_jerk_symmetric(_t(pos), _t(vel), SOFT)
    s0 = reference.compute_accel_jerk_symmetric(_t(pos), _t(vel0), SOFT)
    assert torch.equal(s1[0], s0[0]) and torch.equal(s1[1], s0[1])


@pytest.mark.parametrize("n, config, masses", [(333, "shell", False), (700, "random", True)])
def test_aj_sym_triangle_matches_jax_and_conserves(n, config, masses):
    pos, vel = _state(n, config, masses=masses)
    acc, jerk = reference.compute_accel_jerk_symmetric(_t(pos), _t(vel), SOFT)
    w_acc, w_jerk = jsym.compute_accel_jerk_symmetric(jnp.asarray(pos), jnp.asarray(vel), SOFT,
                                                      tile_j=128, interpret=True)
    assert _rel(acc.numpy(), w_acc) < 1e-5
    assert _rel(jerk.numpy(), w_jerk) < 1e-5
    # each pair once: momentum and its derivative vanish to rounding
    for field in (acc.numpy(), jerk.numpy()):
        mf = pos[:, 3:4].astype(np.float64) * field
        assert np.abs(mf.sum(axis=0)).max() / np.abs(mf).sum() < 1e-6


def test_aj_sym_cross_matches_jax_all_four_outputs():
    pos, vel = _state(384, masses=True)
    pi, vi, pj, vj = pos[:128], vel[:128], pos[128:], vel[128:]
    got = reference.aj_sym_cross(_t(pi), _t(vi), _t(pj), _t(vj), SOFT)
    want = jsym._aj_sym_cross(jnp.asarray(pi), jnp.asarray(vi), jnp.asarray(pj).T,
                              jnp.asarray(vj).T, SOFT, tile_i=64, tile_j=128, interpret=True)
    assert [tuple(t.shape) for t in got] == [(128, 4), (128, 4), (3, 256), (3, 256)]
    assert not got[0][:, 3].any() and not got[1][:, 3].any()
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-5


def test_aj_blocked_matches_jax_blocked_and_conserves():
    pos, vel = _state(1000, "random", seed=5, masses=True)
    got = reference.compute_accel_jerk_symmetric_blocked(_t(pos), _t(vel), SOFT, block_cap=384,
                                                         tile_j=128)
    want = jsym.compute_accel_jerk_symmetric_blocked(jnp.asarray(pos), jnp.asarray(vel), SOFT,
                                                     tile_i=64, tile_j=128, block_cap=384,
                                                     interpret=True)
    assert reference.sym_blocking(1000, 128, 384) == (3, 384)
    for g, w in zip(got, want):
        assert g.shape == (1000, 3)
        assert _rel(g.numpy(), w) < 1e-5
        mf = pos[:, 3:4].astype(np.float64) * g.numpy()
        assert np.abs(mf.sum(axis=0)).max() / np.abs(mf).sum() < 1e-6


@pytest.mark.parametrize("cap, tj", [(512, 256), (256, 128)])
def test_aj_blocked_against_one_sided(cap, tj):
    """More and fewer blocks (k = 2 and 4, with a ragged last block) give
    the one-sided accel + jerk (tests/test_symmetric.py:319-326)."""
    pos, vel = _state(1000, "random", seed=5, masses=True)
    assert reference.sym_blocking(1000, tj, cap)[0] >= 2
    got = reference.compute_accel_jerk_symmetric_blocked(_t(pos), _t(vel), SOFT, block_cap=cap,
                                                         tile_j=tj)
    want = reference.compute_accel_jerk(_t(pos), _t(vel), SOFT)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < 1e-5


def test_aj_blocked_at_or_under_cap_is_one_triangle():
    pos, vel = _state(300, masses=True)
    blocked = reference.compute_accel_jerk_symmetric_blocked(_t(pos), _t(vel), SOFT, block_cap=300)
    tri = reference.compute_accel_jerk_symmetric(_t(pos), _t(vel), SOFT)
    assert torch.equal(blocked[0], tri[0]) and torch.equal(blocked[1], tri[1])


def test_aj_zero_mass_padding_inert_on_both_sides():
    pos, vel = _state(256, seed=3, masses=True)
    pad = np.zeros((64, 4), np.float32)
    pad[:, :3] = np.random.default_rng(5).normal(size=(64, 3))
    padv = np.zeros((64, 4), np.float32)
    padv[:, :3] = np.random.default_rng(6).normal(size=(64, 3))
    a, j = reference.compute_accel_jerk_symmetric(_t(pos), _t(vel), SOFT)
    a_p, j_p = reference.compute_accel_jerk_symmetric(_t(np.concatenate([pos, pad])),
                                                      _t(np.concatenate([vel, padv])), SOFT)
    np.testing.assert_allclose(a_p[:256].numpy(), a.numpy(), atol=1e-6)
    np.testing.assert_allclose(j_p[:256].numpy(), j.numpy(), atol=1e-5)
    out = reference.aj_sym_cross(_t(pos[:100]), _t(vel[:100]), _t(pos[100:]), _t(vel[100:]), SOFT)
    out_p = reference.aj_sym_cross(_t(np.concatenate([pos[:100], pad])),
                                   _t(np.concatenate([vel[:100], padv])),
                                   _t(np.concatenate([pos[100:], pad])),
                                   _t(np.concatenate([vel[100:], padv])), SOFT)
    for g, w, cut in zip(out_p, out, ((100, None), (100, None), (None, 156), (None, 156))):
        g = g[:cut[0]] if cut[0] else g[:, :cut[1]]
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 100])
def test_aj_chunks_do_not_move_the_result(chunk):
    pos, vel = _state(333, masses=True)
    for fn in (reference.compute_accel_jerk, reference.compute_accel_jerk_symmetric):
        dense = fn(_t(pos), _t(vel), SOFT, chunk_size=10**9)
        got = fn(_t(pos), _t(vel), SOFT, chunk_size=chunk)
        for g, d in zip(got, dense):
            np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("damping", [1.0, 0.5])
def test_hermite_step_matches_jax_and_oracle(damping):
    pos, vel = _state(512, "random", seed=3, masses=True)
    p_t, v_t = reference.nbody_step_hermite(_t(pos), _t(vel), DT, SOFT, damping)
    p_j, v_j = jax_hermite(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, damping)
    _close(p_t.numpy(), p_j)
    _close(v_t.numpy(), v_j)
    np.testing.assert_array_equal(p_t.numpy()[:, 3], pos[:, 3])
    np.testing.assert_array_equal(v_t.numpy()[:, 3], vel[:, 3])
    p_o, v_o = step_best(pos, vel, DT, SOFT, damping, integrator="hermite")
    assert_state_close(p_t.numpy(), p_o)
    assert_state_close(v_t.numpy(), v_o)


def test_hermite_step_with_sym_evaluation_matches_jax():
    pos, vel = _state(256, masses=True)

    def aj_sym(p4, v4):
        return reference.compute_accel_jerk_symmetric(p4, v4, SOFT)

    p_t, v_t = reference.nbody_step_hermite(_t(pos), _t(vel), DT, SOFT, 0.999,
                                            accel_jerk_fn=aj_sym)
    p_j, v_j = jax_hermite(
        jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, 0.999,
        accel_jerk_fn=lambda p4, v4: jsym.compute_accel_jerk_symmetric(
            p4, v4, SOFT, tile_j=128, interpret=True))
    _close(p_t.numpy(), p_j)
    _close(v_t.numpy(), v_j)


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_body_system_hermite_matches_jax_pallas(variant):
    """tests/test_hermite.py:185-201 with the port on one side, two steps
    from the same state: the first evaluation of each step is made at its
    start, nothing is carried from the step before."""
    params = NBodyParams(softening=SOFT, damping=0.999)
    pos, vel = _state(256, "shell", seed=9, masses=True)
    ours = BodySystem(256, params, device="cpu", variant=variant, integrator="hermite",
                      state=(pos, vel))
    ref = JaxBodySystem(256, JaxNBodyParams(**dataclasses.asdict(params)), backend="pallas",
                        variant=variant, integrator="hermite", interpret=True, tile_i=16,
                        tile_j=128, state=(pos, vel))
    assert ours.integrator == "hermite" and ours.variant == variant
    for _ in range(2):
        ours.update(DT)
        ref.update(DT)
        _close(ours.positions, ref.positions)
        _close(ours.velocities, ref.velocities)


def test_body_system_hermite_update_many_and_host_placement():
    params = NBodyParams(softening=SOFT, damping=0.5)
    pos, vel = _state(300, "random", seed=4, masses=True)
    a = BodySystem(300, params, device="cpu", integrator="hermite", variant="sym",
                   state=(pos, vel))
    b = BodySystem(300, params, device="cpu", integrator="hermite", variant="sym",
                   placement="host", state=(pos, vel))
    a.update_many(3, DT)
    for _ in range(3):
        b.update(DT)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.velocities, b.velocities)
    # and the plain Hermite step, three times from scratch
    p, v = _t(pos), _t(vel)
    for _ in range(3):
        p, v = reference.nbody_step_hermite(
            p, v, DT, SOFT, 0.5, accel_jerk_fn=lambda p4, v4: reference.compute_accel_jerk_symmetric_blocked(
                p4, v4, SOFT, block_cap=cuda_kernel.AJ_SYM_BLOCK_CAP, tile_j=cuda_kernel.AJ_SYM_TILE))
    np.testing.assert_array_equal(a.positions, p.numpy())


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_body_system_accelerations_and_jerks(variant):
    pos, vel = _state(333, masses=True)
    s = BodySystem(333, NBodyParams(softening=SOFT), device="cpu", variant=variant,
                   integrator="hermite", state=(pos, vel))
    acc, jerk = s.accelerations_and_jerks()
    want = reference.compute_accel_jerk(_t(pos), _t(vel), SOFT)
    assert _rel(acc.numpy(), want[0].numpy()) < 1e-5
    assert _rel(jerk.numpy(), want[1].numpy()) < 1e-5
    # accelerations() stays the force of the variant
    assert _rel(s.accelerations().numpy(), want[0].numpy()) < 1e-5


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_compute_hermite_compare_results_passes(variant):
    lines = []
    c = Compute(num_bodies=512, device="cpu", variant=variant, integrator="hermite",
                log=lines.append)
    before = c.system.positions
    assert c.compare_results() is True
    assert "max |djerk|" in lines[-1] and "-> OK" in lines[-1]
    assert (c.system.positions == before).all()


def test_compare_results_fails_on_a_wrong_jerk(monkeypatch):
    lines = []
    c = Compute(num_bodies=256, device="cpu", integrator="hermite", log=lines.append)
    good = c.system.accelerations_and_jerks

    def off_by_a_percent():
        acc, jerk = good()
        return acc, jerk * 1.01

    monkeypatch.setattr(c.system, "accelerations_and_jerks", off_by_a_percent)
    assert c.compare_results() is False
    assert "FAILED" in lines[-1]


def test_drift_check_matches_jax():
    ours = Compute(num_bodies=512, device="cpu", integrator="hermite", log=lambda s: None)
    ref = JaxCompute(num_bodies=512, backend="xla", integrator="hermite", log=lambda s: None)
    np.testing.assert_array_equal(ours.system.positions, ref.system.positions)
    pos0 = ours.system.positions
    d_ours = ours.drift_check(3)
    d_ref = ref.drift_check(3)
    assert set(d_ours) == set(d_ref)
    assert abs(d_ours["drift_oracle"] - d_ref["drift_oracle"]) <= 1e-12
    assert abs(d_ours["drift_device"] - d_ref["drift_device"]) <= max(
        5e-4, 0.05 * abs(d_ref["drift_oracle"]))
    assert not drift_failed(d_ours)
    # the check restores the state
    np.testing.assert_array_equal(ours.system.positions, pos0)


def test_drift_check_oracle_is_one_native_rollout(monkeypatch):
    from nbody_tpu_torch.oracle import native

    calls = []
    real = native.step_native

    def counting(*args, **kw):
        calls.append(kw.get("steps", 1))
        return real(*args, **kw)

    if not native.native_available():
        pytest.skip("the native oracle library is not built here")
    monkeypatch.setattr(native, "step_native", counting)
    Compute(num_bodies=128, device="cpu", integrator="hermite", log=lambda s: None).drift_check(4)
    assert calls == [4]


def test_cpu_wrappers_take_the_plain_versions_and_launch_nothing():
    pos, vel = _state(300, masses=True)
    p, v = _t(pos), _t(vel)
    before = dict(cuda_kernel.LAUNCHES)
    one = cuda_kernel.compute_accel_jerk_cuda(p, v, p, v, SOFT)
    tri = cuda_kernel.aj_sym_cuda(p, v, SOFT)
    cross = cuda_kernel.aj_sym_cross_cuda(p[:100], v[:100], p[100:], v[100:], SOFT)
    blocked = cuda_kernel.compute_accel_jerk_symmetric_blocked_cuda(p, v, SOFT, block_cap=128,
                                                                    tile=128)
    assert cuda_kernel.LAUNCHES == before
    wants = (reference.compute_accel_jerk(p, v, SOFT),
             reference.compute_accel_jerk_symmetric(p, v, SOFT),
             reference.aj_sym_cross(p[:100], v[:100], p[100:], v[100:], SOFT),
             reference.compute_accel_jerk_symmetric_blocked(p, v, SOFT, block_cap=128,
                                                            tile_j=128))
    for got, want in zip((one, tri, cross, blocked), wants):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rows", "tile", "out_shape", "out_alias", "out_overlap",
                                 "alignment", "dtype", "block_size"])
def test_aj_wrappers_refuse_bad_arguments(bad):
    pos, vel = _state(256)
    p, v = _t(pos), _t(vel)
    if bad == "rows":
        with pytest.raises(ValueError, match="rows"):
            cuda_kernel.compute_accel_jerk_cuda(p, v[:100], p, v, SOFT)
    elif bad == "tile":
        with pytest.raises(ValueError, match="tile"):
            cuda_kernel.aj_sym_cuda(p, v, SOFT, tile=96)
    elif bad == "out_shape":
        with pytest.raises(ValueError, match="shape"):
            cuda_kernel.aj_sym_cuda(p, v, SOFT, out=(torch.empty((256, 4)), torch.empty((256, 3))))
    elif bad == "out_alias":
        # the acceleration written over the velocities it reads
        with pytest.raises(ValueError, match="overlaps"):
            cuda_kernel.aj_sym_cuda(p, v, SOFT, out=(v.view(-1)[:768].view(256, 3),
                                                     torch.empty((256, 3))))
    elif bad == "out_overlap":
        buf = torch.empty(2000)
        with pytest.raises(ValueError, match="overlaps"):
            cuda_kernel.aj_sym_cross_cuda(
                p[:100], v[:100], p[100:], v[100:], SOFT,
                out=(buf[:400].view(100, 4), buf[400:800].view(100, 4),
                     buf[600:1068].view(3, 156), buf[1200:1668].view(3, 156)))
    elif bad == "alignment":
        q = torch.zeros(p.numel() + 1)[1:].view(-1, 4).copy_(p)
        with pytest.raises(ValueError, match="aligned"):
            cuda_kernel.compute_accel_jerk_cuda(q, v, p, v, SOFT)
    elif bad == "dtype":
        with pytest.raises(TypeError, match="float32"):
            cuda_kernel.aj_sym_cross_cuda(p.double(), v.double(), p, v, SOFT)
    else:
        with pytest.raises(ValueError, match="block_size"):
            cuda_kernel.compute_accel_jerk_cuda(p, v, p, v, SOFT, block_size=100)


def test_aj_dispatch_table():
    cap, tile = cuda_kernel.aj_sym_default_dispatch(65536)
    assert tile in cuda_kernel.SYM_TILES and cap % tile == 0
    # the table measured for the kernels of csrc/symmetric_aj_kernels.cu
    # (ops/cuda_kernel.py): tile 512 at every N, cap 65536
    assert (cap, tile) == (65536, 512)
    assert cuda_kernel.aj_sym_default_dispatch(262144) == (cap, tile)
    # one launch's reaction scratch (ceil(N / tile) * 6 * N floats) stays
    # at the force path's 201 MB
    assert -(-cap // tile) * 6 * cap * 4 <= 201 * 2**20
    # the CLI's default N on an H100 is above the cap: the rectangle runs
    k, blk = reference.sym_blocking(4 * 256 * 132, tile, cap)
    assert k >= 2 and blk <= cap


# ---- a float32 emulation of csrc/symmetric_aj_kernels.cu ----
#
# The kernels' algebra (e = dv - w d, w = 3 (d . dv) inv^2; the jerk's action
# s e and reaction -t e), the diagonal's select on s, t and w, and the order
# of their sums: a thread's ROWS rows, a warp's lanes walking each 32-body
# chunk of a 128-body sub-tile in 32 steps with the reactions passed to the
# next lane, the four warps' reactions added in warp order every sub-tile,
# the diagonal's folded into the action of the same body, the tile partials
# added in tile order. The kernels' fused multiply-adds are emulated as a
# product and a sum, so the emulation gives the order, not the bits.

KT = 128  # threads a block, and columns a sub-tile


def _kernel_pair_terms(pi, vi, pj, vj, eps2, keep=None):
    """(action (R,C,6), reaction (R,C,6)) terms of rows pi, vi (R,4) and
    columns pj, vj (C,4) in the kernels' arithmetic; `keep` (R,C) selects."""
    d = pj[None, :, :3] - pi[:, None, :3]
    dv = vj[None, :, :3] - vi[:, None, :3]
    dx, dy, dz = d.unbind(-1)
    r2 = ((dx * dx + eps2) + dy * dy) + dz * dz
    inv = torch.rsqrt(r2)
    inv2 = inv * inv
    inv3 = inv2 * inv
    w = (3.0 * inv2) * ((dx * dv[..., 0] + dy * dv[..., 1]) + dz * dv[..., 2])
    s = pj[None, :, 3] * inv3
    t = pi[:, None, 3] * inv3
    if keep is not None:
        zero = torch.zeros((), dtype=torch.float32)
        s, t, w = (torch.where(keep, x, zero) for x in (s, t, w))
    e = dv - w[..., None] * d
    act = torch.cat([s[..., None] * d, s[..., None] * e], -1)
    react = -torch.cat([t[..., None] * d, t[..., None] * e], -1)
    return act, react


def _kernel_tile_pair(pi, vi, pj, vj, eps2, rows, diag):
    """One T x T tile pair (T = 128 rows), inputs zero-padded to T: (the
    rows' action (T,6), the columns' reaction (T,6)); on the diagonal the
    reaction is folded into the action and the second is zero."""
    t_ = KT * rows
    idx = torch.arange(t_)
    keep = idx[None, :] > idx[:, None] if diag else None
    act_t, react_t = _kernel_pair_terms(pi, vi, pj, vj, eps2, keep)
    lane = idx % 32
    lanes = torch.arange(32)
    warp_rows = torch.arange(4)[:, None] * 32 + lanes[None, :]  # (warp, lane)
    act = torch.zeros((t_, 6))
    react = torch.zeros((t_, 6))
    for sub in range(t_ // KT):
        js0 = sub * KT
        red = torch.zeros((4, KT, 6))
        for c in range(KT // 32):
            re = torch.zeros((4, 32, 6))
            for k in range(32):
                act = act + act_t[idx, js0 + c * 32 + (lane + k) % 32]
                body = js0 + c * 32 + (lanes + k) % 32  # what each lane holds
                for u in range(rows):
                    re = re + react_t[warp_rows + u * KT, body[None, :]]
                re = torch.roll(re, -1, dims=1)  # lane L takes lane L + 1's sums
            red[:, c * 32:(c + 1) * 32] = re
        col = ((red[0] + red[1]) + red[2]) + red[3]
        if diag:
            act[js0:js0 + KT] = act[js0:js0 + KT] + col
        else:
            react[js0:js0 + KT] = col
    return act, react


def _pad(a, m):
    return torch.cat([a, a.new_zeros((m - a.shape[0], 4))])


def _emulate_aj_sym(pos, vel, softening, tile):
    """The triangle kernel and its partial sums: (acc, jerk), each (N,3)."""
    n, rows = pos.shape[0], tile // KT
    tiles = -(-n // tile)
    p, v = _pad(pos, tiles * tile), _pad(vel, tiles * tile)
    eps2 = float(softening) ** 2
    slots = torch.zeros((tiles, tiles * tile, 6))
    for r in range(tiles):
        for c in range(r, tiles):
            rs, cs = slice(r * tile, (r + 1) * tile), slice(c * tile, (c + 1) * tile)
            act, react = _kernel_tile_pair(p[rs], v[rs], p[cs], v[cs], eps2, rows, r == c)
            slots[c, rs] = act
            if r != c:
                slots[r, cs] = react
    total = slots[0]
    for t in range(1, tiles):
        total = total + slots[t]
    return total[:n, :3], total[:n, 3:]


def _emulate_aj_cross(pos_i, vel_i, pos_j, vel_j, softening, tile):
    """The rectangle kernel and its partial sums, in the JAX package's
    layout: (acc_i (Bi,4), jerk_i (Bi,4), both w = 0, react_acc (3,Bj),
    react_jerk (3,Bj))."""
    bi, bj, rows = pos_i.shape[0], pos_j.shape[0], tile // KT
    ri, cj = -(-bi // tile), -(-bj // tile)
    pi, vi = _pad(pos_i, ri * tile), _pad(vel_i, ri * tile)
    pj, vj = _pad(pos_j, cj * tile), _pad(vel_j, cj * tile)
    eps2 = float(softening) ** 2
    acts = torch.zeros((cj, ri * tile, 6))
    reacts = torch.zeros((ri, cj * tile, 6))
    for r in range(ri):
        for c in range(cj):
            rs, cs = slice(r * tile, (r + 1) * tile), slice(c * tile, (c + 1) * tile)
            acts[c, rs], reacts[r, cs] = _kernel_tile_pair(pi[rs], vi[rs], pj[cs], vj[cs],
                                                           eps2, rows, False)
    act, react = acts[0], reacts[0]
    for t in range(1, cj):
        act = act + acts[t]
    for t in range(1, ri):
        react = react + reacts[t]
    zero = torch.zeros((bi, 1))
    return (torch.cat([act[:bi, :3], zero], 1), torch.cat([act[:bi, 3:], zero], 1),
            react[:bj, :3].t(), react[:bj, 3:].t())


def _emulation_state(n, seed):
    """Random ICs, masses from [0.5, 2] with 77 of them zero, a random vel.w."""
    pos, vel = _state(n, "random", seed=seed, masses=True)
    pos[np.random.default_rng(seed).choice(n, 77, replace=False), 3] = 0.0
    return pos, vel


def _held_1e4(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-4


@functools.lru_cache(maxsize=None)
def _jax_aj_sym(n, seed):
    pos, vel = _emulation_state(n, seed)
    return tuple(np.asarray(x) for x in jsym.compute_accel_jerk_symmetric(
        jnp.asarray(pos), jnp.asarray(vel), SOFT, tile_j=128, interpret=True))


@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("n", [333, 700, 1001])
def test_kernel_emulation_triangle_matches_jax(n, tile):
    """The triangle kernel's arithmetic and order against the JAX package's
    interpret-mode _aj_sym_kernel, at 1e-4 * max + 1e-4 (the card's bound)."""
    pos, vel = _emulation_state(n, seed=11)
    got = _emulate_aj_sym(_t(pos), _t(vel), SOFT, tile)
    for g, w in zip(got, _jax_aj_sym(n, 11)):
        _held_1e4(g.numpy(), w)
    for g, w in zip(got, reference.compute_accel_jerk_symmetric(_t(pos), _t(vel), SOFT)):
        _held_1e4(g.numpy(), w.numpy())
    for field in got:  # each pair once
        mf = pos[:, 3:4].astype(np.float64) * field.numpy()
        assert np.abs(mf.sum(axis=0)).max() / np.abs(mf).sum() < 1e-6


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_kernel_emulation_rectangle_matches_jax(tile):
    """The rectangle kernel's arithmetic and order, all four outputs, against
    the JAX package's interpret-mode _aj_sym_cross_kernel on the same sets
    padded with zero-mass slots to its tiles (padding is inert)."""
    pos, vel = _emulation_state(1033, seed=12)
    pi, vi, pj, vj = pos[:333], vel[:333], pos[333:], vel[333:]
    got = _emulate_aj_cross(_t(pi), _t(vi), _t(pj), _t(vj), SOFT, tile)

    def padded(a, m):
        return jnp.asarray(np.concatenate([a, np.zeros((m - a.shape[0], 4), np.float32)]))

    want = jsym._aj_sym_cross(padded(pi, 384), padded(vi, 384), padded(pj, 768).T,
                              padded(vj, 768).T, SOFT, tile_i=64, tile_j=128, interpret=True)
    want = (want[0][:333], want[1][:333], want[2][:, :700], want[3][:, :700])
    assert [tuple(t.shape) for t in got] == [(333, 4), (333, 4), (3, 700), (3, 700)]
    assert not got[0][:, 3].any() and not got[1][:, 3].any()
    for g, w in zip(got, want):
        _held_1e4(g.numpy(), w)
    for g, w in zip(got, reference.aj_sym_cross(_t(pi), _t(vi), _t(pj), _t(vj), SOFT)):
        _held_1e4(g.numpy(), w.numpy())


def test_kernel_emulation_self_pair_adds_zero_at_softening_0():
    """At softening 0 the self pair has inv = inf and w = NaN: the kernels'
    select on s, t and w makes its terms exactly 0, where a 0/1 product
    would make them NaN, so the triangle stays finite and equals the plain
    version (which selects inv3 and c3p)."""
    pos, vel = _emulation_state(333, seed=13)
    p, v = _t(pos), _t(vel)
    idx = torch.arange(128)
    act, react = _kernel_pair_terms(p[:128], v[:128], p[:128], v[:128], 0.0,
                                    idx[None, :] > idx[:, None])
    assert torch.equal(act[idx, idx], torch.zeros((128, 6)))
    assert torch.equal(react[idx, idx], torch.zeros((128, 6)))
    unmasked, _ = _kernel_pair_terms(p[:128], v[:128], p[:128], v[:128], 0.0)
    assert torch.isnan((0.0 * unmasked[idx, idx])).all()
    for tile in (128, 256):
        got = _emulate_aj_sym(p, v, 0.0, tile)
        for g, w in zip(got, reference.compute_accel_jerk_symmetric(p, v, 0.0)):
            _held_1e4(g.numpy(), w.numpy())
