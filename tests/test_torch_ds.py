"""The port's double-single (ds) path against nbody_tpu and the float64 oracle.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its Pallas ds kernels in interpret mode with tile_j=128, as
tests/test_ds_kernel.py runs them; the port's side runs the plain versions
(ops/ds.py), which its CUDA kernels take on a CPU tensor and are held to on
the card. Tolerances, with their reasons:

* the error-free transformations and ds_add / ds_sub / ds_mul / ds_mul_f32
  are the same float32 operations in the same order: bit-equal;
* ds_rsqrt starts from a float32 rsqrt seed, XLA's on the JAX side and
  PyTorch's here, which differ in about a third of the inputs: where the
  seeds agree the results are bit-equal, elsewhere within 5e-14 relative,
  since one Newton step from a float32 seed leaves ~2e-14 on either side
  (the JAX function itself is 1.6e-14 from the exact value);
* a step against the JAX kernels: |dpos| < 1e-11 and relative force < 5e-8,
  the JAX suite's bounds (tests/test_ds_kernel.py:46,53), which cover its
  interpret path's contraction; the sym composition against the JAX one
  and against the one-sided step, 1e-12 (:771);
* against the float64 oracle, where nothing contracts: |dpos| < 1e-12 and
  relative force < 1e-11 (measured 8e-14);
* leapfrog against the JAX kernel, 5e-8, the JAX suite's bound for that
  kernel against the oracle (tests/test_ds_kernel.py:495-496): its interpret
  path lands 4e-10 from the oracle here, the port's plain version 4e-14;
  against the float64 oracle, 1e-12.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models.ds_system import DSBodySystem as JaxDSBodySystem
from nbody_tpu.ops import ds_kernel as jds
from nbody_tpu.oracle.numpy_oracle import accel_numpy, step_numpy, step_numpy_leapfrog
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.cli import drift_failed, main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import DSBodySystem
from nbody_tpu_torch.ops import cuda_kernel, ds
from nbody_tpu_torch.ops.energy import total_energy_f64

SOFT = 0.1
DT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain ds versions are thousands of small eager ops a step; beside
    the suite's other worker processes, intra-op threads only wait for
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state64(n, seed=1, masses=True):
    """Shell ICs in float64; with `masses`, masses from [0.5, 2] drawn in
    float64 (so with a nonzero lo part) and a random vel.w."""
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed, dtype=np.float64)
    if masses:
        rng = np.random.default_rng(seed + 100)
        pos[:, 3] = rng.uniform(0.5, 2.0, n)
        vel[:, 3] = rng.standard_normal(n)
    return pos, vel


def _planes(pos, vel):
    return (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))


def _jax(planes):
    return tuple(jnp.asarray(t.numpy()) for t in planes)


def _f64(hi, lo):
    return ds.ds_to_f64(hi, lo)


def _rel_force(new_vel, vel, ref_vel, dt):
    """The relative force error that a step's velocities carry
    (tests/test_ds_kernel.py:50-52)."""
    a_scale = np.abs(ref_vel[:, :3] - vel[:, :3]).max() / dt
    return np.abs(new_vel[:, :3] - ref_vel[:, :3]).max() / dt / a_scale


def _pairs(seed=0, size=4096):
    rng = np.random.default_rng(seed)
    hi = rng.standard_normal((2, size)).astype(np.float32) * np.float32(100.0)
    lo = (hi * rng.uniform(-1, 1, (2, size)) * 2.0 ** -25).astype(np.float32)
    return (hi[0], lo[0]), (hi[1], lo[1])


# ---- the arithmetic ----


@pytest.mark.parametrize("op", ["ds_add", "ds_sub", "ds_mul"])
def test_ds_ops_bit_equal_to_jax(op):
    x, y = _pairs()
    want = getattr(jds, op)(tuple(map(jnp.asarray, x)), tuple(map(jnp.asarray, y)))
    got = getattr(ds, op)(tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ds_mul_f32_and_eft_bit_equal_to_jax():
    x, y = _pairs(1)
    want = jds.ds_mul_f32(tuple(map(jnp.asarray, x)), jnp.asarray(y[0]))
    got = ds.ds_mul_f32(tuple(map(torch.from_numpy, x)), torch.from_numpy(y[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a, b = (torch.from_numpy(v) for v in (x[0], y[0]))
    for fn in ("_two_sum", "_two_prod", "_split"):
        args = (a,) if fn == "_split" else (a, b)
        want = getattr(jds, fn)(*(jnp.asarray(t.numpy()) for t in args))
        for g, w in zip(getattr(ds, fn)(*args), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the transformations are error-free: the pair holds the exact result
    s, e = ds._two_sum(a, b)
    np.testing.assert_array_equal(s.double() + e.double(), a.double() + b.double())
    p, e = ds._two_prod(a, b)
    np.testing.assert_array_equal(p.double() + e.double(), a.double() * b.double())


def test_ds_rsqrt_against_jax():
    rng = np.random.default_rng(2)
    hi = rng.uniform(0.01, 300.0, 20000).astype(np.float32)
    lo = (hi * rng.uniform(-1, 1, hi.size) * 2.0 ** -25).astype(np.float32)
    want = jds.ds_rsqrt((jnp.asarray(hi), jnp.asarray(lo)))
    got = ds.ds_rsqrt((torch.from_numpy(hi), torch.from_numpy(lo)))
    seeds_agree = np.asarray(jds.jax.lax.rsqrt(jnp.asarray(hi))) == torch.rsqrt(
        torch.from_numpy(hi)).numpy()
    assert seeds_agree.mean() > 0.5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[seeds_agree], np.asarray(w)[seeds_agree])
    g64, w64 = _f64(*got), _f64(*want)
    exact = 1.0 / np.sqrt(hi.astype(np.float64) + lo.astype(np.float64))
    assert np.max(np.abs(g64 - w64) / exact) < 5e-14
    assert np.max(np.abs(g64 - exact) / exact) < 3e-14


def test_ds_from_f64_bit_equal_to_jax_and_round_trip_exact():
    pos, _ = _state64(300)
    hi, lo = ds.ds_from_f64(pos)
    jhi, jlo = jds.ds_from_f64(pos)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(ds.ds_to_f64(hi, lo), jds.ds_to_f64(jhi, jlo))
    # a float64 value keeps ~48 of its 53 bits; the planes round-trip exactly
    assert np.abs(ds.ds_to_f64(hi, lo) - pos).max() <= 2.0 ** -47 * np.abs(pos).max()
    for a, b in zip(ds.ds_from_f64(ds.ds_to_f64(hi, lo)), (hi, lo)):
        assert torch.equal(a, b)
    # and a state born in float32 round-trips exactly (tests/test_ds_kernel.py:33-36)
    p32 = pos.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(ds.ds_to_f64(*ds.ds_from_f64(p32)), p32)


@pytest.mark.parametrize("width", [128, 100])
def test_ds_sum_is_the_lane_tree(width):
    rng = np.random.default_rng(3)
    hi = rng.standard_normal((5, width)).astype(np.float32)
    lo = (hi * rng.uniform(-1, 1, hi.shape) * 2.0 ** -25).astype(np.float32)
    got = ds.ds_sum((torch.from_numpy(hi), torch.from_numpy(lo)), 1)
    if width == 128:
        # a power of two: the JAX package's reduce_ds_lanes, bit for bit
        want = jds.reduce_ds_lanes(jnp.asarray(hi), jnp.asarray(lo))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 0])
    exact = (hi.astype(np.float64) + lo).sum(1)
    assert np.abs(_f64(*got) - exact).max() < 1e-13 * np.abs(hi).sum(1).max()


def test_scal_blocks_equal_jax():
    for port, jax_fn in ((ds.scal_ds, jds._scal_ds), (ds.scal_ds_leapfrog, jds._scal_ds_leapfrog)):
        got = port(0.016, 0.1, 0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(0.016, 0.1, 0.5)))
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4)


# ---- the plain versions of the kernels ----


@pytest.mark.parametrize("n", [256, 333])
def test_ds_step_against_jax_pallas_and_float64_oracle(n):
    pos, vel = _state64(n)
    planes = _planes(pos, vel)
    scal = ds.scal_ds(DT, SOFT, 0.5)
    got = ds.nbody_step_ds(*planes, scal)
    want = jds.nbody_step_pallas_ds(*_jax(planes), jnp.asarray(scal.numpy()), tile_j=128,
                                    interpret=True)
    gp, gv = _f64(*got[:2]), _f64(*got[2:])
    jp, jv = jds.ds_to_f64(*want[:2]), jds.ds_to_f64(*want[2:])
    assert np.abs(gp[:, :3] - jp[:, :3]).max() < 1e-11
    assert _rel_force(gv, vel, jv, DT) < 5e-8
    op, ov = step_numpy(pos, vel, DT, SOFT, 0.5)
    assert np.abs(gp[:, :3] - op[:, :3]).max() < 1e-12
    assert _rel_force(gv, vel, ov, DT) < 1e-11
    # mass (with its lo part) and vel.w pass through both planes
    for g, p in zip(got, planes):
        assert torch.equal(g[:, 3], p[:, 3])


def test_ds_accel_against_float64_oracle():
    pos, _ = _state64(400, seed=5)
    ph, pl = ds.ds_from_f64(pos)
    acc = _f64(*ds.ds_accel_vs(ph, pl, ph, pl, ds.scal_ds(DT, SOFT, 1.0)))
    ref = accel_numpy(pos, SOFT)
    assert np.abs(acc - ref).max() / np.abs(ref).max() < 1e-11
    # an i-vs-j set: the first 100 bodies under all 400
    part = _f64(*ds.ds_accel_vs(ph[:100], pl[:100], ph, pl, ds.scal_ds(DT, SOFT, 1.0)))
    np.testing.assert_array_equal(part, acc[:100])


def test_ds_sym_and_blocked_against_one_sided_and_jax():
    n = 640
    pos, vel = _state64(n, seed=9, masses=False)
    planes = _planes(pos, vel)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    one_sided = _f64(*ds.nbody_step_ds(*planes, scal)[:2])
    tri = ds.ds_accel_symmetric(planes[0], planes[1], scal)
    for cap in (256, 384):
        acc = ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=cap, tile_j=128)
        got = _f64(*ds.ds_integrate(*planes, acc, scal)[:2])
        assert np.abs(got - one_sided).max() < 1e-12, cap
    want = jds.nbody_step_pallas_ds_sym_blocked(*_jax(planes), jnp.asarray(scal.numpy()),
                                                tile_i=64, tile_j=128, interpret=True,
                                                block_cap=256)
    acc = ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=256, tile_j=128)
    got = _f64(*ds.ds_integrate(*planes, acc, scal)[:2])
    assert np.abs(got - jds.ds_to_f64(want[0], want[1])).max() < 1e-12
    # below the cap the composition is the triangle, bit for bit
    under = ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=1024, tile_j=128)
    for u, t in zip(under, tri):
        assert torch.equal(u, t)


def test_ds_sym_random_masses_against_oracle_and_momentum():
    # m_i weighs the reaction, m_j the action: unit masses cannot tell them
    pos, _ = _state64(300, seed=4)
    ph, pl = ds.ds_from_f64(pos)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    ref = accel_numpy(pos, SOFT)
    for acc in (ds.ds_accel_symmetric(ph, pl, scal),
                ds.ds_accel_symmetric_blocked(ph, pl, scal, block_cap=128, tile_j=64)):
        a64 = _f64(*acc)
        assert np.abs(a64 - ref).max() / np.abs(ref).max() < 1e-11
        ma = pos[:, 3:4] * a64
        assert np.abs(ma.sum(0)).max() / np.abs(ma).sum() < 1e-13


def test_ds_sym_cross_layout_and_values():
    pos, _ = _state64(300, seed=6)
    ph, pl = ds.ds_from_f64(pos)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    ah, al, rh, rl = ds.ds_sym_cross(ph[:120], pl[:120], ph[120:], pl[120:], scal)
    assert tuple(ah.shape) == (120, 4) and tuple(rh.shape) == (3, 180)
    assert (ah[:, 3] == 0).all() and (al[:, 3] == 0).all()
    # the i-side is the one-sided force of the j-set on the i-set; the
    # reaction the one-sided force of the i-set on the j-set
    want_i = _f64(*ds.ds_accel_vs(ph[:120], pl[:120], ph[120:], pl[120:], scal))
    want_j = _f64(*ds.ds_accel_vs(ph[120:], pl[120:], ph[:120], pl[:120], scal))
    assert np.abs(_f64(ah, al)[:, :3] - want_i).max() < 1e-12 * np.abs(want_i).max()
    assert np.abs(_f64(rh, rl).T - want_j).max() < 1e-12 * np.abs(want_j).max()


def _accel64_vs(pos_i, pos_j):
    """The float64 force of the j-set on the i-set."""
    d = pos_j[None, :, :3] - pos_i[:, None, :3]
    inv3 = ((d * d).sum(-1) + SOFT * SOFT) ** -1.5
    return (pos_j[None, :, 3, None] * inv3[..., None] * d).sum(1)


def test_ds_chunked_sym_pair_against_jax_and_float64_oracle(monkeypatch):
    # at the test sizes one chunk of the plain versions holds every row;
    # a small chunk makes the triangle and the rectangle carry their
    # reaction across chunks in ds, with a ragged last chunk
    n, cap = 384, 256
    pos, _ = _state64(n, seed=12)
    ph, pl = ds.ds_from_f64(pos)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    whole = (ds.ds_accel_symmetric(ph, pl, scal), ds.ds_accel_vs(ph, pl, ph, pl, scal))
    monkeypatch.setattr(ds, "_CHUNK_ELEMS", 5000)
    assert ds._chunk_rows(n) < n and n % ds._chunk_rows(n)
    tri = ds.ds_accel_symmetric(ph, pl, scal)
    blocked = ds.ds_accel_symmetric_blocked(ph, pl, scal, block_cap=cap, tile_j=128)
    ah, al, rh, rl = ds.ds_sym_cross(ph[:cap], pl[:cap], ph[cap:], pl[cap:], scal)
    ref = accel_numpy(pos, SOFT)
    jscal = jnp.asarray(scal.numpy())
    jtri = jds.compute_accel_pallas_ds_sym(jnp.asarray(ph.numpy()), jnp.asarray(pl.numpy()),
                                           jscal, tile_j=128, interpret=True)
    jblk = jds.compute_accel_pallas_ds_sym_blocked(jnp.asarray(ph.numpy()),
                                                   jnp.asarray(pl.numpy()), jscal, tile_j=128,
                                                   interpret=True, block_cap=cap)
    # the JAX suite's force bound for its interpret path, and the oracle's
    for got, want in ((tri, jtri), (blocked, jblk)):
        g64 = _f64(*got)
        assert np.abs(g64 - jds.ds_to_f64(*want)).max() < 5e-8 * np.abs(ref).max()
        assert np.abs(g64 - ref).max() < 1e-11 * np.abs(ref).max()
    # the rectangle: its i-side is the j-set's force on the i-set, its
    # reaction the i-set's force on the j-set
    for got, want in ((_f64(ah, al)[:, :3], _accel64_vs(pos[:cap], pos[cap:])),
                      (_f64(rh, rl).T, _accel64_vs(pos[cap:], pos[:cap]))):
        assert np.abs(got - want).max() < 1e-11 * np.abs(want).max()
    # chunking reorders only the triangle's ds reaction sum; the one-sided
    # force sums each row alone, so it keeps its bits
    assert np.abs(_f64(*tri) - _f64(*whole[0])).max() < 1e-12 * np.abs(ref).max()
    for a, b in zip(ds.ds_accel_vs(ph, pl, ph, pl, scal), whole[1]):
        assert torch.equal(a, b)


def test_ds_leapfrog_against_jax_pallas_and_float64_oracle():
    n = 256
    pos, vel = _state64(n, seed=3)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_leapfrog(DT, SOFT, 0.5)
    got = ds.nbody_step_ds_leapfrog(*planes, scal)
    want = jds.nbody_step_pallas_ds_leapfrog(*_jax(planes), jnp.asarray(scal.numpy()),
                                             tile_j=128, interpret=True)
    op, ov = step_numpy_leapfrog(pos, vel, DT, SOFT, 0.5)
    for tol, ref_p, ref_v in ((5e-8, jds.ds_to_f64(*want[:2]), jds.ds_to_f64(*want[2:])),
                              (1e-12, op, ov)):
        assert np.abs(_f64(*got[:2])[:, :3] - ref_p[:, :3]).max() < tol
        assert np.abs(_f64(*got[2:])[:, :3] - ref_v[:, :3]).max() < tol
    # the fused step is the half-drift, the force, and the finish
    hh, hl = ds.ds_half_drift(*planes, scal)
    acc = ds.ds_accel_vs(hh, hl, hh, hl, scal)
    for g, w in zip(got, ds.ds_leapfrog_finish(hh, hl, planes[2], planes[3], acc, scal)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 33])
def test_ds_small_n(n):
    pos, vel = _state64(n, seed=8)
    planes = _planes(pos, vel)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    ref = accel_numpy(pos, SOFT)
    for acc in (ds.ds_accel_vs(planes[0], planes[1], planes[0], planes[1], scal),
                ds.ds_accel_symmetric(planes[0], planes[1], scal),
                ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=16,
                                              tile_j=8)):
        a64 = _f64(*acc)
        assert np.isfinite(a64).all()
        assert np.abs(a64 - ref).max() <= 1e-11 * max(np.abs(ref).max(), 1.0)
    op, _ = step_numpy(pos, vel, DT, SOFT, 1.0)
    assert np.abs(_f64(*ds.nbody_step_ds(*planes, scal)[:2]) - op).max() < 1e-12


def test_cpu_wrappers_compute_the_plain_versions_and_launch_nothing():
    pos, vel = _state64(200, seed=2)
    planes = _planes(pos, vel)
    scal = ds.scal_ds(DT, SOFT, 0.5)
    lscal = ds.scal_ds_leapfrog(DT, SOFT, 0.5)
    before = dict(cuda_kernel.LAUNCHES)
    checks = [
        (cuda_kernel.nbody_step_ds_cuda(*planes, scal), ds.nbody_step_ds(*planes, scal)),
        (cuda_kernel.nbody_step_ds_leapfrog_cuda(*planes, lscal),
         ds.nbody_step_ds_leapfrog(*planes, lscal)),
        (cuda_kernel.ds_sym_accel_cuda(planes[0], planes[1], scal),
         ds.ds_accel_symmetric(planes[0], planes[1], scal)),
        (cuda_kernel.ds_sym_cross_cuda(planes[0][:50], planes[1][:50], planes[0][50:],
                                       planes[1][50:], scal),
         ds.ds_sym_cross(planes[0][:50], planes[1][:50], planes[0][50:], planes[1][50:], scal)),
        (cuda_kernel.compute_accel_ds_symmetric_blocked_cuda(planes[0], planes[1], scal,
                                                             block_cap=128, tile=128),
         ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=128, tile_j=128)),
    ]
    acc = checks[2][1]
    checks.append((cuda_kernel.ds_integrate_cuda(*planes, *acc, scal),
                   ds.ds_integrate(*planes, acc, scal)))
    for got, want in checks:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_kernel.LAUNCHES == before


def test_cpu_wrappers_refuse_bad_arguments():
    pos, vel = _state64(64)
    planes = _planes(pos, vel)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    with pytest.raises(ValueError, match="scal"):
        cuda_kernel.nbody_step_ds_cuda(*planes, scal.double())
    with pytest.raises(TypeError):
        cuda_kernel.ds_sym_accel_cuda(planes[0].double(), planes[1], scal)
    with pytest.raises(ValueError, match="rows"):
        cuda_kernel.nbody_step_ds_cuda(planes[0], planes[1][:10], planes[2], planes[3], scal)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.nbody_step_ds_leapfrog_cuda(*planes, scal, out=planes)


# ---- DSBodySystem ----


def _params():
    return NBodyParams(time_step=DT, softening=SOFT, damping=0.5)


def test_planes_carry_over_from_and_to_nbody_tpu_bit_for_bit():
    jparams = JaxNBodyParams(time_step=DT, softening=SOFT, damping=0.5)
    j = JaxDSBodySystem(256, jparams, seed=3, interpret=True)
    s = DSBodySystem(256, _params(), device="cpu", seed=11)
    s.set_ds_state(*j.get_ds_state())
    np.testing.assert_array_equal(s.positions, j.positions)
    np.testing.assert_array_equal(s.velocities, j.velocities)
    for a, b in zip(s.get_ds_state(), j.get_ds_state()):
        np.testing.assert_array_equal(a, b)
    # and back: the port's planes load into nbody_tpu unchanged
    s.update_many(2)
    j.set_ds_state(*s.get_ds_state())
    np.testing.assert_array_equal(j.positions, s.positions)
    # the same seed draws the same float64 initial conditions
    fresh = DSBodySystem(256, _params(), device="cpu", seed=3)
    np.testing.assert_array_equal(fresh.positions, JaxDSBodySystem(
        256, jparams, seed=3, interpret=True).positions)


@pytest.mark.parametrize("integrator, variant", [("euler", "sym"), ("euler", "one_sided"),
                                                 ("leapfrog", "one_sided")])
def test_update_many_equals_the_plain_rollout(integrator, variant):
    pos, vel = _state64(256, seed=5)
    s = DSBodySystem(256, _params(), device="cpu", integrator=integrator, variant=variant,
                     state=(pos, vel))
    s.update_many(3)
    planes = _planes(pos, vel)
    for _ in range(3):
        if integrator == "leapfrog":
            planes = ds.nbody_step_ds_leapfrog(*planes, ds.scal_ds_leapfrog(DT, SOFT, 0.5))
        elif variant == "one_sided":
            planes = ds.nbody_step_ds(*planes, ds.scal_ds(DT, SOFT, 0.5))
        else:
            scal = ds.scal_ds(DT, SOFT, 0.5)
            cap, tile = cuda_kernel.ds_sym_default_dispatch(256)
            acc = ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=cap,
                                                tile_j=tile)
            planes = ds.ds_integrate(*planes, acc, scal)
    for got, want in zip(s.get_ds_state(), planes):
        np.testing.assert_array_equal(got, want.numpy())


def test_variant_resolution_and_refusals():
    # as tests/test_ds_kernel.py:647-666
    params = _params()
    assert DSBodySystem(64, params, device="cpu").variant == "sym"
    assert DSBodySystem(64, params, device="cpu", integrator="leapfrog").variant == "one_sided"
    with pytest.raises(ValueError, match="euler"):
        DSBodySystem(64, params, device="cpu", integrator="leapfrog", variant="sym")
    assert DSBodySystem(64, params, device="cpu", integrator="hermite").variant == "sym"
    with pytest.raises(ValueError, match="integrator"):
        DSBodySystem(64, params, device="cpu", integrator="rk4")
    # a mesh is ported (tests/test_torch_sharded*.py), its 2-D form too,
    # which takes strategy "auto" only, as nbody_tpu's does
    with pytest.raises(ValueError, match="leave strategy at 'auto'"):
        DSBodySystem(64, params, device="cpu", strategy="ring",
                     mesh=types.SimpleNamespace(axis_names=("rows", "cols"), size=4,
                                                device=torch.device("cpu")))
    with pytest.raises(ValueError):
        DSBodySystem(64, params, device="cpu", variant="vpu")
    with pytest.raises(ValueError, match="CUDA"):
        DSBodySystem(64, params, device="cpu", backend="cuda")


def test_sym_and_one_sided_systems_agree():
    params = _params()
    a = DSBodySystem(256, params, device="cpu", seed=5)
    b = DSBodySystem(256, params, device="cpu", seed=5, variant="one_sided")
    a.update_many(5)
    b.update_many(5)
    assert np.abs(a.positions - b.positions).max() < 1e-12


def test_state_accessors_energy_and_forces():
    pos, vel = _state64(200, seed=7)
    s = DSBodySystem(256, _params(), device="cpu", state=(pos, vel))
    # split into ds exactly, padded with zero-mass bodies at the origin
    np.testing.assert_array_equal(s.positions[:200], _f64(*ds.ds_from_f64(pos)))
    assert (s.positions[200:] == 0).all()
    assert s.total_energy() == total_energy_f64(s.positions, s.velocities, SOFT)
    assert abs(s.total_energy(precise=False) - s.total_energy()) < 1e-4 * abs(s.total_energy())
    hi, _ = s.state
    assert hi.dtype == torch.float32 and tuple(hi.shape) == (256, 4)
    ref = accel_numpy(s.positions, SOFT)
    for variant in ("sym", "one_sided"):
        t = DSBodySystem(256, _params(), device="cpu", state=(pos, vel), variant=variant)
        acc = _f64(*t.accelerations())
        assert np.abs(acc - ref).max() < 1e-11 * np.abs(ref).max()
        np.testing.assert_array_equal(t.positions, s.positions)  # the state is left alone
    with pytest.raises(ValueError, match="float32"):
        s.set_ds_state(*(np.zeros((256, 4)),) * 4)


# ---- Compute and the CLI ----


def test_compute_ds_passes_qa_and_both_drift_tiers():
    for integrator in ("euler", "leapfrog"):
        c = Compute(num_bodies=256, device="cpu", precision="ds", integrator=integrator,
                    log=lambda s: None)
        assert c.precision == "ds" and isinstance(c.system, DSBodySystem)
        before = c.system.get_ds_state()
        assert c.compare_results()
        for a, b in zip(before, c.system.get_ds_state()):
            np.testing.assert_array_equal(a, b)
    c = Compute(num_bodies=256, device="cpu", precision="ds", log=lambda s: None)
    before = c.system.get_ds_state()
    drift = c.drift_check(55)
    assert drift["horizon_steps"] == 50 and drift["steps"] == 55
    assert drift["horizon_delta"] <= max(1e-9, 1e-7 * abs(drift["horizon_drift_oracle"]))
    assert not drift_failed(drift)
    for a, b in zip(before, c.system.get_ds_state()):
        np.testing.assert_array_equal(a, b)


def test_compare_results_ds_catches_a_float32_grade_force(monkeypatch):
    c = Compute(num_bodies=256, device="cpu", precision="ds", log=lambda s: None)
    exact = c.system.accelerations

    def rounded():
        hi, lo = exact()
        return (hi + lo).float(), torch.zeros_like(lo)

    monkeypatch.setattr(c.system, "accelerations", rounded)
    assert not c.compare_results()


@pytest.mark.parametrize("drift, failed", [
    ({"delta": 1e-6, "drift_oracle": 1e-3, "horizon_delta": 1e-12,
      "horizon_drift_oracle": 1e-4}, False),
    ({"delta": 1e-6, "drift_oracle": 1e-3, "horizon_delta": 2e-9,
      "horizon_drift_oracle": 1e-4}, True),
    ({"delta": 1e-3, "drift_oracle": 1e-3, "horizon_delta": 1e-12,
      "horizon_drift_oracle": 1e-4}, True),
])
def test_drift_gate_of_ds_has_two_tiers(drift, failed):
    # nbody_tpu/cli.py:362 over the horizon, :374 over the full run
    assert drift_failed(drift) is failed


def test_compute_precision_refusals():
    # precision="fp64" is ported (tests/test_torch_fp64.py): it runs, in
    # float64; ds with fp64=True contradicts it
    c = Compute(num_bodies=64, device="cpu", precision="fp64", log=lambda s: None)
    assert c.system.dtype == torch.float64 and c.fp64_enabled
    with pytest.raises(ValueError, match="contradicts"):
        Compute(num_bodies=64, device="cpu", precision="ds", fp64=True)
    with pytest.raises(ValueError, match="device"):
        Compute(num_bodies=64, device="cpu", precision="ds", placement="host")
    with pytest.raises(ValueError, match="precision"):
        Compute(num_bodies=64, device="cpu", precision="bf16")


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("variant", ["auto", "vpu", "sym", "one_sided", "mxu", "mxu_bf16"])
def test_compute_ds_maps_variants_as_nbody_tpu(integrator, variant):
    # nbody_tpu/compute.py:143-158: every variant but sym and one_sided runs
    # the ds default, and any other raises Compute's error; the two
    # DSBodySystems word their own refusal (sym with leapfrog) differently
    from nbody_tpu.compute import Compute as JaxCompute

    def resolve(make):
        try:
            return make().system.variant
        except ValueError as e:
            return e

    ref = resolve(lambda: JaxCompute(num_bodies=64, precision="ds", variant=variant,
                                     integrator=integrator, interpret=True,
                                     log=lambda s: None))
    got = resolve(lambda: Compute(num_bodies=64, device="cpu", precision="ds",
                                  variant=variant, integrator=integrator,
                                  log=lambda s: None))
    if isinstance(ref, str):
        assert got == ref
    else:
        assert isinstance(got, ValueError)
        if "variants are" in str(ref):
            assert str(got) == str(ref)


def test_benchmark_reports_the_fp64_convention():
    lines = []
    c = Compute(num_bodies=128, device="cpu", precision="ds", log=lines.append)
    res = c.run_benchmark(2)
    assert res["gflops"] == pytest.approx(res["interactions_per_second_e9"] * 30)
    assert lines[-1].endswith(
        "double-single-precision GFLOP/s at 30 flops per interaction (fp64-convention)")


def test_cli_precision_ds_on_cpu(capsys):
    assert main(["--precision", "ds", "--qatest", "--cpu", "--numbodies", "256"]) == 0
    out = capsys.readouterr().out
    assert "256 bodies on cpu [torch kernel, double-single (fp64-grade)]" in out
    assert "ds QA compare vs float64" in out and "-> OK" in out
    assert main(["--precision", "ds", "--integrator", "leapfrog", "--qatest", "--cpu",
                 "--numbodies", "128"]) == 0
    assert main(["--precision", "ds", "--drift-check", "2", "--cpu", "--numbodies", "128"]) == 0
    assert "energy drift over 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("args, says, code", [
    # nbody_tpu's ds measurement modes (_run_ds, cli.py:244-427) run
    # without these flags; the port says that each has no effect
    pytest.param(["--precision", "ds", "--hostmem"],
                 "--hostmem (the ds state stays on the device) has no effect", 0,
                 id="args0-says0"),
    pytest.param(["--precision", "ds", "--integrator", "hermite", "--hostmem"],
                 "--hostmem (the ds state stays on the device) has no effect", 0,
                 id="args1-says1"),
    pytest.param(["--precision", "ds", "--variant", "vpu"],
                 "--variant vpu (the ds default, auto, runs) has no effect", 0,
                 id="args2-says2"),
    # --precision fp64 is ported; beside --fp64, --precision ds exits 1 in
    # nbody_tpu's words (cli.py:449-453)
    pytest.param(["--fp64", "--precision", "ds"], "--precision ds and --fp64 are exclusive", 1,
                 id="args3-says3"),
    pytest.param(["--precision", "ds", "--variant", "mxu_bf16", "--integrator", "leapfrog"],
                 "--variant mxu_bf16 (the ds default, auto, runs) has no effect", 0,
                 id="args4-says4"),
])
def test_cli_precision_refusals_exit_2(capsys, args, says, code):
    """--fp64 beside --precision ds exits 1, as in nbody_tpu; the flags
    nbody_tpu's ds measurement modes ignore run the ds QA, which passes,
    and are named."""
    assert main([*args, "--qatest", "--cpu", "--numbodies", "64"]) == code
    out = capsys.readouterr()
    if code:
        assert says in out.err
    else:
        assert f"--precision ds: {says}" in out.out and "-> OK" in out.out
        assert "force vpu" not in out.out and "force mxu" not in out.out


def test_cli_ds_drift_check_over_0_steps(capsys):
    """nbody_tpu's ds drift check over 0 steps measures the horizon tier
    over 0 steps and exits 0."""
    assert main(["--precision", "ds", "--drift-check", "0", "--cpu", "--numbodies", "64"]) == 0
    assert "energy drift over 0 steps" in capsys.readouterr().out


def test_ds_system_state_setters_and_barriers():
    """set_positions / set_velocities replace one half of the float64
    state (nbody_tpu's BodySystem semantics); block_until_ready and
    hard_sync are the barrier synchronize."""
    pos, vel = _state64(96, seed=4)
    pos2, vel2 = _state64(96, seed=5)

    def planes(state):
        return DSBodySystem(96, _params(), device="cpu", state=state).get_ds_state()

    s = DSBodySystem(96, _params(), device="cpu", state=(pos, vel))
    s.set_positions(pos2)
    for got, want in zip(s.get_ds_state(), planes((pos2, vel))):
        np.testing.assert_array_equal(got, want)
    s.set_velocities(vel2)
    for got, want in zip(s.get_ds_state(), planes((pos2, vel2))):
        np.testing.assert_array_equal(got, want)
    assert DSBodySystem.block_until_ready is DSBodySystem.synchronize
    assert DSBodySystem.hard_sync is DSBodySystem.synchronize
    s.update_many(1)
    s.block_until_ready()
    s.hard_sync()


def test_cli_ds_default_n_is_baseline_config(monkeypatch):
    seen = {}

    class Probe(Exception):
        pass

    def probe(**kw):
        seen.update(kw)
        raise Probe

    monkeypatch.setattr("nbody_tpu_torch.compute.Compute", probe)
    with pytest.raises(Probe):
        main(["--precision", "ds", "--qatest", "--cpu"])
    assert seen["num_bodies"] == 16384 and seen["precision"] == "ds"

