"""The port's double-single Hermite path against nbody_tpu and the float64 oracle.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs its Pallas ds accel + jerk kernels in interpret mode with
tile_j=128, built once for the module; the port's side runs the plain
versions (ops/ds.py), which its CUDA kernels take on a CPU tensor and are
held to on the card. Tolerances, with their reasons:

* the scalar block, the predictor and the corrector are the same float32
  operations in the same order: bit-equal;
* accel + jerk against the JAX kernels: the force within 5e-8 * max|a|, the
  JAX suite's bound for its interpret path (tests/test_ds_kernel.py:53),
  and the jerk within 5e-7 * max|j|: the interpret path's contraction puts
  its jerk up to 1.1e-7 * max|j| from the float64 oracle at this state
  (measured), where the port's plain version is 1.2e-13 from it;
* against the float64 oracle, where nothing contracts: 1e-11 * max for the
  force and the jerk (measured 8e-14 and 1.2e-13);
* a Hermite step against the JAX step: 1e-7, the JAX suite's bound for its
  interpret path against the oracle (tests/test_ds_kernel.py:544-545);
  against the float64 oracle's Hermite step, 1e-12 in positions and
  velocities (measured 2.2e-14 and 3.9e-14);
* sym against one-sided, and blocked against the triangle: 1e-12, the ds
  composition's bound (tests/test_ds_kernel.py:771).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models.ds_system import DSBodySystem as JaxDSBodySystem
from nbody_tpu.ops import ds_kernel as jds
from nbody_tpu.oracle.numpy_oracle import accel_jerk_numpy, step_numpy_hermite
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.cli import drift_failed, main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import DSBodySystem
from nbody_tpu_torch.ops import cuda_kernel, ds

SOFT = 0.1
DT = 1e-3
N_JAX = 160  # two 128-body tiles, the last one ragged
CAP_JAX = 128  # two superblocks: two triangles and one rectangle


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


def _jax(tensors):
    return tuple(jnp.asarray(t.numpy()) for t in tensors)


def _f64(hi, lo):
    return ds.ds_to_f64(hi, lo)


def _fields64(fields):
    """(acc, jerk) float64 (N,3) from four (hi, lo) planes of (N,3) or (N,4)."""
    return _f64(*fields[:2])[:, :3], _f64(*fields[2:])[:, :3]


def _assert_close(got, want, rtol, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (err, rtol * scale)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain ds versions are thousands of small eager ops a step; beside
    the suite's other worker processes, intra-op threads only wait for
    cores (a step measured 300x slower with them)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case():
    """The shared state, its float64 oracle accel + jerk, and the JAX
    package's interpret-mode results on it, each built once."""
    pos, vel = _state64(N_JAX)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 0.5)
    jp, jscal = _jax(planes), jnp.asarray(scal.numpy())
    want = {
        "one_sided": jds.compute_accel_jerk_pallas_ds(*jp, *jp, jscal, tile_j=128,
                                                      interpret=True),
        "triangle": jds.compute_accel_jerk_pallas_ds_sym(*jp, jscal, tile_j=128,
                                                         interpret=True),
        "blocked": jds.compute_accel_jerk_pallas_ds_sym_blocked(*jp, jscal, tile_j=128,
                                                                interpret=True,
                                                                block_cap=CAP_JAX),
        "step": jds.nbody_step_pallas_ds_hermite(*jp, jscal, tile_j=128, interpret=True),
    }
    want = {k: tuple(np.asarray(a) for a in v) for k, v in want.items()}
    return {"pos": pos, "vel": vel, "planes": planes, "scal": scal,
            "oracle": accel_jerk_numpy(pos, vel, SOFT), "jax": want}


# ---- the scalar block, the predictor and the corrector ----


@pytest.mark.parametrize("dt, soft, damping", [(DT, SOFT, 0.5), (0.016, 0.3, 1.0)])
def test_scal_ds_hermite_bit_equal_to_jax(dt, soft, damping):
    got = ds.scal_ds_hermite(dt, soft, damping)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jds._scal_ds_hermite(dt, soft, damping)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8)
    # every power of dt is computed in float64 and kept to the ds grade
    # (hi + lo carries ~48 bits of it)
    d = np.float64(dt)
    exact = np.array([d, d / 2, d * d / 2, d ** 3 / 6, d * d / 12])
    pair = got.numpy().astype(np.float64)[:, [0, 3, 4, 5, 6]].sum(0)
    assert np.all(np.abs(pair - exact) <= 2.0 ** -46 * exact)


def test_predict_and_correct_bit_equal_to_jax(case):
    planes, scal = case["planes"], case["scal"]
    jscal = jnp.asarray(scal.numpy())
    a = tuple(torch.from_numpy(t.copy()) for t in case["jax"]["one_sided"])
    x0, v0 = ds.hermite_planes(*planes[:2]), ds.hermite_planes(*planes[2:])
    a0, j0 = ds.hermite_planes(*a[:2]), ds.hermite_planes(*a[2:])
    xp, vp = ds.hermite_predict(x0, v0, a0, j0, scal)
    want = jds.hermite_predict(_jax(x0), _jax(v0), _jax(a0), _jax(j0), jscal)
    for g, w in zip((*xp, *vp), (*want[0], *want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the predicted state's fields stand in for (a1, j1)
    x1, v1 = ds.hermite_correct(x0, v0, a0, j0, xp, vp, scal)
    want = jds.hermite_correct(_jax(x0), _jax(v0), _jax(a0), _jax(j0), _jax(xp), _jax(vp), jscal)
    for g, w in zip((*x1, *v1), (*want[0], *want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the glue's plain versions assemble the same with mass and vel.w carried
    pred = ds.ds_hermite_predict(*planes, a[:2], a[2:], scal)
    for k in range(4):
        np.testing.assert_array_equal(pred[k][:, :3].numpy(), (*xp, *vp)[k].numpy())
        assert torch.equal(pred[k][:, 3], planes[k][:, 3])


# ---- the plain versions of the kernels ----


@pytest.mark.parametrize("kernel", ["one_sided", "triangle", "blocked"])
def test_ds_accel_jerk_against_jax_pallas_and_float64_oracle(case, kernel):
    planes, scal = case["planes"], case["scal"]
    if kernel == "one_sided":
        got = ds.ds_accel_jerk_vs(*planes, *planes, scal)
        for t in got:  # the JAX layout: (N,4), column 3 zero
            assert tuple(t.shape) == (N_JAX, 4) and (t[:, 3] == 0).all()
    elif kernel == "triangle":
        got = ds.ds_accel_jerk_symmetric(*planes, scal)
    else:
        got = ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=CAP_JAX, tile_j=128)
    acc, jerk = _fields64(got)
    jacc, jjerk = _fields64(case["jax"][kernel])
    ref_acc, ref_jerk = case["oracle"]
    _assert_close(acc, jacc, 5e-8, np.abs(ref_acc).max())
    _assert_close(jerk, jjerk, 5e-7, np.abs(ref_jerk).max())
    _assert_close(acc, ref_acc, 1e-11)
    _assert_close(jerk, ref_jerk, 1e-11)


def test_blocked_composition_below_the_cap_is_the_triangle_and_above_agrees(case):
    planes, scal = case["planes"], case["scal"]
    tri = ds.ds_accel_jerk_symmetric(*planes, scal)
    under = ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=256, tile_j=128)
    for u, t in zip(under, tri):
        assert torch.equal(u, t)
    for cap, tile in ((64, 32), (96, 32), (128, 64)):
        blk = ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=cap, tile_j=tile)
        for got, want in zip(_fields64(blk), _fields64(tri)):
            _assert_close(got, want, 1e-12)


def test_ds_aj_cross_layout_and_values(case):
    ph, pl, vh, vl = case["planes"]
    scal = case["scal"]
    i, j = slice(0, 70), slice(70, None)
    out = ds.ds_aj_sym_cross(ph[i], pl[i], vh[i], vl[i], ph[j], pl[j], vh[j], vl[j], scal)
    assert [tuple(t.shape) for t in out] == [(70, 4)] * 4 + [(3, 90)] * 4
    assert all((t[:, 3] == 0).all() for t in out[:4])
    # the i-side is the j-set's one-sided accel + jerk on the i-set, the
    # reaction the i-set's on the j-set
    want_i = ds.ds_accel_jerk_vs(ph[i], pl[i], vh[i], vl[i], ph[j], pl[j], vh[j], vl[j], scal)
    want_j = ds.ds_accel_jerk_vs(ph[j], pl[j], vh[j], vl[j], ph[i], pl[i], vh[i], vl[i], scal)
    for got, want in zip(_fields64(out[:4]), _fields64(want_i)):
        _assert_close(got, want, 1e-12)
    react = tuple(t.t() for t in out[4:])
    for got, want in zip(_fields64(react), _fields64(want_j)):
        _assert_close(got, want, 1e-12)


def test_ds_aj_sym_momentum_and_its_derivative_vanish():
    # m_i weighs the reaction, m_j the action: unit masses cannot tell them
    pos, vel = _state64(300, seed=4)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 1.0)
    for fields in (ds.ds_accel_jerk_symmetric(*planes, scal),
                   ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=128, tile_j=64)):
        for f in _fields64(fields):
            mf = pos[:, 3:4] * f
            assert np.abs(mf.sum(0)).max() / np.abs(mf).sum() < 1e-13


def test_chunked_plain_versions_agree(monkeypatch):
    # at the test sizes one chunk holds every row; a small chunk makes the
    # triangle and the rectangle carry their reaction across chunks in ds,
    # with a ragged last chunk
    n = 200
    pos, vel = _state64(n, seed=12)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 1.0)
    whole = (ds.ds_accel_jerk_symmetric(*planes, scal),
             ds.ds_accel_jerk_vs(*planes, *planes, scal))
    monkeypatch.setattr(ds, "_CHUNK_ELEMS", 3000)
    assert ds._chunk_rows(n) < n and n % ds._chunk_rows(n)
    for got, want in zip(_fields64(ds.ds_accel_jerk_symmetric(*planes, scal)),
                         _fields64(whole[0])):
        _assert_close(got, want, 1e-12)
    # the one-sided evaluation sums each row alone: chunking keeps its bits
    for a, b in zip(ds.ds_accel_jerk_vs(*planes, *planes, scal), whole[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 33])
def test_ds_aj_small_n(n):
    pos, vel = _state64(n, seed=8)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 1.0)
    ref = accel_jerk_numpy(pos, vel, SOFT)
    for fields in (ds.ds_accel_jerk_vs(*planes, *planes, scal),
                   ds.ds_accel_jerk_symmetric(*planes, scal),
                   ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=16, tile_j=8)):
        for got, want in zip(_fields64(fields), ref):
            assert np.isfinite(got).all()
            _assert_close(got, want, 1e-11, max(np.abs(want).max(), 1.0))


# ---- the Hermite step ----


@pytest.mark.parametrize("sym, cap", [(False, None), (True, None), (True, CAP_JAX)])
def test_ds_hermite_step_against_jax_pallas_and_float64_oracle(case, sym, cap):
    planes, scal = case["planes"], case["scal"]
    got = ds.nbody_step_ds_hermite(*planes, scal, sym=sym, block_cap=cap, tile_j=128)
    gp, gv = _f64(*got[:2]), _f64(*got[2:])
    want = case["jax"]["step"]
    jp, jv = jds.ds_to_f64(*want[:2]), jds.ds_to_f64(*want[2:])
    op, ov = step_numpy_hermite(case["pos"].copy(), case["vel"].copy(), DT, SOFT, 0.5)
    for g, j, o in ((gp, jp, op), (gv, jv, ov)):
        assert np.abs(g[:, :3] - j[:, :3]).max() < 1e-7
        assert np.abs(g[:, :3] - o[:, :3]).max() < 1e-12
    # mass (with its lo part) and vel.w pass through both planes
    for g, p in zip(got, planes):
        assert torch.equal(g[:, 3], p[:, 3])


def test_ds_hermite_is_fourth_order():
    # as tests/test_ds_kernel.py:552-577: against a float64 Hermite run at
    # dt/8, halving dt cuts the one-step error ~16x; allow slack for the
    # chaotic prefactor
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, 512, 1.68, 2.98, seed=7)
    pos, vel = pos.astype(np.float64), vel.astype(np.float64)
    params = NBodyParams(time_step=0.01, softening=SOFT, damping=1.0)

    def err(dt, steps):
        s = DSBodySystem(512, params, device="cpu", integrator="hermite", state=(pos, vel))
        s.update_many(steps, dt)
        op, ov = pos.copy(), vel.copy()
        for _ in range(steps * 8):
            op, ov = step_numpy_hermite(op, ov, dt / 8, SOFT, 1.0)
        return np.abs(s.positions[:, :3] - op[:, :3]).max()

    e_full, e_half = err(0.02, 1), err(0.01, 2)
    assert e_half < e_full / 6, (e_full, e_half)


# ---- DSBodySystem ----


def _params():
    return NBodyParams(time_step=DT, softening=SOFT, damping=0.5)


@pytest.mark.parametrize("variant", ["sym", "one_sided"])
def test_update_many_equals_the_plain_rollout(variant):
    pos, vel = _state64(200, seed=5)
    s = DSBodySystem(200, _params(), device="cpu", integrator="hermite", variant=variant,
                     state=(pos, vel))
    assert s.variant == variant
    s.update_many(3)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 0.5)
    cap, tile = cuda_kernel.ds_aj_sym_default_dispatch(200)
    for _ in range(3):
        planes = ds.nbody_step_ds_hermite(*planes, scal, sym=variant == "sym", block_cap=cap,
                                          tile_j=tile)
    for got, want in zip(s.get_ds_state(), planes):
        np.testing.assert_array_equal(got, want.numpy())


def test_sym_and_one_sided_systems_agree_and_auto_is_sym():
    a = DSBodySystem(256, _params(), device="cpu", seed=5, integrator="hermite")
    b = DSBodySystem(256, _params(), device="cpu", seed=5, integrator="hermite",
                     variant="one_sided")
    assert a.variant == "sym"  # as nbody_tpu resolves 'auto' (ds_system.py:143-148)
    a.update_many(4)
    b.update_many(4)
    assert np.abs(a.positions - b.positions).max() < 1e-12
    assert np.abs(a.velocities - b.velocities).max() < 1e-12


def test_planes_carry_over_from_and_to_nbody_tpu_bit_for_bit():
    jparams = JaxNBodyParams(time_step=DT, softening=SOFT, damping=0.5)
    j = JaxDSBodySystem(256, jparams, seed=3, integrator="hermite", interpret=True)
    s = DSBodySystem(256, _params(), device="cpu", seed=11, integrator="hermite")
    s.set_ds_state(*j.get_ds_state())
    for a, b in zip(s.get_ds_state(), j.get_ds_state()):
        np.testing.assert_array_equal(a, b)
    s.update_many(2)
    j.set_ds_state(*s.get_ds_state())
    np.testing.assert_array_equal(j.positions, s.positions)
    np.testing.assert_array_equal(j.velocities, s.velocities)


def test_accelerations_and_jerks_against_the_float64_oracle():
    pos, vel = _state64(200, seed=7)
    ref_acc, ref_jerk = accel_jerk_numpy(pos, vel, SOFT)
    for integrator, variant in (("hermite", "sym"), ("hermite", "one_sided"),
                                ("euler", "sym"), ("leapfrog", "one_sided")):
        s = DSBodySystem(200, _params(), device="cpu", integrator=integrator, variant=variant,
                         state=(pos, vel))
        before = s.get_ds_state()
        fields = s.accelerations_and_jerks()
        assert all(tuple(f.shape) == (200, 3) for f in fields)
        acc, jerk = _fields64(fields)
        _assert_close(acc, ref_acc, 1e-11)
        _assert_close(jerk, ref_jerk, 1e-11)
        if integrator == "hermite":
            np.testing.assert_array_equal(_f64(*s.accelerations()), acc)
        for a, b in zip(before, s.get_ds_state()):  # the state is left alone
            np.testing.assert_array_equal(a, b)


# ---- Compute and the CLI ----


def test_compute_ds_hermite_passes_qa_and_both_drift_tiers():
    lines = []
    c = Compute(num_bodies=256, device="cpu", precision="ds", integrator="hermite",
                log=lines.append)
    assert c.system.integrator == "hermite" and c.system.variant == "sym"
    before = c.system.get_ds_state()
    assert c.compare_results()
    assert "max |djerk|" in lines[-1] and lines[-1].endswith("-> OK")
    drift = c.drift_check(55)
    assert drift["horizon_steps"] == 50 and drift["steps"] == 55
    assert drift["horizon_delta"] <= max(1e-9, 1e-7 * abs(drift["horizon_drift_oracle"]))
    assert not drift_failed(drift)
    for a, b in zip(before, c.system.get_ds_state()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("field", ["acc", "jerk"])
def test_compare_results_ds_hermite_catches_a_float32_grade_field(monkeypatch, field):
    c = Compute(num_bodies=256, device="cpu", precision="ds", integrator="hermite",
                log=lambda s: None)
    exact = c.system.accelerations_and_jerks
    k = 0 if field == "acc" else 2

    def rounded():
        fields = list(exact())
        fields[k] = (fields[k] + fields[k + 1]).float()
        fields[k + 1] = torch.zeros_like(fields[k + 1])
        return tuple(fields)

    monkeypatch.setattr(c.system, "accelerations_and_jerks", rounded)
    assert not c.compare_results()


def test_cli_ds_hermite_on_cpu(capsys):
    assert main(["--precision", "ds", "--integrator", "hermite", "--qatest", "--cpu",
                 "--numbodies", "256"]) == 0
    out = capsys.readouterr().out
    assert "256 bodies on cpu [torch kernel, double-single (fp64-grade)] force sym, " \
           "integrator hermite" in out
    assert "max |djerk|" in out and "-> OK" in out
    assert main(["--precision", "ds", "--integrator", "hermite", "--benchmark", "-i", "2",
                 "--cpu", "--numbodies", "128"]) == 0
    assert "at 30 flops per interaction (fp64-convention)" in capsys.readouterr().out
    assert main(["--precision", "ds", "--integrator", "hermite", "--drift-check", "3", "--cpu",
                 "--numbodies", "128"]) == 0
    assert "energy drift over 3 steps" in capsys.readouterr().out


# ---- the wrappers on the CPU ----


def test_cpu_wrappers_compute_the_plain_versions_and_launch_nothing():
    pos, vel = _state64(150, seed=2)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 0.5)
    i, j = [t[:50] for t in planes], [t[50:] for t in planes]
    before = dict(cuda_kernel.LAUNCHES)
    one = ds.ds_accel_jerk_vs(*planes, *planes, scal)
    tri = ds.ds_accel_jerk_symmetric(*planes, scal)
    pred = ds.ds_hermite_predict(*planes, one[:2], one[2:], scal)
    one1 = ds.ds_accel_jerk_vs(*pred, *pred, scal)
    checks = [
        (cuda_kernel.compute_accel_jerk_ds_cuda_vs(*planes, *planes, scal), one),
        (cuda_kernel.ds_aj_sym_cuda(*planes, scal), tri),
        (cuda_kernel.ds_aj_sym_cross_cuda(*i, *j, scal), ds.ds_aj_sym_cross(*i, *j, scal)),
        (cuda_kernel.compute_accel_jerk_ds_symmetric_blocked_cuda(*planes, scal, block_cap=128,
                                                                  tile=128),
         ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=128, tile_j=128)),
        (cuda_kernel.ds_hermite_predict_cuda(*planes, *tri, scal),
         ds.ds_hermite_predict(*planes, tri[:2], tri[2:], scal)),
        (cuda_kernel.ds_hermite_correct_cuda(*planes, *one, *one1, scal),
         ds.ds_hermite_correct(*planes, one[:2], one[2:], one1[:2], one1[2:], scal)),
    ]
    for got, want in checks:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_kernel.LAUNCHES == before


def test_cpu_wrappers_refuse_bad_arguments():
    pos, vel = _state64(64)
    planes = _planes(pos, vel)
    scal = ds.scal_ds_hermite(DT, SOFT, 1.0)
    fields = ds.ds_accel_jerk_symmetric(*planes, scal)
    with pytest.raises(ValueError, match="scal"):  # the glue needs the (2, 8) block
        cuda_kernel.ds_hermite_predict_cuda(*planes, *fields, ds.scal_ds(DT, SOFT, 1.0))
    for tile in (512, 1024):  # ROWS 4 and 8 are not built
        with pytest.raises(ValueError, match="tile"):
            cuda_kernel.ds_aj_sym_cuda(*planes, scal, tile=tile)
    with pytest.raises(ValueError, match="shape"):  # (N,3) and (N,4) fields mixed
        cuda_kernel.ds_hermite_correct_cuda(
            *planes, *fields, *ds.ds_accel_jerk_vs(*planes, *planes, scal), scal)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.ds_hermite_predict_cuda(*planes, *fields, scal, out=planes)
    with pytest.raises(ValueError, match="rows"):
        cuda_kernel.compute_accel_jerk_ds_cuda_vs(planes[0], planes[1][:10], *planes[2:],
                                                  *planes, scal)
