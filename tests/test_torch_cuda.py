"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card. The file imports no JAX, so it also runs where JAX is
not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Tolerances: only the order of the j-sum differs between kernel and plain
version, so the acceleration is held to 1e-4 * max|a| + 1e-4
(tests/test_pallas.py:76) and one demo-0 step to 1e-5 at these N, or to
that bound carried through the step where masses are random. The jerk and
the potential's per-row sums are held to the same rule of their own
maximum.
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.models.body_system import AUTO_VARIANT_CUDA
from nbody_tpu_torch.ops import cuda_kernel, energy, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    SYM_TILES,
    aj_sym_cross_cuda,
    aj_sym_cuda,
    compute_accel_cuda,
    compute_accel_jerk_cuda,
    compute_accel_jerk_symmetric_blocked_cuda,
    compute_accel_symmetric_blocked_cuda,
    nbody_step_cuda,
    nbody_step_cuda_vs,
    potential_energy_per_row_cuda,
    sym_accel_cuda,
    sym_cross_cuda,
)

pytestmark = pytest.mark.cuda

DT, SOFT, DAMP = 0.016, 0.1, 1.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _state(n, dev, seed=42):
    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed)
    return torch.tensor(pos, device=dev), torch.tensor(vel, device=dev)


@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("block_size", [128, 256])
def test_kernels_match_plain(dev, n, block_size):
    p, v = _state(n, dev)
    before = dict(cuda_kernel.LAUNCHES)
    a_k = compute_accel_cuda(p, p, SOFT, block_size=block_size)
    p_k, v_k = nbody_step_cuda(p, v, DT, SOFT, DAMP, block_size=block_size)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["accel"] == before["accel"] + 1
    assert cuda_kernel.LAUNCHES["step"] == before["step"] + 1
    a_r = reference.compute_accel(p, SOFT)
    p_r, v_r = reference.nbody_step(p, v, DT, SOFT, DAMP)
    assert (a_k - a_r).abs().max().item() <= 1e-4 * a_r.abs().max().item() + 1e-4
    assert (p_k - p_r).abs().max().item() <= 1e-5
    assert (v_k - v_r).abs().max().item() <= 1e-5
    assert torch.equal(p_k[:, 3], p[:, 3]) and torch.equal(v_k[:, 3], v[:, 3])


@pytest.mark.parametrize("n", [4099, 65536])
def test_kernels_weight_by_m_j_damp_and_keep_w_lanes(dev, n):
    # shell ICs have unit masses and vel.w = 0, and demo 0 damping 1: random
    # masses, vel.w and damping 0.5 catch a kernel that weights a pair by
    # m_i, drops the damping or zeroes vel.w
    p, v = _state(n, dev)
    rng = np.random.default_rng(7)
    p[:, 3] = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=dev)
    v[:, 3] = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    damping = 0.5
    a_k = compute_accel_cuda(p, p, SOFT)
    p_k, v_k = nbody_step_cuda(p, v, DT, SOFT, damping)
    a_r = reference.compute_accel(p, SOFT)
    p_r, v_r = reference.nbody_step(p, v, DT, SOFT, damping)
    tol_a = 1e-4 * a_r.abs().max().item() + 1e-4
    # the step carries the accel bound through v += a*dt and p += v*dt
    assert (a_k - a_r).abs().max().item() <= tol_a
    assert (v_k - v_r).abs().max().item() <= 1e-5 + DT * tol_a
    assert (p_k - p_r).abs().max().item() <= 1e-5 + DT * DT * tol_a
    assert torch.equal(p_k[:, 3], p[:, 3]) and torch.equal(v_k[:, 3], v[:, 3])


def test_misaligned_cuda_tensor_raises_before_launch(dev):
    p, v = _state(256, dev)
    before = dict(cuda_kernel.LAUNCHES)
    bad = torch.zeros(p.numel() + 1, device=dev)[1:].view(-1, 4).copy_(p)
    with pytest.raises(ValueError, match="aligned"):
        nbody_step_cuda(bad, v, DT, SOFT, DAMP)
    with pytest.raises(ValueError, match="aligned"):
        compute_accel_cuda(bad, p, SOFT)
    assert cuda_kernel.LAUNCHES == before
    # the context is still usable
    assert torch.isfinite(compute_accel_cuda(p, p, SOFT)).all()


@pytest.mark.parametrize("m, n", [(1, 33), (777, 4099), (4099, 777)])
def test_i_vs_j_ragged_edges(dev, m, n):
    pj, _ = _state(n, dev)
    pi, vi = _state(m, dev, seed=3)
    p_k, v_k = nbody_step_cuda_vs(pi, vi, pj, DT, SOFT, DAMP, block_size=128)
    p_r, v_r = reference.nbody_step_vs(pi, vi, pj, DT, SOFT, DAMP)
    assert (p_k - p_r).abs().max().item() <= 1e-5
    assert (v_k - v_r).abs().max().item() <= 1e-5


def test_zero_softening_gives_nan_like_the_plain_version(dev):
    p, _ = _state(256, dev)
    assert torch.isnan(compute_accel_cuda(p, p, 0.0)).all()
    assert torch.isnan(reference.compute_accel(p, 0.0)).all()


def test_float64_cuda_tensor_raises(dev):
    p = torch.zeros((8, 4), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        nbody_step_cuda(p, p.clone(), DT, SOFT, DAMP)


def test_body_system_kernel_matches_plain_backend(dev):
    n = 4096
    params = DEMO_PARAMS[0].replace(cluster_scale=tuned_scales(n)[0],
                                    velocity_scale=tuned_scales(n)[1])
    k = BodySystem(n, params, device=dev, variant="vpu")
    t = BodySystem(n, params, device=dev, backend="torch", variant="vpu")
    assert k.backend == "cuda" and t.backend == "torch"
    before = cuda_kernel.LAUNCHES["step"]
    k.update_many(3)
    t.update_many(3)
    assert cuda_kernel.LAUNCHES["step"] == before + 3
    # three steps of the one-step bound
    np.testing.assert_allclose(k.positions, t.positions, atol=3e-5)
    np.testing.assert_allclose(k.velocities, t.velocities, atol=3e-5)


def test_host_placement_is_pinned_and_bit_exact(dev):
    n = 2048
    params = DEMO_PARAMS[0]
    d = BodySystem(n, params, device=dev, placement="device")
    h = BodySystem(n, params, device=dev, placement="host")
    assert h.state[0].is_pinned() and h.state[0].device.type == "cpu"
    d.update_many(4)
    h.update_many(4)
    d.synchronize()
    np.testing.assert_array_equal(d.positions, h.positions)
    np.testing.assert_array_equal(d.velocities, h.velocities)


def test_compute_qa_on_card(dev):
    c = Compute(num_bodies=4096, device=dev, variant="vpu", log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    assert cuda_kernel.LAUNCHES["step"] > before["step"]
    assert cuda_kernel.LAUNCHES["accel"] > before["accel"]


def _tol(ref):
    return 1e-4 * ref.abs().max().item() + 1e-4


def _random_w(p, v, seed=7):
    rng = np.random.default_rng(seed)
    n = p.shape[0]
    p[:, 3] = torch.tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32, device=p.device)
    v[:, 3] = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=p.device)
    return p, v


@pytest.mark.parametrize("n", [1, 33, 333, 1000, 4099])
@pytest.mark.parametrize("tile", [128, 1024])
def test_sym_triangle_matches_plain(dev, n, tile):
    p, v = _random_w(*_state(n, dev))
    before = dict(cuda_kernel.LAUNCHES)
    a_k = sym_accel_cuda(p, SOFT, tile=tile)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["sym"] == before["sym"] + 1
    a_r = reference.compute_accel_symmetric(p, SOFT)
    assert (a_k - a_r).abs().max().item() <= _tol(a_r)
    # no atomics: a second call gives the same bits
    assert torch.equal(a_k, sym_accel_cuda(p, SOFT, tile=tile))


@pytest.mark.parametrize("bi, bj", [(1, 33), (33, 1), (333, 1000), (1000, 333), (4099, 4099)])
def test_sym_cross_matches_plain(dev, bi, bj):
    pi, _ = _random_w(*_state(bi, dev, seed=3))
    pj, _ = _random_w(*_state(bj, dev))
    before = cuda_kernel.LAUNCHES["sym_cross"]
    a_k, r_k = sym_cross_cuda(pi, pj, SOFT)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["sym_cross"] == before + 1
    a_r, r_r = reference.sym_cross(pi, pj, SOFT)
    assert a_k.shape == (bi, 4) and r_k.shape == (3, bj)
    assert (a_k - a_r).abs().max().item() <= _tol(a_r)
    assert (r_k - r_r).abs().max().item() <= _tol(r_r)
    assert not a_k[:, 3].any()
    a2, r2 = sym_cross_cuda(pi, pj, SOFT)
    assert torch.equal(a_k, a2) and torch.equal(r_k, r2)


@pytest.mark.parametrize("n", [4099, 65536])
def test_sym_step_random_masses_and_damping(dev, n):
    """The blocked composition (two triangles and a rectangle: a cap of
    half of N rounded up to the tile), masses from [0.5, 2], a random vel.w
    and damping 0.5, through a step."""
    p, v = _random_w(*_state(n, dev))
    cap = -(-n // 512) * 256
    before = dict(cuda_kernel.LAUNCHES)
    a_k = compute_accel_symmetric_blocked_cuda(p, SOFT, block_cap=cap, tile=256)
    assert cuda_kernel.LAUNCHES["sym"] == before["sym"] + 2
    assert cuda_kernel.LAUNCHES["sym_cross"] == before["sym_cross"] + 1
    a_r = reference.compute_accel_symmetric_blocked(p, SOFT, block_cap=cap, tile_j=256)
    tol_a = _tol(a_r)
    assert (a_k - a_r).abs().max().item() <= tol_a
    out = (torch.empty_like(p), torch.empty_like(v))
    reference.integrate_into(p, v, a_k, DT, 0.5, out)
    p_r, v_r = reference.integrate(p, v, a_r, DT, 0.5)
    assert (out[1] - v_r).abs().max().item() <= 1e-5 + DT * tol_a
    assert (out[0] - p_r).abs().max().item() <= 1e-5 + DT * DT * tol_a
    assert torch.equal(out[0][:, 3], p[:, 3]) and torch.equal(out[1][:, 3], v[:, 3])


def test_sym_bad_out_refused_before_launch(dev):
    p, _ = _state(256, dev)
    before = dict(cuda_kernel.LAUNCHES)
    misaligned = torch.empty(256 * 3 + 1, device=dev)[1:].view(256, 3)
    with pytest.raises(ValueError, match="aligned"):
        sym_accel_cuda(p, SOFT, out=misaligned)
    with pytest.raises(ValueError, match="overlaps"):
        sym_accel_cuda(p, SOFT, out=p.view(-1)[:768].view(256, 3))
    buf = torch.empty(1000, device=dev)
    with pytest.raises(ValueError, match="overlaps"):
        sym_cross_cuda(p[:100], p[100:], SOFT,
                       out=(buf[:400].view(100, 4), buf[:468].view(3, 156)))
    assert cuda_kernel.LAUNCHES == before
    assert torch.isfinite(sym_accel_cuda(p, SOFT)).all()


def test_sym_every_tile_gives_one_force(dev):
    p, _ = _state(3000, dev)
    forces = [sym_accel_cuda(p, SOFT, tile=t) for t in SYM_TILES]
    a_r = reference.compute_accel(p, SOFT)
    for a in forces:
        assert (a - a_r).abs().max().item() <= _tol(a_r)


def test_body_system_auto_is_sym_on_the_card(dev):
    n = 4096
    params = DEMO_PARAMS[0].replace(cluster_scale=tuned_scales(n)[0],
                                    velocity_scale=tuned_scales(n)[1])
    s = BodySystem(n, params, device=dev)
    assert s.variant == "sym" and s.backend == "cuda"
    t = BodySystem(n, params, device=dev, backend="torch", variant="sym")
    before = dict(cuda_kernel.LAUNCHES)
    s.update_many(3)
    t.update_many(3)
    assert cuda_kernel.LAUNCHES["sym"] == before["sym"] + 3
    assert cuda_kernel.LAUNCHES["step"] == before["step"]
    np.testing.assert_allclose(s.positions, t.positions, atol=3e-5)
    np.testing.assert_allclose(s.velocities, t.velocities, atol=3e-5)


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_compute_leapfrog_qa_on_card(dev, variant):
    c = Compute(num_bodies=4096, device=dev, variant=variant, integrator="leapfrog",
                log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    kernel = "sym" if variant == "sym" else "accel"
    assert cuda_kernel.LAUNCHES[kernel] > before[kernel]


# ---- accel + jerk and the potential ----


def _held(got, want):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= _tol(w)


@pytest.mark.parametrize("m, n", [(1, 33), (1000, 1000), (777, 4099), (4099, 777)])
@pytest.mark.parametrize("block_size", [128, 256])
def test_accel_jerk_matches_plain(dev, m, n, block_size):
    pi, vi = _random_w(*_state(m, dev, seed=3))
    pj, vj = _random_w(*_state(n, dev))
    before = cuda_kernel.LAUNCHES["accel_jerk"]
    got = compute_accel_jerk_cuda(pi, vi, pj, vj, SOFT, block_size=block_size)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["accel_jerk"] == before + 1
    assert got[0].shape == (m, 3) and got[1].shape == (m, 3)
    _held(got, reference.compute_accel_jerk_vs(pi, vi, pj, vj, SOFT))


@pytest.mark.parametrize("n", [1, 33, 333, 1000, 4099])
@pytest.mark.parametrize("tile", [128, 512, 1024])
def test_aj_sym_triangle_matches_plain(dev, n, tile):
    p, v = _random_w(*_state(n, dev))
    before = cuda_kernel.LAUNCHES["aj_sym"]
    got = aj_sym_cuda(p, v, SOFT, tile=tile)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["aj_sym"] == before + 1
    _held(got, reference.compute_accel_jerk_symmetric(p, v, SOFT))
    # no atomics: a second call gives the same bits
    again = aj_sym_cuda(p, v, SOFT, tile=tile)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("bi, bj", [(1, 33), (33, 1), (333, 1000), (1000, 333), (4099, 4099)])
def test_aj_sym_cross_matches_plain(dev, bi, bj):
    pi, vi = _random_w(*_state(bi, dev, seed=3))
    pj, vj = _random_w(*_state(bj, dev))
    before = cuda_kernel.LAUNCHES["aj_sym_cross"]
    got = aj_sym_cross_cuda(pi, vi, pj, vj, SOFT)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["aj_sym_cross"] == before + 1
    assert [tuple(t.shape) for t in got] == [(bi, 4), (bi, 4), (3, bj), (3, bj)]
    _held(got, reference.aj_sym_cross(pi, vi, pj, vj, SOFT))
    assert not got[0][:, 3].any() and not got[1][:, 3].any()
    again = aj_sym_cross_cuda(pi, vi, pj, vj, SOFT)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("n", [4099, 65536])
def test_aj_sym_blocked_random_masses_momentum_and_hermite_step(dev, n):
    """The blocked composition (two triangles and a rectangle), masses from
    [0.5, 2], a random vel.w and damping 0.5 through one Hermite step; each
    pair once, so sum m a and sum m j vanish to the rounding of N-term sums
    (the JAX suite's 1e-6 at N=384, grown with sqrt(N / 384))."""
    p, v = _random_w(*_state(n, dev))
    cap = -(-n // 512) * 256
    before = dict(cuda_kernel.LAUNCHES)
    got = compute_accel_jerk_symmetric_blocked_cuda(p, v, SOFT, block_cap=cap, tile=256)
    assert cuda_kernel.LAUNCHES["aj_sym"] == before["aj_sym"] + 2
    assert cuda_kernel.LAUNCHES["aj_sym_cross"] == before["aj_sym_cross"] + 1
    want = reference.compute_accel_jerk_symmetric_blocked(p, v, SOFT, block_cap=cap, tile_j=256)
    _held(got, want)
    m = p[:, 3:4].double()
    for field in got:
        mf = m * field.double()
        assert mf.sum(0).abs().max().item() / mf.abs().sum().item() <= 1e-6 * (n / 384) ** 0.5

    def aj_kernel(p4, v4):
        return compute_accel_jerk_symmetric_blocked_cuda(p4, v4, SOFT, block_cap=cap, tile=256)

    p_k, v_k = reference.nbody_step_hermite(p, v, DT, SOFT, 0.5, accel_jerk_fn=aj_kernel)
    p_r, v_r = reference.nbody_step_hermite(p, v, DT, SOFT, 0.5, accel_jerk_fn=lambda a, b: (
        reference.compute_accel_jerk_symmetric_blocked(a, b, SOFT, block_cap=cap, tile_j=256)))
    tol_a = _tol(want[0])
    # the step carries the acceleration bound into v as dt * da and into p
    # as dt^2 * da (the jerk terms add dt^2 and dt^3 of the jerk bound)
    tol_j = _tol(want[1])
    assert (v_k - v_r).abs().max().item() <= 1e-5 + DT * tol_a + DT * DT * tol_j
    assert (p_k - p_r).abs().max().item() <= 1e-5 + DT * DT * tol_a + DT ** 3 * tol_j
    assert torch.equal(p_k[:, 3], p[:, 3]) and torch.equal(v_k[:, 3], v[:, 3])


@pytest.mark.parametrize("n", [1, 333, 4099])
@pytest.mark.parametrize("block_size", [128, 256])
def test_potential_matches_plain(dev, n, block_size):
    p, _ = _random_w(*_state(n, dev))
    before = cuda_kernel.LAUNCHES["potential"]
    got = potential_energy_per_row_cuda(p, SOFT, block_size=block_size)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["potential"] == before + 1
    _held((got,), (energy.potential_energy_per_row(p, SOFT),))


def test_potential_masks_self_pair_by_index_at_zero_softening(dev):
    # d = 0 only for the self pair here, which is inf at eps = 0: masked
    # by its index, it adds nothing, so every row is finite
    p, _ = _state(256, dev)
    got = potential_energy_per_row_cuda(p, 0.0)
    assert torch.isfinite(got).all()
    _held((got,), (energy.potential_energy_per_row(p, 0.0),))


def test_new_wrappers_refuse_bad_arguments_before_launch(dev):
    p, v = _state(256, dev)
    before = dict(cuda_kernel.LAUNCHES)
    bad = torch.zeros(p.numel() + 1, device=dev)[1:].view(-1, 4).copy_(p)
    with pytest.raises(ValueError, match="aligned"):
        compute_accel_jerk_cuda(p, bad, p, v, SOFT)
    with pytest.raises(ValueError, match="aligned"):
        potential_energy_per_row_cuda(bad, SOFT)
    with pytest.raises(ValueError, match="rows"):
        aj_sym_cuda(p, v[:100], SOFT)
    with pytest.raises(TypeError):
        aj_sym_cuda(p.double(), v.double(), SOFT)
    with pytest.raises(ValueError, match="overlaps"):
        aj_sym_cuda(p, v, SOFT, out=(p.view(-1)[:768].view(256, 3), torch.empty((256, 3), device=dev)))
    buf = torch.empty(4000, device=dev)
    with pytest.raises(ValueError, match="overlaps"):
        aj_sym_cross_cuda(p[:100], v[:100], p[100:], v[100:], SOFT,
                          out=(buf[:400].view(100, 4), buf[400:800].view(100, 4),
                               buf[:468].view(3, 156), buf[1000:1468].view(3, 156)))
    assert cuda_kernel.LAUNCHES == before
    assert torch.isfinite(aj_sym_cuda(p, v, SOFT)[1]).all()


@pytest.mark.parametrize("variant", ["vpu", "sym"])
def test_compute_hermite_qa_and_drift_on_card(dev, variant):
    c = Compute(num_bodies=4096, device=dev, variant=variant, integrator="hermite",
                log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    kernel = "aj_sym" if variant == "sym" else "accel_jerk"
    assert cuda_kernel.LAUNCHES[kernel] > before[kernel]
    drift = c.drift_check(3)
    assert drift["delta"] <= max(5e-4, 0.05 * abs(drift["drift_oracle"]))


def test_hermite_host_placement_is_bit_exact_and_auto_is_measured(dev):
    n = 2048
    params = DEMO_PARAMS[0]
    d = BodySystem(n, params, device=dev, placement="device", integrator="hermite")
    h = BodySystem(n, params, device=dev, placement="host", integrator="hermite")
    assert d.variant == h.variant == AUTO_VARIANT_CUDA
    d.update_many(3)
    h.update_many(3)
    d.synchronize()
    np.testing.assert_array_equal(d.positions, h.positions)
    np.testing.assert_array_equal(d.velocities, h.velocities)


def test_total_energy_kernel_against_precise(dev):
    n = 4096
    params = DEMO_PARAMS[0].replace(cluster_scale=tuned_scales(n)[0],
                                    velocity_scale=tuned_scales(n)[1])
    s = BodySystem(n, params, device=dev)
    before = cuda_kernel.LAUNCHES["potential"]
    fast = s.total_energy()
    assert cuda_kernel.LAUNCHES["potential"] == before + 1
    precise = s.total_energy(precise=True)
    # f32 pair terms and f32 sums against the float64 functional
    assert abs(fast - precise) / abs(precise) < 1e-4


# ---- double-single (csrc/ds_kernels.cu, csrc/ds_symmetric_kernels.cu) ----
#
# Each ds output, as hi + lo in float64, is held to its plain version
# (ops/ds.py) within 1e-12 * max + 1e-14: both are ds-grade, and only the
# order of the ds sums and the float32 rsqrt seed (the card's rsqrtf against
# PyTorch's) differ. Each force is held to the float64 oracle's within
# 1e-10 * max|a|, which a float32-grade force misses by three orders.


def _ds_planes(n, dev, seed=42):
    """Shell ICs in float64 with masses from [0.5, 2] (so with a lo part)
    and a random vel.w, as four planes on `dev`, and the float64 state."""
    from nbody_tpu_torch.ops import ds

    demo = DEMO_PARAMS[0]
    scales = tuned_scales(n) or (demo.cluster_scale, demo.velocity_scale)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, *scales, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(7)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    planes = tuple(t.to(dev) for t in (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel)))
    return planes, pos


def _ds_held(got, want):
    from nbody_tpu_torch.ops import ds

    for g, w in zip(got, want):
        g64, w64 = ds.ds_to_f64(*g), ds.ds_to_f64(*w)
        assert np.isfinite(g64).all()
        assert np.abs(g64 - w64).max() <= 1e-12 * np.abs(w64).max() + 1e-14


def _ds_oracle_held(acc, pos64):
    from nbody_tpu_torch.compute import _oracle_accel
    from nbody_tpu_torch.ops import ds

    ref = _oracle_accel(pos64, SOFT)
    assert np.abs(ds.ds_to_f64(*acc)[:, :3] - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("kernel", ["ds_step", "ds_leapfrog", "ds_sym", "ds_sym_cross",
                                    "ds_sym_512", "ds_sym_cross_512"])
def test_ds_kernels_match_plain_and_oracle(dev, kernel):
    from nbody_tpu_torch.ops import ds

    # the sym pair at tile 256 and, with the suffix, at 512: the two tiles
    # of ds_sym_default_dispatch
    tile = 512 if kernel.endswith("_512") else 256
    kernel = kernel.removesuffix("_512")
    n = 4099
    planes, pos64 = _ds_planes(n, dev)
    # damping 0.5: a kernel that drops the damping fails the step checks
    scal = (ds.scal_ds_leapfrog if kernel == "ds_leapfrog" else ds.scal_ds)(DT, SOFT, 0.5)
    before = dict(cuda_kernel.LAUNCHES)
    zero = torch.zeros_like(planes[2])
    if kernel == "ds_step":
        got = cuda_kernel.nbody_step_ds_cuda(*planes, scal)
        want = ds.nbody_step_ds(*planes, scal)
        # one step from zero velocity with dt = 1, damping 1 leaves v' = a
        acc = cuda_kernel.nbody_step_ds_cuda(planes[0], planes[1], zero, zero, ds.scal_ds(1.0, SOFT, 1.0))[2:]
    elif kernel == "ds_leapfrog":
        got = cuda_kernel.nbody_step_ds_leapfrog_cuda(*planes, scal)
        want = ds.nbody_step_ds_leapfrog(*planes, scal)
        acc = cuda_kernel.nbody_step_ds_leapfrog_cuda(planes[0], planes[1], zero, zero,
                                                      ds.scal_ds_leapfrog(1.0, SOFT, 1.0))[2:]
    elif kernel == "ds_sym":
        got = cuda_kernel.ds_sym_accel_cuda(planes[0], planes[1], scal, tile=tile)
        want = ds.ds_accel_symmetric(planes[0], planes[1], scal)
        acc = got
    else:
        # a small cap forces the composition: 3 triangles and 3 rectangles
        got = cuda_kernel.compute_accel_ds_symmetric_blocked_cuda(
            planes[0], planes[1], scal, block_cap=1536, tile=tile)
        want = ds.ds_accel_symmetric_blocked(planes[0], planes[1], scal, block_cap=1536,
                                             tile_j=tile)
        acc = got
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES[kernel] > before[kernel]
    pairs = lambda t: [t[:2], t[2:]] if len(t) == 4 else [t]  # noqa: E731
    _ds_held(pairs(got), pairs(want))
    _ds_oracle_held(acc, pos64)
    if len(got) == 4:
        # mass and vel.w carried through from both planes
        for g, p in zip(got, planes):
            assert torch.equal(g[:, 3], p[:, 3])


def test_ds_sym_pair_repeats_bit_for_bit(dev):
    from nbody_tpu_torch.ops import ds

    planes, _ = _ds_planes(4099, dev)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    for kw in ({}, {"block_cap": 1536, "tile": 256}):
        a = cuda_kernel.compute_accel_ds_symmetric_blocked_cuda(planes[0], planes[1], scal, **kw)
        b = cuda_kernel.compute_accel_ds_symmetric_blocked_cuda(planes[0], planes[1], scal, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("integrator, variant", [("euler", "sym"), ("euler", "one_sided"),
                                                 ("leapfrog", "auto")])
def test_ds_system_kernels_against_plain_backend(dev, monkeypatch, integrator, variant):
    from nbody_tpu_torch.models import DSBodySystem

    # a small cap, so the sym path composes triangles and rectangles
    monkeypatch.setattr(cuda_kernel, "DS_SYM_BLOCK_CAP", 1024)
    params = DEMO_PARAMS[0].replace(damping=0.5)
    a = DSBodySystem(2500, params, device=dev, integrator=integrator, variant=variant)
    b = DSBodySystem(2500, params, device=dev, backend="torch", integrator=integrator,
                     variant=variant)
    a.update_many(3, DT)
    b.update_many(3, DT)
    a.synchronize()
    for x, y in ((a.positions, b.positions), (a.velocities, b.velocities)):
        assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max() + 1e-14


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_compute_ds_qa_and_drift_on_card(dev, integrator):
    c = Compute(num_bodies=4096, device=dev, precision="ds", integrator=integrator,
                log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    kernel = "ds_sym" if integrator == "euler" else "ds_leapfrog"
    assert cuda_kernel.LAUNCHES[kernel] > before[kernel]
    from nbody_tpu_torch.cli import drift_failed

    assert not drift_failed(c.drift_check(5))


def test_ds_wrappers_refuse_bad_arguments_before_launch(dev):
    from nbody_tpu_torch.ops import ds

    planes, _ = _ds_planes(256, dev)
    scal = ds.scal_ds(DT, SOFT, 1.0)
    before = dict(cuda_kernel.LAUNCHES)
    bad = torch.zeros(planes[0].numel() + 1, device=dev)[1:].view(-1, 4).copy_(planes[0])
    with pytest.raises(ValueError, match="aligned"):
        cuda_kernel.nbody_step_ds_cuda(bad, *planes[1:], scal)
    with pytest.raises(ValueError, match="scal"):
        cuda_kernel.ds_sym_accel_cuda(planes[0], planes[1], scal.to(dev))
    with pytest.raises(ValueError, match="rows"):
        cuda_kernel.nbody_step_ds_leapfrog_cuda(planes[0], planes[1][:100], *planes[2:], scal)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.nbody_step_ds_cuda(*planes, scal, out=(planes[0], *planes[1:]))
    assert cuda_kernel.LAUNCHES == before


# ---- double-single Hermite: csrc/ds_aj_kernels.cu, csrc/ds_symmetric_aj_kernels.cu ----
#
# The ds accel + jerk kernels and the Hermite glue by the rules of the ds
# kernels above: each output within 1e-12 * max + 1e-14 of its plain
# version, each force and jerk within 1e-10 * max of the float64 oracle's.


def _ds_aj_oracle_held(fields, pos64, vel64):
    from nbody_tpu_torch.compute import _oracle_accel_jerk
    from nbody_tpu_torch.ops import ds

    for got, ref in zip((fields[:2], fields[2:]), _oracle_accel_jerk(pos64, vel64, SOFT)):
        assert np.abs(ds.ds_to_f64(*got)[:, :3] - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.mark.parametrize("kernel", ["ds_accel_jerk", "ds_aj_sym", "ds_aj_sym_128",
                                    "ds_aj_sym_cross", "ds_aj_sym_cross_128"])
def test_ds_aj_kernels_match_plain_and_oracle(dev, kernel):
    from nbody_tpu_torch.ops import ds

    tile = int(kernel.rsplit("_", 1)[1]) if kernel[-1].isdigit() else 256
    kernel = kernel.removesuffix(f"_{tile}")
    n = 4099
    planes, pos64 = _ds_planes(n, dev)
    vel64 = ds.ds_to_f64(*planes[2:])
    scal = ds.scal_ds_hermite(DT, SOFT, 0.5)
    before = dict(cuda_kernel.LAUNCHES)
    if kernel == "ds_accel_jerk":
        def run():
            return cuda_kernel.compute_accel_jerk_ds_cuda_vs(*planes, *planes, scal)
        want = ds.ds_accel_jerk_vs(*planes, *planes, scal)
    elif kernel == "ds_aj_sym":
        def run():
            return cuda_kernel.ds_aj_sym_cuda(*planes, scal, tile=tile)
        want = ds.ds_accel_jerk_symmetric(*planes, scal)
    else:
        # a small cap forces the composition: 3 triangles and 3 rectangles
        def run():
            return cuda_kernel.compute_accel_jerk_ds_symmetric_blocked_cuda(
                *planes, scal, block_cap=1536, tile=tile)
        want = ds.ds_accel_jerk_symmetric_blocked(*planes, scal, block_cap=1536, tile_j=tile)
    got = run()
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES[kernel] > before[kernel]
    _ds_held([got[:2], got[2:]], [want[:2], want[2:]])
    _ds_aj_oracle_held(got, pos64, vel64)
    assert all(torch.equal(a, b) for a, b in zip(got, run()))  # no atomics


def test_ds_hermite_glue_matches_plain_bit_for_bit(dev):
    from nbody_tpu_torch.ops import ds

    planes, _ = _ds_planes(4099, dev)
    scal = ds.scal_ds_hermite(DT, SOFT, 0.5)
    for aj in (lambda s: cuda_kernel.compute_accel_jerk_ds_cuda_vs(*s, *s, scal),
               lambda s: cuda_kernel.compute_accel_jerk_ds_symmetric_blocked_cuda(*s, scal)):
        f0 = aj(planes)
        before = dict(cuda_kernel.LAUNCHES)
        pred = cuda_kernel.ds_hermite_predict_cuda(*planes, *f0, scal)
        f1 = aj(pred)
        new = cuda_kernel.ds_hermite_correct_cuda(*planes, *f0, *f1, scal)
        for key in ("ds_hermite_predict", "ds_hermite_correct"):
            assert cuda_kernel.LAUNCHES[key] == before[key] + 1
        # the same ds operations in the same order, none contracted
        for got, want in ((pred, ds.ds_hermite_predict(*planes, f0[:2], f0[2:], scal)),
                          (new, ds.ds_hermite_correct(*planes, f0[:2], f0[2:], f1[:2], f1[2:],
                                                      scal))):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        for g, p in zip(new, planes):  # mass and vel.w carried in both planes
            assert torch.equal(g[:, 3], p[:, 3])


@pytest.mark.parametrize("variant", ["sym", "one_sided"])
def test_ds_hermite_system_kernels_against_plain_backend(dev, monkeypatch, variant):
    from nbody_tpu_torch.models import DSBodySystem

    # a small cap, so the sym path composes triangles and rectangles
    monkeypatch.setattr(cuda_kernel, "DS_AJ_SYM_BLOCK_CAP", 1024)
    params = DEMO_PARAMS[0].replace(damping=0.5)
    a = DSBodySystem(2500, params, device=dev, integrator="hermite", variant=variant)
    b = DSBodySystem(2500, params, device=dev, backend="torch", integrator="hermite",
                     variant=variant)
    a.update_many(3, DT)
    b.update_many(3, DT)
    a.synchronize()
    for x, y in ((a.positions, b.positions), (a.velocities, b.velocities)):
        assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max() + 1e-14


@pytest.mark.parametrize("variant", ["auto", "one_sided"])
def test_compute_ds_hermite_qa_and_drift_on_card(dev, variant):
    from nbody_tpu_torch.cli import drift_failed

    c = Compute(num_bodies=4096, device=dev, precision="ds", integrator="hermite",
                variant=variant, log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    kernel = "ds_aj_sym" if variant == "auto" else "ds_accel_jerk"
    for key in (kernel, "ds_hermite_predict", "ds_hermite_correct"):
        assert cuda_kernel.LAUNCHES[key] > before[key]
    assert not drift_failed(c.drift_check(5))


def test_ds_aj_wrappers_refuse_bad_arguments_before_launch(dev):
    from nbody_tpu_torch.ops import ds

    planes, _ = _ds_planes(256, dev)
    scal = ds.scal_ds_hermite(DT, SOFT, 1.0)
    fields = cuda_kernel.ds_aj_sym_cuda(*planes, scal)
    before = dict(cuda_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="tile"):
        cuda_kernel.ds_aj_sym_cuda(*planes, scal, tile=512)
    with pytest.raises(ValueError, match="scal"):
        cuda_kernel.ds_hermite_predict_cuda(*planes, *fields, ds.scal_ds(DT, SOFT, 1.0))
    with pytest.raises(ValueError, match="rows"):
        cuda_kernel.compute_accel_jerk_ds_cuda_vs(planes[0], planes[1][:100], *planes[2:],
                                                  *planes, scal)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.ds_hermite_correct_cuda(*planes, *fields, *fields, scal, out=planes)
    assert cuda_kernel.LAUNCHES == before


# ---- the tensor-core step (csrc/mxu_kernels.cu) and the rollout ----
#
# Kernel and plain version evaluate the same mxu algebra: each is held to
# the other under the mxu error model (reference.mxu_step_tolerance:
# MXU_ERROR_COEF[variant] * E carried through the update, E_ik = sum_j
# |s_ij| (|P_jk| + |p_ik| m_j)): bf16 may round an s to the neighbouring
# value, f32 (3xTF32) differs in the last bits. The w lanes are copied.
# The rollout repeats the step kernel's arithmetic and j order: bit-equal.

MXU_VARIANTS = ("mxu", "mxu_bf16")


def _mxu_held(pi, vi, pj, got, want, damping, variant):
    tol_p, tol_v = reference.mxu_step_tolerance(pi, vi, pj, want, DT, SOFT, damping,
                                                variant=variant)
    rp = ((got[0][:, :3] - want[0][:, :3]).abs() / tol_p).max().item()
    rv = ((got[1][:, :3] - want[1][:, :3]).abs() / tol_v).max().item()
    assert rp <= 1.0 and rv <= 1.0, (rp, rv)
    assert torch.equal(got[0][:, 3], pi[:, 3]) and torch.equal(got[1][:, 3], vi[:, 3])


@pytest.mark.parametrize("variant", MXU_VARIANTS)
@pytest.mark.parametrize("m, n", [(1, 33), (33, 1), (333, 1000), (1000, 1000), (777, 4099),
                                  (4099, 777), (4099, 4099)])
def test_mxu_step_matches_plain(dev, variant, m, n):
    pj, _ = _state(n, dev)
    pi, vi = _state(m, dev, seed=3)
    before = cuda_kernel.LAUNCHES[cuda_kernel.MXU_KERNELS[variant][1]]
    got = cuda_kernel.nbody_step_mxu_cuda_vs(pi, vi, pj, DT, SOFT, DAMP, variant=variant)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES[cuda_kernel.MXU_KERNELS[variant][1]] == before + 1
    want = reference.nbody_step_mxu_vs(pi, vi, pj, DT, SOFT, DAMP,
                                       mxu_dtype=reference.MXU_DTYPES[variant])
    _mxu_held(pi, vi, pj, got, want, DAMP, variant)


@pytest.mark.parametrize("variant", MXU_VARIANTS)
@pytest.mark.parametrize("n", [4099, 65536])
def test_mxu_step_random_masses_damping_and_repeats(dev, variant, n):
    p, v = _random_w(*_state(n, dev))
    got = cuda_kernel.nbody_step_mxu_cuda(p, v, DT, SOFT, 0.5, variant=variant)
    again = cuda_kernel.nbody_step_mxu_cuda(p, v, DT, SOFT, 0.5, variant=variant)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = reference.nbody_step_mxu(p, v, DT, SOFT, 0.5, mxu_dtype=reference.MXU_DTYPES[variant])
    _mxu_held(p, v, p, got, want, 0.5, variant)


@pytest.mark.parametrize("variant", MXU_VARIANTS)
def test_mxu_body_system_and_compute_on_card(dev, variant):
    n = 4096
    params = DEMO_PARAMS[0].replace(cluster_scale=tuned_scales(n)[0],
                                    velocity_scale=tuned_scales(n)[1])
    k = BodySystem(n, params, device=dev, variant=variant)
    t = BodySystem(n, params, device=dev, backend="torch", variant=variant)
    p0, v0 = (x.clone() for x in k.state)
    acc = k.accelerations()
    assert k.backend == "cuda" and k.mxu_force == variant
    key = cuda_kernel.MXU_KERNELS[variant][1]
    before = cuda_kernel.LAUNCHES[key]
    k.update()
    t.update()
    assert cuda_kernel.LAUNCHES[key] == before + 1
    _mxu_held(p0, v0, p0, k.state, t.state, params.damping, variant)
    # the QA's force is the kernel's own: within the error model of plain's
    want = reference.compute_accel_mxu_vs(p0, p0, params.softening, variant=variant)
    bound = reference.MXU_ERROR_COEF[variant] * reference.mxu_error_scale(
        p0, p0, params.softening)
    assert ((acc - want).abs() <= bound).all()
    c = Compute(num_bodies=n, device=dev, variant=variant, log=lambda s: None)
    before = cuda_kernel.LAUNCHES[key]
    assert c.compare_results()
    assert cuda_kernel.LAUNCHES[key] == before + 2


def test_mxu_launch_error_raises_and_counts_nothing(dev, monkeypatch):
    from nbody_tpu_torch.ops import _build

    lib = _build.load_library()
    p, v = _state(64, dev)
    out = (torch.empty_like(p), torch.empty_like(v))
    stream = torch.cuda.current_stream().cuda_stream
    # the entry points refuse a negative size without launching
    for entry, _ in cuda_kernel.MXU_KERNELS.values():
        assert getattr(lib, entry)(p.data_ptr(), v.data_ptr(), p.data_ptr(), out[0].data_ptr(),
                                   out[1].data_ptr(), -1, 64, 0.0, 0.0, 1.0, stream) != 0

    class Refusing:
        def __getattr__(self, name):
            if name == "nbody_error_string":
                return lambda err: b"invalid argument"
            return lambda *args: 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load_library", lambda: Refusing())
    before = dict(cuda_kernel.LAUNCHES)
    for variant in MXU_VARIANTS:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            cuda_kernel.nbody_step_mxu_cuda(p, v, DT, SOFT, DAMP, variant=variant)
    with pytest.raises(RuntimeError, match="nbody_step_t_f32"):
        cuda_kernel.nbody_rollout_cuda(p, v, DT, SOFT, DAMP, steps=2)
    assert cuda_kernel.LAUNCHES == before


@pytest.mark.parametrize("n", [1, 1000, 4099])
@pytest.mark.parametrize("block_size", [128, 256])
def test_rollout_equals_step_launches_bit_for_bit(dev, n, block_size):
    p, v = _random_w(*_state(n, dev))
    before = dict(cuda_kernel.LAUNCHES)
    gp, gv = cuda_kernel.nbody_rollout_cuda(p, v, DT, SOFT, 0.5, steps=5,
                                            block_size=block_size)
    assert cuda_kernel.LAUNCHES["step_t"] == before["step_t"] + 5
    sp, sv = p, v
    for _ in range(5):
        sp, sv = nbody_step_cuda(sp, sv, DT, SOFT, 0.5, block_size=block_size)
    assert torch.equal(gp, sp) and torch.equal(gv, sv)
    # the inputs are not written
    q, w = _random_w(*_state(n, dev))
    assert torch.equal(p, q) and torch.equal(v, w)


# ---- the P3M short-range pair kernel (csrc/p3m_kernels.cu) ----
# held to the plain short-range sum at rtol 1e-4, atol 2e-4, nbody_tpu's
# bound between its Pallas and XLA short-range engines (tests/test_p3m.py:367)


def _p3m_state(n, dev, pads=0):
    """Shell ICs with masses from [0.5, 2] and `pads` zero-mass bodies at
    the origin."""
    p, _ = _random_w(*_state(n, dev))
    return torch.cat([p, torch.zeros((pads, 4), device=dev)])


@pytest.mark.parametrize("blk", cuda_kernel.P3M_BLKS)
@pytest.mark.parametrize("n, pads, grid, cap", [(4099, 77, 32, None), (16384, 0, 64, None),
                                                (4099, 0, 32, 8)])
def test_p3m_pair_kernel_matches_plain(dev, blk, n, pads, grid, cap):
    from nbody_tpu_torch.ops import p3m

    p = _p3m_state(n, dev, pads)
    if cap is None:  # BodySystem's auto size
        cap = max(8, -(-int(int(p3m.p3m_max_occupancy(p, grid=grid)) * 1.5 + 1) // 8) * 8)
    before = dict(cuda_kernel.LAUNCHES)
    acc, ovf = cuda_kernel.p3m_short_range_cuda(p, SOFT, grid=grid, capacity=cap, blk=blk)
    again, _ = cuda_kernel.p3m_short_range_cuda(p, SOFT, grid=grid, capacity=cap, blk=blk)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES["p3m_sr"] == before["p3m_sr"] + 2
    plain = reference.p3m_short_range(p, SOFT, grid=grid, capacity=cap)
    torch.testing.assert_close(acc, plain, rtol=1e-4, atol=2e-4)
    assert torch.equal(acc, again)
    assert int(ovf) == int(p3m.p3m_overflow_count(p, grid=grid, capacity=cap))
    assert (int(ovf) > 0) == (cap == 8)


def test_p3m_accel_repeats_bit_for_bit_and_matches_torch(dev):
    from nbody_tpu_torch.ops import p3m

    p = _p3m_state(16384, dev, 77)
    a1, o1 = p3m.p3m_accel(p, SOFT, grid=64, capacity=256)
    a2, o2 = p3m.p3m_accel(p, SOFT, grid=64, capacity=256)
    assert torch.equal(a1, a2) and int(o1) == int(o2) == 0
    plain, _ = p3m.p3m_accel(p, SOFT, grid=64, capacity=256, backend="torch")
    torch.testing.assert_close(a1, plain, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_p3m_body_system_on_the_card(dev, integrator):
    params = DEMO_PARAMS[0]
    pos, vel = ic.generate(NBodyConfig.SHELL, 8192, params.cluster_scale,
                           params.velocity_scale, seed=3)
    before = cuda_kernel.LAUNCHES["p3m_sr"]
    card = BodySystem(8192, params, device="cuda", kernel="p3m", integrator=integrator,
                      state=(pos, vel))
    plain = BodySystem(8192, params, device="cuda", backend="torch", kernel="p3m",
                       integrator=integrator, state=(pos, vel))
    card.update_many(3)
    plain.update_many(3)
    assert cuda_kernel.LAUNCHES["p3m_sr"] == before + 3
    np.testing.assert_allclose(card.positions, plain.positions, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(card.velocities, plain.velocities, rtol=1e-4, atol=1e-4)
