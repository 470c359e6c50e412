"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips without a card. The file imports no JAX, so it also runs where JAX is
not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Tolerances: only the order of the j-sum differs between kernel and plain
version, so the acceleration is held to 1e-4 * max|a| + 1e-4
(tests/test_pallas.py:76) and one demo-0 step to 1e-5 at these N.
"""

import numpy as np
import pytest
import torch

from nbody_tpu import DEMO_PARAMS, NBodyConfig, ic
from nbody_tpu.params import tuned_scales

from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    compute_accel_cuda,
    nbody_step_cuda,
    nbody_step_cuda_vs,
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
    k = BodySystem(n, params, device=dev)
    t = BodySystem(n, params, device=dev, backend="torch")
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
    c = Compute(num_bodies=4096, device=dev, log=lambda s: None)
    before = dict(cuda_kernel.LAUNCHES)
    assert c.compare_results()
    assert cuda_kernel.LAUNCHES["step"] > before["step"]
    assert cuda_kernel.LAUNCHES["accel"] > before["accel"]
