"""nbody_tpu_torch.models.BodySystem against nbody_tpu's BodySystem.

The port keeps its own copies of the numpy modules, so each package gets
its own NBodyParams and NBodyConfig; the two are compared by value."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from nbody_tpu.io import save_checkpoint
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
from nbody_tpu_torch.models import BodySystem, load_checkpoint, state_from_numpy
from nbody_tpu_torch.ops import cuda_kernel

N = 1024


def _jax(params):
    """The JAX package's NBodyParams of the same values."""
    return JaxNBodyParams(**dataclasses.asdict(params))


@pytest.fixture
def params():
    cs, vs = tuned_scales(N)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs)


@pytest.fixture
def state(params):
    return ic.generate(NBodyConfig.SHELL, N, params.cluster_scale,
                       params.velocity_scale, seed=11)


def test_update_many_matches_jax_xla(params, state):
    """Five demo-0 steps (dt=0.016) from the same numpy state. The two
    differ only in float32 rounding order. Positions: 1e-5, the JAX suite's
    bound for multi-step rollouts of two backends
    (tests/test_body_system.py:67). Velocities reach ~11 here, where a
    float32 ulp is ~1e-6, so five steps of rounding differences are held
    to 1e-5 relative on top of that absolute bound."""
    pos, vel = state
    pos_t, vel_t = state_from_numpy(pos, vel, device="cpu")
    ours = BodySystem(N, params, device="cpu", state=(pos_t, vel_t))
    ref = JaxBodySystem(N, _jax(params), backend="xla", state=(pos, vel))
    ours.update_many(5)
    ref.update_many(5)
    np.testing.assert_allclose(ours.positions, ref.positions, atol=1e-5)
    np.testing.assert_allclose(ours.velocities, ref.velocities, rtol=1e-5, atol=1e-5)


def test_update_many_equals_repeated_update(params, state):
    a = BodySystem(N, params, device="cpu", state=state)
    b = BodySystem(N, params, device="cpu", state=state)
    a.update_many(3)
    for _ in range(3):
        b.update()
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.velocities, b.velocities)


def test_host_placement_equals_device(params, state):
    dev = BodySystem(N, params, device="cpu", placement="device", state=state)
    host = BodySystem(N, params, device="cpu", placement="host", state=state)
    dev.update_many(3)
    host.update_many(3)
    host.update()
    dev.update()
    np.testing.assert_array_equal(dev.positions, host.positions)
    np.testing.assert_array_equal(dev.velocities, host.velocities)
    torch.testing.assert_close(dev.accelerations(), host.accelerations(), rtol=0, atol=0)


def test_ping_pong_buffers_are_reused(params, state):
    s = BodySystem(N, params, device="cpu", state=state)
    ptrs = {s.state[0].data_ptr()}
    for _ in range(4):
        s.update()
        ptrs.add(s.state[0].data_ptr())
    assert len(ptrs) == 2


def test_set_state_round_trip_and_padding(params, state):
    pos, vel = state
    s = BodySystem(N, params, device="cpu", state=state)
    np.testing.assert_array_equal(s.positions, pos)
    np.testing.assert_array_equal(s.velocities, vel)
    out = s.positions
    out[:] = 0  # positions is a copy, not a view of the state
    np.testing.assert_array_equal(s.positions, pos)
    s.set_state(pos[:1000], vel[:1000])  # zero-mass padded up to N
    np.testing.assert_array_equal(s.positions[:1000], pos[:1000])
    assert not s.positions[1000:].any() and not s.velocities[1000:].any()
    with pytest.raises(ValueError):
        s.set_state(np.zeros((N + 1, 4)), np.zeros((N + 1, 4)))


def test_set_positions_and_velocities_as_jax(params, state):
    """set_positions / set_velocities replace one half of the state and keep
    the other, as nbody_tpu's BodySystem does; block_until_ready and
    hard_sync are synchronize."""
    pos, vel = state
    pos2, vel2 = ic.generate(NBodyConfig.SHELL, N, params.cluster_scale,
                             params.velocity_scale, seed=12)
    ours = BodySystem(N, params, device="cpu", state=state)
    ref = JaxBodySystem(N, _jax(params), backend="xla", state=(pos, vel))
    for name, value in (("set_positions", pos2), ("set_velocities", vel2)):
        getattr(ours, name)(value)
        getattr(ref, name)(value)
        np.testing.assert_array_equal(ours.positions, ref.positions)
        np.testing.assert_array_equal(ours.velocities, ref.velocities)
    np.testing.assert_array_equal(ours.positions, pos2)
    np.testing.assert_array_equal(ours.velocities, vel2)
    assert BodySystem.block_until_ready is BodySystem.synchronize
    assert BodySystem.hard_sync is BodySystem.synchronize
    ours.update_many(1)
    ours.block_until_ready()
    ours.hard_sync()


def test_state_from_numpy_pads_and_converts():
    pos = np.ones((3, 4), np.float64)
    vel = np.zeros((3, 4), np.float64)
    p, v = state_from_numpy(pos, vel, device="cpu", num_bodies=5)
    assert p.dtype == torch.float32 and p.shape == (5, 4)
    assert p[3:].abs().sum() == 0 and v.shape == (5, 4)
    pos32 = np.ones((3, 4), np.float32)
    p, _ = state_from_numpy(pos32, pos32, device="cpu")
    p[0, 0] = 7  # the tensor does not alias the caller's array
    assert pos32[0, 0] == 1


def test_reset_matches_ic_generate(params):
    s = BodySystem(N, params, device="cpu", seed=5)
    pos, vel = ic.generate(NBodyConfig.SHELL, N, params.cluster_scale,
                           params.velocity_scale, seed=5)
    np.testing.assert_array_equal(s.positions, pos)
    s.reset(params, NBodyConfig.RANDOM, seed=6)
    pos, _ = ic.generate(NBodyConfig.RANDOM, N, params.cluster_scale,
                         params.velocity_scale, seed=6)
    np.testing.assert_array_equal(s.positions, pos)


def test_load_checkpoint_written_by_jax_package(tmp_path, params, state):
    pos, vel = state
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, pos, vel, _jax(params), step=17)
    p, v, loaded, meta = load_checkpoint(path, device="cpu")
    assert isinstance(p, torch.Tensor) and p.device.type == "cpu"
    np.testing.assert_array_equal(p.numpy(), pos)
    np.testing.assert_array_equal(v.numpy(), vel)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(params)
    assert meta["step"] == 17
    with pytest.raises(ValueError, match="orbax"):
        load_checkpoint(tmp_path, device="cpu")


def test_update_params_takes_effect(params, state):
    a = BodySystem(N, params, device="cpu", state=state)
    b = BodySystem(N, params, device="cpu", state=state)
    b.update_params(params.replace(damping=0.5))
    a.update()
    b.update()
    assert not np.array_equal(a.velocities, b.velocities)


def test_total_energy_matches_jax(params, state):
    s = BodySystem(N, params, device="cpu", state=state)
    ref = JaxBodySystem(N, _jax(params), backend="xla", state=state)
    np.testing.assert_allclose(s.total_energy(), ref.total_energy(), rtol=1e-5)


def test_cpu_backend_launches_no_kernel(params, state):
    before = dict(cuda_kernel.LAUNCHES)
    s = BodySystem(N, params, device="cpu", state=state)
    assert s.backend == "torch" and s.variant == "vpu"
    s.update_many(2)
    s.accelerations()
    assert cuda_kernel.LAUNCHES == before


# A mesh is ported (tests/test_torch_sharded*.py), its 2-D form and float64
# too (#13); plain PM, the P3M options, P3M in float64 and the sharded PM and
# P3M steps too (#16, tests/test_torch_pm.py, tests/test_torch_p3m_sharded.py).
# What is left of #16 (the rest of #10) is the XLA cell-list engine: every
# case asks for it now, beside what the case asked before, and keeps its id.
@pytest.mark.parametrize("kw, item", [
    pytest.param({"mesh": types.SimpleNamespace(axis_names=("bodies",), size=2,
                                                device=torch.device("cpu")),
                  "kernel": "p3m", "p3m_short_range": "xla"}, "#16", id="kw0-#13"),
    pytest.param({"kernel": "pm", "p3m_short_range": "xla"}, "#10", id="kw1-#10"),
    pytest.param({"kernel": "p3m", "p3m_short_range": "xla"}, "#10", id="kw2-#10"),
    pytest.param({"dtype": torch.float64, "kernel": "p3m", "p3m_short_range": "xla"}, "#16",
                 id="kw3-#16"),
    pytest.param({"dtype": torch.float64, "kernel": "p3m", "p3m_short_range": "xla",
                  "mesh": types.SimpleNamespace(axis_names=("bodies",), size=2,
                                                device=torch.device("cpu"))},
                 "#16", id="kw4-#13"),
])
def test_later_slices_raise_naming_roadmap_item(params, kw, item):
    with pytest.raises(ValueError, match="ROADMAP.md") as e:
        BodySystem(64, params, device="cpu", **kw)
    assert item in str(e.value)


def test_p3m_kernel_is_ported(params):
    # backend="p3m" was refused, naming ROADMAP item #10, until the P3M slice
    # was ported; the algorithm now has its own keyword (the port's backend
    # is the implementation), and backend="p3m" points to it
    s = BodySystem(64, params, device="cpu", kernel="p3m")
    assert s.backend == "torch" and s.kernel == "p3m" and s.p3m_capacity >= 8
    s.update_many(2)
    assert np.isfinite(s.positions).all()
    with pytest.raises(ValueError, match="kernel='p3m'"):
        BodySystem(64, params, device="cpu", backend="p3m")


@pytest.mark.parametrize("variant", ["mxu", "mxu_bf16"])
def test_mxu_variants_are_ported(params, variant):
    # refused until the tensor-core step was ported; the caller's name is kept
    s = BodySystem(64, params, device="cpu", variant=variant)
    assert s.backend == "torch" and s.variant == variant and s.mxu_force == variant


@pytest.mark.parametrize("kw", [{"backend": "xla"}, {"variant": "bogus"},
                                # a block size off the kernels' rule (48) runs on
                                # the CPU path, which has no blocks; none runs
                                # below 1
                                {"placement": "mapped"}, {"block_size": 0}])
def test_unknown_options_raise(params, kw):
    with pytest.raises(ValueError):
        BodySystem(64, params, device="cpu", **kw)


def test_cuda_backend_on_cpu_device_raises(params):
    with pytest.raises(ValueError, match="CUDA"):
        BodySystem(64, params, device="cpu", backend="cuda")


def test_cuda_device_without_cuda_raises(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        BodySystem(64, params, device="cuda")
    with pytest.raises(RuntimeError):
        BodySystem(64, params, device="cuda", backend="cuda")
