"""The dual-bank step: the wrapper of csrc/nbody_kernels.cu::step_dual_kernel
(``cuda_kernel.nbody_step_dual_cuda``), which on CPU tensors computes its
plain version, against the Pallas kernel of scripts/tpu_r3_dualbank.py
(``_dual_kernel``) in interpret mode; and the port of that script,
scripts/torch_r3_dualbank.py, rehearsed on the CPU. The kernel itself runs
on a card only (chip_smoke.py phase 3e, tests/test_torch_cuda.py).

Inputs are made with numpy from a seed: shell ICs with masses from
[0.5, 2] and a random vel.w, dt 1e-3, softening 0.1, damping 0.5. A step
is held at atol 1e-6, the bound of tests/test_pallas.py:26 between two
float32 summation orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from nbody_tpu.ops.pallas_kernel import LANES, _common_specs, _pad_i, _pad_j_t, _scal
from tpu_scripts import load_script

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.ops import cuda_kernel, reference

DT, SOFT, DAMP = 1e-3, 0.1, 0.5


@pytest.fixture(scope="module")
def script():
    return load_script("tpu_r3_dualbank")


def _state(n, seed=3):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=seed)
    rng = np.random.default_rng(seed)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return pos, vel


def _dual_interpret(script, pos, vel, *, tile_i, tile_j):
    """The script's ``step_dual`` around its ``_dual_kernel``, in interpret
    mode: the same specs, padding and scratch."""
    half = tile_i // 2
    p = jnp.asarray(pos)
    pos_p, m = _pad_i(p, tile_i)
    vel_p, _ = _pad_i(jnp.asarray(vel), tile_i)
    post = _pad_j_t(p, tile_j)
    m_pad, n_pad = pos_p.shape[0], post.shape[1]
    specs = _common_specs(tile_i, tile_j)
    new_pos, new_vel = pl.pallas_call(
        functools.partial(script._dual_kernel, tile_j=tile_j, half=half),
        grid=(m_pad // tile_i, n_pad // tile_j),
        in_specs=[specs["smem"], specs["i_tile"], specs["i_tile"], specs["j_tile"]],
        out_specs=[specs["i_tile"], specs["i_tile"]],
        out_shape=[jax.ShapeDtypeStruct((m_pad, 4), jnp.float32)] * 2,
        scratch_shapes=[pltpu.VMEM((half, LANES), jnp.float32) for _ in range(6)],
        interpret=True,
    )(_scal(DT, SOFT, DAMP), pos_p, vel_p, post)
    return np.asarray(new_pos[:m]), np.asarray(new_vel[:m])


@pytest.mark.parametrize("n", [300, 257])
def test_dual_step_matches_the_script_kernel(script, n):
    """N=257 is odd and no multiple of the tiles (128 rows, 256 j-bodies)."""
    pos, vel = _state(n)
    want_p, want_v = _dual_interpret(script, pos, vel, tile_i=128, tile_j=256)
    got_p, got_v = cuda_kernel.nbody_step_dual_cuda(torch.from_numpy(pos), torch.from_numpy(vel),
                                                    DT, SOFT, DAMP)
    np.testing.assert_allclose(got_p.numpy(), want_p, atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), want_v, atol=1e-6)
    np.testing.assert_array_equal(got_p.numpy()[:, 3], pos[:, 3])
    np.testing.assert_array_equal(got_v.numpy()[:, 3], vel[:, 3])


def test_cpu_wrapper_is_the_plain_step_and_launches_nothing():
    pos, vel = (torch.from_numpy(a) for a in _state(200))
    before = dict(cuda_kernel.LAUNCHES)
    want = reference.nbody_step(pos, vel, DT, SOFT, DAMP)
    out = (torch.empty_like(pos), torch.empty_like(vel))
    for bs in (64, 128, 256):
        got = cuda_kernel.nbody_step_dual_cuda(pos, vel, DT, SOFT, DAMP, block_size=bs, out=out)
        assert got[0] is out[0] and got[1] is out[1]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_kernel.nbody_step_dual_cuda(pos, vel, DT, SOFT, DAMP, block_size=100)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernel.nbody_step_dual_cuda(pos.double(), vel.double(), DT, SOFT, DAMP)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.nbody_step_dual_cuda(pos, vel, DT, SOFT, DAMP, out=(pos, out[1]))


def test_script_port_rehearses_on_the_cpu(capsys):
    port = load_script("torch_r3_dualbank")
    assert port.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "times are not device times" in out
    dual = [ln for ln in out.splitlines() if ln.startswith("dual block=")]
    assert len(dual) == 3 and all("bit-equal to the step kernel: True" in ln for ln in dual)
    assert "dual block=64 (3 blocks)" in out and "step block=256 (2 blocks)" in out
