"""The packed-state step: the wrappers of
csrc/nbody_kernels.cu::step_packed_kernel (``cuda_kernel.nbody_step_packed_cuda``
and ``nbody_rollout_packed_cuda``), which on CPU tensors compute the plain
version ``reference.nbody_step_packed``, against the Pallas kernel of
scripts/tpu_r3_packed.py (``_packed_kernel``) in interpret mode; and the
port of that script, scripts/torch_r3_packed.py, rehearsed on the CPU. The
kernel itself runs on a card only (chip_smoke.py phase 3e,
tests/test_torch_cuda.py).

Inputs are made with numpy from a seed: shell ICs with masses from
[0.5, 2] and a random vel.w, dt 1e-3, softening 0.1, damping 0.5. A step
is held at atol 1e-6, the bound of tests/test_pallas.py:26 between two
float32 summation orders; three steps at 3e-6, the same bound a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from nbody_tpu.ops.pallas_kernel import LANES, _ix, _scal
from tpu_scripts import load_script

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.ops import cuda_kernel, reference

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
TI, TJ = 64, 256


@pytest.fixture(scope="module")
def script():
    return load_script("tpu_r3_packed")


def _state(n, seed=5):
    pos, vel = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=seed)
    rng = np.random.default_rng(seed)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return np.concatenate([pos, vel], axis=1)


def _packed_interpret(script, state, steps=1):
    """`steps` of the script's ``step_packed`` around its ``_packed_kernel``,
    in interpret mode: the state padded with zero-mass bodies to a multiple
    of the tiles (the script takes it padded), the planes transposed from
    each new state as the script's XLA code does."""
    n = state.shape[0]
    n_pad = -(-n // TJ) * TJ
    s = jnp.asarray(np.pad(state, ((0, n_pad - n), (0, 0))))
    post = s[:, :4].T
    smem = pl.BlockSpec((1, 4), lambda i, j: _ix(0, 0), memory_space=pltpu.SMEM)
    i_tile = pl.BlockSpec((TI, 8), lambda i, j: _ix(i, 0), memory_space=pltpu.VMEM)
    j_tile = pl.BlockSpec((4, TJ), lambda i, j: _ix(0, j), memory_space=pltpu.VMEM)
    call = pl.pallas_call(
        functools.partial(script._packed_kernel, tile_j=TJ),
        grid=(n_pad // TI, n_pad // TJ),
        in_specs=[smem, i_tile, j_tile],
        out_specs=i_tile,
        out_shape=jax.ShapeDtypeStruct((n_pad, 8), jnp.float32),
        scratch_shapes=[pltpu.VMEM((TI, LANES), jnp.float32) for _ in range(3)],
        interpret=True,
    )
    for _ in range(steps):
        s = call(_scal(DT, SOFT, DAMP), s, post)
        post = s[:, :4].T
    return np.asarray(s[:n])


@pytest.mark.parametrize("n", [300, 257])
def test_packed_step_matches_the_script_kernel(script, n):
    """N=257 is odd and no multiple of the tiles (64 rows, 256 j-bodies)."""
    state = _state(n)
    want = _packed_interpret(script, state)
    s = torch.from_numpy(state)
    new_state, new_planes = cuda_kernel.nbody_step_packed_cuda(
        s, s[:, :4].t().contiguous(), DT, SOFT, DAMP)
    np.testing.assert_allclose(new_state.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(new_state.numpy()[:, 3], state[:, 3])
    np.testing.assert_array_equal(new_state.numpy()[:, 7], state[:, 7])
    assert torch.equal(new_planes, new_state[:, :4].t())


def test_packed_rollout_matches_the_script_steps(script):
    state = _state(300, seed=6)
    want = _packed_interpret(script, state, steps=3)
    got = cuda_kernel.nbody_rollout_packed_cuda(torch.from_numpy(state), DT, SOFT, DAMP,
                                                steps=3)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-6)


def test_cpu_wrappers_are_the_plain_step_and_launch_nothing():
    state = torch.from_numpy(_state(200))
    planes = state[:, :4].t().contiguous()
    before = dict(cuda_kernel.LAUNCHES)
    p, v = reference.nbody_step(state[:, :4], state[:, 4:], DT, SOFT, DAMP)
    out = (torch.empty_like(state), torch.empty_like(planes))
    got = cuda_kernel.nbody_step_packed_cuda(state, planes, DT, SOFT, DAMP, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(got[0], torch.cat([p, v], dim=1)) and torch.equal(got[1], p.t())
    rolled = cuda_kernel.nbody_rollout_packed_cuda(state, DT, SOFT, DAMP, steps=2)
    p2, v2 = reference.rollout(state[:, :4], state[:, 4:], DT, SOFT, DAMP, steps=2)
    assert torch.equal(rolled, torch.cat([p2, v2], dim=1))
    assert cuda_kernel.nbody_rollout_packed_cuda(state, DT, SOFT, DAMP, steps=0) is state
    assert cuda_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad, match", [
    (lambda s, pl_: (s[:, :4].contiguous(), pl_), "(N, 8)"),
    (lambda s, pl_: (s, pl_[:, :-1].contiguous()), "shape"),
    (lambda s, pl_: (s.double(), pl_), "float32"),
    (lambda s, pl_: (s, pl_.t()), "shape"),
])
def test_packed_wrapper_refuses_bad_inputs(bad, match):
    state = torch.from_numpy(_state(64))
    planes = state[:, :4].t().contiguous()
    with pytest.raises((ValueError, TypeError), match=match):
        cuda_kernel.nbody_step_packed_cuda(*bad(state, planes), DT, SOFT, DAMP)
    with pytest.raises(ValueError, match="overlaps"):
        cuda_kernel.nbody_step_packed_cuda(state, planes, DT, SOFT, DAMP,
                                           out=(state, torch.empty_like(planes)))


def test_script_port_rehearses_on_the_cpu(capsys):
    port = load_script("torch_r3_packed")
    assert port.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "times are not device times" in out
    assert ("bit-equal to the step kernel: True, planes equal the new positions: True"
            in out)
    assert all(f"{k} scan, block 256:" in out for k in ("packed", "step_t", "step"))
