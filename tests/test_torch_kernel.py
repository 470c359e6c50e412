"""The CUDA kernel wrappers (nbody_tpu_torch.ops.cuda_kernel) and their build.

On CPU tensors a wrapper computes its plain version; those cases are held to
nbody_tpu's Pallas kernels in interpret mode at the tile sizes and
tolerances of tests/test_pallas.py. The kernels themselves run only on a
card, in tests/test_torch_cuda.py.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.pallas_kernel import (
    compute_accel_pallas,
    nbody_step_pallas,
    nbody_step_pallas_vs,
)

from nbody_tpu_torch.ops import _build, cuda_kernel, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    compute_accel_cuda,
    nbody_step_cuda,
    nbody_step_cuda_vs,
)

DT, SOFT, DAMP = 0.001, 0.1, 1.0
TI, TJ = 64, 256  # tests/test_pallas.py's tiles
REPO = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_step_matches_pallas(random_state_tiny):
    pos, vel = random_state_tiny
    p_t, v_t = nbody_step_cuda(_t(pos), _t(vel), DT, SOFT, DAMP)
    p_k, v_k = nbody_step_pallas(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP,
                                 tile_i=TI, tile_j=TJ, interpret=True)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_k), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_k), atol=1e-6)


def test_accel_matches_pallas(random_state_tiny):
    pos, _ = random_state_tiny
    a_t = compute_accel_cuda(_t(pos[:128]), _t(pos), SOFT)
    a_k = compute_accel_pallas(jnp.asarray(pos[:128]), jnp.asarray(pos), SOFT,
                               tile_i=TI, tile_j=TJ, interpret=True)
    assert a_t.shape == (128, 3)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_k), rtol=1e-4, atol=1e-4)


def test_step_i_vs_j_matches_pallas(random_state_tiny):
    pos, vel = random_state_tiny
    p_t, v_t = nbody_step_cuda_vs(_t(pos[:128]), _t(vel[:128]), _t(pos), DT, SOFT, DAMP)
    p_k, v_k = nbody_step_pallas_vs(jnp.asarray(pos[:128]), jnp.asarray(vel[:128]),
                                    jnp.asarray(pos), DT, SOFT, DAMP,
                                    tile_i=TI, tile_j=TJ, interpret=True)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_k), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_k), atol=1e-6)


def test_step_non_divisible_n_matches_pallas(random_state_tiny):
    pos, vel = random_state_tiny
    pos, vel = pos[:333], vel[:333]
    p_t, v_t = nbody_step_cuda(_t(pos), _t(vel), DT, SOFT, DAMP)
    p_k, v_k = nbody_step_pallas(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP,
                                 tile_i=TI, tile_j=TJ, interpret=True)
    assert p_t.shape == (333, 4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_k), atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_k), atol=1e-6)


def test_step_writes_into_out(random_state_tiny):
    pos, vel = random_state_tiny
    out = (torch.empty(pos.shape), torch.empty(vel.shape))
    res = nbody_step_cuda(_t(pos), _t(vel), DT, SOFT, DAMP, out=out)
    assert res[0] is out[0] and res[1] is out[1]
    p_r, v_r = reference.nbody_step(_t(pos), _t(vel), DT, SOFT, DAMP)
    torch.testing.assert_close(out[0], p_r, rtol=0, atol=0)
    torch.testing.assert_close(out[1], v_r, rtol=0, atol=0)


def test_cpu_tensors_launch_no_kernel(random_state_tiny):
    pos, vel = random_state_tiny
    before = dict(cuda_kernel.LAUNCHES)
    nbody_step_cuda(_t(pos), _t(vel), DT, SOFT, DAMP)
    compute_accel_cuda(_t(pos), _t(pos), SOFT)
    assert cuda_kernel.LAUNCHES == before


def test_float64_raises_not_casts(random_state_tiny):
    pos, vel = random_state_tiny
    p64 = torch.from_numpy(pos.astype(np.float64))
    v64 = torch.from_numpy(vel.astype(np.float64))
    with pytest.raises(TypeError, match="float32"):
        nbody_step_cuda(p64, v64, DT, SOFT, DAMP)
    with pytest.raises(TypeError, match="float32"):
        compute_accel_cuda(p64, p64, SOFT)
    with pytest.raises(TypeError):
        compute_accel_cuda(pos, pos, SOFT)  # numpy, not a tensor


@pytest.mark.parametrize("bad", ["shape", "contiguity", "alignment", "rows", "block_size",
                                 "alias"])
def test_bad_arguments_raise_value_error(random_state_tiny, bad):
    pos, vel = random_state_tiny
    p, v = _t(pos), _t(vel)
    kw = {}
    if bad == "shape":
        p = p[:, :3].contiguous()
    elif bad == "contiguity":
        p = torch.from_numpy(np.asfortranarray(pos))
    elif bad == "alignment":
        # contiguous (N, 4), but 4 bytes past a float4 boundary
        p = torch.zeros(p.numel() + 1)[1:].view(-1, 4).copy_(p)
    elif bad == "rows":
        v = v[:100]
    elif bad == "block_size":
        kw["block_size"] = 100
    elif bad == "alias":
        # the fused step must never write the array it reads pos_j from
        kw["out"] = (p, torch.empty_like(v))
    with pytest.raises(ValueError):
        nbody_step_cuda(p, v, DT, SOFT, DAMP, **kw)


def test_nvcc_command_targets_sm90a():
    compiles, link = _build.nvcc_commands("nvcc", _build.library_path())
    # one nvcc per source, started together, then one link
    assert len(compiles) == len(_build.SOURCES)
    for cmd, src in zip(compiles, _build.SOURCES):
        line = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in line and "-c" in cmd
        assert "-O3" in cmd and "--use_fast_math" not in cmd
        assert str(src) in cmd
    assert "-shared" in link and str(_build.library_path()) in link
    assert all(cmd[cmd.index("-o") + 1] in link for cmd in compiles)
    assert [s.name for s in _build.SOURCES] == ["nbody_kernels.cu", "symmetric_kernels.cu",
                                                "symmetric_aj_kernels.cu", "ds_kernels.cu",
                                                "ds_symmetric_kernels.cu", "ds_aj_kernels.cu",
                                                "ds_symmetric_aj_kernels.cu", "mxu_kernels.cu",
                                                "p3m_kernels.cu"]
    assert [h.name for h in _build.HEADERS] == ["sym_common.cuh", "ds_common.cuh",
                                                "ds_sym_common.cuh"]
    # every source and header in csrc/ is built and hashed
    assert sorted(p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")) == \
        sorted(p.name for p in (*_build.SOURCES, *_build.HEADERS))


def test_build_dir_is_under_build():
    lib = _build.library_path()
    assert lib.parent == REPO / "build" / "nbody_tpu_torch"
    assert lib.is_relative_to(REPO / "build")


def test_library_name_follows_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCES", (src,))
    first = _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first


def test_missing_nvcc_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_nvcc_found_through_cuda_home(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(nvcc)
