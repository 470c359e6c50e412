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
    """float64 runs the double kernels' path without a cast (the outputs are
    float64); mixed types and the float32-only wrappers raise TypeError."""
    pos, vel = random_state_tiny
    p64 = torch.tensor(pos.astype(np.float64))
    v64 = torch.tensor(vel.astype(np.float64))
    assert all(t.dtype == torch.float64 for t in nbody_step_cuda(p64, v64, DT, SOFT, DAMP))
    assert compute_accel_cuda(p64, p64, SOFT).dtype == torch.float64
    with pytest.raises(TypeError, match="share a type"):
        nbody_step_cuda(p64, _t(vel), DT, SOFT, DAMP)
    with pytest.raises(TypeError, match="share a type"):
        compute_accel_cuda(p64, _t(pos), SOFT)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernel.nbody_step_dual_cuda(p64, v64, DT, SOFT, DAMP)
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
                                                "p3m_kernels.cu", "ring_kernels.cu",
                                                "f64_kernels.cu"]
    assert [h.name for h in _build.HEADERS] == ["allpairs_common.cuh", "sym_common.cuh",
                                                "ds_common.cuh", "ds_sym_common.cuh"]
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


PTXAS_V = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z4waitv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Function properties for _Z1aPf
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 368 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_kernel_not_its_callees(tmp_path, monkeypatch):
    """ptxas -v's lines as nvcc prints them: each kernel gets its own frame
    line, not that of a callee it did not inline; a kernel without shared
    memory has 0 bytes smem. No cu++filt beside nvcc: names stay mangled."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    (tmp_path / "ptxas.txt").write_text(PTXAS_V)
    nvcc.write_text(f"#!/bin/sh\ncat {tmp_path / 'ptxas.txt'} >&2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    usage = _build.ptxas_usage(tmp_path / "k.cu")
    assert usage == {
        "_Z1aPf": {"registers": 40, "smem": 4096, "stack": 16, "spill_stores": 0,
                   "spill_loads": 0},
        "_Z1bPf": {"registers": 255, "smem": 0, "stack": 0, "spill_stores": 12,
                   "spill_loads": 8}}
    lines = _build.ptxas_lines("nbody_kernels.cu", label="kernel", usage=usage)
    assert lines[1] == ("ptxas kernel: _Z1bPf: 255 registers, 0 bytes smem, 0 bytes stack "
                        "frame, 12 bytes spill stores, 8 bytes spill loads")
    nvcc.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 1\n")
    with pytest.raises(RuntimeError, match="nvcc failed on k.cu"):
        _build.ptxas_usage("k.cu")


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117aj_sym_tri_kernelILi4EEEvPK6float4S3_llfPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
        /*0010*/                   LDS.128 R4, [R2+0x10] ;
        /*0020*/                   FADD R8, R4, -R12 ;
        /*0030*/                   FFMA R9, R8, R8, R3 ;
        /*0040*/                   MUFU.RSQ R10, R9 ;
        /*0050*/                   FSEL R10, R10, RZ, P1 ;
        /*0060*/                   MUFU.RSQ R11, R9 ;
        /*0070*/                   SHFL.IDX PT, R3, R3, R0, 0x1f ;
        /*0080*/                   IADD3 R2, R2, 0x20, RZ ;
        /*0090*/              @!P0 BRA 0x10 ;
        /*00a0*/                   STS [R5], R3 ;
        /*00b0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00c0*/               @P2 BRA 0x0 ;
        /*00d0*/                   BRA 0xd0 ;
        /*00e0*/                   EXIT ;
\t\tFunction : _Z5otherPf
        /*0000*/                   MUFU.RSQ R1, R1 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_sass_loops_counts_the_innermost_rsqrt_loop_by_class():
    """The walk's count: the innermost backward branch whose body holds a
    MUFU.RSQ (not the loop around it, not a self-branch after EXIT's
    padding, not another function), its instructions by class, and its
    pairs as its MUFU.RSQ."""
    (loop,) = _build.sass_loops(SASS, "aj_sym_tri_kernelILi4E")
    assert loop["function"].endswith("aj_sym_tri_kernelILi4EEEvPK6float4S3_llfPf")
    assert loop["instructions"] == 9 and loop["pairs"] == 2
    assert loop["mix"] == {"shared": 1, "fp32": 2, "mufu": 2, "select": 1, "shfl": 1,
                           "integer": 1, "branch": 1}
    assert loop["ops"]["MUFU.RSQ"] == 2 and loop["ops"]["LDS.128"] == 1
    assert _build.sass_class("ULDC.64") == "uniform"
    assert _build.sass_class("STL.64") == "local"
    assert _build.sass_loops(SASS, "no_such_kernel") == []
