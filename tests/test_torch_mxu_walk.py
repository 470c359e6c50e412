"""The tensor-core step's walk (csrc/mxu_kernels.cu: mxu_step_kernel<Tf32x3>
/ <Bf16>, mxu_finish_kernel) and its j-split (``cuda_kernel.mxu_splits``)
against nbody_tpu, on the CPU.

The kernel runs only on the card, so these tests emulate its arithmetic in
torch and hold the emulation to the JAX package's ``_mxu_step_kernel`` in
interpret mode (``nbody_step_pallas_vs(..., variant=..., interpret=True)``)
under the mxu error model, ``reference.mxu_step_tolerance`` (the bound the
card's kernel is held to against its plain version). The emulation:

* s as the kernel computes it: d = p_j - p_i, r2 = fma(dz, dz, fma(dy, dy,
  fma(dx, dx, eps2))) (a fused multiply-add as an exact float64 product and
  sum rounded once to float32), inv = rsqrt(r2), s = (inv inv) inv;
* the TF32 split on int32 views: big = (bits + 0x1000) & ~0x1fff, small =
  x - big; A's small part truncated to TF32 (what the tensor core reads of
  it, the farthest it can be from x - big), P's rounded at staging;
* B as [P_big | P_small] in its 8 columns and two products a k-step,
  A_big B then A_small B, each added to the tile's float32 fragment (the
  products of TF32 values are exact; the tensor core's own sum is taken as
  exact and rounded once an mma); bf16 rounds s and P to nearest even and
  takes one product a k-step of 16;
* each 128-body tile's sum from a zero fragment, added to the running
  float32 sums; a chunk's four sums add column c and c + 4;
* the chunks of the rule (``mxu_splits``, whole 512-body stages), each
  row's partials added in chunk order from 0, then the kernel's update.

The same emulated 3xTF32 force is held to the float64 evaluation of the
algebra within ``MXU_ERROR_COEF["mxu"] * E`` (the largest ratio printed).
The rule is checked as a rule (the j-range once, in order; S = 1 where the
i-tiles fill the card), and the kernel's constants are read from csrc/.
"""

import functools
import importlib.util
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops.pallas_kernel import nbody_step_pallas_vs

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference

SOFT = 0.1
DT = 0.016  # demo 0's time step
DAMP = 0.5  # a kernel that drops the damping fails
TILE_J = 128  # kMxuTileJ: j-bodies a tile sum from a zero fragment
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
VARIANTS = ("mxu", "mxu_bf16")
# one card at the main N and the CLI's default on an H100, the four-card
# allgather ranks at 65536 and 262144, and past the fill
SHAPES = [(1, 1), (1, 33), (33, 1), (255, 513), (1000, 1000), (777, 4099), (4096, 16384),
          (16384, 16384), (16384, 65536), (65536, 65536), (65537, 65537), (135168, 135168),
          (65536, 262144), (1 << 20, 1 << 20)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The emulation is many small eager ops; beside the suite's other
    worker processes, intra-op threads only wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _split_bounds(n, splits):
    """The j-ranges [j0, j1) of the kernel's `splits` chunks of N j-bodies,
    in chunk order: ceil(ceil(N / MXU_STAGE) / splits) stages each, the last
    cut at N (``launch`` in csrc/mxu_kernels.cu)."""
    chunk = _cdiv(_cdiv(n, ck.MXU_STAGE), splits) * ck.MXU_STAGE
    return [(min(c * chunk, n), min((c + 1) * chunk, n)) for c in range(splits)]


# ---- the rule ----


@pytest.mark.parametrize("m, n", SHAPES + [(0, 100), (100, 0)])
def test_splits_cover_the_j_range_once_in_order(m, n):
    s = ck.mxu_splits(m, n)
    assert isinstance(s, int) and s >= 1
    assert s == ck.mxu_splits(m, n)  # a pure function of (M, N)
    bounds = _split_bounds(n, s)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (_, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0  # contiguous, in order: each j exactly once
    for j0, j1 in bounds:
        assert j0 % ck.MXU_STAGE == 0  # a whole number of stages
        assert j1 > j0 or n == 0  # no chunk is empty
    if n:
        assert s <= _cdiv(n, ck.MXU_STAGE)
        sizes = [j1 - j0 for j0, j1 in bounds]
        assert all(z == sizes[0] for z in sizes[:-1]) and sizes[-1] <= sizes[0]


def test_one_split_where_the_i_tiles_fill_the_card():
    full = ck.MXU_FILL_BLOCKS * ck.MXU_TILE_I
    for m in (full, full + 1, 3 * full):
        assert ck.mxu_splits(m, m) == 1
        assert ck.mxu_splits(m, 5) == 1
    assert ck.mxu_splits(full - ck.MXU_TILE_I, 1 << 22) == 2
    # the shapes the card measured: one card at 65536 and 135168, a
    # four-card hop, the step at 16384
    assert ck.mxu_splits(65536, 65536) == 16
    assert ck.mxu_splits(135168, 135168) == 4
    assert ck.mxu_splits(16384, 65536) == 64
    assert ck.mxu_splits(16384, 16384) == 32
    assert ck.mxu_splits(1 << 20, 1 << 20) == 1


def _constants(text: str) -> dict:
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_the_kernels_tile_stage_and_chunks_are_the_rules():
    """The chunks and i-tiles the kernel cuts are the ones the rule
    describes only if its constants agree with the Python ones."""
    text = (CSRC / "mxu_kernels.cu").read_text()
    k = _constants(text)
    assert k["kMxuWarps"] * 16 * k["kMxuTiles"] == ck.MXU_TILE_I
    assert re.search(r"constexpr int kMxuRows = kMxuWarps \* 16 \* kMxuTiles;", text)
    assert k["kMxuStage"] == ck.MXU_STAGE
    assert k["kMxuTileJ"] == TILE_J and k["kMxuStage"] % k["kMxuTileJ"] == 0
    assert "cdiv(cdiv(n, kMxuStage), splits) * kMxuStage" in text
    assert "cdiv(m, kMxuRows)" in text


def test_the_split_has_no_cvt_and_two_mmas_a_tf32_step():
    """The source's own claims: the TF32 split by integer rounding (no
    cvt.rna.tf32), B staged once, two mmas a k-step for 3xTF32."""
    text = (CSRC / "mxu_kernels.cu").read_text()
    code = "\n".join(ln for ln in text.splitlines() if not ln.lstrip().startswith("//"))
    assert "cvt.rna.tf32" not in code
    assert code.count("mma_tf32(d,") == 2
    assert "stage_b(" in code and code.count("sB[") >= 2


# ---- the kernel's arithmetic, emulated ----


def _t(a):
    return torch.tensor(np.asarray(a))


def _fma(a, b, c):
    """float32 fma: the product exact in float64, the sum rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _bits(x):
    return x.contiguous().view(torch.int32)


def _tf32_big(x):
    """x rounded to TF32, to nearest with ties away from zero, on the bits."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def _s(pi, pj, eps2):
    """s (M, N) in the kernel's arithmetic."""
    d = [pj[None, :, c] - pi[:, None, c] for c in range(3)]
    zero = torch.zeros((), dtype=torch.float32)
    r2 = _fma(d[2], d[2], _fma(d[1], d[1], _fma(d[0], d[0], zero + eps2)))
    inv = torch.rsqrt(r2)
    return (inv * inv) * inv


def _chunk_sums(s, P, variant):
    """The four sums (M, 4) of one chunk: s (M, L), P (L, 4), L <= a
    chunk, in the kernel's tiles, k-steps and passes."""
    m = s.shape[0]
    if variant == "mxu":
        a_big = _tf32_big(s)
        a_small = _tf32_trunc(s - a_big)
        p_big = _tf32_big(P)
        B = torch.cat([p_big, _tf32_big(P - p_big)], dim=1).double()  # (L, 8)
        passes, k = (a_big.double(), a_small.double()), 8
    else:
        B = P.to(torch.bfloat16).double()  # columns 4..7 zero: left out
        passes, k = (s.to(torch.bfloat16).double(),), 16
    acc = torch.zeros((m, B.shape[1]), dtype=torch.float32)
    for t0 in range(0, s.shape[1], TILE_J):
        d = torch.zeros_like(acc)
        for k0 in range(t0, min(t0 + TILE_J, s.shape[1]), k):
            for a in passes:
                d = (d.double() + a[:, k0:k0 + k] @ B[k0:k0 + k]).float()
        acc = acc + d
    return acc[:, :4] + acc[:, 4:] if variant == "mxu" else acc


def _emulated_sums(pos_i, pos_j, eps2, variant, splits):
    """The four sums of each row: the chunks' sums added in chunk order
    from 0, as mxu_finish_kernel adds them."""
    P = torch.cat([pos_j[:, :3] * pos_j[:, 3:4], pos_j[:, 3:4]], dim=1)
    total = torch.zeros((pos_i.shape[0], 4), dtype=torch.float32)
    for j0, j1 in _split_bounds(pos_j.shape[0], splits):
        total = total + _chunk_sums(_s(pos_i, pos_j[j0:j1], eps2), P[j0:j1], variant)
    return total


def _emulated_step(pos_i, vel_i, pos_j, variant, splits):
    """The kernel's step: mxu_update on the emulated sums."""
    sums = _emulated_sums(pos_i, pos_j, SOFT * SOFT, variant, splits)
    acc = sums[:, :3] - pos_i[:, :3] * sums[:, 3:4]
    new_vel, new_pos = vel_i.clone(), pos_i.clone()
    new_vel[:, :3] = (vel_i[:, :3] + acc * DT) * DAMP
    new_pos[:, :3] = pos_i[:, :3] + new_vel[:, :3] * DT
    return new_pos, new_vel


@functools.lru_cache(maxsize=None)
def _case(m, n, config, variant):
    """A state (masses from [0.5, 2], a random vel.w) of max(m, n) bodies:
    the i-set its first m rows, the j-set its first n; and the JAX
    interpret-mode mxu step of the i-set under the j-set."""
    size = max(m, n)
    pos, vel = jax_ic.generate(JaxNBodyConfig(config), size, 1.52,
                               2.0 if config == "shell" else 8.0, seed=4)
    rng = np.random.default_rng(104)
    pos[:, 3] = rng.uniform(0.5, 2.0, size).astype(np.float32)
    vel[:, 3] = rng.standard_normal(size).astype(np.float32)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    step = nbody_step_pallas_vs(p[:m], v[:m], p[:n], DT, SOFT, DAMP, tile_i=64, tile_j=128,
                                interpret=True, variant=variant)
    return pos, vel, tuple(np.asarray(x) for x in step)


def _held(pos_i, vel_i, pos_j, got, want, variant):
    tol_p, tol_v = reference.mxu_step_tolerance(pos_i, vel_i, pos_j, want, DT, SOFT, DAMP,
                                                variant=variant)
    rp = ((got[0][:, :3] - want[0][:, :3]).abs() / tol_p).max().item()
    rv = ((got[1][:, :3] - want[1][:, :3]).abs() / tol_v).max().item()
    assert rp <= 1.0 and rv <= 1.0, f"error / bound: positions {rp:.3g}, velocities {rv:.3g}"
    assert torch.equal(got[0][:, 3], pos_i[:, 3]) and torch.equal(got[1][:, 3], vel_i[:, 3])


# (M, N, S): M != N both ways, N odd and not a multiple of the stage or of
# 128, the self set with one body past a stage; the rule's S and others
EMULATED = [(77, 1100, None), (77, 1100, 1), (300, 1031, None), (1100, 300, None),
            (513, 513, None), (513, 513, 1)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("m, n, splits", EMULATED)
def test_emulated_kernel_matches_pallas(variant, m, n, splits):
    pos, vel, want = _case(m, n, "random", variant)
    p, v = _t(pos), _t(vel)
    s = ck.mxu_splits(m, n) if splits is None else splits
    got = _emulated_step(p[:m], v[:m], p[:n], variant, s)
    _held(p[:m], v[:m], p[:n], got, tuple(_t(w) for w in want), variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_emulated_kernel_matches_pallas_on_a_shell(variant):
    pos, vel, want = _case(700, 700, "shell", variant)
    p, v = _t(pos), _t(vel)
    got = _emulated_step(p, v, p, variant, ck.mxu_splits(700, 700))
    _held(p, v, p, got, tuple(_t(w) for w in want), variant)


def test_emulated_3xtf32_force_within_the_error_model_of_float64(capsys):
    """The 3xTF32 walk (truncated small parts of A included) against the
    algebra in float64: within MXU_ERROR_COEF["mxu"] * E."""
    pos, *_ = _case(300, 1031, "random", "mxu")
    p = _t(pos)
    pi, pj = p[:300], p[:1031]
    sums = _emulated_sums(pi, pj, SOFT * SOFT, "mxu", ck.mxu_splits(300, 1031))
    got = sums[:, :3] - pi[:, :3] * sums[:, 3:4]
    p64, j64 = pi.double(), pj.double()
    sp = reference._mxu_s_rows(p64[:, :3], j64[:, :3], SOFT ** 2) @ reference._mxu_fold(j64)
    exact = sp[:, :3] - p64[:, :3] * sp[:, 3:4]
    bound = reference.MXU_ERROR_COEF["mxu"] * reference.mxu_error_scale(pi, pj, SOFT).double()
    ratio = ((got.double() - exact).abs() / bound).max().item()
    with capsys.disabled():
        print(f"\nemulated 3xTF32 force against float64: largest error / bound {ratio:.3e}")
    assert ratio <= 1.0


def test_the_split_is_exact_and_rounds_as_cvt_rna():
    """big + small == x exactly; big is x to nearest TF32, ties away from
    zero, for both signs."""
    x = torch.tensor([1.0, -1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11,
                      3.14159265, -2.718281828, 1e-30, 6e37], dtype=torch.float32)
    big = _tf32_big(x)
    assert torch.equal(big + (x - big), x)
    assert torch.equal(_bits(big) & 0x1FFF, torch.zeros_like(_bits(big)))
    want = torch.tensor([1.0, -1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 * 2 ** -10],
                        dtype=torch.float32)
    assert torch.equal(big[:5], want)
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()


# ---- the CPU wrapper ----


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_cpu_wrapper_takes_the_plain_version_at_any_split(variant, splits):
    pos, vel, _ = _case(77, 1100, "random", variant)
    p, v = _t(pos), _t(vel)
    pi, vi = p[:77].contiguous(), v[:77].contiguous()
    launches = dict(ck.LAUNCHES)
    got = ck._mxu_step(pi, vi, p, DT, SOFT, DAMP, variant, None, splits=splits)
    want = reference.nbody_step_mxu_vs(pi, vi, p, DT, SOFT, DAMP,
                                       mxu_dtype=reference.MXU_DTYPES[variant])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ck.LAUNCHES == launches


# ---- chip_smoke.py's report of the walks ----


def _walk_sass(name: str) -> str:
    """cuobjdump-like SASS of one kernel whose walk is a loop of five
    instructions around two MUFU.RSQ."""
    ins = ["LDS.64 R2, [R1]", "MUFU.RSQ R4, R3", "FFMA R5, R4, R4, R5", "MUFU.RSQ R6, R3",
           "HMMA.1688.F32.TF32 R8, R10, R12, R8", "@P0 BRA 0x10", "EXIT"]
    lines = ["\tcode for sm_90a", f"\t\tFunction : {name}"]
    lines += [f"        /*{16 * k:04x}*/                   {op} ;" for k, op in enumerate(ins)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("spill", [0, 8])
def test_chip_smoke_prints_each_walk_and_fails_on_a_spill(spill, monkeypatch, capsys):
    """Phases 3m and 3h's walk_lines: registers, the walk's SASS a pair and
    its issue bound; a spill fails the phase."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    name = "_ZN12_GLOBAL__N_115mxu_step_kernelINS_6Tf32x3EEEvPK6float4"
    usage = {name: {"registers": 95, "smem": 24576, "stack": 0, "spill_stores": spill,
                    "spill_loads": spill}}
    monkeypatch.setattr(smoke, "sass_of_source", lambda src: (usage, _walk_sass(name)))
    build = types.SimpleNamespace(sass_loops=_build.sass_loops,
                                  demangle=lambda u: {k: k for k in u})
    pairs = 65536.0 ** 2
    if spill:
        with pytest.raises(RuntimeError, match="spills registers"):
            smoke.walk_lines(build, "mxu_kernels.cu", "6Tf32x3", "[3m mxu]", pairs, 132)
        return
    smoke.walk_lines(build, "mxu_kernels.cu", "6Tf32x3", "[3m mxu]", pairs, 132)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[3m mxu]")]
    issue = pairs * 2.5 / 32 / (132 * 4 * smoke.NOMINAL_MHZ * 1e6) * 1e3
    assert "95 registers" in line and "walk 2.50 SASS instructions a pair" in line
    assert "mufu 1.00" in line and f"issue bound {issue:.3f} ms" in line
