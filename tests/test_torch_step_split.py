"""The j-split of the port's fp32 one-sided step kernel and its twins
(``cuda_kernel.step_splits``, csrc/nbody_kernels.cu: ``step_kernel``,
``step_t_kernel``, ``step_dual_kernel``, ``step_packed_kernel``) against
nbody_tpu.

The kernels cut the j-range into S chunks of whole shared-memory stages,
sum each row's chunk in j order from 0, add the chunks' partials in chunk
order and apply the damped Euler update to that sum. On the CPU the split is
plain Python, so these tests hold the rule itself (S at least 1, chunks
that cover [0, N) once and in order, one chunk where the i-tiles fill the
card, filling at the sharded shapes) and the arithmetic in that order: the
plain force (ops/reference.py) summed chunk by chunk, and an emulation of
the kernel's pair terms and sums, each through the update, against the JAX
package's interpret-mode ``nbody_step_pallas_vs`` and
``compute_accel_pallas``. Tolerances: the force within 1e-4 * max|a| + 1e-4
(tests/test_pallas.py:76), carried through the step into the velocity as
1e-5 + dt * that and into the position as 1e-5 + dt^2 * that, the bounds
chip_smoke.py holds the kernel to on the card. The card's bits are held in
tests/test_torch_cuda.py and chip_smoke.py.
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
from nbody_tpu.ops.pallas_kernel import compute_accel_pallas, nbody_step_pallas_vs

from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference

SOFT = 0.1
DT = 0.016  # demo 0's time step
DAMP = 0.5  # a kernel that drops the damping fails
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
# one card at the main N and the CLI's default on an H100, four-card
# allgather ranks and ring hops at N = 16384 and 65536, and past the fill
SHAPES = [(1, 1), (1, 33), (33, 1), (255, 257), (1000, 1000), (777, 4099), (4096, 4096),
          (4096, 16384), (16384, 16384), (16384, 65536), (65536, 65536), (65537, 65537),
          (135168, 135168), (262144, 262144), (1 << 20, 1 << 20)]


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
    """The j-ranges [j0, j1) of the kernels' `splits` chunks of N j-bodies,
    in chunk order: ceil(ceil(N / STEP_STAGE) / splits) stages each, the
    last cut at N (``step_chunk`` in csrc/nbody_kernels.cu)."""
    chunk = _cdiv(_cdiv(n, ck.STEP_STAGE), splits) * ck.STEP_STAGE
    return [(min(c * chunk, n), min((c + 1) * chunk, n)) for c in range(splits)]


# ---- the rule ----


@pytest.mark.parametrize("m, n", SHAPES + [(0, 100), (100, 0), (0, 0)])
def test_splits_are_at_least_one_and_cover_the_j_range_once_in_order(m, n):
    s = ck.step_splits(m, n)
    assert isinstance(s, int) and s >= 1
    assert s == ck.step_splits(m, n)  # a pure function of (M, N)
    bounds = _split_bounds(n, s)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0  # contiguous, in order: each j exactly once
    for j0, j1 in bounds:
        assert j0 % ck.STEP_STAGE == 0  # a whole number of stages
        assert j1 > j0 or n == 0  # no chunk is empty
    if n:
        assert s <= _cdiv(n, ck.STEP_STAGE)


@pytest.mark.parametrize("m, n", SHAPES)
def test_splits_fill_the_card_at_the_sharded_shapes(m, n):
    """The grid reaches half the fill at least (a power of two of chunks
    that reaches it, evened out to whole stages, or every stage its own
    chunk), with at most twice the least chunk count that would reach it;
    the chunks are equal but the last, which is no longer."""
    s, tiles, stages = ck.step_splits(m, n), _cdiv(m, ck.AJ_TILE_I), _cdiv(n, ck.STEP_STAGE)
    assert 2 * tiles * s >= min(ck.AJ_FILL_BLOCKS, tiles * stages)
    assert s <= 2 * _cdiv(ck.AJ_FILL_BLOCKS, tiles)
    sizes = [j1 - j0 for j0, j1 in _split_bounds(n, s)]
    assert all(z == sizes[0] for z in sizes[:-1]) and sizes[-1] <= sizes[0]


def test_one_split_where_the_i_tiles_fill_the_card():
    full = ck.AJ_FILL_BLOCKS * ck.AJ_TILE_I
    for m in (full, full + 1, 3 * full):
        assert ck.step_splits(m, m) == 1
        assert ck.step_splits(m, 5) == 1
    assert ck.step_splits(full - ck.AJ_TILE_I, 1 << 22) == 2
    assert ck.step_splits(full // 4, 1 << 22) == 4
    # the main path's shapes: one card at 65536 and 135168, a four-card hop
    assert ck.step_splits(135168, 135168) == 4
    assert ck.step_splits(65536, 65536) == 16
    assert ck.step_splits(16384, 65536) == 64


def test_splits_at_odd_n_and_below_one_stage():
    """Below one stage there is one chunk; past it one a stage while the
    i-tiles are few, the last chunk cut at N."""
    assert ck.step_splits(5, 1) == 1 and ck.step_splits(5, 255) == 1
    assert ck.step_splits(5, 256) == 1 and ck.step_splits(5, 257) == 2
    assert _split_bounds(257, 2) == [(0, 256), (256, 257)]
    assert ck.step_splits(5, 1025) == 5
    assert _split_bounds(1025, 5)[-1] == (1024, 1025)
    assert _split_bounds(4099, 3) == [(0, 1536), (1536, 3072), (3072, 4099)]


def test_the_kernels_stage_is_the_rules_stage():
    """The chunks the kernels cut are the ones the rule describes only if
    their stage sizes agree."""
    (found,) = re.findall(r"constexpr int kStepStage = (\d+);",
                          (CSRC / "allpairs_common.cuh").read_text())
    assert int(found) == ck.STEP_STAGE


# ---- the plain force chunk by chunk, and the kernel's arithmetic ----


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _case(m, n, config):
    """An N-body state (masses from [0.5, 2], a random vel.w) whose first m
    rows are the i-set, and the JAX interpret-mode force and damped step of
    the i-set under the whole set."""
    pos, vel = jax_ic.generate(JaxNBodyConfig(config), n, 1.52,
                               2.0 if config == "shell" else 8.0, seed=2)
    rng = np.random.default_rng(102)
    pos[:, 3] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    vel[:, 3] = rng.standard_normal(n).astype(np.float32)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    acc = compute_accel_pallas(p[:m], p, SOFT, tile_i=64, tile_j=128, interpret=True)
    step = nbody_step_pallas_vs(p[:m], v[:m], p, DT, SOFT, DAMP, tile_i=64, tile_j=128,
                                interpret=True)
    return pos, vel, np.asarray(acc), tuple(np.asarray(x) for x in step)


def _chunked(fn, n, splits):
    """fn(j0, j1) of each chunk, added in chunk order."""
    total = None
    for j0, j1 in _split_bounds(n, splits):
        part = fn(j0, j1)
        total = part if total is None else total + part
    return total


def _emulate_chunk(pi, pj, eps2):
    """The kernel's sums over one chunk: each pair term in its arithmetic
    (r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))), s = m_j ((inv inv)
    inv), a = fma(s, d, a); a fused multiply-add taken as a product and a
    sum), added in j order from 0."""
    acc = torch.zeros((pi.shape[0], 3))
    for j in range(pj.shape[0]):
        d = pj[j, :3] - pi[:, :3]
        dx, dy, dz = d.unbind(-1)
        r2 = ((dx * dx + eps2) + dy * dy) + dz * dz
        inv = torch.rsqrt(r2)
        s = pj[j, 3] * ((inv * inv) * inv)
        acc = acc + s[:, None] * d
    return acc


def _update(pi, vi, acc):
    """The kernels' Euler update (euler_update): v = (v + a dt) damping,
    p = p + v dt, pos.w and vel.w carried."""
    v = vi.clone()
    p = pi.clone()
    v[:, :3] = (vi[:, :3] + acc * DT) * DAMP
    p[:, :3] = pi[:, :3] + v[:, :3] * DT
    return p, v


def _held(acc, new_pos, new_vel, want_acc, want_step, pi, vi):
    tol_a = 1e-4 * np.abs(want_acc).max() + 1e-4
    assert np.isfinite(acc).all()
    assert np.abs(acc - want_acc).max() <= tol_a
    assert np.abs(new_vel - want_step[1]).max() <= 1e-5 + DT * tol_a
    assert np.abs(new_pos - want_step[0]).max() <= 1e-5 + DT * DT * tol_a
    assert np.array_equal(new_pos[:, 3], pi[:, 3]) and np.array_equal(new_vel[:, 3], vi[:, 3])


CHUNKED = [(128, 700, None), (128, 700, 3), (77, 301, 2), (64, 255, 1), (33, 1025, None)]


@pytest.mark.parametrize("config", ["random", "shell"])
@pytest.mark.parametrize("m, n, splits", CHUNKED)
def test_chunked_plain_step_matches_pallas(m, n, splits, config):
    """The plain force chunk by chunk, added in chunk order, through the
    update, as the split step kernel's finish applies it."""
    pos, vel, want_acc, want_step = _case(m, n, config)
    p, v = _t(pos), _t(vel)
    s = ck.step_splits(m, n) if splits is None else splits
    acc = _chunked(lambda j0, j1: reference.compute_accel_vs(p[:m], p[j0:j1], SOFT), n, s)
    assert acc.shape == (m, 3)
    new_pos, new_vel = _update(p[:m], v[:m], acc)
    _held(acc.numpy(), new_pos.numpy(), new_vel.numpy(), want_acc, want_step, pos[:m], vel[:m])


@pytest.mark.parametrize("m, n, splits", [(128, 700, 3), (77, 301, 2), (33, 257, 1),
                                          (33, 1025, None)])
def test_kernel_emulation_matches_pallas(m, n, splits):
    """The kernel's pair arithmetic and its sum order (j order within a
    chunk, chunks in order), then the update, against the interpret-mode
    _step_kernel and _accel_kernel."""
    pos, vel, want_acc, want_step = _case(m, n, "random")
    p, v = _t(pos), _t(vel)
    s = ck.step_splits(m, n) if splits is None else splits
    acc = _chunked(lambda j0, j1: _emulate_chunk(p[:m], p[j0:j1], SOFT * SOFT), n, s)
    new_pos, new_vel = _update(p[:m], v[:m], acc)
    _held(acc.numpy(), new_pos.numpy(), new_vel.numpy(), want_acc, want_step, pos[:m], vel[:m])


def test_one_chunk_is_the_unsplit_plain_force():
    """S = 1 is the whole j-range in one sum: the plain force itself."""
    pos, *_ = _case(77, 301, "random")
    p = _t(pos)
    got = _chunked(lambda j0, j1: reference.compute_accel_vs(p[:77], p[j0:j1], SOFT), 301, 1)
    assert torch.equal(got, reference.compute_accel_vs(p[:77], p, SOFT))


# ---- the CPU wrappers ----


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_cpu_wrappers_take_the_plain_version_at_any_split(splits):
    """The step, its rollout, dual-bank and packed twins on CPU tensors:
    their plain versions whatever S, and no launch counted."""
    pos, vel, *_ = _case(77, 301, "random")
    p, v = _t(pos), _t(vel)
    pi, vi = p[:77].contiguous(), v[:77].contiguous()
    launches = dict(ck.LAUNCHES)
    for got, want in (
            (ck.nbody_step_cuda_vs(pi, vi, p, DT, SOFT, DAMP, splits=splits),
             reference.nbody_step_vs(pi, vi, p, DT, SOFT, DAMP)),
            (ck._step(pi, vi, p, DT, SOFT, DAMP, 128, None, splits=splits),
             reference.nbody_step_vs(pi, vi, p, DT, SOFT, DAMP)),
            (ck.nbody_rollout_cuda(p, v, DT, SOFT, DAMP, steps=2, splits=splits),
             reference.rollout(p, v, DT, SOFT, DAMP, steps=2)),
            (ck.nbody_step_dual_cuda(p, v, DT, SOFT, DAMP, splits=splits),
             reference.nbody_step(p, v, DT, SOFT, DAMP)),
            (ck.nbody_step_packed_cuda(torch.cat([p, v], 1), p.t().contiguous(), DT, SOFT, DAMP,
                                       splits=splits),
             reference.nbody_step_packed(torch.cat([p, v], 1), p.t().contiguous(), DT, SOFT,
                                         DAMP))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ck.LAUNCHES == launches


# ---- chip_smoke.py's guard on the step kernels' walks ----


def _step_sass(kind: str) -> str:
    """cuobjdump-like SASS of the four step kernels: a walk (the loop
    around MUFU.RSQ) with an STL before it and an LDL after it; with kind
    "inside" one more LDL inside the walk, with "stage" a loop around the
    whole (the stage loop) that holds the STL and the LDL."""
    out = ["\tcode for sm_90a"]
    for key in ("11step_kernel", "13step_t_kernel", "16step_dual_kernel",
                "18step_packed_kernel"):
        ins = ["STL.64 [R1], R2", "LDS.128 R4, [R2]", "MUFU.RSQ R10, R9",
               "LDL R3, [R1+0x8]" if kind == "inside" else "FFMA R3, R10, R4, R3",
               "@!P0 BRA 0x10", "LDL.64 R2, [R1]",
               "@P1 BRA 0x0" if kind == "stage" else "NOP", "EXIT"]
        out.append(f"\t\tFunction : _ZN12_GLOBAL__N_1{key}ILi4ELi512EEEvPK6float4")
        out += [f"        /*{16 * k:04x}*/                   {op} ;" for k, op in
                enumerate(ins)]
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("kind, where", [
    ("outside", "outside every loop"), ("stage", "in a loop around it"), ("inside", None)])
def test_chip_smoke_fails_on_a_spill_inside_a_step_walk_only(kind, where, capsys):
    """Phase 3e's step_walks_checked: a local-memory access outside the walk
    is printed with where it lies, one inside the walk fails the phase;
    the walk's span is the loop sass_loops finds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    text = _step_sass(kind)
    (walk,) = _build.sass_loops(text, "13step_t_kernel")
    assert walk["span"] == (0x10, 0x40) and walk["pairs"] == 1
    build = types.SimpleNamespace(**{k: getattr(_build, k) for k in (
        "sass_functions", "sass_loops", "sass_class")}, demangle=lambda u: {})
    if where is None:
        with pytest.raises(RuntimeError, match="spills inside its walk"):
            smoke.step_walks_checked(build, {}, text)
        return
    smoke.step_walks_checked(build, {}, text)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[3e sass]")]
    assert len(lines) == 4
    assert all("0 local accesses inside" in ln
               and f"STL.64 at 0x0 (before the walk, {where})" in ln
               and f"LDL.64 at 0x50 (after the walk, {where})" in ln for ln in lines)
