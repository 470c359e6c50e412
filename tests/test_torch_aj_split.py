"""The j-split of the port's one-sided accel + jerk kernels
(``cuda_kernel.aj_splits`` / ``ds_aj_splits``, csrc/nbody_kernels.cu,
csrc/ds_aj_kernels.cu) against nbody_tpu.

The kernels cut the j-range into S chunks of whole shared-memory stages,
sum each chunk in j order and add the chunks' partials in chunk order. On
the CPU the split is plain Python, so these tests hold the rule itself (S at
least 1, chunks that cover [0, N) once and in order, one chunk where the
i-tiles fill the card) and the arithmetic in that order: the plain versions
(ops/reference.py, ops/ds.py) summed over the chunks in chunk order, and an
emulation of the fp32 kernel's pair terms and sums, against the JAX
package's interpret-mode ``compute_accel_jerk_pallas`` and
``compute_accel_jerk_pallas_ds``. Tolerances are the JAX suites' own, as in
tests/test_torch_hermite.py and tests/test_torch_ds_hermite.py: fp32 1e-5
of the largest value (tests/test_symmetric.py:325), ds 5e-8 * max|a| for the
force and 5e-7 * max|j| for the jerk against the interpret path, 1e-11 *
max against the float64 oracle. The card's bits are held in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops import ds_kernel as jds
from nbody_tpu.ops.pallas_kernel import compute_accel_jerk_pallas
from nbody_tpu.oracle.numpy_oracle import accel_jerk_numpy

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import ds, reference

SOFT = 0.1
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
RULES = {"fp32": (ck.aj_splits, ck.AJ_TILE_I, ck.AJ_STAGE, ck.AJ_FILL_BLOCKS),
         "ds": (ck.ds_aj_splits, ck.DS_AJ_TILE_I, ck.DS_AJ_STAGE, ck.DS_AJ_FILL_BLOCKS)}
SHAPES = [(1, 1), (1, 33), (33, 1), (255, 257), (1000, 1000), (777, 4099), (4096, 4096),
          (4096, 16384), (16384, 16384), (16384, 65536), (36864, 36864), (65536, 65536),
          (65537, 65537), (135168, 135168), (1 << 20, 1 << 20)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain ds version and the emulation are many small eager ops;
    beside the suite's other worker processes, intra-op threads only wait
    for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _split_bounds(n, splits, stage):
    """The j-ranges [j0, j1) of the kernels' `splits` chunks of N j-bodies,
    in chunk order: ceil(ceil(N / stage) / splits) stages each, the last cut
    at N (``launch_accel_jerk`` / ``launch_ds_accel_jerk``)."""
    chunk = _cdiv(_cdiv(n, stage), splits) * stage
    return [(min(c * chunk, n), min((c + 1) * chunk, n)) for c in range(splits)]


# ---- the rule ----


@pytest.mark.parametrize("kind", ["fp32", "ds"])
@pytest.mark.parametrize("m, n", SHAPES + [(0, 100), (100, 0), (0, 0)])
def test_splits_are_at_least_one_and_cover_the_j_range_once_in_order(kind, m, n):
    rule, _, stage, _ = RULES[kind]
    s = rule(m, n)
    assert isinstance(s, int) and s >= 1
    assert s == rule(m, n)  # a pure function of (M, N)
    bounds = _split_bounds(n, s, stage)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0  # contiguous, in order: each j exactly once
    for j0, j1 in bounds:
        assert j0 % stage == 0  # a whole number of stages
        assert j1 > j0 or n == 0  # no chunk is empty
    if n:
        assert s <= _cdiv(n, stage)


@pytest.mark.parametrize("kind", ["fp32", "ds"])
def test_one_split_where_the_i_tiles_fill_the_card(kind):
    rule, tile_i, _, fill = RULES[kind]
    for m in (fill * tile_i, fill * tile_i + 1, 3 * fill * tile_i):
        assert rule(m, m) == 1
        assert rule(m, 5) == 1
    assert rule(fill * tile_i - tile_i, 1 << 22) == 2
    assert rule(fill * tile_i // 4, 1 << 22) == 4


@pytest.mark.parametrize("kind", ["fp32", "ds"])
@pytest.mark.parametrize("m, n", SHAPES)
def test_splits_fill_the_card_at_the_sharded_shapes(kind, m, n):
    """The grid reaches half the fill at least (a power of two of chunks
    that reaches it, evened out to whole stages, or every stage its own
    chunk), with at most twice the least chunk count that would reach it;
    the chunks are equal but the last, which is no longer."""
    rule, tile_i, stage, fill = RULES[kind]
    s, tiles, stages = rule(m, n), _cdiv(m, tile_i), _cdiv(n, stage)
    assert 2 * tiles * s >= min(fill, tiles * stages)
    assert s <= 2 * _cdiv(fill, tiles)
    sizes = [j1 - j0 for j0, j1 in _split_bounds(n, s, stage)]
    assert all(z == sizes[0] for z in sizes[:-1]) and sizes[-1] <= sizes[0]


def test_splits_at_odd_n_and_below_one_stage():
    """Below one stage there is one chunk; past it one a stage while the
    i-tiles are few, the last chunk cut at N."""
    assert ck.aj_splits(5, 1) == 1 and ck.aj_splits(5, 255) == 1
    assert ck.aj_splits(5, 257) == 2 and ck.ds_aj_splits(5, 257) == 3
    assert _split_bounds(257, 2, ck.AJ_STAGE) == [(0, 256), (256, 257)]
    assert _split_bounds(257, 3, ck.DS_AJ_STAGE) == [(0, 128), (128, 256), (256, 257)]
    assert ck.aj_splits(5, 1025) == 5
    assert _split_bounds(1025, 5, ck.AJ_STAGE)[-1] == (1024, 1025)
    assert _split_bounds(4099, 3, 128) == [(0, 1408), (1408, 2816), (2816, 4099)]


@pytest.mark.parametrize("name, value", [("kAjStage", ck.AJ_STAGE),
                                         ("kDsAjStage", ck.DS_AJ_STAGE)])
def test_the_kernels_stage_is_the_rules_stage(name, value):
    """The chunks the kernel cuts are the ones the rule describes only if
    their stage sizes agree."""
    text = (CSRC / "nbody_kernels.cu").read_text() + (CSRC / "ds_aj_kernels.cu").read_text()
    (found,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert int(found) == value


def test_cpu_wrappers_take_the_plain_version_at_any_split():
    pos, vel = _state(300, masses=True)
    p, v = _t(pos), _t(vel)
    want = reference.compute_accel_jerk_vs(p[:77], v[:77], p, v, SOFT)
    launches = dict(ck.LAUNCHES)
    for sp in (None, 1, 3):
        got = ck._accel_jerk(p[:77].contiguous(), v[:77].contiguous(), p, v, SOFT, 256,
                             splits=sp)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ck.LAUNCHES == launches


# ---- fp32: the plain version and the kernel's arithmetic, chunk by chunk ----


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(n, config="random", seed=2, masses=False):
    pos, vel = jax_ic.generate(JaxNBodyConfig(config), n, 1.52,
                               2.0 if config == "shell" else 8.0, seed=seed)
    if masses:
        rng = np.random.default_rng(seed + 100)
        pos[:, 3] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        vel[:, 3] = rng.standard_normal(n).astype(np.float32)
    return pos, vel


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _jax_fp32(m, n, config, masses):
    pos, vel = _state(n, config, masses=masses)
    p, v = jnp.asarray(pos), jnp.asarray(vel)
    return tuple(np.asarray(x) for x in compute_accel_jerk_pallas(
        p[:m], v[:m], p, v, SOFT, tile_i=64, tile_j=128, interpret=True))


def _chunked(fn, n, splits, stage, add):
    """fn(j0, j1) of each chunk, added in chunk order with `add`."""
    total = None
    for j0, j1 in _split_bounds(n, splits, stage):
        part = fn(j0, j1)
        total = part if total is None else add(total, part)
    return total


def _emulate_one_sided_chunk(pi, vi, pj, vj, eps2):
    """The fp32 kernel's sums over one chunk: each pair term in its
    arithmetic (r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))), w = 3
    inv2 (d . dv), jerk s (dv - w d); a fused multiply-add taken as a
    product and a sum), added in j order from 0."""
    acc = torch.zeros((pi.shape[0], 6))
    for j in range(pj.shape[0]):
        d = pj[j, :3] - pi[:, :3]
        dv = vj[j, :3] - vi[:, :3]
        dx, dy, dz = d.unbind(-1)
        r2 = ((dx * dx + eps2) + dy * dy) + dz * dz
        inv = torch.rsqrt(r2)
        inv2 = inv * inv
        s = pj[j, 3] * (inv2 * inv)
        w = (3.0 * inv2) * ((dx * dv[:, 0] + dy * dv[:, 1]) + dz * dv[:, 2])
        e = dv - w[:, None] * d
        acc = acc + torch.cat([s[:, None] * d, s[:, None] * e], 1)
    return acc


@pytest.mark.parametrize("config, masses", [("random", True), ("shell", False)])
@pytest.mark.parametrize("m, n, splits", [(128, 700, None), (128, 700, 3), (77, 301, 2),
                                          (64, 255, 1)])
def test_chunked_plain_matches_pallas(m, n, splits, config, masses):
    pos, vel = _state(n, config, masses=masses)
    p, v = _t(pos), _t(vel)
    s = ck.aj_splits(m, n) if splits is None else splits
    got = _chunked(lambda j0, j1: reference.compute_accel_jerk_vs(
        p[:m], v[:m], p[j0:j1], v[j0:j1], SOFT), n, s, ck.AJ_STAGE,
        lambda a, b: (a[0] + b[0], a[1] + b[1]))
    for g, w in zip(got, _jax_fp32(m, n, config, masses)):
        assert g.shape == (m, 3)
        assert _rel(g.numpy(), w) < 1e-5


@pytest.mark.parametrize("m, n, splits", [(128, 700, 3), (77, 301, 2), (33, 257, 1)])
def test_kernel_emulation_matches_pallas(m, n, splits):
    """The fp32 kernel's pair arithmetic and its sum order (j order within a
    chunk, chunks in order) against the interpret-mode _accel_jerk_kernel."""
    pos, vel = _state(n, "random", masses=True)
    p, v = _t(pos), _t(vel)
    eps2 = SOFT * SOFT
    got = _chunked(lambda j0, j1: _emulate_one_sided_chunk(p[:m], v[:m], p[j0:j1], v[j0:j1],
                                                           eps2),
                   n, splits, ck.AJ_STAGE, lambda a, b: a + b)
    want_acc, want_jerk = _jax_fp32(m, n, "random", True)
    assert _rel(got[:, :3].numpy(), want_acc) < 1e-5
    assert _rel(got[:, 3:].numpy(), want_jerk) < 1e-5


# ---- ds: the plain version chunk by chunk, ds-added in chunk order ----


def _state64(n, seed=1):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed + 100)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return pos, vel


@functools.lru_cache(maxsize=None)
def _ds_case(m, n):
    pos, vel = _state64(n)
    planes = (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))
    scal = ds.scal_ds_hermite(1e-3, SOFT, 0.5)
    jp = tuple(jnp.asarray(t.numpy()) for t in planes)
    want = jds.compute_accel_jerk_pallas_ds(*(t[:m] for t in jp), *jp,
                                            jnp.asarray(scal.numpy()), tile_j=128,
                                            interpret=True)
    oracle = accel_jerk_numpy(pos, vel, SOFT)
    return planes, scal, tuple(np.asarray(a) for a in want), (oracle[0][:m], oracle[1][:m])


def _ds_add4(x, y):
    return (*ds.ds_add(x[:2], y[:2]), *ds.ds_add(x[2:], y[2:]))


@pytest.mark.parametrize("m, n, splits", [(40, 300, None), (40, 300, 3), (33, 129, 2)])
def test_ds_chunked_plain_matches_pallas_and_oracle(m, n, splits):
    planes, scal, want, oracle = _ds_case(m, n)
    s = ck.ds_aj_splits(m, n) if splits is None else splits
    assert s > 1
    got = _chunked(lambda j0, j1: ds.ds_accel_jerk_vs(
        *(t[:m] for t in planes), *(t[j0:j1] for t in planes), scal),
        n, s, ck.DS_AJ_STAGE, _ds_add4)
    acc, jerk = ds.ds_to_f64(*got[:2])[:, :3], ds.ds_to_f64(*got[2:])[:, :3]
    jacc = want[0][:, :3].astype(np.float64) + want[1][:, :3]
    jjerk = want[2][:, :3].astype(np.float64) + want[3][:, :3]
    assert np.abs(acc - jacc).max() <= 5e-8 * np.abs(jacc).max()
    assert np.abs(jerk - jjerk).max() <= 5e-7 * np.abs(jjerk).max()
    assert np.abs(acc - oracle[0]).max() <= 1e-11 * np.abs(oracle[0]).max()
    assert np.abs(jerk - oracle[1]).max() <= 1e-11 * np.abs(oracle[1]).max()
    for t in got:
        assert t.shape == (m, 4) and torch.equal(t[:, 3], torch.zeros(m))
