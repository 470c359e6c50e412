"""The j-split of the port's one-sided ds step, force and leapfrog kernels
(``cuda_kernel.ds_splits``, csrc/ds_kernels.cu) against nbody_tpu.

The kernels cut the j-range into S chunks of whole shared-memory stages,
sum each chunk in j order and ds-add the chunks' partials in chunk order;
the steps then apply their update to that sum (the leapfrog step after
half-drifting both sides). All three take S from one rule, so that the
force followed by the ds Euler update gives the step's bits, and a
leapfrog step from zero velocity the force's. On the CPU the split is plain
Python, so these tests hold the rule itself (S at least 1, chunks that
cover [0, N) once and in order, one chunk where the i-tiles fill the
card) and the arithmetic in that order: the plain versions (ops/ds.py)
summed over the chunks in chunk order, against
the JAX package's interpret-mode ``compute_accel_pallas_ds`` and
``nbody_step_pallas_ds_vs`` (tile_j=128). Tolerances are the JAX suites'
own, as in tests/test_torch_ds.py: against the interpret path 5e-8 *
max|a| for the force, |dpos| < 1e-11 and a relative force of 5e-8 through
a step; against the float64 oracle 1e-11 * max|a|, and through a step
|dpos| < 1e-12 and 1e-11. The leapfrog step: its force at the half-step
positions within 1e-10 * max|a| + 1e-12 of the float64 oracle's; its
positions and velocities within 5e-8 of the interpret-mode
``nbody_step_pallas_ds_leapfrog_vs`` and 1e-12 of the oracle's DKD step, as
tests/test_torch_ds.py holds the unsplit plain version. The card's bits are
held in tests/test_torch_cuda.py and chip_smoke.py.
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
from nbody_tpu.oracle.numpy_oracle import accel_numpy, step_numpy, step_numpy_leapfrog

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import ds

SOFT = 0.1
DT = 1e-3
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
# one card at the ds default N and at 65536, four-card allgather ranks and
# ring hops at N = 16384 and 65536, above the ds sym cap, and past the fill
SHAPES = [(1, 1), (1, 33), (33, 1), (255, 257), (1000, 1000), (777, 4099), (4096, 4096),
          (4096, 16384), (16384, 16384), (16384, 65536), (69632, 69632), (65536, 65536),
          (65537, 65537), (131072, 131072), (1 << 20, 1 << 20)]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain ds versions are many small eager ops; beside the suite's
    other worker processes, intra-op threads only wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _split_bounds(n, splits):
    """The j-ranges [j0, j1) of the kernels' `splits` chunks of N j-bodies,
    in chunk order: ceil(ceil(N / DS_STAGE) / splits) stages each, the last
    cut at N (``chunk_of`` in csrc/ds_kernels.cu)."""
    chunk = _cdiv(_cdiv(n, ck.DS_STAGE), splits) * ck.DS_STAGE
    return [(min(c * chunk, n), min((c + 1) * chunk, n)) for c in range(splits)]


# ---- the rule ----


@pytest.mark.parametrize("m, n", SHAPES + [(0, 100), (100, 0), (0, 0)])
def test_splits_are_at_least_one_and_cover_the_j_range_once_in_order(m, n):
    s = ck.ds_splits(m, n)
    assert isinstance(s, int) and s >= 1
    assert s == ck.ds_splits(m, n)  # a pure function of (M, N)
    bounds = _split_bounds(n, s)
    assert len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0  # contiguous, in order: each j exactly once
    for j0, j1 in bounds:
        assert j0 % ck.DS_STAGE == 0  # a whole number of stages
        assert j1 > j0 or n == 0  # no chunk is empty
    if n:
        assert s <= _cdiv(n, ck.DS_STAGE)


@pytest.mark.parametrize("m, n", SHAPES)
def test_splits_fill_the_card_at_the_main_path_shapes(m, n):
    """The grid reaches half the fill at least (a power of two of chunks
    that reaches it, evened out to whole stages, or every stage its own
    chunk), with at most twice the least chunk count that would reach it;
    the chunks are equal but the last, which is no longer."""
    s, tiles, stages = ck.ds_splits(m, n), _cdiv(m, ck.DS_AJ_TILE_I), _cdiv(n, ck.DS_STAGE)
    assert 2 * tiles * s >= min(ck.DS_AJ_FILL_BLOCKS, tiles * stages)
    assert s <= 2 * _cdiv(ck.DS_AJ_FILL_BLOCKS, tiles)
    sizes = [j1 - j0 for j0, j1 in _split_bounds(n, s)]
    assert all(z == sizes[0] for z in sizes[:-1]) and sizes[-1] <= sizes[0]


def test_one_split_where_the_i_tiles_fill_the_card():
    full = ck.DS_AJ_FILL_BLOCKS * ck.DS_AJ_TILE_I
    for m in (full, full + 1, 3 * full):
        assert ck.ds_splits(m, m) == 1
        assert ck.ds_splits(m, 5) == 1
    assert ck.ds_splits(full - ck.DS_AJ_TILE_I, 1 << 22) == 2
    assert ck.ds_splits(full // 4, 1 << 22) == 4


def test_splits_at_odd_n_and_below_one_stage():
    """Below one stage there is one chunk; past it one a stage while the
    i-tiles are few, the last chunk cut at N."""
    assert ck.ds_splits(5, 1) == 1 and ck.ds_splits(5, 127) == 1
    assert ck.ds_splits(5, 128) == 1 and ck.ds_splits(5, 129) == 2
    assert _split_bounds(129, 2) == [(0, 128), (128, 129)]
    assert ck.ds_splits(5, 257) == 3
    assert _split_bounds(257, 3) == [(0, 128), (128, 256), (256, 257)]
    assert ck.ds_splits(4099, 4099) == 33
    assert _split_bounds(4099, 33)[-1] == (4096, 4099)
    assert _split_bounds(4099, 3) == [(0, 1408), (1408, 2816), (2816, 4099)]


def test_the_kernels_stage_is_the_rules_stage():
    """The chunks the kernels cut are the ones the rule describes only if
    their stage sizes agree."""
    (found,) = re.findall(r"constexpr int kDsStage = (\d+);",
                          (CSRC / "ds_kernels.cu").read_text())
    assert int(found) == ck.DS_STAGE


# ---- the plain versions chunk by chunk, ds-added in chunk order ----


def _state64(n, seed=1):
    """Shell ICs in float64, masses from [0.5, 2] (so with a lo part) and a
    random vel.w."""
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed + 100)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return pos, vel


@functools.lru_cache(maxsize=None)
def _case(m, n):
    """The planes of an N-body state, whose first m rows are the i-set; the
    JAX interpret-mode force and damped step of the i-set under the whole
    set; the float64 oracle's force and step of those rows."""
    pos, vel = _state64(n)
    planes = (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))
    scal = ds.scal_ds(DT, SOFT, 0.5)
    jp = tuple(jnp.asarray(t.numpy()) for t in planes)
    js = jnp.asarray(scal.numpy())
    acc = jds.compute_accel_pallas_ds(jp[0][:m], jp[1][:m], jp[0], jp[1], js, tile_j=128,
                                      interpret=True)
    step = jds.nbody_step_pallas_ds_vs(*(t[:m] for t in jp), jp[0], jp[1], js, tile_j=128,
                                       interpret=True)
    op, ov = step_numpy(pos, vel, DT, SOFT, 0.5)
    return (planes, scal, tuple(np.asarray(a) for a in acc),
            tuple(np.asarray(a) for a in step), accel_numpy(pos, SOFT)[:m], op[:m], ov[:m],
            vel[:m])


def _chunked_accel(planes, m, n, splits, scal):
    """The plain force of the first m rows under the whole set, chunk by
    chunk, ds-added in chunk order."""
    total = None
    for j0, j1 in _split_bounds(n, splits):
        part = ds.ds_accel_vs(planes[0][:m], planes[1][:m], planes[0][j0:j1],
                              planes[1][j0:j1], scal)
        total = part if total is None else ds.ds_add(total, part)
    return total


def _rel_force(new_vel, vel, ref_vel, dt):
    """The relative force error that a step's velocities carry
    (tests/test_ds_kernel.py:50-52)."""
    a_scale = np.abs(ref_vel[:, :3] - vel[:, :3]).max() / dt
    return np.abs(new_vel[:, :3] - ref_vel[:, :3]).max() / dt / a_scale


CHUNKED = [(77, 301, None), (40, 300, 3), (33, 129, 2), (150, 391, 4)]


@pytest.mark.parametrize("m, n, splits", CHUNKED)
def test_chunked_plain_force_matches_pallas_and_oracle(m, n, splits):
    planes, scal, want, _, oracle, *_ = _case(m, n)
    s = ck.ds_splits(m, n) if splits is None else splits
    assert s > 1
    got = _chunked_accel(planes, m, n, s, scal)
    acc = ds.ds_to_f64(*got)
    jacc = want[0][:, :3].astype(np.float64) + want[1][:, :3]
    assert acc.shape == (m, 3)
    assert np.abs(acc - jacc).max() <= 5e-8 * np.abs(jacc).max()
    assert np.abs(acc - oracle).max() <= 1e-11 * np.abs(oracle).max()


@pytest.mark.parametrize("m, n, splits", CHUNKED)
def test_chunked_plain_step_matches_pallas_and_oracle(m, n, splits):
    """The chunked force through the ds Euler update, as the split step
    kernel's second launch applies it: positions and the force the
    velocities carry against the interpret-mode step and the oracle's, the
    mass and vel.w carried through both planes."""
    planes, scal, _, want, _, op, ov, vel = _case(m, n)
    s = ck.ds_splits(m, n) if splits is None else splits
    i_planes = tuple(t[:m] for t in planes)
    got = ds.ds_integrate(*i_planes, _chunked_accel(planes, m, n, s, scal), scal)
    gp, gv = ds.ds_to_f64(*got[:2]), ds.ds_to_f64(*got[2:])
    jp, jv = jds.ds_to_f64(*want[:2]), jds.ds_to_f64(*want[2:])
    assert np.abs(gp[:, :3] - jp[:m, :3]).max() < 1e-11
    assert _rel_force(gv, vel, jv[:m], DT) < 5e-8
    assert np.abs(gp[:, :3] - op[:, :3]).max() < 1e-12
    assert _rel_force(gv, vel, ov, DT) < 1e-11
    for g, p in zip(got, i_planes):
        assert torch.equal(g[:, 3], p[:, 3])


def test_one_chunk_is_the_unsplit_plain_version():
    """S = 1 is the whole j-range in one sum: the plain version itself."""
    planes, scal, *_ = _case(77, 301)
    got = _chunked_accel(planes, 77, 301, 1, scal)
    want = ds.ds_accel_vs(planes[0][:77], planes[1][:77], planes[0], planes[1], scal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- the CPU wrappers ----


@pytest.mark.parametrize("kernel", ["ds_step", "ds_accel"])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_cpu_wrappers_take_the_plain_version_at_any_split(kernel, splits):
    planes, scal, *_ = _case(77, 301)
    i_planes = tuple(t[:77].contiguous() for t in planes)
    launches = dict(ck.LAUNCHES)
    if kernel == "ds_step":
        got = ck._ds_step(*i_planes, planes[0], planes[1], scal, 256, None, splits=splits)
        want = ds.nbody_step_ds_vs(*i_planes, planes[0], planes[1], scal)
    else:
        got = ck._ds_accel(i_planes[0], i_planes[1], planes[0], planes[1], scal, None, None,
                           splits=splits)
        want = ds.ds_accel_vs(i_planes[0], i_planes[1], planes[0], planes[1], scal)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ck.LAUNCHES == launches


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_cpu_force_then_update_is_the_step(splits):
    """The card's contract on the CPU path: the force wrapper followed by
    the ds Euler update wrapper gives the step wrapper's bits."""
    planes, scal, *_ = _case(77, 301)
    i_planes = tuple(t[:77].contiguous() for t in planes)
    acc = ck._ds_accel(i_planes[0], i_planes[1], planes[0], planes[1], scal, None, None,
                       splits=splits)
    got = ck.ds_integrate_cuda(*i_planes, *acc, scal)
    want = ck._ds_step(*i_planes, planes[0], planes[1], scal, 256, None, splits=splits)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- the leapfrog step: both sides half-drifted, the force chunk by chunk ----


@functools.lru_cache(maxsize=None)
def _leapfrog_case(m, n):
    """The planes of an N-body state, whose first m rows are the i-set; the
    JAX interpret-mode damped DKD step of the i-set under the whole set;
    the float64 oracle's force at the half-step positions and its DKD step
    of those rows."""
    pos, vel = _state64(n)
    planes = (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))
    scal = ds.scal_ds_leapfrog(DT, SOFT, 0.5)
    jp = tuple(jnp.asarray(t.numpy()) for t in planes)
    step = jds.nbody_step_pallas_ds_leapfrog_vs(*(t[:m] for t in jp), *jp,
                                                jnp.asarray(scal.numpy()), tile_j=128,
                                                interpret=True)
    half = pos.copy()
    half[:, :3] += vel[:, :3] * (DT / 2)
    op, ov = step_numpy_leapfrog(pos, vel, DT, SOFT, 0.5)
    return (planes, scal, tuple(np.asarray(a) for a in step), accel_numpy(half, SOFT)[:m],
            op[:m], ov[:m])


def _chunked_leapfrog(planes, m, n, splits, scal):
    """The plain leapfrog step of the first m rows under the whole set, its
    force at the half-step positions summed chunk by chunk and ds-added in
    chunk order, then the kick and second drift; returns (the four new
    planes, the force)."""
    hh, hl = ds.ds_half_drift(*(t[:m] for t in planes), scal)
    jh, jl = ds.ds_half_drift(*planes, scal)
    acc = None
    for j0, j1 in _split_bounds(n, splits):
        part = ds.ds_accel_vs(hh, hl, jh[j0:j1], jl[j0:j1], scal)
        acc = part if acc is None else ds.ds_add(acc, part)
    return ds.ds_leapfrog_finish(hh, hl, planes[2][:m], planes[3][:m], acc, scal), acc


@pytest.mark.parametrize("m, n, splits", CHUNKED)
def test_chunked_plain_leapfrog_matches_pallas_and_oracle(m, n, splits):
    """The split leapfrog kernel's arithmetic in its order: the force at
    the half-step positions against the float64 oracle's, the step against
    the interpret-mode DKD step and the oracle's, the mass and vel.w carried
    through both planes."""
    planes, scal, want, oracle, op, ov = _leapfrog_case(m, n)
    s = ck.ds_splits(m, n) if splits is None else splits
    assert s > 1
    got, acc = _chunked_leapfrog(planes, m, n, s, scal)
    a64 = ds.ds_to_f64(*acc)
    assert a64.shape == (m, 3)
    assert np.abs(a64 - oracle).max() <= 1e-10 * np.abs(oracle).max() + 1e-12
    gp, gv = ds.ds_to_f64(*got[:2]), ds.ds_to_f64(*got[2:])
    for tol, ref_p, ref_v in ((5e-8, jds.ds_to_f64(*want[:2]), jds.ds_to_f64(*want[2:])),
                              (1e-12, op, ov)):
        assert np.abs(gp[:, :3] - ref_p[:, :3]).max() < tol
        assert np.abs(gv[:, :3] - ref_v[:, :3]).max() < tol
    for g, p in zip(got, planes):
        assert torch.equal(g[:, 3], p[:m, 3])


def test_one_chunk_is_the_unsplit_plain_leapfrog():
    """S = 1 is the whole j-range in one sum: the plain leapfrog step."""
    planes, scal, *_ = _leapfrog_case(77, 301)
    got, _ = _chunked_leapfrog(planes, 77, 301, 1, scal)
    want = ds.nbody_step_ds_leapfrog_vs(*(t[:77] for t in planes), *planes, scal)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_leapfrog_step_from_rest_takes_the_force_at_the_start():
    """With zero velocities the half drift moves no body (p + 0 dt/2 is p
    exactly in ds), so the chunked leapfrog force is the chunked force of
    the split force kernel's arithmetic, bit for bit: the contract that
    lets ``DSBodySystem.accelerations()`` of a leapfrog system take
    ``ds_splits`` as the leapfrog step does."""
    planes, _, *_ = _leapfrog_case(77, 301)
    zero = torch.zeros_like(planes[2])
    rest = (planes[0], planes[1], zero, zero)
    s = ck.ds_splits(77, 301)
    _, acc = _chunked_leapfrog(rest, 77, 301, s, ds.scal_ds_leapfrog(1.0, SOFT, 1.0))
    want = _chunked_accel(rest, 77, 301, s, ds.scal_ds(1.0, SOFT, 1.0))
    assert all(torch.equal(a, w) for a, w in zip(acc, want))


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_cpu_leapfrog_wrapper_takes_the_plain_version_at_any_split(splits):
    planes, scal, *_ = _leapfrog_case(77, 301)
    i_planes = tuple(t[:77].contiguous() for t in planes)
    launches = dict(ck.LAUNCHES)
    got = ck._ds_leapfrog(*i_planes, *planes, scal, 256, None, splits=splits)
    want = ds.nbody_step_ds_leapfrog_vs(*i_planes, *planes, scal)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ck.LAUNCHES == launches
