"""The j-split of the port's fp32 one-sided force kernel
(``cuda_kernel.compute_accel_cuda``, csrc/nbody_kernels.cu: ``accel_kernel``)
against nbody_tpu.

The force kernel runs the step kernel's walk (``walk_chunk``,
csrc/allpairs_common.cuh) in ``step_splits(M, N)`` chunks of whole
shared-memory stages: each row's chunk summed in j order from 0, the chunks'
partials added in chunk order from 0 by a second kernel. On the CPU the split
is plain Python, so these tests hold the arithmetic in that order against the
JAX package's interpret-mode ``compute_accel_pallas``: the plain force
(ops/reference.py) summed chunk by chunk, and an emulation of the kernel's
pair terms and sums, at S = 1, 2 and the rule's, at ragged shapes and the
shards of a ring, within 1e-4 * max|a| + 1e-4 (tests/test_pallas.py:76), the
bound chip_smoke.py holds the kernel to on the card. They also hold that the
kernels' constants in csrc/ are the rule's and that the CPU wrapper takes the
plain version. The card's bits are held in tests/test_torch_cuda.py and
chip_smoke.py.
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
from nbody_tpu.ops.pallas_kernel import compute_accel_pallas

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference

SOFT = 0.1
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"


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
    """The j-ranges [j0, j1) of the kernel's `splits` chunks of N j-bodies
    (``step_chunk`` in csrc/allpairs_common.cuh)."""
    chunk = _cdiv(_cdiv(n, ck.STEP_STAGE), splits) * ck.STEP_STAGE
    return [(min(c * chunk, n), min((c + 1) * chunk, n)) for c in range(splits)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _case(m, n):
    """A shell state of n bodies, masses from [0.5, 2] and the last 7 bodies
    zero-mass at the origin (a ragged shard's padding), whose first m rows
    are the i-set; and the JAX interpret-mode force on them."""
    pos, _ = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=4)
    pos[:, 3] = np.random.default_rng(104).uniform(0.5, 2.0, n).astype(np.float32)
    pos[-7:] = 0.0
    p = jnp.asarray(pos)
    tile = 128 if n <= 1025 else 512
    acc = compute_accel_pallas(p[:m], p, SOFT, tile_i=tile, tile_j=tile, interpret=True)
    return pos, np.asarray(acc)


def _chunked(fn, n, splits):
    """fn(j0, j1) of each chunk, added in chunk order from 0 (the second
    kernel's sum; sum_partials)."""
    total = 0.0
    for j0, j1 in _split_bounds(n, splits):
        total = total + fn(j0, j1)
    return total


def _emulate_chunk(pi, pj, eps2):
    """The walk's sums over one chunk: each pair term in its arithmetic
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


def _held(acc, want):
    acc = np.asarray(acc)
    assert acc.shape == want.shape and np.isfinite(acc).all()
    assert np.abs(acc - want).max() <= 1e-4 * np.abs(want).max() + 1e-4


# a ring hop of 1025 and 4099 bodies (a four-rank shard), a rank's force
# under the whole set, ragged i-sets, one card at 4099
CHUNKED = [(1025, 1025), (1025, 4099), (4099, 4099), (777, 4099), (33, 1025), (128, 700)]


@pytest.mark.parametrize("splits", [None, 1, 2])
@pytest.mark.parametrize("m, n", CHUNKED)
def test_chunked_plain_force_matches_pallas(m, n, splits):
    """The plain force chunk by chunk at S = the rule's, 1 and 2, added in
    chunk order: the force kernel's sums in its order."""
    pos, want = _case(m, n)
    p = _t(pos)
    s = ck.step_splits(m, n) if splits is None else splits
    acc = _chunked(lambda j0, j1: reference.compute_accel_vs(p[:m], p[j0:j1], SOFT), n, s)
    _held(acc, want)


@pytest.mark.parametrize("m, n, splits", [(128, 700, None), (77, 301, 2), (33, 257, 1),
                                          (33, 1025, None)])
def test_kernel_emulation_matches_pallas(m, n, splits):
    """The walk's pair arithmetic and its sum order (j order within a
    chunk, chunks in order from 0) against the interpret-mode
    _accel_kernel."""
    pos, want = _case(m, n)
    p = _t(pos)
    s = ck.step_splits(m, n) if splits is None else splits
    acc = _chunked(lambda j0, j1: _emulate_chunk(p[:m], p[j0:j1], SOFT * SOFT), n, s)
    _held(acc, want)


def test_the_rule_splits_the_sharded_shapes():
    """The force takes the step's rule: at a four-card hop and a ring shard
    the i-tiles alone leave the card idle, so the j-range is split; one card
    at 135168 fills it nearly alone."""
    assert ck.step_splits(65536, 65536) == 16
    assert ck.step_splits(16384, 65536) == 64
    assert ck.step_splits(16384, 16384) == 64
    assert ck.step_splits(135168, 135168) == 4
    assert ck.step_splits(4099, 4099) == 17
    assert _split_bounds(4099, 17)[-1] == (4096, 4099)


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("block_size", [32, 256, 1024])
def test_cpu_wrapper_takes_the_plain_version_at_any_split(splits, block_size):
    """compute_accel_cuda and _accel on CPU tensors: the plain force whatever
    S and the block, and no launch counted."""
    pos, _ = _case(77, 301)
    p = _t(pos)
    pi = p[:77].contiguous()
    want = reference.compute_accel_vs(pi, p, SOFT)
    launches = dict(ck.LAUNCHES)
    assert torch.equal(ck._accel(pi, p, SOFT, block_size, splits=splits), want)
    assert torch.equal(ck.compute_accel_cuda(pi, p, SOFT, block_size=block_size), want)
    assert ck.LAUNCHES == launches


def test_the_kernels_constants_are_the_rules():
    """The chunks and tiles the kernels cut are the ones the rule and
    ring_items describe only if their stage, rows and block rule agree."""
    text = (CSRC / "allpairs_common.cuh").read_text()
    (stage,) = re.findall(r"constexpr int kStepStage = (\d+);", text)
    (rows,) = re.findall(r"constexpr int kStepRows = (\d+);", text)
    (above,) = re.findall(r"return block_size <= (\d+) \? kStepRows : 1;", text)
    assert int(stage) == ck.STEP_STAGE and int(rows) == ck.STEP_ROWS
    assert ck.step_rows(int(above)) == ck.STEP_ROWS and ck.step_rows(int(above) + 32) == 1
    assert [ck.step_rows(b) for b in (32, 256, 512, 544, 1024)] == [4, 4, 4, 1, 1]


def test_the_force_and_the_ring_walk_the_steps_walk():
    """Both kernels run walk_chunk and store their chunks' sums with
    store_chunk, as the step kernel does (the ring kernel through
    ring_item, an item of a hop); the old one-row walk is gone from every
    source."""
    sources = {p.name: p.read_text() for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert not any("accumulate_all_j" in s for s in sources.values())
    nbody, ring = sources["nbody_kernels.cu"], sources["ring_kernels.cu"]
    accel = nbody[nbody.index("accel_kernel(const float4*"):nbody.index("accel_jerk_kernel(")]
    step = nbody[nbody.index("void fused_step("):nbody.index("step_finish_kernel(")]
    hop = ring[ring.index("void ring_item("):ring.index("ring_finish_kernel(")]
    assert "ring_item<ROWS>(" in hop[hop.index("ring_accel_kernel(const"):]
    for body in (accel, step, hop):
        assert "walk_chunk<ROWS>(" in body and "store_chunk<ROWS>(" in body
        assert "atomic" not in body
    assert '#include "allpairs_common.cuh"' in nbody and '#include "allpairs_common.cuh"' in ring


# ---- chip_smoke.py's guard on the walks the force and the ring share ----


def _walk_sass(key: str, inside: bool) -> str:
    """cuobjdump-like SASS of one kernel: a walk (the loop around MUFU.RSQ),
    with an LDL inside it when `inside`."""
    ins = ["LDS.128 R4, [R2]", "MUFU.RSQ R10, R9",
           "LDL R3, [R1+0x8]" if inside else "FFMA R3, R10, R4, R3", "@!P0 BRA 0x0", "EXIT"]
    out = ["\tcode for sm_90a", f"\t\tFunction : _ZN12_GLOBAL__N_1{key}ILi4ELi512EEEvPK6float4"]
    out += [f"        /*{16 * k:04x}*/                   {op} ;" for k, op in enumerate(ins)]
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("source, key", [("nbody_kernels.cu", "12accel_kernel"),
                                         ("ring_kernels.cu", "17ring_accel_kernel")])
def test_chip_smoke_guards_the_force_and_ring_walks(source, key, inside, capsys):
    """Phase 3e's step_walks_checked also runs over the force and the ring
    kernels (WALK_SHARERS): a local-memory access inside their walk fails
    the phase, none passes and prints the walk's SASS count a pair."""
    import importlib.util
    import types

    from nbody_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.WALK_SHARERS[source] == (key,)
    build = types.SimpleNamespace(**{k: getattr(_build, k) for k in (
        "sass_functions", "sass_loops", "sass_class")}, demangle=lambda u: {})
    text = _walk_sass(key, inside)
    if inside:
        with pytest.raises(RuntimeError, match="spills inside its walk"):
            smoke.step_walks_checked(build, {}, text, smoke.WALK_SHARERS[source], source)
        return
    smoke.step_walks_checked(build, {}, text, smoke.WALK_SHARERS[source], source)
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[3e sass]")]
    assert key in line and "4.00 SASS instructions a pair, 0 local accesses inside" in line
    with pytest.raises(RuntimeError, match=f"no kernel {key} in the SASS of {source}"):
        smoke.step_walks_checked(build, {}, _walk_sass("11step_kernel", False),
                                 smoke.WALK_SHARERS[source], source)
