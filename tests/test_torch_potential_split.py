"""The potential kernel's split walk (csrc/nbody_kernels.cu:
potential_kernel, potential_finish_kernel; csrc/allpairs_common.cuh:
walk_potential) against nbody_tpu, on the CPU.

The kernel runs only on the card, so these tests emulate its order and
arithmetic in torch: the j-chunks of the step's rule (``step_splits(N, N)``,
whole 256-body stages), each row's sum of m_j rsqrt(r2) from 0 in j order
(r2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))), a fused multiply-add as an
exact float64 product and sum rounded once, and one more into the sum), the
self pair dropped by a select only in the stages that hold one of the
block's own rows or end the set, the chunks' partials added in chunk order
from 0 and multiplied by m_i. The emulation is held to the JAX package's
interpret-mode ``potential_energy_pallas`` (1e-5 relative, the bound of
tests/test_energy.py:39-59) and to its per-row sums (rtol 1e-5, as
tests/test_torch_energy.py's ``test_per_row_matches_jax_per_row``), at N not
a multiple of the stage, at eps = 0 (the self pair dropped by its index: a
stage rule that missed it would add inf) and with two bodies at one position
at eps > 0 (they still count). Blocks of 128, 256 and 1024 threads (four rows
a thread below 512, one above) give the same bits. The card's bits are held
in tests/test_torch_cuda.py and chip_smoke.py.
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
from nbody_tpu.ops import energy as jax_energy
from nbody_tpu.ops.pallas_kernel import potential_energy_pallas

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import energy

SOFT = 0.1
CSRC = pathlib.Path(ck.__file__).resolve().parents[1] / "csrc"
BLOCKS = (128, 256, 1024)


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


def _rows_a_thread(block_size):
    """rows_a_thread of csrc/allpairs_common.cuh."""
    return ck.STEP_ROWS if block_size <= 512 else 1


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _emulate(pos, eps2, block_size, splits=None, shift=0):
    """The per-row sums as the kernel forms them at `block_size` threads
    (with `shift`, the masked stages moved that many bodies past the
    block's own rows: a wrong rule)."""
    n = pos.shape[0]
    s = ck.step_splits(n, n) if splits is None else splits
    chunk = _cdiv(_cdiv(n, ck.STEP_STAGE), s) * ck.STEP_STAGE
    rows = torch.arange(n)
    span = _rows_a_thread(block_size) * block_size
    own_lo = rows // span * span + shift  # the block's own rows: [own_lo, own_lo + span)
    p3, m = pos[:, :3], pos[:, 3]
    eps = torch.full((n,), eps2, dtype=torch.float32)
    total = torch.zeros(n, dtype=torch.float32)
    for c in range(s):
        u = torch.zeros(n, dtype=torch.float32)
        for base in range(c * chunk, min((c + 1) * chunk, n), ck.STEP_STAGE):
            end = min(base + ck.STEP_STAGE, n)
            masked = (end < base + ck.STEP_STAGE) | ((base < own_lo + span)
                                                     & (base + ck.STEP_STAGE > own_lo))
            for j in range(base, end):
                d = p3[j] - p3
                r2 = _fma(d[:, 2], d[:, 2], _fma(d[:, 1], d[:, 1], _fma(d[:, 0], d[:, 0], eps)))
                step = _fma(m[j].expand(n), torch.rsqrt(r2), u)
                u = torch.where(masked & (rows == j), u, step)
        total = total + u
    return m * total


def _t(a):
    return torch.tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _state(n, config="random", seed=3, twin=False):
    pos, _ = jax_ic.generate(JaxNBodyConfig(config), n, 1.52,
                             2.0 if config == "shell" else 8.0, seed=seed)
    rng = np.random.default_rng(seed + 100)
    pos[:, 3] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    if twin:
        pos[17] = pos[n - 5]  # two distinct bodies at one position
    return pos


@pytest.mark.parametrize("n, config, soft, twin", [
    (333, "random", SOFT, False), (700, "shell", SOFT, False), (513, "random", 0.0, False),
    (300, "random", SOFT, True)])
def test_emulated_kernel_matches_pallas_and_jax_per_row(n, config, soft, twin):
    pos = _state(n, config, twin=twin)
    got = _emulate(_t(pos), soft * soft, 256)
    assert torch.isfinite(got).all()
    want_rows = np.asarray(jax_energy.potential_energy_per_row(jnp.asarray(pos), soft))
    np.testing.assert_allclose(got.numpy(), want_rows, rtol=1e-5)
    total = float(potential_energy_pallas(jnp.asarray(pos), soft, tile_i=64, tile_j=256,
                                          interpret=True))
    assert abs(-0.5 * float(got.double().sum()) - total) <= 1e-5 * abs(total)


@pytest.mark.parametrize("soft", [SOFT, 0.0])
def test_every_block_gives_the_same_bits(soft):
    """The stages masked differ with the block (its own rows), but every
    other pair takes the same FFMA in the same order, so the bits do not."""
    pos = _t(_state(600))
    first = _emulate(pos, soft * soft, BLOCKS[0])
    assert torch.isfinite(first).all()
    for bs in BLOCKS[1:]:
        assert torch.equal(_emulate(pos, soft * soft, bs), first)


def test_chunks_follow_the_rule_and_one_chunk_is_the_unsplit_walk():
    pos = _t(_state(600))
    assert ck.step_splits(600, 600) == 3
    one = _emulate(pos, SOFT * SOFT, 256, splits=1)
    rule = _emulate(pos, SOFT * SOFT, 256)
    np.testing.assert_allclose(rule.numpy(), one.numpy(), rtol=1e-5)
    np.testing.assert_allclose(one.numpy(), energy.potential_energy_per_row(pos, SOFT).numpy(),
                               rtol=1e-5)


def test_a_stage_rule_that_missed_the_self_pair_would_show():
    """At eps = 0 the self pair is inf: with the masked stages moved one
    stage past the block's own rows, the emulation leaves it in."""
    pos = _t(_state(600))
    assert torch.isfinite(_emulate(pos, 0.0, 128)).all()
    assert not torch.isfinite(_emulate(pos, 0.0, 128, shift=ck.STEP_STAGE)).all()


def test_the_kernels_stage_rows_and_chunks_are_the_rules():
    """The potential walks the step's stage, rows and chunks: the constants
    and the launch read from csrc/ against the Python rule."""
    common = (CSRC / "allpairs_common.cuh").read_text()
    kernels = (CSRC / "nbody_kernels.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", common)}
    assert consts["kStepStage"] == ck.STEP_STAGE and consts["kStepRows"] == ck.STEP_ROWS
    assert "__shared__ float4 sp[kStepStage];" in common.split("walk_potential(")[1]
    launch = kernels.split("int launch_potential_f32(")[1].split("\n}\n")[0]
    assert "rows_a_thread(block_size)" in launch
    assert "step_chunk(n, splits)" in launch
    assert "potential_finish_kernel" in launch


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("block_size", BLOCKS)
def test_cpu_wrapper_takes_the_plain_version_at_any_split(splits, block_size):
    pos = _t(_state(333))
    launches = dict(ck.LAUNCHES)
    got = ck._potential(pos, SOFT, block_size, splits=splits)
    assert torch.equal(got, energy.potential_energy_per_row(pos, SOFT))
    assert torch.equal(ck.potential_energy_per_row_cuda(pos, SOFT, block_size=block_size), got)
    assert ck.LAUNCHES == launches
