"""The j-split of the port's fused ring kernel (csrc/ring_kernels.cu:
``ring_accel_kernel``) against nbody_tpu's ``ring_accel_fused``.

A hop of the ring kernel is the force kernel's at (M, M): the visiting
shard in ``step_splits(M, M)`` chunks, each summed from 0 by the step
kernel's walk, the chunks added in chunk order from 0; the rank's total is
hop 0, then each hop added in hop order. On the CPU that order is plain
Python over the plain force (ops/reference.py), held here against the JAX
package's interpret-mode ``ring_accel_fused`` on the virtual CPU devices of
tests/conftest.py, at atol 5e-4 / rtol 1e-4 (tests/test_ring_fused.py's
bound for the interpret-mode kernel against the XLA force, as
tests/test_torch_ring_fused.py holds the unsplit plain ring), at shard sizes
whose hops split. The rule that sizes the kernel's grid (``ring_items``,
``ring_groups``) and a CPU ring's split are held too. The card's bits, the
ring against the hop-ordered force launches, are held in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops.ring_kernel import ring_accel_fused
from nbody_tpu.parallel import make_mesh as jax_make_mesh

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference

SOFT = 0.1
FORCE_ATOL, FORCE_RTOL = 5e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cdiv(a, b):
    return -(-a // b)


def _state(n, seed=6):
    """Shell ICs, masses from [0.5, 2], the last 7 bodies zero-mass at the
    origin (a ragged ring's padding)."""
    pos, _ = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed)
    pos[:, 3] = np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(np.float32)
    pos[-7:] = 0.0
    return pos


def _jax_ring_accel(pos, ndev, tile_i):
    """nbody_tpu's fused ring kernel on a D-device virtual mesh, interpret mode."""
    mesh = jax_make_mesh(ndev)

    def local(p):
        return ring_accel_fused(p, SOFT, axis="bodies", ndev=ndev, tile_i=tile_i,
                                interpret=True)

    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("bodies", None),
                              out_specs=P("bodies", None), check_vma=False))
    return np.asarray(f(jax.device_put(jnp.asarray(pos), NamedSharding(mesh, P("bodies", None)))))


def _hop(pi, pj, splits):
    """A hop as the ring kernel sums it: the chunks of step_chunk's length,
    each the plain force, added in chunk order from 0 (one chunk: its own
    sum)."""
    m = pj.shape[0]
    chunk = _cdiv(_cdiv(m, ck.STEP_STAGE), splits) * ck.STEP_STAGE
    parts = [reference.compute_accel_vs(pi, pj[c * chunk:(c + 1) * chunk], SOFT)
             for c in range(splits) if c * chunk < m]
    if splits == 1:
        return parts[0]
    total = torch.zeros_like(parts[0])
    for part in parts:
        total = total + part
    return total


def _split_ring(shards, splits):
    """Each rank's force: hop h from rank r - h, hop 0 first, the hops added
    in hop order."""
    d = len(shards)
    out = []
    for r in range(d):
        total = _hop(shards[r], shards[r], splits)
        for h in range(1, d):
            total = total + _hop(shards[r], shards[(r - h) % d], splits)
        out.append(total)
    return out


# shards of 513 (S = 3), 1025 (S = 5) and 300 (S = 2) bodies, none a lane
# multiple: the JAX kernel zero-mass pads them, the port's takes them as they are
@pytest.mark.parametrize("ndev, n, tile_i", [(2, 1026, 64), (4, 4100, 128), (8, 2400, 64)])
def test_hop_split_ring_matches_jax_ring_kernel(ndev, n, tile_i):
    pos = _state(n)
    m = n // ndev
    splits = ck.step_splits(m, m)
    assert splits > 1
    want = _jax_ring_accel(pos, ndev, tile_i)
    got = _split_ring([torch.from_numpy(s) for s in np.split(pos, ndev)], splits)
    np.testing.assert_allclose(torch.cat(got).numpy(), want, atol=FORCE_ATOL, rtol=FORCE_RTOL)


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_split_ring_is_the_plain_ring_within_the_force_bound(splits):
    """Any split of the hops keeps the plain ring's force within the bound
    the card holds the kernel to (1e-4 * max|a| + 1e-4), and S = 1 is the
    plain ring itself, bit for bit."""
    pos = _state(4 * 1025)
    shards = [torch.from_numpy(s) for s in np.split(pos, 4)]
    plain = reference.ring_accel_fused_plain(shards, SOFT)
    got = _split_ring(shards, splits)
    tol = 1e-4 * max(p.abs().max().item() for p in plain) + 1e-4
    assert max((g - p).abs().max().item() for g, p in zip(got, plain)) <= tol
    if splits == 1:
        assert all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("m, block_size", [(1025, 256), (4099, 128), (16384, 256),
                                           (16384, 1024), (65536, 256), (262144, 512)])
def test_ring_items_are_the_force_kernels_blocks_at_m_m(m, block_size):
    """A hop's items are the force kernel's grid at (M, M): its i-tiles of
    step_rows * block rows times step_splits(M, M) chunks."""
    rows = 4 if block_size <= 512 else 1
    assert ck.ring_items(m, block_size) == _cdiv(m, rows * block_size) * ck.step_splits(m, m)


def test_ring_groups_take_the_items_or_the_resident_blocks(monkeypatch):
    """G is the items of a hop, or the blocks the card holds at once split
    among the launch's ranks when fewer; a launch that cannot hold one block
    a rank raises."""
    monkeypatch.setattr(ck, "ring_coresident_blocks", lambda device, block_size=256: 528)
    assert ck.ring_groups(16384, 4, 256, "cuda") == 132
    assert ck.ring_groups(65536, 1, 256, "cuda") == 528  # 1024 items
    assert ck.ring_groups(1025, 1, 256, "cuda") == ck.ring_items(1025, 256) == 10
    with pytest.raises(RuntimeError, match="do not fit"):
        ck.ring_groups(1025, 529, 256, "cuda")


def test_a_cpu_ring_carries_the_rules_split():
    ring = ck.FusedRing(1025, 4, 1, device="cpu", hops=lambda shard: [shard])
    assert ring.splits == ck.step_splits(1025, 1025) == 5
