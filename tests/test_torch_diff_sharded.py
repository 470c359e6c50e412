"""The port's differentiable body-sharded step
(``nbody_tpu_torch/ops/diff.py::make_sharded_step_diff``) on 2 and 4 gloo
ranks (``tests/test_torch_sharded_ranks.py``'s pool, one process a rank),
against the port's single-device ``nbody_step_diff`` and ``nbody_tpu``'s
``nbody_step_xla`` gradients of the same state.

The loss is sum(p[:, :3]**2) of the whole new state; each rank
differentiates its rows' part, and the backward's transposed collectives
(the j-side's cotangent reduce-scattered onto its owners, the scalars'
gradients summed over the ranks in rank order) make each rank's gradients
those of the whole loss. Tolerance rtol 1e-4, atol 1e-5
(``tests/test_diff.py:127``): float32 sums in other orders. The scalars'
gradients are the same bits on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sharded_ranks import RankPool

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.ops.reference import nbody_step_xla

from nbody_tpu_torch.ops import diff

N = 64
DT, SOFT, DAMP = 0.01, 0.5, 0.9
STRATEGIES = ("allgather", "ring", "ring_fused", "sym", "auto")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """As in the rank processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One gloo process group of D ranks for each D, started together."""
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"diff{d}") / "store"))
            for d in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def state():
    return jax_ic.generate(JaxNBodyConfig.SHELL, N, 1.0, 1.0, seed=5)


@pytest.fixture(scope="module")
def single(state):
    """(port, jax): the single-device gradients of pos, vel, dt,
    softening and damping."""
    pos, vel = state
    ts = [torch.tensor(a, requires_grad=True) for a in (pos, vel)]
    ts += [torch.tensor(x, requires_grad=True) for x in (DT, SOFT, DAMP)]
    p, _ = diff.nbody_step_diff(*ts)
    port = [g.numpy() for g in torch.autograd.grad(torch.sum(p[:, :3] ** 2), ts)]

    def loss(*args):
        return jnp.sum(nbody_step_xla(*args)[0][:, :3] ** 2)

    args = [jnp.asarray(pos), jnp.asarray(vel)] + [jnp.float32(x) for x in (DT, SOFT, DAMP)]
    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]
    return port, want


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_grads_match_single_device(pools, state, single, d, strategy):
    pos, vel = state
    ranks = pools[d].run("diff_grads", strategy, pos, vel, DT, SOFT, DAMP)
    m = N // d
    for ref in single:
        for r, got in enumerate(ranks):
            rows = slice(r * m, (r + 1) * m)
            for k in (0, 1):
                np.testing.assert_allclose(got[k], ref[k][rows], rtol=1e-4, atol=1e-5)
            for k in (2, 3, 4):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5)
    for got in ranks[1:]:
        for k in (2, 3, 4):
            assert got[k].tobytes() == ranks[0][k].tobytes(), "the ranks' scalar grads differ"


def test_two_d_mesh_raises(pools):
    errors = pools[4].run("diff_2d_error")
    assert all(e is not None and "1-D body mesh" in e for e in errors), errors


def test_sharded_step_is_first_order_only(pools, state):
    """A backward that would build a graph for a gradient of the gradient
    raises on every rank (the single-device step gives one:
    tests/test_torch_diff.py)."""
    errors = pools[2].run("diff_second_order_error", *state, DT, SOFT, DAMP)
    assert all(e is not None and "first order only" in e for e in errors), errors
