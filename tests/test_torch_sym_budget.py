"""The sym triangle's reaction ablations: the wrapper of
csrc/symmetric_kernels.cu::sym_ablate_kernel (``cuda_kernel.sym_ablated_accel_cuda``),
which on CPU tensors computes its plain version
``reference.sym_ablated_accel``, against the Pallas kernel of
scripts/tpu_r4_sym_budget.py (``_ablate_kernel``) in interpret mode, for
each reaction tail (full, none, tree_small); the plain version's own rules;
and the port of that script, scripts/torch_r4_sym_budget.py, rehearsed on
the CPU. The kernel itself runs on a card only (chip_smoke.py phase 3e,
tests/test_torch_cuda.py).

Inputs are made with numpy from a seed: shell ICs with masses from
[0.5, 2], softening 0.1. The action, and the full variant's reaction, are
held at the one-sided force bound 1e-4 * max|a| + 1e-4 (max|a| of the
whole force), the bound of tests/test_pallas.py:76 between two float32
summation orders. The tree_small slots hold per-tile-pair totals whose
tiles differ from the script's, so their sum over all pairs is held to
the script's lane totals at 1e-4 of the sum of the terms' magnitudes,
which bounds a float32 sum of them; both over the script's zero-mass
padded set, since the script's total takes the padding bodies' reactions.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from nbody_tpu.ops.pallas_kernel import LANES, _ix, _round_up
from nbody_tpu.ops.symmetric_kernel import SUB, _pair_tables
from tpu_scripts import load_script

from nbody_tpu_torch import NBodyConfig, ic
from nbody_tpu_torch.ops import cuda_kernel, reference

SOFT = 0.1
TI, TJ = 64, 256


@pytest.fixture(scope="module")
def script():
    return load_script("tpu_r4_sym_budget")


def _pos(n, seed=9):
    pos, _ = ic.generate(NBodyConfig.SHELL, n, 1.54, 8.0, seed=seed)
    pos[:, 3] = np.random.default_rng(seed).uniform(0.5, 2.0, n)
    return pos


def _ablate_interpret(script, pos, reaction):
    """The script's ``ablated_accel`` around its ``_ablate_kernel`` in
    interpret mode, both outputs kept: (acc (n, 3), react (3, w)), w = n_pad
    for full and 128 for the others."""
    n = pos.shape[0]
    n_pad = _round_up(n, TJ)
    pos_p = jnp.pad(jnp.asarray(pos), ((0, n_pad - n), (0, 0)))
    rows, cols, first, last = _pair_tables(n_pad, TI, TJ)
    n_steps = int(rows.shape[0])
    width = LANES if reaction in ("none", "tree_small") else n_pad

    def spec(shape, index):
        return pl.BlockSpec(shape, lambda p, meta, rows, cols, first, last: index(p, rows, cols))

    acc, react = pl.pallas_call(
        functools.partial(script._ablate_kernel, tile_i=TI, tile_j=TJ, n_steps=n_steps,
                          reaction=reaction),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=5,
            grid=(n_steps,),
            in_specs=[spec((TI, 4), lambda p, rows, cols: _ix(rows[p], 0)),
                      spec((4, TJ), lambda p, rows, cols: _ix(0, cols[p]))],
            out_specs=[spec((TI, 4), lambda p, rows, cols: _ix(rows[p], 0)),
                       spec((3, width), lambda p, rows, cols: _ix(0, 0))],
            scratch_shapes=[pltpu.VMEM((TI, LANES), jnp.float32)] * 3
            + [pltpu.VMEM((SUB, width), jnp.float32)] * 3,
        ),
        out_shape=[jax.ShapeDtypeStruct((n_pad, 4), jnp.float32),
                   jax.ShapeDtypeStruct((3, width), jnp.float32)],
        interpret=True,
    )(jnp.asarray(SOFT, jnp.float32).reshape(1) ** 2, jnp.asarray(rows), jnp.asarray(cols),
      jnp.asarray(first), jnp.asarray(last), pos_p, pos_p.T)
    return np.asarray(acc[:n, :3]), np.asarray(react)


@pytest.mark.parametrize("n", [300, 257])
@pytest.mark.parametrize("reaction", ["full", "none", "tree_small"])
def test_ablation_matches_the_script_kernel(script, reaction, n):
    """N=257 is odd and no multiple of the tiles (64 rows, 256 columns, and
    the port's 128)."""
    pos = _pos(n)
    want_acc, want_react = _ablate_interpret(script, pos, reaction)
    p = torch.from_numpy(pos)
    acc, react = cuda_kernel.sym_ablated_accel_cuda(p, SOFT, reaction=reaction, tile=128)
    tol = 1e-4 * np.abs(reference.compute_accel_symmetric(p, SOFT).numpy()).max() + 1e-4
    np.testing.assert_allclose(acc.numpy(), want_acc, rtol=0, atol=tol)
    if reaction == "full":
        np.testing.assert_allclose(react.numpy(), want_react[:, :n], rtol=0, atol=tol)
    elif reaction == "tree_small":
        # the script's total takes the reactions on its zero-mass padding
        # bodies too; the port's slots take those of the bodies it is given,
        # so here it is given the script's padded set
        n_pad = _round_up(n, TJ)
        padded = torch.from_numpy(np.pad(pos, ((0, n_pad - n), (0, 0))))
        _, slots = cuda_kernel.sym_ablated_accel_cuda(padded, SOFT, reaction="tree_small",
                                                      tile=128)
        _, scale = reference.sym_reaction_slots(padded.double(), SOFT, tile=128)
        got = slots.double().sum(0).numpy()
        want = want_react.astype(np.float64).sum(1)
        assert (np.abs(got - want) <= 1e-4 * scale.sum(0).numpy()).all()
        assert react.shape == (6, 3)  # 3 tiles of 128 for 257 or 300 bodies: 6 pairs
    else:
        assert react is None


def _slots64(pos, tile):
    """Each tile pair's reaction total and sum of |terms|, in float64 from
    the start: pairs (r, c), c >= r, row-major; j > i on the diagonal."""
    n = pos.shape[0]
    tiles = -(-n // tile)
    d = pos[None, :, :3] - pos[:, None, :3]
    c = (np.einsum("ijk,ijk->ij", d, d) + SOFT * SOFT) ** -1.5
    terms = -(pos[:, 3, None] * c)[..., None] * d * np.triu(np.ones((n, n)), 1)[..., None]
    out = [(terms[r * tile:(r + 1) * tile, q * tile:(q + 1) * tile].sum((0, 1)),
            np.abs(terms[r * tile:(r + 1) * tile, q * tile:(q + 1) * tile]).sum((0, 1)))
           for r in range(tiles) for q in range(r, tiles)]
    return np.array([t for t, _ in out]), np.array([s for _, s in out])


@pytest.mark.parametrize("n, tile", [(257, 128), (300, 256), (129, 1024)])
def test_plain_ablations_keep_their_rules(n, tile):
    """full: acc + react.T is the each-pair-once force, bit for bit; none:
    the same action; tree_small: the same action, and each slot the tile
    pair's reaction total within 1e-4 of its sum of |terms| of the float64
    sum; the slots and the full reaction share their sum."""
    pos = _pos(n, seed=10)
    p = torch.from_numpy(pos)
    acc_f, react = reference.sym_ablated_accel(p, SOFT, reaction="full", tile=tile)
    assert torch.equal(acc_f + react.t(), reference.compute_accel_symmetric(p, SOFT))
    acc_n, none = reference.sym_ablated_accel(p, SOFT, reaction="none", tile=tile)
    acc_t, slots = reference.sym_ablated_accel(p, SOFT, reaction="tree_small", tile=tile)
    assert none is None and torch.equal(acc_n, acc_f) and torch.equal(acc_t, acc_f)
    tiles = -(-n // tile)
    assert slots.shape == (tiles * (tiles + 1) // 2, 3) and slots.dtype == torch.float32
    want, scale = _slots64(pos.astype(np.float64), tile)
    assert (np.abs(slots.double().numpy() - want) <= 1e-4 * scale + 1e-30).all()
    np.testing.assert_allclose(slots.double().sum(0).numpy(), react.double().sum(1).numpy(),
                               rtol=0, atol=1e-4 * scale.sum(0).max())


def test_cpu_wrapper_refusals_and_no_launches():
    p = torch.from_numpy(_pos(200))
    before = dict(cuda_kernel.LAUNCHES)
    acc, react, total = cuda_kernel.sym_ablated_accel_cuda(p, SOFT, reaction="full",
                                                           with_total=True)
    assert torch.equal(total, reference.compute_accel_symmetric(p, SOFT))
    assert acc.shape == (200, 3) and react.shape == (3, 200)
    assert cuda_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="with_total"):
        cuda_kernel.sym_ablated_accel_cuda(p, SOFT, reaction="none", with_total=True)
    with pytest.raises(ValueError, match="reaction must be one of"):
        cuda_kernel.sym_ablated_accel_cuda(p, SOFT, reaction="tree")
    with pytest.raises(ValueError, match="tile must be one of"):
        cuda_kernel.sym_ablated_accel_cuda(p, SOFT, reaction="none", tile=64)


def test_script_port_rehearses_on_the_cpu(capsys):
    port = load_script("torch_r4_sym_budget")
    assert port.parse(["300", "--cpu"]).n == 300 and port.parse([]).n == 65536
    assert port.main(["--cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert all(lines[0]["check"][k] for k in ("full_total_bit_equal_production",
                                               "none_acc_bit_equal_full_acc",
                                               "tree_small_acc_bit_equal_full_acc"))
    assert [ln["variant"] for ln in lines[1:6]] == [
        "A_one_sided", "B_sym_production", "C_no_reaction", "D_tree_small_slot",
        "E_tree_wide_rmw"]
    budget = lines[6]["budget"]
    assert budget["shape"] == {"N": 257, "tile": 128}
    assert {"walk_overhead_ms", "reaction_arith_shuffles_ms", "warp_sum_scratch_partial_sum_ms",
            "layout_delta_ms_B_vs_E"} <= set(budget)
