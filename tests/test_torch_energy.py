"""The port's energy diagnostics (nbody_tpu_torch.ops.energy and the
potential kernel's wrapper) against nbody_tpu.

Inputs are made with numpy from a seed (shell and random ICs; masses from
[0.5, 2] and a random vel.w in one case of each check). The JAX side runs
its Pallas potential kernel in interpret mode, as tests/test_energy.py runs
it; the port's side runs the plain per-row sums, which are what the
potential kernel's wrapper takes on a CPU tensor and what the kernel is held
to on the card. Tolerances are the JAX suite's own: 1e-5 relative for the
float32 potential (tests/test_energy.py:39-59), 1e-6 for the hybrid
functional against the full float64 one (tests/test_energy.py:140-149),
1e-9 and 1e-4 for BodySystem's precise and fast energies
(tests/test_energy.py:163-175); the float64 functionals of the two packages
differ only in the order of float64 sums, so they agree to 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import energy as jax_energy
from nbody_tpu.ops.pallas_kernel import potential_energy_pallas
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import NBodyParams
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, energy

SOFT = 0.1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(n, config="shell", seed=1, masses=False):
    cfg = JaxNBodyConfig(config)
    pos, vel = jax_ic.generate(cfg, n, 1.52, 2.0 if config == "shell" else 8.0, seed=seed)
    if masses:
        rng = np.random.default_rng(seed + 100)
        pos[:, 3] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        vel[:, 3] = rng.standard_normal(n).astype(np.float32)
    return pos, vel


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("n, config, masses", [(700, "shell", False), (333, "random", True)])
def test_potential_matches_pallas(n, config, masses):
    """Non-multiple N exercises the padding and the self mask."""
    pos, _ = _state(n, config, masses=masses)
    per_row = energy.potential_energy_per_row(_t(pos), SOFT)
    got = -0.5 * float(per_row.sum())
    want = float(potential_energy_pallas(jnp.asarray(pos), SOFT, tile_i=64, tile_j=256,
                                         interpret=True))
    assert _rel(got, want) < 1e-5
    # the kernel's wrapper takes the plain version on a CPU tensor
    before = dict(cuda_kernel.LAUNCHES)
    torch.testing.assert_close(cuda_kernel.potential_energy_per_row_cuda(_t(pos), SOFT), per_row,
                               rtol=0, atol=0)
    assert cuda_kernel.LAUNCHES == before


def test_per_row_matches_jax_per_row():
    pos, _ = _state(333, masses=True)
    got = energy.potential_energy_per_row(_t(pos), SOFT, chunk_size=100).numpy()
    want = np.asarray(jax_energy.potential_energy_per_row(jnp.asarray(pos), SOFT, chunk_size=100))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_potential_two_bodies_at_zero_softening():
    # the self pair is masked by its index, not by d = 0: at eps = 0 it is
    # inf, and the pair potential is exactly -m1 m2 / r
    pos = np.zeros((2, 4), np.float32)
    pos[1, 0] = 1.0
    pos[:, 3] = 1.0
    assert float(energy.potential_energy(_t(pos), 0.0)) == -1.0
    assert energy.total_energy_f64(pos, np.zeros_like(pos), 0.0) == -1.0
    rows = cuda_kernel.potential_energy_per_row_cuda(_t(pos), 0.0)
    assert torch.isfinite(rows).all()


@pytest.mark.parametrize("n, config, masses", [(512, "shell", False), (333, "random", True)])
def test_total_energy_f64_matches_jax(n, config, masses):
    pos, vel = _state(n, config, masses=masses)
    got = energy.total_energy_f64(pos, vel, SOFT)
    want = jax_energy.total_energy_f64(pos, vel, SOFT)
    assert _rel(got, want) < 1e-12
    # tensors of any type give the same functional
    assert energy.total_energy_f64(_t(pos), _t(vel), SOFT) == got
    assert _rel(energy.total_energy_f64(pos.astype(np.float64), vel.astype(np.float64), SOFT),
                got) < 1e-15


def test_total_energy_precise_matches_jax_below_threshold():
    pos, vel = _state(512, masses=True)
    got = energy.total_energy_precise(pos, vel, SOFT)
    want = jax_energy.total_energy_precise(pos, vel, SOFT)
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("n, config, masses", [(700, "shell", False), (600, "random", True)])
def test_total_energy_precise_hybrid_matches_jax(n, config, masses):
    """Above a lowered host_threshold both packages take float32 per-row
    pair sums and add them up in host float64."""
    pos, vel = _state(n, config, masses=masses)
    got = energy.total_energy_precise(pos, vel, SOFT, host_threshold=256)
    want = jax_energy.total_energy_precise(pos, vel, SOFT, host_threshold=256)
    full = energy.total_energy_f64(pos, vel, SOFT)
    assert _rel(got, want) < 1e-6
    assert _rel(got, full) < 1e-6
    # a tensor, and an explicit CPU device, change nothing
    assert energy.total_energy_precise(_t(pos), _t(vel), SOFT, host_threshold=256) == got
    assert energy.total_energy_precise(pos, vel, SOFT, host_threshold=256, device="cpu") == got


def test_precise_functional_state_type_invariant():
    pos, vel = _state(700)
    for threshold in (0, 131072):
        e32 = energy.total_energy_precise(pos, vel, SOFT, host_threshold=threshold)
        e64 = energy.total_energy_precise(pos.astype(np.float64), vel.astype(np.float64), SOFT,
                                          host_threshold=threshold)
        assert _rel(e32, e64) < 1e-6


def test_body_system_energy_matches_jax_pallas():
    params = NBodyParams(softening=SOFT)
    ours = BodySystem(512, params, device="cpu", seed=3)
    ref = JaxBodySystem(512, JaxNBodyParams(**dataclasses.asdict(params)), backend="pallas",
                        tile_i=64, tile_j=128, interpret=True, seed=3)
    np.testing.assert_array_equal(ours.positions, ref.positions)
    assert _rel(ours.total_energy(), ref.total_energy()) < 1e-5
    precise = ours.total_energy(precise=True)
    assert _rel(precise, jax_energy.total_energy_f64(ref.positions, ref.velocities, SOFT)) < 1e-9
    assert _rel(ours.total_energy(), precise) < 1e-4


def test_body_system_energy_host_placement_and_no_launch():
    params = NBodyParams(softening=SOFT)
    d = BodySystem(300, params, device="cpu", seed=4)
    h = BodySystem(300, params, device="cpu", seed=4, placement="host")
    before = dict(cuda_kernel.LAUNCHES)
    assert d.total_energy() == h.total_energy()
    assert d.total_energy(precise=True) == h.total_energy(precise=True)
    assert cuda_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "block_size", "numpy"])
def test_potential_wrapper_refuses_bad_arguments(bad):
    pos, _ = _state(64)
    p = _t(pos)
    if bad == "shape":
        with pytest.raises(ValueError, match="shape"):
            cuda_kernel.potential_energy_per_row_cuda(p[:, :3].contiguous(), SOFT)
    elif bad == "dtype":
        # float32 and float64 (the double kernel) are taken, nothing else
        with pytest.raises(TypeError, match="float32"):
            cuda_kernel.potential_energy_per_row_cuda(p.half(), SOFT)
    elif bad == "block_size":
        with pytest.raises(ValueError, match="block_size"):
            cuda_kernel.potential_energy_per_row_cuda(p, SOFT, block_size=48)
    else:
        with pytest.raises(TypeError):
            cuda_kernel.potential_energy_per_row_cuda(pos, SOFT)
