"""The port's fused ring (strategy="ring_fused") against nbody_tpu's.

The JAX side runs ``nbody_tpu.ops.ring_kernel.ring_accel_fused`` and
``make_sharded_step(kernel="pallas", strategy="ring_fused")`` in interpret
mode on the virtual CPU devices that tests/conftest.py gives JAX. The
port's side runs the kernel's plain version, ``reference.ring_accel_fused_plain``,
and its sharded step on 2 and 4 gloo ranks (tests/test_torch_sharded_ranks.py),
where the wrapper of the ring kernel takes the plain ring: the exchanges of
the unfused ring with the plain force. The kernel itself runs on the card
only (tests/test_torch_cuda.py, chip_smoke.py phase 3rf). Inputs are made
with numpy from a seed, masses drawn from [0.5, 2] and vel.w random.
Tolerances, with their reasons:

* the force: atol 5e-4 / rtol 1e-4, tests/test_ring_fused.py's bound for
  the interpret-mode kernel against the XLA force (the two sum in other
  orders);
* a step: atol 1e-5, tests/test_ring_fused.py's bound for the sharded
  ring_fused step; against the port's own ``ring`` strategy, bit for bit:
  both sum the same plain partial forces in the same hop order.

tests/test_ring_fused.py::test_compiled_ring_fused_rounds_tiles_to_lane_multiple
has no counterpart here: its rule (round tile_i up to a multiple of 128)
is Mosaic's, for the TPU's lane-aligned stores; the CUDA kernel takes any
shard length and block size.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models.ds_system import DSBodySystem as JaxDSBodySystem
from nbody_tpu.ops.ring_kernel import ring_accel_fused
from nbody_tpu.params import NBodyParams as JaxNBodyParams
from nbody_tpu.parallel import make_mesh as jax_make_mesh
from nbody_tpu.parallel import make_sharded_step as jax_make_sharded_step
from nbody_tpu.parallel import shard_state as jax_shard_state
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch import DEMO_PARAMS
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.parallel import Mesh, choose_strategy, make_sharded_step, pad_to_multiple

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
FORCE_ATOL, FORCE_RTOL = 5e-4, 1e-4
STEP_ATOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One gloo process group of D ranks for each D, started together."""
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"gloo{d}") / "store")) for d in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(n, *, seed=5):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.52, 2.0, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return pos.astype(np.float32), vel.astype(np.float32)


def _fake_mesh(size=2):
    """A 1-D Mesh record with no process group: enough for the checks a
    system makes before its first collective."""
    return Mesh(axis="bodies", size=size, rank=0, group=None, device=torch.device("cpu"))


def _params(n):
    from nbody_tpu_torch import tuned_scales

    cs, vs = tuned_scales(n) or (1.54, 8.0)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs, damping=DAMP)


def _cat(shards):
    return tuple(np.concatenate(parts) for parts in zip(*shards))


def _jax_ring_accel(pos, ndev, tile_i):
    """nbody_tpu's fused ring kernel on a D-device virtual mesh, interpret mode."""
    mesh = jax_make_mesh(ndev)

    def local(p):
        return ring_accel_fused(p, SOFT, axis="bodies", ndev=ndev, tile_i=tile_i,
                                interpret=True)

    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=P("bodies", None),
                              out_specs=P("bodies", None), check_vma=False))
    return np.asarray(f(jax.device_put(jnp.asarray(pos), NamedSharding(mesh, P("bodies", None)))))


# ---- the kernel's plain version against the JAX kernel ----


@pytest.mark.parametrize("ndev, n, tile_i", [(2, 512, 64), (8, 2048, 64), (8, 800, 32)])
def test_plain_ring_matches_jax_ring_kernel(ndev, n, tile_i):
    """(8, 800): shards of 100 bodies, not a lane multiple; the JAX kernel
    zero-mass pads them, the port's takes them as they are."""
    pos, _ = _state(n)
    want = _jax_ring_accel(pos, ndev, tile_i)
    shards = list(torch.from_numpy(pos).split(n // ndev))
    got = reference.ring_accel_fused_plain(shards, SOFT)
    assert [tuple(g.shape) for g in got] == [(n // ndev, 3)] * ndev
    np.testing.assert_allclose(torch.cat(got).numpy(), want, atol=FORCE_ATOL, rtol=FORCE_RTOL)
    # the emulated ring's wrapper takes the plain version on CPU shards
    before = dict(cuda_kernel.LAUNCHES)
    wrapped = cuda_kernel.ring_accel_fused_emulated_cuda([s.contiguous() for s in shards], SOFT)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))
    assert cuda_kernel.LAUNCHES == before


def test_plain_ring_sums_hops_in_ring_order():
    """Rank r's hop h is rank (r-h)'s shard, added in hop order: bit-equal to
    the sum written out, and not to the same partials summed in rank order
    on a state where the order shows."""
    pos, _ = _state(300, seed=11)
    shards = list(torch.from_numpy(pos).split(100))
    got = reference.ring_accel_fused_plain(shards, SOFT)
    for r in range(3):
        parts = [reference.compute_accel_vs(shards[r], shards[(r - h) % 3], SOFT)
                 for h in range(3)]
        assert torch.equal(got[r], (parts[0] + parts[1]) + parts[2])
    # rank 0 adds rank 2's shard before rank 1's
    by_rank = [reference.compute_accel_vs(shards[0], s, SOFT) for s in shards]
    assert not torch.equal(got[0], (by_rank[0] + by_rank[1]) + by_rank[2])


def test_ring_wrapper_on_the_cpu_takes_the_plain_ring():
    """ring_accel_fused_cuda with a CPU ring: the hops of ``ring.hops`` (here a
    list standing in for the mesh's exchanges), each by the plain force,
    summed in hop order; no launch counted. A CPU ring without hops, a shard
    of another length and a CUDA-only argument raise."""
    pos, _ = _state(300, seed=2)
    shards = list(torch.from_numpy(pos).split(100))
    ring = cuda_kernel.FusedRing(100, 3, 1, device="cpu",
                                 hops=lambda s: iter([s, shards[0], shards[2]]))
    before = dict(cuda_kernel.LAUNCHES)
    got = cuda_kernel.ring_accel_fused_cuda(shards[1], SOFT, ring)
    assert torch.equal(got, reference.ring_accel_fused_plain(shards, SOFT)[1])
    assert cuda_kernel.LAUNCHES == before
    ring.close()  # nothing to free on the CPU
    with pytest.raises(ValueError, match="hops"):
        cuda_kernel.FusedRing(100, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="shards of 100 bodies"):
        cuda_kernel.ring_accel_fused_cuda(shards[1][:50].contiguous(), SOFT, ring)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernel.ring_accel_fused_cuda(shards[1].double(), SOFT, ring)
    with pytest.raises(ValueError, match="one length"):
        cuda_kernel.ring_accel_fused_emulated_cuda([shards[0], shards[1][:50].contiguous()],
                                                   SOFT)
    with pytest.raises(ValueError, match="1 to 16 ranks"):
        cuda_kernel.ring_accel_fused_emulated_cuda([shards[0]] * 17, SOFT)


# ---- the sharded step on gloo ranks against nbody_tpu's and the port's ring ----


@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("d", [2, 4])
def test_ring_fused_step_matches_jax_and_the_ring(pools, d, integrator, n):
    """Two steps: against nbody_tpu's ring_fused step (interpret mode,
    tile_i 8) at atol 1e-5 after one, and bit-equal to the port's ring
    strategy on the same ranks after two (the second reuses the ring)."""
    pos, vel = _state(n)
    pos, vel, _ = pad_to_multiple(pos, vel, d)  # N=250: zero-mass padded to a multiple of D
    mesh = jax_make_mesh(d)
    jstep = jax_make_sharded_step(mesh, kernel="pallas", strategy="ring_fused",
                                  integrator=integrator, tile_i=8, interpret=True)
    want = [np.asarray(a) for a in jstep(*jax_shard_state(mesh, pos, vel), DT, SOFT, DAMP)]
    one = _cat(pools[d].run("fp32_step", "ring_fused", integrator, "vpu", pos, vel, DT, SOFT,
                            DAMP, "auto"))
    for g, w in zip(one, want):
        np.testing.assert_allclose(g, w, atol=STEP_ATOL)
    np.testing.assert_array_equal(one[0][:, 3], pos[:, 3])
    np.testing.assert_array_equal(one[1][:, 3], vel[:, 3])
    fused = _cat(pools[d].run("fp32_step", "ring_fused", integrator, "vpu", pos, vel, DT, SOFT,
                              DAMP, "auto", 2))
    ring = _cat(pools[d].run("fp32_step", "ring", integrator, "vpu", pos, vel, DT, SOFT, DAMP,
                             "auto", 2))
    for a, b in zip(fused, ring):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_ring_fused_system_on_a_mesh_matches_one_device(pools, integrator):
    """BodySystem(strategy="ring_fused") on 2 ranks, N=99 rounded up to 100
    with a zero-mass body: 3 steps and the force (``accelerations()``, the
    fused ring's) against the single-device system of the 99 bodies."""
    n = 99
    params = _params(n)
    state = _state(n)
    res = pools[2].run("system", "fp32", n, params,
                       {"integrator": integrator, "strategy": "ring_fused"}, state, 3)
    one = BodySystem(n, params, device="cpu", state=state, integrator=integrator,
                     variant="vpu")
    one.update_many(3)
    acc = one.accelerations().numpy()
    for pos, vel, a, strategy, variant, _ in res:
        assert pos.shape == (100, 4) and strategy == "ring_fused" and variant == "vpu"
        assert np.abs(pos[:n] - one.positions).max() < 2e-5
        assert np.abs(vel[:n] - one.velocities).max() < 2e-5
        assert np.abs(a[:n] - acc).max() < 2e-5 * max(1.0, np.abs(acc).max())
        np.testing.assert_array_equal(pos, res[0][0])


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_compute_qa_on_a_ring_fused_mesh(pools, integrator):
    res = pools[2].run("compute_checks", 128, {"strategy": "ring_fused",
                                               "integrator": integrator}, 2)
    for passed, drift, pos in res:
        assert passed is True
        assert drift == res[0][1] and drift["steps"] == 2
        np.testing.assert_array_equal(pos, res[0][2])


def test_cli_ring_fused_under_torchrun_on_two_gloo_ranks(tmp_path):
    """nbody-torch --cpu --devices 2 --strategy ring_fused --qatest under
    torchrun, Euler and leapfrog started together: each exits 0, only rank
    0 prints, and the banner names the strategy."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    runs = ([], ["--integrator", "leapfrog"])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", "2", "--strategy", "ring_fused",
         "--qatest", "--numbodies", "250", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in runs]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.count("-> OK") == 1 and out.count("2-device mesh [ring_fused]") == 1, out


@pytest.mark.parametrize("d", [2, 4])
def test_a_mesh_over_hosts_is_refused(pools, d):
    """CUDA IPC maps memory within one host: a card mesh whose ranks name
    different hosts is refused on every rank, before any buffer is made."""
    errors = pools[d].run("fused_ring_over_hosts", 64)
    assert all(e is not None and "within one host" in e and f"spans {d}" in e for e in errors)


# ---- refusals, in nbody_tpu's words ----


def _error(build) -> str:
    with pytest.raises(ValueError) as e:
        build()
    return str(e.value)


def test_hermite_is_refused_as_nbody_tpu_refuses_it():
    want = _error(lambda: jax_make_sharded_step(jax_make_mesh(2), kernel="pallas",
                                                strategy="ring_fused", integrator="hermite"))
    assert "ring_fused fuses the Euler update" in want
    assert _error(lambda: make_sharded_step(_fake_mesh(), strategy="ring_fused",
                                            integrator="hermite")) == want
    assert _error(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                                     strategy="ring_fused", integrator="hermite")) == want


def test_torch_backend_is_refused_as_nbody_tpu_refuses_xla():
    """nbody_tpu: "strategy='ring_fused' is a Pallas kernel; use
    kernel='pallas'"; the port's backend names the implementation."""
    jax_text = _error(lambda: jax_make_sharded_step(jax_make_mesh(2), kernel="xla",
                                                    strategy="ring_fused"))
    got = _error(lambda: make_sharded_step(_fake_mesh(), strategy="ring_fused",
                                           backend="torch"))
    assert got == (jax_text.replace("Pallas", "CUDA").replace("kernel='pallas'", "backend='cuda'"))
    assert _error(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                                     strategy="ring_fused", backend="torch")) == got
    # backend "auto" is the kernel's wrapper, on the CPU its plain ring
    assert make_sharded_step(_fake_mesh(), strategy="ring_fused").backend == "cuda"


def test_ds_is_refused_as_nbody_tpu_refuses_it(capsys):
    params = _params(64)
    want = _error(lambda: JaxDSBodySystem(
        64, JaxNBodyParams(**dataclasses.asdict(params)), mesh=jax_make_mesh(2),
        strategy="ring_fused", interpret=True))
    assert "ring_fused/sym are fp32 mesh paths" in want
    assert _error(lambda: DSBodySystem(64, params, device="cpu", mesh=_fake_mesh(),
                                       strategy="ring_fused")) == want
    assert _error(lambda: Compute(num_bodies=64, device="cpu", precision="ds",
                                  mesh=_fake_mesh(), strategy="ring_fused",
                                  log=lambda s: None)) == want
    # the CLI checks before it builds the mesh (nbody_tpu/cli.py:283-288)
    assert main(["--qatest", "--numbodies", "64", "--cpu", "--precision", "ds",
                 "--strategy", "ring_fused", "--devices", "2"]) == 2
    assert ("error: the sharded ds step gathers or ring-rotates the hi/lo planes; use "
            "--strategy auto/allgather/ring (ring_fused and sym are fp32 mesh paths)"
            in capsys.readouterr().err)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_choose_strategy_never_picks_ring_fused(d):
    for n in (64, 1000, 16384 * d - 1, 16384 * d, 1 << 20):
        assert choose_strategy(n, d) in ("allgather", "ring")
    s = BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(d) if d > 1 else None,
                   strategy="auto")
    assert s.strategy in ("auto", "allgather", "ring")


def test_ring_fused_system_builds_on_a_mesh_record():
    """A mesh record with no group still builds a ring_fused system: nothing
    is exchanged before the first step. A 2-D mesh stays refused."""
    s = BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), strategy="ring_fused")
    assert s.strategy == "ring_fused" and s._sharded.backend == "cuda"
    with pytest.raises(ValueError, match="2-D"):
        BodySystem(64, _params(64), device="cpu", strategy="ring_fused",
                   mesh=types.SimpleNamespace(axis_names=("rows", "cols")))
