"""The port's body-sharded steps (nbody_tpu_torch/parallel) against nbody_tpu's.

The port's side runs D gloo ranks on the CPU (tests/test_torch_sharded_ranks.py:
one process a rank, one process group per D for the whole module), with
the plain versions of the kernels. The JAX side runs ``nbody_tpu.parallel``
on a D-device mesh of the virtual CPU devices that tests/conftest.py gives
JAX, in interpret mode where it reaches Pallas. Inputs are made with numpy
from a seed, masses drawn from [0.5, 2] and vel.w random, and handed to
both. Tolerances, with their reasons:

* fp32 steps: atol 2e-5, the JAX suite's bound for a sharded step against
  the single-device one (tests/test_sharded.py:36-37): the two differ in
  float32 summation order only;
* ds steps: max |d| < 5e-9, the JAX suite's bound for its sharded ds steps
  (tests/test_ds_kernel.py:249,276,326), which covers its interpret path's
  FMA contraction; the port's own sharded and single-device ds steps share
  the plain ds arithmetic and are held to the same bound;
* the plain ds force: 5e-8 of max|a| from the JAX kernel in interpret mode
  and 1e-11 from the float64 oracle, as tests/test_torch_ds.py holds it,
  and bit for bit where the port composes its own functions.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models.ds_system import DSBodySystem as JaxDSBodySystem
from nbody_tpu.ops import ds_kernel as jds
from nbody_tpu.oracle.numpy_oracle import accel_numpy
from nbody_tpu.params import NBodyParams as JaxNBodyParams
from nbody_tpu.parallel import choose_strategy as jax_choose_strategy
from nbody_tpu.parallel import make_mesh as jax_make_mesh
from nbody_tpu.parallel import make_sharded_ds_step as jax_make_sharded_ds_step
from nbody_tpu.parallel import make_sharded_step as jax_make_sharded_step
from nbody_tpu.parallel import shard_state as jax_shard_state
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch import DEMO_PARAMS
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import cuda_kernel, ds
from nbody_tpu_torch.parallel import (
    Mesh,
    choose_strategy,
    make_mesh_2d,
    make_sharded_ds_adaptive_rollout,
    make_sharded_ds_step,
    make_sharded_step,
    make_sharded_step_2d,
    pad_to_multiple,
)
from nbody_tpu_torch.parallel.sharded import RING_AUTO_MIN_SHARD

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
FP32_ATOL = 2e-5
DS_TOL = 5e-9


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The plain ds versions are many small eager ops; beside the suite's
    other workers and the ranks, intra-op threads only wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One gloo process group of D ranks for each D, started together."""
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"gloo{d}") / "store")) for d in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(n, *, seed=5, dtype=np.float32):
    pos, vel = jax_ic.generate(JaxNBodyConfig.SHELL, n, 1.54, 8.0, seed=seed, dtype=np.float64)
    rng = np.random.default_rng(seed)
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel[:, 3] = rng.standard_normal(n)
    return pos.astype(dtype), vel.astype(dtype)


def _fake_mesh(size=2):
    """A 1-D Mesh record with no process group: enough for the checks a
    system makes before its first collective."""
    return Mesh(axis="bodies", size=size, rank=0, group=None, device=torch.device("cpu"))


def _planes(pos, vel):
    return (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))


def _scal(integrator):
    return {"euler": ds.scal_ds, "leapfrog": ds.scal_ds_leapfrog,
            "hermite": ds.scal_ds_hermite}[integrator](DT, SOFT, DAMP)


def _cat(shards):
    """Rank-ordered results of a task, each a tuple of arrays -> the tuple of
    their concatenations."""
    return tuple(np.concatenate(parts) for parts in zip(*shards))


# ---- the ring itself ----


@pytest.mark.parametrize("d", [2, 4])
def test_ring_brings_rank_r_minus_k_at_hop_k(pools, d):
    """perm [(d, (d+1) % D)]: rank r receives from r-1 on every hop, so hop
    k holds rank (r-k)'s shard; hop 0 is the local shard and exactly D-1
    exchanges follow (the generator yields D shards)."""
    orders = pools[d].run("ring_order", 3)
    assert orders == [[(r - k) % d for k in range(d)] for r in range(d)]


# ---- fp32 against nbody_tpu's make_sharded_step(kernel="xla") ----


@pytest.mark.parametrize("n", [256, 250])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("strategy", ["allgather", "ring"])
@pytest.mark.parametrize("d", [2, 4])
def test_fp32_sharded_step_matches_jax(pools, d, strategy, integrator, n):
    pos, vel = _state(n)
    pos, vel, _ = pad_to_multiple(pos, vel, d)  # N=250 on 4 ranks: 252, zero-mass padded
    mesh = jax_make_mesh(d)
    jstep = jax_make_sharded_step(mesh, kernel="xla", strategy=strategy, integrator=integrator)
    want = [np.asarray(a) for a in jstep(*jax_shard_state(mesh, pos, vel), DT, SOFT, DAMP)]
    got = _cat(pools[d].run("fp32_step", strategy, integrator, "vpu", pos, vel, DT, SOFT, DAMP))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FP32_ATOL)
    # mass and vel.w pass through
    np.testing.assert_array_equal(got[0][:, 3], pos[:, 3])
    np.testing.assert_array_equal(got[1][:, 3], vel[:, 3])


@pytest.mark.parametrize("variant", ["mxu", "mxu_bf16"])
def test_fp32_allgather_euler_takes_the_variant(pools, variant):
    """The variant reaches the allgather Euler step (nbody_tpu's sharded.py
    :458-467): the mxu plain step on the gathered j-set, shard by shard,
    equals the single-device mxu step of the whole set."""
    from nbody_tpu_torch.ops import reference

    pos, vel = _state(256)
    got = _cat(pools[2].run("fp32_step", "allgather", "euler", variant, pos, vel, DT, SOFT,
                            DAMP))
    want = reference.nbody_step_mxu(torch.from_numpy(pos), torch.from_numpy(vel), DT, SOFT, DAMP,
                                    mxu_dtype=reference.MXU_DTYPES[variant])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=FP32_ATOL)


# ---- ds against nbody_tpu's make_sharded_ds_step and the port's single device ----


@pytest.mark.parametrize("strategy, n", [("allgather", 128), ("ring", 128), ("ring", 99)])
def test_ds_euler_sharded_step_matches_jax(pools, strategy, n):
    """D=2 against make_sharded_ds_step in interpret mode (tile_j=512); N=99
    is padded to 100 with a zero-mass body at the origin on both sides."""
    pos, vel = _state(n, dtype=np.float64)
    pos, vel, _ = pad_to_multiple(pos, vel, 2)
    planes = _planes(pos, vel)
    scal = _scal("euler")
    jstep = jax_make_sharded_ds_step(jax_make_mesh(2), tile_j=512, interpret=True,
                                     strategy=strategy)
    want = jstep(*(jnp.asarray(p.numpy()) for p in planes), jnp.asarray(scal.numpy()))
    got = _cat(pools[2].run("ds_step", strategy, "euler", tuple(p.numpy() for p in planes),
                            scal.numpy()))
    for g, w in zip(got, want):
        assert np.abs(g - np.asarray(w)).max() < DS_TOL


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("strategy", ["allgather", "ring"])
@pytest.mark.parametrize("d", [2, 4])
def test_ds_sharded_step_matches_single_device(pools, d, strategy, integrator):
    """Two sharded ds steps against two steps of the port's single-device
    one-sided ds path (itself held to nbody_tpu in tests/test_torch_ds*.py);
    the reference's own ds ring Hermite test is a slow one, so it is not
    run here (tests/test_ds_kernel.py:281-284)."""
    pos, vel = _state(64, dtype=np.float64)
    planes = _planes(pos, vel)
    scal = _scal(integrator)
    single = {"euler": ds.nbody_step_ds, "leapfrog": ds.nbody_step_ds_leapfrog,
              "hermite": ds.nbody_step_ds_hermite}[integrator]
    want = planes
    for _ in range(2):
        want = single(*want, scal)
    got = _cat(pools[d].run("ds_step", strategy, integrator, tuple(p.numpy() for p in planes),
                            scal.numpy(), 2))
    for g, w in zip(got, want):
        assert np.abs(g - w.numpy()).max() < DS_TOL
    if strategy == "allgather" and integrator != "hermite":
        # the same fused plain step on each shard against the whole set
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# ---- the plain ds force, the kernel's plain version ----


def test_plain_ds_accel_matches_jax_kernel_and_oracle():
    """ds_accel_vs at an i != j shape, (100, 400), against
    compute_accel_pallas_ds (_ds_accel_kernel) in interpret mode at 5e-8 of
    max|a|, the JAX suite's bound for its interpret path's contraction
    (tests/test_ds_kernel.py:47-53), and against the float64 oracle at
    1e-11, where nothing contracts (tests/test_torch_ds.py's bound)."""
    pos, vel = _state(400, dtype=np.float64)
    ph, pl, _, _ = _planes(pos, vel)
    scal = _scal("euler")
    got = ds.ds_accel_vs(ph[:100], pl[:100], ph, pl, scal)
    want = jds.compute_accel_pallas_ds(*(jnp.asarray(t.numpy()) for t in (ph[:100], pl[:100],
                                                                           ph, pl)),
                                       jnp.asarray(scal.numpy()), interpret=True)
    assert got[0].shape == (100, 3)
    g = ds.ds_to_f64(*got)
    ref = accel_numpy(pos, SOFT)[:100]
    scale = np.abs(ref).max()
    assert np.abs(g - jds.ds_to_f64(*want)).max() < 5e-8 * scale
    assert np.abs(g - ref).max() < 1e-11 * scale


def test_plain_ds_accel_then_integrate_is_the_step():
    pos, vel = _state(128, dtype=np.float64)
    planes = _planes(pos, vel)
    scal = _scal("euler")
    acc = ds.ds_accel_vs(planes[0], planes[1], planes[0], planes[1], scal)
    for g, w in zip(ds.ds_integrate(*planes, acc, scal), ds.nbody_step_ds(*planes, scal)):
        assert torch.equal(g, w)


def test_accel_wrapper_on_cpu_gives_the_plain_shape_and_rows_of_four():
    """compute_accel_ds_cuda_vs takes the plain version on a CPU tensor: its
    (M,3) result views (M,4) rows with w = 0, which ds_integrate_cuda takes
    as rows 4 floats apart; a kernel launch is not counted."""
    pos, vel = _state(96, dtype=np.float64)
    planes = _planes(pos, vel)
    scal = _scal("euler")
    before = dict(cuda_kernel.LAUNCHES)
    out = tuple(torch.full((40, 4), 7.0) for _ in range(2))
    acc = cuda_kernel.compute_accel_ds_cuda_vs(planes[0][:40], planes[1][:40], planes[0],
                                               planes[1], scal, out=out)
    want = ds.ds_accel_vs(planes[0][:40], planes[1][:40], planes[0], planes[1], scal)
    for a, o, w in zip(acc, out, want):
        assert a.shape == (40, 3) and a.stride() == (4, 1) and a.data_ptr() == o.data_ptr()
        assert torch.equal(a, w) and torch.equal(o[:, 3], torch.zeros(40))
    full = cuda_kernel.compute_accel_ds_cuda_vs(planes[0], planes[1], planes[0], planes[1], scal)
    for g, w in zip(cuda_kernel.ds_integrate_cuda(*planes, *full, scal),
                    ds.nbody_step_ds(*planes, scal)):
        assert torch.equal(g, w)
    assert cuda_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="rows"):
        cuda_kernel.ds_integrate_cuda(*planes, torch.zeros(96, 5)[:, :3], full[1], scal)


# ---- systems, Compute and the CLI on a mesh ----


def _params(n):
    from nbody_tpu_torch import tuned_scales

    cs, vs = tuned_scales(n) or (1.54, 8.0)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs, damping=DAMP)


@pytest.mark.parametrize("kind, integrator, strategy", [
    ("fp32", "euler", "allgather"), ("fp32", "leapfrog", "ring"), ("fp32", "hermite", "ring"),
    ("ds", "euler", "ring"), ("ds", "leapfrog", "allgather"), ("ds", "hermite", "ring"),
])
def test_system_on_a_mesh_matches_one_device(pools, kind, integrator, strategy):
    """N=99 on 2 ranks: rounded up to 100 with a zero-mass body at the origin,
    which adds nothing to the real bodies' forces; 3 steps against the
    single-device system of the 99 bodies."""
    n = 99
    params = _params(n)
    dtype = np.float64 if kind == "ds" else np.float32
    state = _state(n, dtype=dtype)
    kw = {"integrator": integrator, "strategy": strategy}
    res = pools[2].run("system", kind, n, params, kw, state, 3)
    cls = DSBodySystem if kind == "ds" else BodySystem
    one = cls(n, params, device="cpu", state=state, integrator=integrator,
              variant="one_sided" if kind == "ds" else "vpu")
    one.update_many(3)
    acc = ds.ds_to_f64(*one.accelerations()) if kind == "ds" else one.accelerations().numpy()
    tol = DS_TOL if kind == "ds" else FP32_ATOL
    for pos, vel, a, strat, variant, _ in res:
        assert pos.shape == (100, 4) and strat == strategy
        assert variant == ("one_sided" if kind == "ds" else "vpu")
        assert np.abs(pos[:n] - one.positions).max() < tol
        assert np.abs(vel[:n] - one.velocities).max() < tol
        assert np.abs(a[:n] - acc).max() < tol * max(1.0, np.abs(acc).max())
        assert pos[n, 3] == 0.0
    # every rank sees the same gathered system
    for r in res[1:]:
        np.testing.assert_array_equal(r[0], res[0][0])


def test_ds_state_from_jax_steps_alike_on_a_mesh(pools):
    """Planes from nbody_tpu's DSBodySystem.get_ds_state, loaded into a
    sharded port system by set_ds_state, step as nbody_tpu's system steps
    them (one-sided, interpret mode, tile_j=512)."""
    n = 64
    params = _params(n)
    jax_sys = JaxDSBodySystem(n, JaxNBodyParams(**dataclasses.asdict(params)),
                              variant="one_sided",
                              tile_j=512, interpret=True, seed=3)
    planes = jax_sys.get_ds_state()
    jax_sys.update()
    res = pools[2].run("system", "ds", n, params, {"strategy": "ring"}, None, 1, planes)
    want = jax_sys.get_ds_state()
    for *_, got in res:
        for k in (0, 2):  # positions, velocities: hi + lo in float64
            g = ds.ds_to_f64(*(torch.from_numpy(a) for a in got[k:k + 2]))
            assert np.abs(g - jds.ds_to_f64(*want[k:k + 2])).max() < DS_TOL


@pytest.mark.parametrize("kw", [{}, {"precision": "ds", "integrator": "leapfrog",
                                    "strategy": "ring"}])
def test_compute_on_a_mesh_gives_rank0_verdict_everywhere(pools, kw):
    res = pools[2].run("compute_checks", 128, kw, 2)
    for passed, drift, pos in res:
        assert passed is True
        assert drift == res[0][1] and drift["steps"] == 2
        np.testing.assert_array_equal(pos, res[0][2])


@pytest.mark.parametrize("d", [2, 4])
def test_initialize_multihost_keeps_a_started_group(pools, d):
    assert pools[d].run("multihost_view") == [(d, True)] * d
    from nbody_tpu_torch.parallel import is_multihost

    assert not is_multihost()  # this process starts no group


def test_rank0_judge_may_outlast_the_group_timeout(tmp_path):
    """Compute's QA and drift checks judge on rank 0 alone while the other
    ranks wait for the verdict. A group whose collectives time out after
    2 s still hands on a verdict that took 5 s: the wait is on the mesh's
    judge group (parallel.mesh.JUDGE_TIMEOUT), not on the body group."""
    pool = RankPool(2, str(tmp_path / "store"), timeout_s=2)
    try:
        res = pool.run("slow_verdict", 5.0)
    finally:
        pool.close()
    assert [verdict for verdict, _ in res] == ["rank 0's verdict"] * 2
    assert res[1][1] > 4.0  # rank 1 waited past the group's timeout


def test_meshes_share_one_judge_group(pools):
    assert pools[2].run("judge_groups") == [True, True]


def test_make_mesh_raises_the_reference_error(pools):
    errors = pools[2].run("make_mesh_error", 4)
    assert errors == ["requested 4 devices but only 2 available"] * 2
    assert all("2 ranks" in e for e in pools[2].run("make_mesh_error", 1))


@pytest.mark.parametrize("n, d", [(256, 2), (32768, 2), (65536, 4), (65535, 4), (4096, 1)])
def test_auto_strategy_resolves_as_choose_strategy(n, d):
    assert choose_strategy(n, d) == jax_choose_strategy(n, d)
    assert RING_AUTO_MIN_SHARD == 16384
    if d > 1:
        s = BodySystem(n, _params(n), device="cpu", mesh=_fake_mesh(d), strategy="auto")
        assert s.strategy == choose_strategy(s.num_bodies, d) and s.variant == "vpu"
        assert s.num_bodies % d == 0


def _fake_grid():
    """A 2-D mesh record with no process groups: enough for the checks a
    system makes before its first collective."""
    return types.SimpleNamespace(axis_names=("rows", "cols"), size=4, device=torch.device("cpu"))


# The cases whose ids name #13 refused what that item has since brought
# (2-D meshes, strategy="sym", meshes in float64); they now hold those
# paths to the refusals that remain on them, in nbody_tpu's words, and keep
# their ids, as the ring_fused cases keep theirs (Queue 2 #20). The paths
# themselves run in tests/test_torch_sharded_sym.py and _2d.py.
@pytest.mark.parametrize("build, match", [
    pytest.param(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_grid(),
                                    variant="mxu_bf16"),
                 "the 2-D decomposition uses the accel-only kernels", id="<lambda>-#13_0"),
    pytest.param(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                                    strategy="sym", dtype=torch.float64),
                 "strategy='sym' is a float32 kernel path", id="<lambda>-#13_1"),
    # the ring_fused refusals, Hermite and backend="torch"; their ids name the
    # ROADMAP item that brought ring_fused (Queue 2 #20)
    pytest.param(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                                    strategy="ring_fused", integrator="hermite"),
                 "ring_fused fuses the Euler update", id="<lambda>-Queue 2 #20_0"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), variant="sym"),
     "single-device"),
    # the sharded P3M step with the XLA cell-list engine was refused naming
    # #16 until that item brought it (it runs in tests/test_torch_p3m_sharded.py);
    # the case now builds that system and holds nbody_tpu's refusal of block
    # timesteps on a mesh
    pytest.param(lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                                    kernel="p3m", p3m_short_range="xla").update_many_block(1),
                 "block timesteps are single-device", id="<lambda>-#13_2"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), placement="host"),
     "single-device"),
    pytest.param(lambda: DSBodySystem(64, _params(64), device="cpu", mesh=_fake_grid(),
                                      strategy="allgather"),
                 "leave strategy at 'auto'", id="<lambda>-#13_3"),
    (lambda: DSBodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                          strategy="ring_fused"), "ring_fused/sym are fp32"),
    (lambda: DSBodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), variant="sym"),
     "single device"),
    pytest.param(lambda: make_sharded_step(_fake_mesh(), strategy="ring_fused",
                                           backend="torch"),
                 "strategy='ring_fused' is a CUDA kernel; use backend='cuda'",
                 id="<lambda>-Queue 2 #20_1"),
    pytest.param(lambda: make_sharded_step(_fake_mesh(), strategy="sym", backend="torch"),
                 "strategy='sym' runs the Newton's-third-law CUDA kernels",
                 id="<lambda>-#13_4"),
    (lambda: make_sharded_step(_fake_mesh(), integrator="rk4"), "integrator"),
    (lambda: make_sharded_ds_step(_fake_mesh(), strategy="ring_fused"), "'allgather' or"),
    pytest.param(lambda: make_mesh_2d(2, 2), "requested 2x2 devices but only 1 available",
                 id="<lambda>-#13_5"),
    pytest.param(lambda: make_sharded_step_2d(_fake_mesh()), "parallel.make_mesh_2d",
                 id="<lambda>-#13_6"),
    # the sharded ds adaptive rollout raised naming ROADMAP.md Queue 1 #7
    # until that item brought it; the id keeps it, and the case now holds
    # nbody_tpu's refusal of an empty dt window
    pytest.param(lambda: make_sharded_ds_adaptive_rollout(
        _fake_mesh(), softening=SOFT, damping=DAMP, eta=0.01, dt_min=0.1, dt_max=0.01, steps=2),
                 r"need 0 < dt_min <= dt_max", id="<lambda>-#7"),
])
def test_refusals_name_the_reference_error_or_roadmap_item(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def test_ds_mesh_variants_resolve_one_sided():
    s = DSBodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), strategy="allgather")
    assert s.variant == "one_sided" and s.strategy == "allgather" and s.num_bodies == 64
    s = DSBodySystem(63, _params(64), device="cpu", mesh=_fake_mesh(4), integrator="hermite")
    assert s.num_bodies == 64 and s.strategy == "allgather"
    assert BodySystem(64, _params(64), device="cpu").strategy == "auto"


def test_cli_under_torchrun_on_two_gloo_ranks(tmp_path):
    """nbody-torch --cpu --devices 2 --qatest under torchrun, fp32 and ds,
    the two runs started together: each exits 0, and only rank 0 prints."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    runs = (["--qatest", "--numbodies", "250", "--strategy", "ring"],
            ["--precision", "ds", "--qatest", "--numbodies", "99", "--strategy", "allgather"])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", "2", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in runs]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.count("-> OK") == 1 and out.count("2-device mesh") == 1, out
