"""The port's 2-D (rows x cols) decompositions, its reduce-scatter and its
float64 meshes, against nbody_tpu's and the float64 oracle.

The port's side runs gloo ranks on the CPU (tests/test_torch_sharded_ranks.py)
or a grid's ranks in one process (``emulated_accel_2d``), with the plain
versions of the kernels. The JAX side runs ``nbody_tpu.parallel``'s
``make_sharded_step_2d`` (kernel "xla") and ``make_sharded_ds_step_2d``
(Pallas in interpret mode, tile_j 512, as tests/test_ds_kernel.py runs it)
on ``make_mesh_2d`` grids of the virtual CPU devices. Inputs are made with
numpy from a seed: masses from [0.5, 2], a random vel.w, damping 0.5;
chunks of 35 bodies, odd and no tile's multiple. Tolerances:

* fp32 against nbody_tpu: atol 2e-5, the JAX suite's bound for a sharded
  step (tests/test_sharded.py:36-37), float32 summation order only;
* ds against nbody_tpu: max |d| < 5e-9 of the values hi + lo (``DS_TOL``,
  tests/test_ds_kernel.py:375), which covers its interpret path's FMA
  contraction (a hi plane may then differ by an ulp that its lo carries);
* float64 meshes against the float64 oracle's force: 1e-10 · max|a|, the
  rule of the port's fp64 QA (``DS_QA_ACCEL_RTOL``), and their steps
  against the single-device float64 system at 1e-12;
* a rank against ``emulated_accel_2d`` and ``ring_reduce_scatter`` against
  ``emulated_reduce_scatter``, a rollout against its steps: bit for bit.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.oracle.numpy_oracle import accel_numpy
from nbody_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nbody_tpu.parallel import make_sharded_ds_step_2d as jax_make_sharded_ds_step_2d
from nbody_tpu.parallel import make_sharded_step_2d as jax_make_sharded_step_2d
from nbody_tpu.parallel import shard_state as jax_shard_state
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch import DEMO_PARAMS
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.ops import ds, reference
from nbody_tpu_torch.parallel import (
    Mesh,
    emulated_accel_2d,
    make_mesh_2d,
    make_sharded_ds_step,
    make_sharded_ds_step_2d,
    make_sharded_step,
    make_sharded_step_2d,
)

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
FP32_ATOL = 2e-5
DS_TOL = 5e-9
F64_FORCE_RTOL = 1e-10
M = 35  # bodies a chunk


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"grid{d}") / "store")) for d in (2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(n, *, seed=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(0.5, 2.0, n)]
    vel = np.c_[rng.standard_normal((n, 3)), rng.standard_normal(n)]
    return pos.astype(dtype), vel.astype(dtype)


def _cat(shards, k):
    return np.concatenate([s[k] for s in shards])


def _jax_2d(rows, cols, integrator, pos, vel):
    mesh = jax_make_mesh_2d(rows, cols)
    step = jax_make_sharded_step_2d(mesh, kernel="xla", integrator=integrator)
    return [np.asarray(a) for a in step(*jax_shard_state(mesh, pos, vel, axis=("rows", "cols")),
                                        DT, SOFT, DAMP)]


def _params(n):
    from nbody_tpu_torch import tuned_scales

    cs, vs = tuned_scales(n) or (1.54, 8.0)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs, damping=DAMP)


# ---- the grid and the reduce-scatter ----


@pytest.mark.parametrize("world, rows", [(4, 2), (4, 1), (4, 4), (2, 2)])
def test_grid_lines_are_the_rows_and_columns(pools, world, rows):
    """Rank r·C + c is (r, c): its row's ranks gather the row block, its
    column's ranks the strided column block."""
    cols = world // rows
    for rank, (size, r, shape, along_rows, along_cols) in enumerate(
            pools[world].run("mesh_2d_view", rows)):
        assert size == world and r == rank and shape == {"rows": rows, "cols": cols}
        row, col = divmod(rank, cols)
        assert along_rows == [k * cols + col for k in range(rows)]
        assert along_cols == [row * cols + k for k in range(cols)]


@pytest.mark.parametrize("world, rows", [(2, None), (4, None), (4, 2)])
def test_ring_reduce_scatter_sums_in_the_fixed_order(pools, world, rows):
    """Partials whose magnitudes spread over 1e±14, where the sum order
    shows in the bits: every rank's chunk equals emulated_reduce_scatter's
    (P_{c+1} + ... + P_{c}) bit for bit, with torch.add and with ds_add, on
    a 1-D mesh and along both lines of a 2 x 2 grid."""
    for flags in pools[world].run("reduce_scatter_bits", 9, 3, 5, rows):
        assert flags and all(flags)


# ---- fp32 against nbody_tpu's 2-D decomposition ----


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_2x2_step_matches_jax(pools, integrator):
    pos, vel = _state(4 * M)
    want = _jax_2d(2, 2, integrator, pos, vel)
    res = pools[4].run("step_2d", 2, integrator, pos, vel, DT, SOFT, DAMP)
    for k, w in enumerate(want):
        np.testing.assert_allclose(_cat(res, k), w, atol=FP32_ATOL)
    assert all(r[2] for r in res)  # each rank's force is emulated_accel_2d's rows


@pytest.mark.parametrize("rows", [1, 2])
def test_two_rank_grids_match_jax(pools, rows):
    """1 x 2 (one row block, the column sum over both ranks) and 2 x 1 (no
    column sum)."""
    pos, vel = _state(2 * M, seed=3)
    want = _jax_2d(rows, 2 // rows, "euler", pos, vel)
    res = pools[2].run("step_2d", rows, "euler", pos, vel, DT, SOFT, DAMP, 2)
    jstep = jax_make_sharded_step_2d(jax_make_mesh_2d(rows, 2 // rows), kernel="xla")
    jp, jv = jstep(jnp.asarray(want[0]), jnp.asarray(want[1]), DT, SOFT, DAMP)
    for k, w in enumerate((jp, jv)):
        np.testing.assert_allclose(_cat(res, k), np.asarray(w), atol=FP32_ATOL)
    assert all(r[2] for r in res)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("rows, cols", [(2, 4), (4, 2)])
def test_emulated_grid_matches_jax(rows, cols, integrator):
    """emulated_accel_2d of 2 x 4 and 4 x 2 grids, integrated as the step
    integrates, against nbody_tpu's make_mesh_2d(2, 4) / (4, 2) steps."""
    pos, vel = _state(rows * cols * M, seed=rows)
    want = _jax_2d(rows, cols, integrator, pos, vel)
    p, v = torch.from_numpy(pos), torch.from_numpy(vel)
    if integrator == "leapfrog":
        got = reference.nbody_step_leapfrog(
            p, v, DT, SOFT, DAMP, accel_fn=lambda q: emulated_accel_2d(q, rows, cols, SOFT))
    else:
        got = reference.integrate(p, v, emulated_accel_2d(p, rows, cols, SOFT), DT, DAMP)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_ATOL)


def test_2d_rollout_is_its_steps(pools):
    pos, vel = _state(4 * M, seed=9)
    for rolled, stepped in pools[4].run("rollout", None, "hermite", pos, vel, DT, SOFT, DAMP,
                                        2, 2):
        for a, b in zip(rolled, stepped):
            np.testing.assert_array_equal(a, b)


# ---- ds against nbody_tpu's make_sharded_ds_step_2d ----


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_ds_2x2_step_matches_jax(pools, integrator):
    pos, vel = _state(4 * M, seed=5, dtype=np.float64)
    planes = (*ds.ds_from_f64(pos), *ds.ds_from_f64(vel))
    scal = {"euler": ds.scal_ds, "leapfrog": ds.scal_ds_leapfrog,
            "hermite": ds.scal_ds_hermite}[integrator](DT, SOFT, DAMP)
    jstep = jax_make_sharded_ds_step_2d(jax_make_mesh_2d(2, 2), tile_j=512, interpret=True,
                                        integrator=integrator)
    want = jstep(*(jnp.asarray(p.numpy()) for p in planes), jnp.asarray(scal.numpy()))
    res = pools[4].run("ds_step_2d", 2, integrator, tuple(p.numpy() for p in planes),
                       scal.numpy())
    for k in (0, 2):  # positions, velocities: hi + lo in float64
        got = ds.ds_to_f64(*(torch.from_numpy(_cat(res, i)) for i in (k, k + 1)))
        assert np.abs(got - ds.ds_to_f64(*(torch.from_numpy(np.array(w))
                                           for w in want[k:k + 2]))).max() < DS_TOL


# ---- systems and Compute on a grid, and float64 meshes ----


@pytest.mark.parametrize("kind, integrator", [
    ("fp32", "euler"), ("fp32", "hermite"), ("ds", "euler"), ("ds", "leapfrog"),
    ("ds", "hermite"),
])
def test_system_on_a_grid_matches_one_device(pools, kind, integrator):
    """N = 139 on a 2 x 2 grid: rounded up to 140 with a zero-mass body,
    three steps against the single-device one-sided system of 139 bodies."""
    n = 139
    params = _params(n)
    dtype = np.float64 if kind == "ds" else np.float32
    state = _state(n, seed=29, dtype=dtype)
    res = pools[4].run("system", kind, n, params, {"integrator": integrator}, state, 3, None, 2)
    cls = DSBodySystem if kind == "ds" else BodySystem
    one = cls(n, params, device="cpu", state=state, integrator=integrator,
              variant="one_sided" if kind == "ds" else "vpu")
    one.update_many(3)
    acc = ds.ds_to_f64(*one.accelerations()) if kind == "ds" else one.accelerations().numpy()
    tol = DS_TOL if kind == "ds" else FP32_ATOL
    for pos, vel, a, strategy, variant, _ in res:
        assert pos.shape == (140, 4) and strategy == "2d" and pos[n, 3] == 0.0
        assert variant == ("one_sided" if kind == "ds" else "vpu")
        assert np.abs(pos[:n] - one.positions).max() < tol
        assert np.abs(vel[:n] - one.velocities).max() < tol
        assert np.abs(a[:n] - acc).max() < tol * max(1.0, np.abs(acc).max())


@pytest.mark.parametrize("world, mesh_rows, strategy, integrator", [
    (2, None, "allgather", "euler"), (2, None, "ring", "hermite"), (4, None, "auto", "leapfrog"),
    (4, 2, "auto", "euler"), (4, 2, "auto", "hermite"),
])
def test_float64_mesh_force_matches_the_float64_oracle(pools, world, mesh_rows, strategy,
                                                        integrator):
    """BodySystem(dtype=torch.float64) on a mesh: its force within 1e-10 of
    max|a| of the float64 oracle, and two steps within 1e-12 of the
    single-device float64 system."""
    n = 140
    params = _params(n)
    state = _state(n, seed=31, dtype=np.float64)
    kw = {"integrator": integrator, "strategy": strategy, "dtype": torch.float64}
    res = pools[world].run("system", "fp32", n, params, kw, state, 0, None, mesh_rows)
    want = accel_numpy(state[0], params.softening)
    scale = np.abs(want).max()
    for _, _, acc, resolved, _, _ in res:
        assert acc.dtype == np.float64
        assert np.abs(acc - want).max() <= F64_FORCE_RTOL * scale
        assert resolved == ("2d" if mesh_rows else "allgather" if strategy == "auto" else strategy)
    res = pools[world].run("system", "fp32", n, params, kw, state, 2, None, mesh_rows)
    one = BodySystem(n, params, device="cpu", state=state, integrator=integrator,
                     dtype=torch.float64)
    one.update_many(2)
    for pos, vel, *_ in res:
        assert np.abs(pos - one.positions).max() < 1e-12
        assert np.abs(vel - one.velocities).max() < 1e-12


@pytest.mark.parametrize("kw", [{}, {"precision": "ds", "integrator": "hermite"},
                                {"precision": "fp64", "integrator": "leapfrog"}])
def test_compute_on_a_grid_gives_rank0_verdict_everywhere(pools, kw):
    res = pools[4].run("compute_checks", 128, kw, 2, 2)
    for passed, drift, pos in res:
        assert passed is True
        assert drift == res[0][1] and drift["steps"] == 2
        np.testing.assert_array_equal(pos, res[0][2])


def test_float64_system_round_trips_sym_strategy(pools):
    """switch_precision on a mesh carries the strategy request: sym runs
    auto in float64 (sym is a float32 kernel path) and sym again after."""
    res = pools[2].run("switch_strategy", 64, "sym")
    assert res == [("sym", "allgather", "sym")] * 2


# ---- the CLI ----


def test_cli_grids_and_float64_meshes_under_torchrun(tmp_path):
    """nbody-torch --cpu under torchrun, the runs started together: fp32 and
    ds on --devices 4 --mesh-rows 2, and --fp64 --devices 2 with ring; each
    exits 0 and only rank 0 prints."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    runs = ((4, ["--mesh-rows", "2", "--numbodies", "139", "--integrator", "leapfrog"], "2d"),
            (4, ["--mesh-rows", "2", "--numbodies", "100", "--precision", "ds"], "2d"),
            (2, ["--fp64", "--numbodies", "99", "--strategy", "ring"], "ring"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(d), "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", str(d), "--qatest", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for d, args, _ in runs]
    outs = [proc.communicate(timeout=300) for proc in procs]
    for (d, _, strategy), proc, (out, err) in zip(runs, procs, outs):
        assert proc.returncode == 0, err
        assert out.count("-> OK") == 1, out
        assert out.count(f"{d}-device mesh [{strategy}]") == 1, out


@pytest.mark.parametrize("args, message", [
    (["--mesh-rows", "2"], "--mesh-rows needs --devices > 1"),
    (["--mesh-rows", "0", "--devices", "4"], "--mesh-rows must be at least 1"),
    (["--mesh-rows", "2", "--devices", "4", "--kernel", "p3m"], "applies to the exact kernels"),
    (["--strategy", "sym", "--devices", "2", "--kernel", "p3m"], "Newton's-third-law kernels"),
    (["--strategy", "sym", "--devices", "4", "--mesh-rows", "2"], "drop --mesh-rows"),
    (["--strategy", "sym", "--devices", "2", "--fp64"], "float32 path"),
    (["--strategy", "sym", "--devices", "2", "--precision", "fp64"], "float32 path"),
    (["--mesh-rows", "2", "--devices", "4", "--variant", "mxu"], "no mxu variants"),
    (["--mesh-rows", "3", "--devices", "4"], "does not divide --devices 4"),
    (["--precision", "ds", "--mesh-rows", "2", "--devices", "4", "--strategy", "ring"],
     "leave --strategy auto"),
    (["--precision", "ds", "--mesh-rows", "3", "--devices", "4"], "does not divide"),
])
def test_cli_mesh_refusals_exit_1_in_nbody_tpu_words(args, message, capsys):
    assert main(["--qatest", "--numbodies", "64", "--cpu", *args]) == 1
    assert message in capsys.readouterr().err


# ---- refusals of the builders and systems ----


def _fake_mesh(size=2):
    return Mesh(axis="bodies", size=size, rank=0, group=None, device=torch.device("cpu"))


def _fake_grid():
    return types.SimpleNamespace(axis_names=("rows", "cols"), size=4,
                                 device=torch.device("cpu"))


@pytest.mark.parametrize("build, match", [
    (lambda: make_mesh_2d(2, 2), "requested 2x2 devices but only 1 available"),
    (lambda: make_mesh_2d(0, 2), "rows, cols >= 1"),
    (lambda: make_sharded_step_2d(_fake_mesh()), "make_mesh_2d"),
    (lambda: make_sharded_ds_step_2d(_fake_mesh()), "make_mesh_2d"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_grid(), variant="mxu"),
     "no mxu variants"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_grid(), kernel="p3m"),
     "1-D body mesh"),
    (lambda: DSBodySystem(64, _params(64), device="cpu", mesh=_fake_grid(), strategy="ring"),
     "leave strategy at 'auto'"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(),
                        strategy="ring_fused", dtype=torch.float64), "float32 kernel path"),
    # the sharded P3M step is ported (tests/test_torch_p3m_sharded.py); its
    # XLA cell-list engine is not
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), kernel="p3m",
                        p3m_short_range="xla"),
     "ROADMAP.md Queue 1 #16"),
])
def test_grid_and_float64_refusals(build, match):
    with pytest.raises(ValueError, match=match):
        build()


def test_1d_builders_refuse_a_grid():
    from nbody_tpu_torch.parallel.mesh import Mesh2D

    grid = Mesh2D(axes=("rows", "cols"), rows=2, cols=2, rank=0, group=None,
                  device=torch.device("cpu"), along_rows=_fake_mesh(), along_cols=_fake_mesh())
    assert grid.size == 4 and grid.shape == {"rows": 2, "cols": 2}
    for build in (make_sharded_step, make_sharded_ds_step):
        with pytest.raises(ValueError, match="2-D decomposition"):
            build(grid)
