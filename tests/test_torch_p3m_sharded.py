"""The port's sharded PM and P3M steps (ops/pm.py::make_sharded_pm_step,
ops/p3m.py::make_sharded_p3m_step), the pair kernel's ranges
(p3m.item_range, p3m.short_range_part) and BodySystem on a mesh with
kernel="pm" / "p3m", against nbody_tpu's on the CPU.

The port's side runs 1, 2 and 4 gloo ranks (tests/test_torch_sharded_ranks.py)
with the plain versions of the kernels; the JAX side runs
``make_sharded_pm_step`` / ``make_sharded_p3m_step`` (short_range "xla") on
D of the virtual CPU devices that tests/conftest.py gives JAX. Inputs are
made with numpy from a seed: 388 bodies (odd shards of 97 and 194), masses
from [0.5, 2], damping 0.5; grid 16 (27 short-range cells, split unevenly
over any D) and 32 (216 cells). Tolerances, with their reasons:

* a replicated step against nbody_tpu's: rtol / atol 1e-5, the JAX suite's
  bound for its sharded PM and P3M steps against one device
  (tests/test_pm.py:87-105, tests/test_p3m.py:182-206);
* a slab step: rtol / atol 1e-4, the JAX suite's slab bound
  (tests/test_pm.py:182-204);
* one rank against one device, a repeat against its run, and the ranges'
  plain rows against the whole plain short range: bit for bit (the same
  operations in the same order);
* the breach step on a mesh: within 2 steps of nbody_tpu's sharded probe,
  the JAX suite's own slack (tests/test_p3m.py:579-606).
"""

import os
import pathlib
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops.p3m import make_sharded_p3m_step as jax_sharded_p3m_step
from nbody_tpu.ops.pm import make_sharded_pm_step as jax_sharded_pm_step
from nbody_tpu.params import NBodyParams as JaxNBodyParams
from nbody_tpu.parallel import make_mesh as jax_make_mesh
from nbody_tpu.parallel import shard_state as jax_shard_state
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import p3m, pm, reference
from nbody_tpu_torch.params import NBodyParams
from nbody_tpu_torch.parallel import Mesh

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
N = 4 * 97
REPLICATED_TOL, SLAB_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"solver{d}") / "store"))
            for d in (1, 2, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(n=N, *, seed=11):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(0.5, 2.0, n)].astype(np.float32)
    vel = np.c_[rng.standard_normal((n, 3)), rng.standard_normal(n)].astype(np.float32)
    return pos, vel


def _ours(pools, d, kernel, kw, steps=1):
    """The D ranks' shards after `steps` steps, concatenated, and whether
    every rank's repeat gave its bits."""
    pos, vel = _state()
    out = pools[d].run("mesh_solver_step", kernel, kw, pos, vel, DT, SOFT, DAMP, steps)
    shards = [o[0] for o in out]
    return tuple(np.concatenate(parts) for parts in zip(*shards)), all(o[1] for o in out)


def _theirs(d, kernel, kw, steps=1):
    pos, vel = _state()
    mesh = jax_make_mesh(d)
    make = jax_sharded_pm_step if kernel == "pm" else jax_sharded_p3m_step
    step = make(mesh, **kw)
    p, v = jax_shard_state(mesh, pos, vel)
    for _ in range(steps):
        p, v = step(p, v, DT, SOFT, DAMP)
    return np.asarray(p), np.asarray(v)


CASES = [
    # (D, fft, assignment, integrator): odd shards and uneven cell splits
    # at D = 2 and 4, both FFT decompositions, both assignments
    (2, "replicated", "cic", "euler"), (4, "replicated", "tsc", "euler"),
    (4, "replicated", "cic", "leapfrog"), (2, "slab", "tsc", "euler"),
    (4, "slab", "cic", "euler"), (2, "slab", "cic", "leapfrog"),
]


@pytest.mark.parametrize("d, fft, assignment, integrator", CASES)
def test_sharded_pm_step_matches_nbody_tpu(pools, d, fft, assignment, integrator):
    kw = {"grid": 16, "fft": fft, "assignment": assignment, "integrator": integrator}
    (p, v), repeat = _ours(pools, d, "pm", kw)
    tp, tv = _theirs(d, "pm", kw)
    tol = SLAB_TOL if fft == "slab" else REPLICATED_TOL
    np.testing.assert_allclose(p, tp, rtol=tol, atol=tol)
    np.testing.assert_allclose(v, tv, rtol=tol, atol=tol)
    assert repeat


@pytest.mark.parametrize("d, fft, assignment, integrator", CASES)
def test_sharded_p3m_step_matches_nbody_tpu(pools, d, fft, assignment, integrator):
    grid = 16 if d == 2 else 32
    kw = {"grid": grid, "capacity": 64, "fft": fft, "assignment": assignment,
          "integrator": integrator}
    (p, v), repeat = _ours(pools, d, "p3m", kw)
    tp, tv = _theirs(d, "p3m", kw)
    tol = SLAB_TOL if fft == "slab" else REPLICATED_TOL
    np.testing.assert_allclose(p, tp, rtol=tol, atol=tol)
    np.testing.assert_allclose(v, tv, rtol=tol, atol=tol)
    assert repeat


def _one_device(kernel, kw, steps):
    pos, vel = _state()
    p, v = torch.tensor(pos), torch.tensor(vel)
    grid, assignment = kw.get("grid", 64), kw.get("assignment", "cic")
    if kernel == "pm":
        def accel(q):
            return pm.pm_accel(q, grid=grid, assignment=assignment)
    else:
        def accel(q):
            return p3m.p3m_accel(q, SOFT, grid=grid, capacity=kw["capacity"],
                                 assignment=assignment)[0]
    for _ in range(steps):
        if kw.get("integrator") == "leapfrog":
            p, v = reference.nbody_step_leapfrog(p, v, DT, SOFT, DAMP, accel_fn=accel)
        else:
            p, v = reference.integrate(p, v, accel(p), DT, DAMP)
    return p.numpy(), v.numpy()


@pytest.mark.parametrize("kernel", ["pm", "p3m"])
@pytest.mark.parametrize("fft, integrator", [("replicated", "euler"), ("slab", "leapfrog")])
def test_one_rank_is_one_device_bit_for_bit(pools, kernel, fft, integrator):
    kw = {"grid": 16, "fft": fft, "integrator": integrator, "assignment": "tsc"}
    if kernel == "p3m":
        kw["capacity"] = 64
    (p, v), repeat = _ours(pools, 1, kernel, kw, steps=2)
    op, ov = _one_device(kernel, kw, steps=2)
    np.testing.assert_array_equal(p, op)
    np.testing.assert_array_equal(v, ov)
    assert repeat


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_ranges_plain_rows_sum_to_the_whole(d):
    """Each rank's range of the pair work (p3m.item_range) takes whole
    clusters, the ranges partition the live clusters and items, and their
    plain rows together are the whole plain short range bit for bit."""
    pos, _ = _state(2000, seed=3)
    t = torch.tensor(pos)
    tables = p3m.pair_tables(t, SOFT, grid=32, capacity=64, blk=128)
    ranges = [p3m.item_range(tables, r, d).tolist() for r in range(d)]
    assert ranges[0][0] == 0 and ranges[0][2] == 0
    assert ranges[-1][1] == int(tables.cl_nitem.sum())
    assert ranges[-1][3] == tables.cl_item0.shape[0]
    for (lo, hi, c0, c1), nxt in zip(ranges, ranges[1:] + [None]):
        assert lo == (int(tables.cl_item0[c0]) if c0 < tables.cl_item0.shape[0] else hi)
        if nxt is not None:
            assert (hi, c1) == (nxt[0], nxt[2])
    whole = reference.p3m_short_range(t, SOFT, grid=32, capacity=64)
    parts = [p3m.short_range_part(t, SOFT, grid=32, capacity=64, rank=r, ndev=d)[0]
             for r in range(d)]
    owner = torch.full((t.shape[0],), -1)
    for r, (part, (_, _, c0, c1)) in enumerate(zip(parts, ranges)):
        mine = (tables.body_row >= c0 * p3m.CLUSTER) & (tables.body_row < c1 * p3m.CLUSTER)
        assert bool((owner[mine] < 0).all()) and bool((part[~mine] == 0).all())
        owner[mine] = r
    assert bool((owner >= 0).all())  # every body kept at capacity 64 has one owner
    assert torch.equal(sum(parts[1:], parts[0]), whole)
    with pytest.raises(ValueError, match="rank"):
        p3m.item_range(tables, d, d)


def _fake_mesh(size=2):
    return Mesh(axis="bodies", size=size, rank=0, group=None, device=torch.device("cpu"))


def test_system_refusals():
    grid = types.SimpleNamespace(axis_names=("rows", "cols"), size=4, rows=2, cols=2,
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="1-D body mesh"):
        BodySystem(64, NBodyParams(), device="cpu", mesh=grid, kernel="pm")
    with pytest.raises(ValueError, match="divide the padded grid"):
        BodySystem(66, NBodyParams(), device="cpu", mesh=_fake_mesh(3), kernel="p3m",
                   pm_grid=16, pm_fft="slab")
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 #16"):
        BodySystem(64, NBodyParams(), device="cpu", mesh=_fake_mesh(), kernel="p3m",
                   p3m_short_range="xla")
    with pytest.raises(ValueError, match="jerk"):
        BodySystem(64, NBodyParams(), device="cpu", mesh=_fake_mesh(), kernel="pm",
                   integrator="hermite")
    with pytest.raises(ValueError, match="fft"):
        pm.make_sharded_pm_step(_fake_mesh(), fft="pencil")


@pytest.mark.parametrize("kernel, kw", [("pm", {"pm_fft": "slab", "pm_assignment": "tsc"}),
                                        ("p3m", {"pm_fft": "replicated"}),
                                        ("p3m", {"pm_fft": "slab", "integrator": "leapfrog"})])
def test_system_on_a_mesh_matches_nbody_tpu(pools, kernel, kw):
    pos, vel = _state()
    params = NBodyParams(time_step=DT, softening=SOFT, damping=DAMP)
    jkw = {"pm_fft": kw["pm_fft"], "pm_assignment": kw.get("pm_assignment", "cic"),
           "integrator": kw.get("integrator", "euler")}
    kw = {"kernel": kernel, "pm_grid": 16, **kw}
    out = pools[4].run("system", "fp32", N, params, kw, (pos, vel), 3)
    theirs = JaxBodySystem(N, JaxNBodyParams(time_step=DT, softening=SOFT, damping=DAMP),
                           backend=kernel, pm_grid=16, mesh=jax_make_mesh(4),
                           p3m_short_range="xla", state=(pos, vel), **jkw)
    theirs.update_many(3)
    tol = SLAB_TOL if kw["pm_fft"] == "slab" else REPLICATED_TOL
    for positions, velocities, acc, *_ in out:  # every rank speaks of the whole system
        np.testing.assert_allclose(positions, np.asarray(theirs.positions), rtol=tol, atol=tol)
        np.testing.assert_allclose(velocities, np.asarray(theirs.velocities), rtol=tol,
                                   atol=tol)
        assert acc.shape == (N, 3) and np.isfinite(acc).all()
        np.testing.assert_array_equal(positions, out[0][0])


def _collapsing():
    """tests/test_p3m.py:528-545's infalling shell."""
    n = 512
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.9, 1.1, size=(n, 1))
    pos = np.concatenate([dirs * radii, np.ones((n, 1))], 1).astype(np.float32)
    vel = np.concatenate([-dirs * 2.0, np.zeros((n, 1))], 1).astype(np.float32)
    kw = dict(time_step=0.01, softening=0.05, damping=1.0)
    return n, kw, (pos, vel)


def test_breach_step_on_a_mesh_matches_nbody_tpu(pools):
    """tests/test_p3m.py:579-606: the probe finds the first breached step of
    a sharded collapsing rollout; every rank finds the same."""
    n, kw, state = _collapsing()
    single = JaxBodySystem(n, JaxNBodyParams(**kw), backend="p3m", pm_grid=16,
                           p3m_short_range="xla", state=state)
    cap = single.p3m_capacity
    truth = single._update_many_inner(60, 0.01)
    assert truth >= 1
    sharded = JaxBodySystem(n, JaxNBodyParams(**kw), backend="p3m", pm_grid=16,
                            p3m_short_range="xla", state=state, mesh=jax_make_mesh(4),
                            p3m_capacity=cap)
    jax_found = sharded._update_many_inner(60, 0.01)
    found = pools[4].run("p3m_breach", n, NBodyParams(**kw), {"pm_grid": 16, "p3m_capacity": cap},
                         state, 60, False)
    assert len(set(found)) == 1
    assert abs(found[0] - jax_found) <= 2 and abs(found[0] - truth) <= 2, (found, jax_found,
                                                                            truth)


def test_auto_refresh_on_a_mesh_recovers(pools):
    """tests/test_p3m.py:609-636: the sharded run rewinds, re-sizes, rebuilds
    its step and resumes: no warning, the capacity grown, the last state
    within it; every rank alike."""
    n, kw, state = _collapsing()
    out = pools[2].run("p3m_breach", n, NBodyParams(**kw), {"pm_grid": 16}, state, 60, True)
    for broken, cap0, cap, refreshes, positions in out:
        assert not broken and cap > cap0 and refreshes
        assert np.isfinite(positions).all()
        assert int(p3m.p3m_overflow_count(torch.tensor(positions), grid=16, capacity=cap)) == 0
        np.testing.assert_array_equal(positions, out[0][4])
    theirs = JaxBodySystem(n, JaxNBodyParams(**kw), backend="p3m", pm_grid=16,
                           p3m_short_range="xla", state=state, mesh=jax_make_mesh(2),
                           p3m_auto_refresh=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        theirs.update_many(60, 0.01)
    assert not any("contract broken" in str(x.message) for x in w)
    assert theirs.p3m_capacity > out[0][1]


def test_cli_mesh_solvers_under_torchrun(tmp_path):
    """nbody-torch --cpu --devices 2 with --kernel p3m --pm-fft slab
    --p3m-auto-refresh --qatest and --kernel pm --pm-assignment tsc
    --integrator leapfrog --qatest under torchrun, started together: each
    exits 0, and only rank 0 prints."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    runs = (["--kernel", "p3m", "--pm-fft", "slab", "--p3m-auto-refresh", "--pm-grid", "16"],
            ["--kernel", "pm", "--pm-assignment", "tsc", "--integrator", "leapfrog"])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", "2", "--qatest", "--numbodies",
         "250", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in runs]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err), args in zip(procs, outs, runs):
        assert proc.returncode == 0, err
        assert out.count("-> OK") == 1 and out.count("2-device mesh") == 1, out
        assert f"force {args[1]}" in out and "not gated" in out, out
