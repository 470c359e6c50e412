"""strategy="sym" (each pair once across the mesh) of the port against nbody_tpu's.

The port's side runs D gloo ranks on the CPU (tests/test_torch_sharded_ranks.py)
or all D ranks' work in one process (``emulated_sym``), with the plain
versions of the each-pair-once kernels, which their wrappers take on CPU
tensors. The JAX side runs ``nbody_tpu.parallel.make_sharded_step(...,
strategy="sym")`` on a D-device mesh of the virtual CPU devices in Pallas
interpret mode, tiles (8, 128), as tests/test_sharded.py:195-330 runs it.
Inputs are made with numpy from a seed: masses from [0.5, 2], a random
vel.w, damping 0.5. Shards are odd and no tile's multiple (33, 35, 37
bodies), so the port pads them to even for even D. Tolerances:

* against nbody_tpu: atol 2e-5, the JAX suite's own bound for a sharded
  step against the single-device one (tests/test_sharded.py:213,232,275):
  the two differ in float32 summation order only;
* a rank's force against ``emulated_sym``'s rows, two calls of a step, a
  rollout against its steps, and D = 1 against the single-device
  each-pair-once force: bit for bit, since each pair runs the same
  functions on the same inputs and sums in the same order.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.reference import compute_accel_jerk_xla
from nbody_tpu.ops.reference import nbody_step_hermite as jax_nbody_step_hermite
from nbody_tpu.parallel import make_mesh as jax_make_mesh
from nbody_tpu.parallel import make_sharded_step as jax_make_sharded_step
from nbody_tpu.parallel import shard_state as jax_shard_state
from nbody_tpu.parallel.sharded import make_sharded_rollout as jax_make_sharded_rollout
from test_torch_sharded_ranks import RankPool

from nbody_tpu_torch import DEMO_PARAMS
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.parallel import Mesh, emulated_sym, make_sharded_step

DT, SOFT, DAMP = 1e-3, 0.1, 0.5
FP32_ATOL = 2e-5
# the shard of each D: odd, and a multiple of no tile
NLOC = {1: 37, 2: 37, 3: 33, 4: 35, 5: 33, 8: 35}
# the each-pair-once dispatch with its caps forced under a shard
SMALL_CAPS = {"SYM_BLOCK_CAP": 128, "DEFAULT_SYM_TILE": 128,
              "AJ_SYM_BLOCK_CAP": 128, "AJ_SYM_TILE": 128}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """As in the rank processes: the plain versions' sums then run in the
    same order here and there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One gloo process group of D ranks for each D, started together."""
    made = {d: RankPool(d, str(tmp_path_factory.mktemp(f"sym{d}") / "store"))
            for d in (1, 2, 3, 4)}
    yield made
    for pool in made.values():
        pool.close()


def _state(n, *, seed=7):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(0.5, 2.0, n)]
    vel = np.c_[rng.standard_normal((n, 3)), rng.standard_normal(n)]
    return pos.astype(np.float32), vel.astype(np.float32)


def _cat(shards, k):
    return np.concatenate([s[k] for s in shards])


def _jax_sym(d, integrator, pos, vel):
    mesh = jax_make_mesh(d)
    step = jax_make_sharded_step(mesh, kernel="pallas", strategy="sym", tile_i=8, tile_j=128,
                                 interpret=True, integrator=integrator)
    return [np.asarray(a) for a in step(*jax_shard_state(mesh, pos, vel), DT, SOFT, DAMP)]


# ---- D gloo ranks against nbody_tpu's mesh ----


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_sym_step_matches_jax(pools, d, integrator):
    """Even D runs the antipodal quarters, odd D the offsets alone."""
    pos, vel = _state(d * NLOC[d])
    want = _jax_sym(d, integrator, pos, vel)
    res = pools[d].run("sym_step", integrator, pos, vel, DT, SOFT, DAMP)
    for k, w in enumerate(want):
        np.testing.assert_allclose(_cat(res, k), w, atol=FP32_ATOL)
    np.testing.assert_array_equal(_cat(res, 0)[:, 3], pos[:, 3])
    np.testing.assert_array_equal(_cat(res, 1)[:, 3], vel[:, 3])


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_rank_fields_equal_emulated_sym_bits_and_repeat(pools, d, integrator):
    """Each rank's force (and jerk) is emulated_sym's rows of its shard bit
    for bit, a second call gives the same bits, and so do two runs of three
    steps; the fields are the plain one-sided ones to float32 rounding."""
    pos, vel = _state(d * NLOC[d], seed=11)
    res = pools[d].run("sym_step", integrator, pos, vel, DT, SOFT, DAMP, 3)
    assert all(emulated and repeated for *_, emulated, repeated in res)
    p, v = torch.from_numpy(pos), torch.from_numpy(vel)
    want = (reference.compute_accel_jerk(p, v, SOFT) if integrator == "hermite"
            else (reference.compute_accel(p, SOFT),))
    for k, w in enumerate(want):
        got = np.concatenate([r[2][k] for r in res])
        scale = float(w.abs().max())
        assert np.abs(got - w.numpy()).max() <= 1e-5 * scale + 1e-5


def test_one_rank_sym_is_the_single_device_triangle(pools):
    """At D = 1 sym is the triangle alone: the mesh's force equals
    compute_accel_symmetric_blocked_cuda's (its plain version here) bit for
    bit, and emulated_sym's too."""
    pos, vel = _state(NLOC[1])
    (res,) = pools[1].run("sym_step", "euler", pos, vel, DT, SOFT, DAMP)
    want = ck.compute_accel_symmetric_blocked_cuda(torch.from_numpy(pos), SOFT)
    np.testing.assert_array_equal(res[2][0], want.numpy())
    assert torch.equal(emulated_sym(torch.from_numpy(pos), 1, SOFT), want)
    assert res[3] and res[4]


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_sub_blocked_rectangles_on_the_ranks(pools, integrator):
    """The caps forced to 128 (each rank's dispatch constants): shards of
    2 · 150 bodies run the triangle composition and j-sub-blocked quarter
    and offset rectangles; the ranks still equal emulated_sym under the
    same caps bit for bit and nbody_tpu's sym step with its own caps forced
    to 128 (tests/test_sharded.py:280-330)."""
    import nbody_tpu.ops.symmetric_kernel as symk

    pos, vel = _state(600, seed=13)
    res = pools[4].run("sym_step", integrator, pos, vel, DT, SOFT, DAMP, 1, SMALL_CAPS)
    assert all(r[3] for r in res)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(symk, "SYM_MAX_N", 128)
        mp.setattr(symk, "AJ_SYM_MAX_N", 128)
        want = _jax_sym(4, integrator, pos, vel)
    finally:
        mp.undo()
    for k, w in enumerate(want):
        np.testing.assert_allclose(_cat(res, k), w, atol=FP32_ATOL)


# ---- all D ranks in one process ----


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
@pytest.mark.parametrize("d", [5, 8])
def test_emulated_sym_matches_jax(d, integrator):
    """emulated_sym at D = 5 (odd) and 8 (even, four antipodal pairs), its
    force through the step's own integrators, against nbody_tpu's D = 5 and
    8 meshes."""
    pos, vel = _state(d * NLOC[d], seed=d)
    want = _jax_sym(d, integrator, pos, vel)
    p, v = torch.from_numpy(pos), torch.from_numpy(vel)
    if integrator == "hermite":
        got = reference.nbody_step_hermite(
            p, v, DT, SOFT, DAMP, accel_jerk_fn=lambda q, w: emulated_sym(q, d, SOFT, vel=w))
    else:
        got = reference.integrate(p, v, emulated_sym(p, d, SOFT), DT, DAMP)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_ATOL)


def test_emulated_sym_sub_blocks_at_the_forced_cap(monkeypatch):
    """The caps of ops/cuda_kernel.py forced to 128, the shards of 2 · 150
    sub-block; the force and jerk equal nbody_tpu's sub-blocked Hermite
    evaluation (its AJ_SYM_MAX_N forced to 128) within the bound, and the
    composition differs from the uncapped one (the sub-blocks ran)."""
    import nbody_tpu.ops.symmetric_kernel as symk

    pos, vel = _state(600, seed=17)
    p, v = torch.from_numpy(pos), torch.from_numpy(vel)
    uncapped = emulated_sym(p, 2, SOFT, vel=v)
    for k, val in SMALL_CAPS.items():
        monkeypatch.setattr(ck, k, val)
    monkeypatch.setattr(symk, "AJ_SYM_MAX_N", 128)
    capped = emulated_sym(p, 2, SOFT, vel=v)
    assert not all(torch.equal(a, b) for a, b in zip(capped, uncapped))
    jp, jv = jax_nbody_step_hermite(
        jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP,
        accel_jerk_fn=lambda q, w: compute_accel_jerk_xla(q, w, SOFT))
    want = _jax_sym(2, "hermite", pos, vel)
    got = reference.nbody_step_hermite(
        p, v, DT, SOFT, DAMP, accel_jerk_fn=lambda q, w: emulated_sym(q, 2, SOFT, vel=w))
    for g, w, single in zip(got, want, (jp, jv)):
        np.testing.assert_allclose(g.numpy(), w, atol=FP32_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(single), atol=FP32_ATOL)


def test_sym_rollout_is_its_steps_and_matches_jax(pools):
    """make_sharded_rollout(step, 3) equals three calls of the step bit for
    bit, and nbody_tpu's make_sharded_rollout of its sym step within the
    bound."""
    pos, vel = _state(2 * NLOC[2], seed=19)
    res = pools[2].run("rollout", "sym", "leapfrog", pos, vel, DT, SOFT, DAMP, 3)
    for rolled, stepped in res:
        for a, b in zip(rolled, stepped):
            np.testing.assert_array_equal(a, b)
    mesh = jax_make_mesh(2)
    jstep = jax_make_sharded_step(mesh, kernel="pallas", strategy="sym", tile_i=8, tile_j=128,
                                  interpret=True, integrator="leapfrog")
    want = jax_make_sharded_rollout(lambda p, v, dt, s, d: jstep(p, v, dt, s, d), 3)(
        *jax_shard_state(mesh, pos, vel), DT, SOFT, DAMP)
    for k, w in enumerate(want):
        np.testing.assert_allclose(np.concatenate([r[0][k] for r in res]), np.asarray(w),
                                   atol=FP32_ATOL)


# ---- systems, Compute and the CLI ----


def _params(n):
    from nbody_tpu_torch import tuned_scales

    cs, vs = tuned_scales(n) or (1.54, 8.0)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs, damping=DAMP)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_system_with_sym_strategy_matches_one_device(pools, integrator):
    """N = 99 on 3 ranks (shards of 33), three steps against the
    single-device system's sym variant."""
    n = 99
    params = _params(n)
    state = _state(n, seed=23)
    res = pools[3].run("system", "fp32", n, params,
                       {"integrator": integrator, "strategy": "sym"}, state, 3)
    one = BodySystem(n, params, device="cpu", state=state, integrator=integrator,
                     variant="sym")
    one.update_many(3)
    for pos, vel, acc, strategy, variant, _ in res:
        assert strategy == "sym" and variant == "vpu"
        np.testing.assert_allclose(pos, one.positions, atol=FP32_ATOL)
        np.testing.assert_allclose(vel, one.velocities, atol=FP32_ATOL)
        ref = one.accelerations().numpy()
        assert np.abs(acc - ref).max() < FP32_ATOL * max(1.0, np.abs(ref).max())


def test_compute_with_sym_strategy_passes_qa_everywhere(pools):
    res = pools[4].run("compute_checks", 128, {"strategy": "sym", "integrator": "hermite"}, 2)
    for passed, drift, pos in res:
        assert passed is True and drift == res[0][1]
        np.testing.assert_array_equal(pos, res[0][2])


def test_cli_strategy_sym_under_torchrun_on_three_gloo_ranks(tmp_path):
    """nbody-torch --cpu --devices 3 --strategy sym --qatest under torchrun,
    Euler and Hermite started together: each exits 0, and only rank 0
    prints (nbody_tpu refuses --cpu here, its sym being Pallas-only; the
    port runs the plain versions)."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    runs = (["--numbodies", "99"], ["--numbodies", "100", "--integrator", "hermite"])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "3",
         "-m", "nbody_tpu_torch.cli", "--cpu", "--devices", "3", "--strategy", "sym",
         "--qatest", *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in runs]
    outs = [proc.communicate(timeout=240) for proc in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0, err
        assert out.count("-> OK") == 1 and out.count("3-device mesh [sym]") == 1, out


def _fake_mesh(size=2):
    return Mesh(axis="bodies", size=size, rank=0, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("build, match", [
    (lambda: make_sharded_step(_fake_mesh(), strategy="sym", backend="torch"),
     "use backend='cuda'"),
    (lambda: make_sharded_step(_fake_mesh(1), strategy="sym")(
        *(torch.zeros(4, 4, dtype=torch.float64) for _ in range(2)), DT, SOFT, DAMP),
     "float32 each-pair-once"),
    (lambda: BodySystem(64, _params(64), device="cpu", mesh=_fake_mesh(), strategy="sym",
                        dtype=torch.float64), "float32 kernel path"),
    (lambda: BodySystem(64, _params(64), device="cpu", strategy="sym",
                        mesh=types.SimpleNamespace(axis_names=("rows", "cols"), size=4,
                                                   device=torch.device("cpu"))),
     "1-D body mesh"),
])
def test_sym_refusals_in_nbody_tpu_words(build, match):
    with pytest.raises(ValueError, match=match):
        build()


@pytest.mark.parametrize("n, d", [(99, 3), (74, 2), (140, 4), (165, 5), (280, 8)])
def test_auto_never_picks_sym(n, d):
    from nbody_tpu_torch.parallel import choose_strategy

    assert choose_strategy(n, d) in ("allgather", "ring")
    assert choose_strategy(n * 65536, d) == "ring"
