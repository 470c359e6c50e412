"""The port's native fp64 mode against nbody_tpu's float64 XLA path.

On the CPU the double kernels' wrappers (``ops/cuda_kernel.py``) run the
plain float64 versions, ``BodySystem(dtype=torch.float64)`` and
``Compute(precision="fp64")`` run them end to end, and each is held to the
JAX package with x64 on (restored after each test, as
``tests/test_body_system.py:99-109`` does). The inputs are made with numpy
from a seed and handed to both.

Tolerance: 1e-12 of the largest magnitude of each output. Both sides are
float64 and differ only in the order of their sums and where they fuse a
multiply-add, each a few units of 2^-53 (1.1e-16) of a term; a sum of up to
N = 1000 terms and five steps of them stay well inside 1e-12, while a
float32 step anywhere (2^-24, 6e-8) misses it by four orders.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from nbody_tpu.compute import Compute as JaxCompute
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops import energy as jax_energy
from nbody_tpu.ops import reference as jax_ref
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
from nbody_tpu_torch.cli import main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.ops import cuda_kernel, energy, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    compute_accel_cuda,
    compute_accel_jerk_cuda,
    nbody_step_cuda,
    nbody_step_cuda_vs,
    potential_energy_per_row_cuda,
)

SOFT, DT, DAMP = 0.1, 0.016, 0.5
RTOL = 1e-12


@pytest.fixture
def x64():
    """JAX's x64 on for the test, restored after it."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _state(n, seed=0):
    """float64 (pos, vel): positions and velocities normal, masses from
    [0.5, 2], a random vel.w (not a velocity: it must pass through)."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 4))
    pos[:, 3] = rng.uniform(0.5, 2.0, n)
    vel = rng.standard_normal((n, 4))
    return pos, vel


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def _params(n):
    cs, vs = tuned_scales(n)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs)


def _jax_params(params):
    return JaxNBodyParams(**dataclasses.asdict(params))


@pytest.mark.parametrize("n", [257, 1000])
def test_wrappers_match_jax_xla_in_float64(x64, n):
    """The four double wrappers, on CPU tensors their plain float64
    versions, against nbody_tpu's float64 XLA functions: the force, the
    step (vel.w and mass carried), accel + jerk and the potential's rows."""
    import jax.numpy as jnp

    pos, vel = _state(n, seed=n)
    # torch's own allocations: 32-byte aligned, as the double kernels read them
    p, v = torch.tensor(pos), torch.tensor(vel)
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    assert jp.dtype == jnp.float64
    _close(compute_accel_cuda(p, p, SOFT), jax_ref.compute_accel_xla_vs(jp, jp, SOFT))
    new_p, new_v = nbody_step_cuda(p, v, DT, SOFT, DAMP)
    want_p, want_v = jax_ref.nbody_step_xla(jp, jv, DT, SOFT, DAMP)
    _close(new_p, want_p)
    _close(new_v, want_v)
    assert np.array_equal(new_v[:, 3].numpy(), vel[:, 3])
    assert np.array_equal(new_p[:, 3].numpy(), pos[:, 3])
    acc, jerk = compute_accel_jerk_cuda(p, v, p, v, SOFT)
    want_a, want_j = jax_ref.compute_accel_jerk_xla(jp, jv, SOFT)
    _close(acc, want_a)
    _close(jerk, want_j)
    _close(potential_energy_per_row_cuda(p, SOFT), jax_energy.potential_energy_per_row(jp, SOFT))


def test_i_vs_j_step_matches_jax_xla_in_float64(x64):
    """The sharded form (M != N) of the step, float64 throughout."""
    import jax.numpy as jnp

    pj, _ = _state(1000, seed=1)
    pi, vi = _state(257, seed=2)
    got = nbody_step_cuda_vs(torch.tensor(pi), torch.tensor(vi), torch.tensor(pj), DT, SOFT,
                             DAMP)
    want = jax_ref.nbody_step_xla_vs(jnp.asarray(pi), jnp.asarray(vi), jnp.asarray(pj), DT,
                                     SOFT, DAMP)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
@pytest.mark.parametrize("n", [257, 1000])
def test_body_system_matches_jax_xla_in_float64(x64, integrator, n):
    """Five demo-0 steps of BodySystem(dtype=float64) against nbody_tpu's
    BodySystem(dtype=float64, backend="xla") from the same float64 state,
    and the energy of the end state (the float64 functional of both)."""
    import jax.numpy as jnp

    params = _params(n)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, params.cluster_scale, params.velocity_scale,
                           seed=5, dtype=np.float64)
    ours = BodySystem(n, params, device="cpu", dtype=torch.float64, integrator=integrator,
                      state=(pos, vel))
    ref = JaxBodySystem(n, _jax_params(params), dtype=jnp.float64, backend="xla",
                        integrator=integrator, state=(pos, vel))
    assert ours.dtype == torch.float64 and ours.variant == "vpu"
    ours.update_many(5)
    ref.update_many(5)
    _close(ours.positions, ref.positions)
    _close(ours.velocities, ref.velocities)
    e_ours = ours.total_energy(precise=True)
    e_ref = ref.total_energy(precise=True)
    assert abs(e_ours - e_ref) <= RTOL * abs(e_ref)
    assert abs(ours.total_energy() - e_ref) <= RTOL * abs(e_ref)


def test_body_system_reset_and_accessors_are_float64():
    """reset draws the ICs in float64 (nbody_tpu's rule), and every
    accessor keeps the type: buffers, positions, force, force and jerk."""
    n = 257
    params = _params(n)
    s = BodySystem(n, params, device="cpu", dtype=torch.float64, seed=3)
    pos, vel = ic.generate(NBodyConfig.SHELL, n, params.cluster_scale, params.velocity_scale,
                           seed=3, dtype=np.float64)
    assert np.array_equal(s.positions, pos) and np.array_equal(s.velocities, vel)
    assert s.state[0].dtype == torch.float64
    assert s.accelerations().dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in s.accelerations_and_jerks())


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_host_placement_equals_device_placement_in_float64(integrator):
    n = 257
    params = _params(n)
    dev = BodySystem(n, params, device="cpu", dtype=torch.float64, integrator=integrator)
    host = BodySystem(n, params, device="cpu", dtype=torch.float64, integrator=integrator,
                      placement="host")
    assert host.state[0].dtype == torch.float64
    dev.update_many(3)
    host.update_many(3)
    assert np.array_equal(dev.positions, host.positions)
    assert np.array_equal(dev.velocities, host.velocities)


@pytest.mark.parametrize("variant", ["mxu", "mxu_bf16"])
def test_mxu_variants_run_the_one_sided_force_in_float64(x64, variant):
    """nbody_tpu's float64 XLA path ignores the variant: an mxu request
    steps as the plain one-sided force. The port maps it to vpu, and both
    packages' mxu systems equal their vpu ones."""
    import jax.numpy as jnp

    n = 257
    params = _params(n)
    pos, vel = _state(n, seed=9)
    ours = BodySystem(n, params, device="cpu", dtype=torch.float64, variant=variant,
                      state=(pos, vel))
    vpu = BodySystem(n, params, device="cpu", dtype=torch.float64, variant="vpu",
                     state=(pos, vel))
    assert ours.variant == "vpu" and ours.mxu_force is None
    ref = JaxBodySystem(n, _jax_params(params), dtype=jnp.float64, backend="xla",
                        variant=variant, state=(pos, vel))
    ref_vpu = JaxBodySystem(n, _jax_params(params), dtype=jnp.float64, backend="xla",
                            variant="vpu", state=(pos, vel))
    for s in (ours, vpu, ref, ref_vpu):
        s.update_many(3)
    assert np.array_equal(ours.positions, vpu.positions)
    assert np.array_equal(ref.positions, ref_vpu.positions)
    _close(ours.positions, ref.positions)


def test_refusals_in_float64(x64):
    """sym raises in both packages (Pallas-only there, float32-only here),
    and so do the ring_fused and sym strategies on a mesh (a float64 mesh
    runs allgather, ring, auto and the 2-D step, tests/test_torch_sharded_2d.py);
    kernel="p3m" runs in float64 (tests/test_torch_pm.py), and so does its
    XLA cell-list engine, refused until it was ported: a step matches
    nbody_tpu's float64 system (the float32 mesh force under a float64
    update, rtol / atol 1e-5), and Compute runs the exact double force, as
    nbody_tpu's fp64 does."""
    import jax.numpy as jnp

    params = _params(256)
    with pytest.raises(ValueError, match="sym"):
        BodySystem(256, params, device="cpu", dtype=torch.float64, variant="sym")
    with pytest.raises(ValueError, match="sym"):
        JaxBodySystem(256, _jax_params(params), dtype=jnp.float64, backend="xla",
                      variant="sym")
    mesh = types.SimpleNamespace(axis_names=("bodies",), size=1, device=torch.device("cpu"))
    for strategy in ("ring_fused", "sym"):
        with pytest.raises(ValueError, match=f"strategy='{strategy}' is a float32 kernel path"):
            BodySystem(256, params, device="cpu", dtype=torch.float64, mesh=mesh,
                       strategy=strategy)
    s = BodySystem(256, params, device="cpu", dtype=torch.float64, kernel="p3m",
                   p3m_short_range="xla")
    ref = JaxBodySystem(256, _jax_params(params), dtype=jnp.float64, backend="p3m",
                        p3m_short_range="xla", state=(s.positions, s.velocities))
    s.update_many(1)
    ref.update_many(1)
    assert s.positions.dtype == np.float64 and s.p3m_short_range == "xla"
    np.testing.assert_allclose(s.positions, np.asarray(ref.positions), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.velocities, np.asarray(ref.velocities), rtol=1e-5, atol=1e-5)
    c = Compute(num_bodies=256, device="cpu", precision="fp64", kernel="p3m",
                p3m_short_range="xla", log=lambda line: None)
    assert c.system.kernel == "auto" and c.system.dtype == torch.float64
    assert c.compare_results()
    with pytest.raises(ValueError, match="dtype"):
        BodySystem(256, params, device="cpu", dtype=torch.float16)


def test_switch_precision_round_trip_in_both_packages(x64):
    """fp32 -> fp64 -> fp32 keeps the state (cast) and restores the
    requested variant: sym runs auto (vpu) in float64 and sym again after,
    in nbody_tpu (Pallas sym, XLA fp64) and in the port alike."""
    n = 256
    params = _params(n)
    ours = BodySystem(n, params, device="cpu", variant="sym", integrator="leapfrog", seed=4)
    assert ours.variant == "sym" and ours.dtype == torch.float32
    ours64 = ours.switch_precision()
    assert ours64.dtype == torch.float64 and ours64.variant == "vpu"
    assert ours64.integrator == "leapfrog"
    assert np.array_equal(ours64.positions, ours.positions.astype(np.float64))
    assert np.array_equal(ours64.velocities, ours.velocities.astype(np.float64))
    ours64.update_many(2)
    back = ours64.switch_precision()
    assert back.dtype == torch.float32 and back.variant == "sym"
    assert np.array_equal(back.positions, ours64.positions.astype(np.float32))

    ref = JaxBodySystem(n, _jax_params(params), variant="sym", backend="pallas",
                        interpret=True, integrator="leapfrog", seed=4)
    ref64 = ref.switch_precision()
    assert ref64.dtype == np.float64 and ref64.backend == "xla"
    ref32 = ref64.switch_precision()
    assert ref32.variant == "sym" and ref32.backend == "pallas"
    np.testing.assert_array_equal(ours.positions, ref.positions)


def test_compute_fp64_and_its_contradiction(x64):
    """Compute(fp64=True) and Compute(precision="fp64") are one request;
    fp64=True with another precision raises nbody_tpu's error."""
    for kw in ({"fp64": True}, {"precision": "fp64"}):
        c = Compute(num_bodies=256, device="cpu", log=lambda s: None, **kw)
        assert c.precision == "fp64" and c.fp64_enabled
        assert c.system.dtype == torch.float64 and c.system.variant == "vpu"
    for precision in ("fp32", "ds"):
        with pytest.raises(ValueError, match=f"fp64=True contradicts precision='{precision}'"):
            Compute(num_bodies=256, device="cpu", fp64=True, precision=precision)
        with pytest.raises(ValueError, match=f"fp64=True contradicts precision='{precision}'"):
            JaxCompute(num_bodies=256, fp64=True, precision=precision)


def test_compute_switch_precision_hops_and_ds_stays(x64):
    lines = []
    c = Compute(num_bodies=256, device="cpu", log=lines.append)
    pos32 = c.system.positions
    c.switch_precision()
    assert c.precision == "fp64" and c.fp64_enabled and c.system.dtype == torch.float64
    assert np.array_equal(c.system.positions, pos32.astype(np.float64))
    c.switch_precision()
    assert c.precision == "fp32" and not c.fp64_enabled and c.system.dtype == torch.float32
    ds = Compute(num_bodies=64, device="cpu", precision="ds", log=lines.append)
    ds.switch_precision()
    assert ds.precision == "ds" and "precision fixed" in lines[-1]


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "hermite"])
def test_compute_fp64_qa_passes_and_benchmark_counts_30_flops(integrator):
    lines = []
    c = Compute(num_bodies=256, device="cpu", precision="fp64", integrator=integrator,
                log=lines.append)
    assert c.compare_results()
    assert "float64" in lines[-1] and "-> OK" in lines[-1]
    if integrator == "hermite":
        assert "max |djerk|" in lines[-1]
    res = c.run_benchmark(2)
    assert res["fp64"] is True
    assert any("double-precision GFLOP/s at 30 flops per interaction" in s for s in lines)


def test_fp64_qa_fails_a_float32_grade_force():
    """One QA step hides a float32-grade force in the positions; the fp64
    QA's force check at the ds grade does not."""
    c = Compute(num_bodies=256, device="cpu", precision="fp64", log=lambda s: None)
    exact = c.system.accelerations
    c.system.accelerations = lambda: exact().float().double()
    assert not c.compare_results()
    c.system.accelerations = exact
    assert c.compare_results()


def test_fp64_drift_check_uses_one_float64_functional():
    c = Compute(num_bodies=256, device="cpu", precision="fp64", integrator="hermite",
                log=lambda s: None)
    pos0 = c.system.positions
    drift = c.drift_check(3)
    assert drift["steps"] == 3 and drift["delta"] < 1e-12
    assert np.array_equal(c.system.positions, pos0)


def test_double_wrappers_take_float64_without_a_cast_and_refuse_the_rest():
    pos, vel = (torch.tensor(a) for a in _state(64, seed=3))
    assert compute_accel_cuda(pos, pos, SOFT).dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in nbody_step_cuda(pos, vel, DT, SOFT, DAMP))
    assert all(t.dtype == torch.float64
               for t in compute_accel_jerk_cuda(pos, vel, pos, vel, SOFT))
    assert potential_energy_per_row_cuda(pos, SOFT).dtype == torch.float64
    with pytest.raises(TypeError, match="share a type"):
        compute_accel_cuda(pos, pos.float(), SOFT)
    with pytest.raises(TypeError, match="share a type"):
        nbody_step_cuda_vs(pos, vel.float(), pos, DT, SOFT, DAMP)
    with pytest.raises(TypeError, match="share a type"):
        compute_accel_jerk_cuda(pos, vel, pos.float(), vel.float(), SOFT)
    with pytest.raises(TypeError, match="float32 only"):
        cuda_kernel.sym_accel_cuda(pos, SOFT)
    with pytest.raises(TypeError, match="float32 only"):
        cuda_kernel.nbody_step_mxu_cuda(pos, vel, DT, SOFT, DAMP, variant="mxu")
    with pytest.raises(TypeError, match="float32 or float64"):
        compute_accel_cuda(pos.half(), pos.half(), SOFT)
    # float64 bodies are read as two 16-byte halves: 32-byte alignment
    flat = torch.zeros(64 * 4 + 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="32-byte"):
        compute_accel_cuda(flat[2:].view(64, 4), pos, SOFT)


def test_f64_splits_follow_the_rule():
    assert cuda_kernel.f64_splits(16384, 16384) == 32
    assert cuda_kernel.f64_splits(65536, 65536) == 8
    assert cuda_kernel.f64_splits(16384, 65536) == 32
    assert cuda_kernel.f64_splits(1, 100) == 1
    assert cuda_kernel.f64_splits(0, 100) == 1


def test_precise_energy_on_the_cpu_keeps_the_host_functional():
    pos, vel = _state(300, seed=8)
    want = energy.total_energy_f64(pos, vel, SOFT)
    assert energy.total_energy_precise(pos, vel, SOFT) == want
    assert energy.total_energy_precise(torch.from_numpy(pos), torch.from_numpy(vel), SOFT,
                                       device="cpu") == want


def test_cli_fp64_qatest(capsys):
    assert main(["--fp64", "--qatest", "--cpu", "--numbodies", "256"]) == 0
    out = capsys.readouterr().out
    assert "fp64]" in out and "float64" in out and "-> OK" in out


def test_cli_precision_fp64_benchmark(capsys):
    assert main(["--precision", "fp64", "--benchmark", "--cpu", "--numbodies", "256",
                 "-i", "2"]) == 0
    assert "double-precision GFLOP/s at 30 flops per interaction" in capsys.readouterr().out


@pytest.mark.parametrize("integrator", ["euler", "hermite"])
def test_cli_fp64_drift_check(capsys, integrator):
    assert main(["--fp64", "--drift-check", "3", "--cpu", "--numbodies", "256",
                 "--integrator", integrator]) == 0
    assert "energy drift over 3 steps" in capsys.readouterr().out


def test_cli_fp64_with_ds_exits_1_in_nbody_tpus_words(capsys):
    assert main(["--fp64", "--precision", "ds", "--qatest", "--cpu", "--numbodies", "64"]) == 1
    assert "--precision ds and --fp64 are exclusive" in capsys.readouterr().err


# --fp64 --kernel p3m runs the exact force since the mesh solvers' slice,
# as nbody_tpu's fp64 does, and so with --p3m-short-range xla since the
# cell-list engine was ported (tests/test_torch_pm.py); the second case
# adds to those flags the refusal that remains, nbody_tpu's of --variant sym
@pytest.mark.parametrize("args, says", [
    (["--variant", "sym"], "variant='sym'"),
    (["--kernel", "p3m", "--p3m-short-range", "xla", "--variant", "sym"], "variant='sym'"),
])
def test_cli_fp64_refusals_exit_2(capsys, args, says):
    assert main(["--fp64", *args, "--qatest", "--cpu", "--numbodies", "64"]) == 2
    assert says in capsys.readouterr().err


def test_cli_fp64_tipsy_and_hostmem(tmp_path, capsys):
    from nbody_tpu.io import write_tipsy_file

    pos, vel = _state(200, seed=6)
    pos[:, :3] *= 0.5
    vel[:, :3] *= 0.1
    vel[:, 3] = 0.0
    path = tmp_path / "g.tipsy"
    write_tipsy_file(str(path), pos, vel)
    assert main(["--fp64", "--qatest", "--cpu", "--hostmem", "--tipsy", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"bodies from {path}" in out and "host memory" in out and "-> OK" in out


def test_cpu_tensors_launch_no_double_kernel():
    pos, vel = (torch.tensor(a) for a in _state(64, seed=4))
    before = dict(cuda_kernel.LAUNCHES)
    nbody_step_cuda(pos, vel, DT, SOFT, DAMP)
    compute_accel_cuda(pos, pos, SOFT)
    compute_accel_jerk_cuda(pos, vel, pos, vel, SOFT)
    potential_energy_per_row_cuda(pos, SOFT)
    assert cuda_kernel.LAUNCHES == before
    assert all(k in cuda_kernel.LAUNCHES
               for k in ("step_f64", "accel_f64", "accel_jerk_f64", "potential_f64"))


def test_the_split_rules_tile_is_the_kernels():
    """f64_splits' i-tile is the default block (256 threads) times the
    kernel's rows a thread, and its stage the shared fp32 stage."""
    import re

    src = (cuda_kernel.__file__.rsplit("/ops/", 1)[0] + "/csrc/f64_kernels.cu")
    rows = int(re.search(r"constexpr int kF64Rows = (\d+);", open(src).read()).group(1))
    assert cuda_kernel.F64_TILE_I == cuda_kernel.DEFAULT_BLOCK_SIZE * rows
    assert "step_chunk(n, splits)" in open(src).read()


def _smoke():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("key", ["step_f64", "accel_f64", "accel_jerk_f64", "potential_f64"])
def test_chip_smoke_guards_the_double_walks(key, inside, capsys):
    """Phase 3f runs step_walks_checked over the double kernels' walks: a
    local-memory access (a spill) inside one fails, none passes and prints
    the walk's SASS count a pair under its own tag."""
    from nbody_tpu_torch.ops import _build

    smoke = _smoke()
    piece = smoke.F64_WALKS[key]
    ins = ["LDS.128 R4, [R2]", "DADD R6, R4, -R8", "MUFU.RSQ64H R11, R7",
           "LDL R3, [R1+0x8]" if inside else "DFMA R12, R10, R6, R12", "@!P0 BRA 0x0", "EXIT"]
    text = "\n".join(["\tcode for sm_90a",
                      f"\t\tFunction : _ZN12_GLOBAL__N_1{piece}ILi2ELi512EEEvPK7double2"]
                     + [f"        /*{16 * k:04x}*/                   {op} ;"
                        for k, op in enumerate(ins)]) + "\n"
    build = types.SimpleNamespace(**{k: getattr(_build, k) for k in (
        "sass_functions", "sass_loops", "sass_class")}, demangle=lambda u: {})
    if inside:
        with pytest.raises(RuntimeError, match="spills inside its walk"):
            smoke.step_walks_checked(build, {}, text, (piece,), "f64_kernels.cu",
                                     tag="[3f sass]")
        return
    smoke.step_walks_checked(build, {}, text, (piece,), "f64_kernels.cu", tag="[3f sass]")
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[3f sass]")]
    assert piece in line and "5.00 SASS instructions a pair, 0 local accesses inside" in line
    loop, = _build.sass_loops(text, piece)
    assert loop["mix"]["fp64"] == 2 and loop["mix"]["mufu"] == 1
