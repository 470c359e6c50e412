"""The tensor-core force variants (variant="mxu" / "mxu_bf16") and the
transposed-carry rollout of nbody_tpu_torch, on the CPU, against nbody_tpu.

The plain mxu step (ops/reference.py) is held to nbody_tpu's
``_mxu_step_kernel`` in interpret mode under the mxu error model: each
velocity within MXU_ERROR_COEF[variant] * E * dt (E_ik = sum_j |s_ij|
(|P_jk| + |p_ik| m_j)) plus the update's own rounding, and each position
within dt times that (``reference.mxu_step_tolerance``). bf16 rounds s and P
on both sides, so the two may round one s to neighbouring bf16 values
(2 * 2^-8 relative); f32 differs in the last bits of s and in the order of
the sums (16 * 2^-20). Against the oracle, both hold the reference's QA
position rule, |dpos| <= 5e-4 after one dt=1e-3 step. The CUDA kernels
themselves run on the card, in tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import NBodyConfig as JaxNBodyConfig
from nbody_tpu import ic as jax_ic
from nbody_tpu.models import BodySystem as JaxBodySystem
from nbody_tpu.ops.pallas_kernel import nbody_rollout_pallas, nbody_step_pallas
from nbody_tpu.params import NBodyParams as JaxNBodyParams

from conftest import assert_state_close
from nbody_tpu_torch import DEMO_PARAMS, NBodyConfig, ic, tuned_scales
from nbody_tpu_torch.cli import drift_failed, main
from nbody_tpu_torch.compute import Compute
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.oracle import step_best
from nbody_tpu_torch.ops import cuda_kernel, reference
from nbody_tpu_torch.ops.cuda_kernel import (
    nbody_rollout_cuda,
    nbody_step_mxu_cuda,
    nbody_step_mxu_cuda_vs,
)
from nbody_tpu_torch.ops.energy import total_energy_f64

DT, SOFT, DAMP = 0.001, 0.1, 1.0
TI, TJ = 64, 256  # tests/test_pallas.py's tiles
VARIANTS = ("mxu", "mxu_bf16")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small eager (C, N) tensors: beside the suite's other worker processes,
    intra-op threads only wait for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _held(pos, vel, got, want, dt, damping, variant):
    """got (pos', vel') of the port and want of nbody_tpu (numpy), from
    (pos, vel): within the mxu step's error model, w lanes equal."""
    p, v = _t(pos), _t(vel)
    gp, gv = (_t(x) for x in got)
    wp, wv = (_t(x) for x in want)
    tol_p, tol_v = reference.mxu_step_tolerance(p, v, p, (wp, wv), dt, SOFT, damping,
                                                variant=variant)
    rp = ((gp[:, :3] - wp[:, :3]).abs() / tol_p).max().item()
    rv = ((gv[:, :3] - wv[:, :3]).abs() / tol_v).max().item()
    assert rp <= 1.0 and rv <= 1.0, f"error / bound: positions {rp:.3g}, velocities {rv:.3g}"
    assert torch.equal(gp[:, 3], p[:, 3]) and torch.equal(gv[:, 3], v[:, 3])
    return max(rp, rv)


def _fuzz_cases():
    return [(c, seed) for c in JaxNBodyConfig for seed in (0, 1)]


def _pallas_step(pos, vel, dt, damping, variant, tile_j):
    return nbody_step_pallas(jnp.asarray(pos), jnp.asarray(vel), dt, SOFT, damping,
                             tile_i=TI, tile_j=tile_j, interpret=True, variant=variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [512, 300])
def test_plain_mxu_step_matches_pallas(random_state_tiny, variant, n):
    # N=300 pads the j-set with zero-mass bodies in nbody_tpu
    # (test_mxu_variant_zero_mass_padding); the port does not pad
    pos, vel = (a[:n] for a in random_state_tiny)
    got = reference.nbody_step_mxu(_t(pos), _t(vel), DT, SOFT, DAMP,
                                   mxu_dtype=reference.MXU_DTYPES[variant])
    want = _pallas_step(pos, vel, DT, DAMP, variant, TJ)
    _held(pos, vel, got, [np.asarray(w) for w in want], DT, DAMP, variant)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("config, seed", _fuzz_cases())
def test_plain_mxu_step_matches_pallas_every_config(variant, config, seed):
    # test_fuzz_pallas_vs_oracle's cases, with masses from [0.5, 2], a random
    # vel.w and damping 0.5, which unit masses and damping 1 cannot tell from
    # a step that weights a pair by m_i, drops the damping or zeroes vel.w
    pos, vel = jax_ic.generate(config, 384, 1.3, 3.0, seed=seed)
    rng = np.random.default_rng(seed + 10)
    pos[:, 3] = rng.uniform(0.5, 2.0, 384)
    vel[:, 3] = rng.standard_normal(384)
    got = reference.nbody_step_mxu(_t(pos), _t(vel), 0.016, SOFT, 0.5,
                                   mxu_dtype=reference.MXU_DTYPES[variant])
    want = _pallas_step(pos, vel, 0.016, 0.5, variant, 128)
    _held(pos, vel, got, [np.asarray(w) for w in want], 0.016, 0.5, variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_mxu_step_passes_the_qa_rule_against_the_oracle(random_state_tiny, variant):
    pos, vel = random_state_tiny
    got, _ = reference.nbody_step_mxu(_t(pos), _t(vel), DT, SOFT, DAMP,
                                      mxu_dtype=reference.MXU_DTYPES[variant])
    ref_pos, _ = step_best(pos, vel, DT, SOFT, DAMP)
    assert_state_close(got.numpy(), ref_pos)


@pytest.mark.parametrize("variant", VARIANTS)
def test_error_model_bounds_the_force_against_float64(variant):
    # the same algebra in float64 (no bf16 rounding): the plain float32
    # evaluation stays within MXU_ERROR_COEF * E of it
    pos, _ = ic.generate(NBodyConfig.SHELL, 500, 1.52, 2.0, seed=5)
    p = _t(pos)
    got = reference.compute_accel_mxu_vs(p, p, SOFT, variant=variant)
    p64 = p.double()
    s = reference._mxu_s_rows(p64[:, :3], p64[:, :3], SOFT ** 2)
    sp = s @ reference._mxu_fold(p64)
    exact = sp[:, :3] - p64[:, :3] * sp[:, 3:4]
    bound = reference.MXU_ERROR_COEF[variant] * reference.mxu_error_scale(p, p, SOFT).double()
    assert ((got.double() - exact).abs() <= bound).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_force_is_chunk_invariant_and_cpu_wrapper_is_plain(random_state_tiny, variant):
    pos, vel = random_state_tiny
    p, v = _t(pos), _t(vel)
    whole = reference.compute_accel_mxu_vs(p, p, SOFT, variant=variant)
    chunked = reference.compute_accel_mxu_vs(p, p, SOFT, variant=variant, chunk_size=100)
    assert torch.equal(whole, chunked)
    before = dict(cuda_kernel.LAUNCHES)
    out = (torch.empty_like(p), torch.empty_like(v))
    res = nbody_step_mxu_cuda(p, v, DT, SOFT, DAMP, variant=variant, out=out)
    plain = reference.nbody_step_mxu(p, v, DT, SOFT, DAMP,
                                     mxu_dtype=reference.MXU_DTYPES[variant])
    assert res[0] is out[0] and res[1] is out[1]
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    gp, gv = nbody_step_mxu_cuda_vs(p[:100], v[:100], p, DT, SOFT, DAMP, variant=variant)
    assert torch.equal(gp, plain[0][:100]) and torch.equal(gv, plain[1][:100])
    assert cuda_kernel.LAUNCHES == before


@pytest.mark.parametrize("kw, exc", [
    ({"variant": "tensor-core"}, ValueError),
    ({"variant": "mxu", "dtype": torch.float64}, TypeError),
    ({"variant": "mxu", "overlap": True}, ValueError),
    ({"variant": "mxu_bf16", "rows": 3}, ValueError),
])
def test_mxu_wrapper_refuses_bad_arguments(kw, exc):
    p = torch.zeros((8, 4), dtype=kw.get("dtype", torch.float32))
    v = torch.zeros((kw.get("rows", 8), 4), dtype=p.dtype)
    out = (p, torch.zeros((8, 4))) if kw.get("overlap") else None
    with pytest.raises(exc):
        nbody_step_mxu_cuda(p, v, DT, SOFT, DAMP, variant=kw["variant"], out=out)


def _params(n):
    cs, vs = tuned_scales(n)
    return DEMO_PARAMS[0].replace(cluster_scale=cs, velocity_scale=vs)


@pytest.mark.parametrize("variant", VARIANTS)
def test_body_system_and_compute_match_jax_interpret(variant):
    # k steps of both systems, each from nbody_tpu's state of the step
    # before, held to the one-step error model
    n, k = 256, 3
    params = _params(n)
    state = ic.generate(NBodyConfig.SHELL, n, params.cluster_scale, params.velocity_scale,
                        seed=11)
    port = BodySystem(n, params, device="cpu", variant=variant, state=state)
    ref = JaxBodySystem(n, JaxNBodyParams(**dataclasses.asdict(params)), backend="pallas",
                        interpret=True, variant=variant, state=state)
    for _ in range(k):
        pos, vel = ref.positions, ref.velocities
        port.set_state(pos, vel)
        port.update()
        ref.update()
        _held(pos, vel, (port.positions, port.velocities),
              (ref.positions, ref.velocities), params.time_step, params.damping, variant)
    # Compute steps its BodySystem: the same bits as the port's own k steps
    c = Compute(num_bodies=n, device="cpu", variant=variant, cycle_demo=False,
                log=lambda s: None)
    c.system.set_state(*state)
    c.update_params(time_step=params.time_step)
    c.update_simulation(steps=k)
    free = BodySystem(n, params, device="cpu", variant=variant, state=state)
    free.update_many(k)
    assert c.system.variant == variant and c.steps_taken == k
    assert np.array_equal(c.system.positions, free.positions)
    assert np.array_equal(c.system.velocities, free.velocities)


def test_mxu_bf16_energy_drift_is_nbody_tpus():
    # bf16's drift is the JAX function's own: over 10 steps at N=1024 the
    # port's relative energy drift is nbody_tpu's interpret-mode kernel's
    # to 1 %, and it fails the --drift-check gate against the one-sided
    # step's drift (which the oracle's matches to ~1e-8)
    n = 1024
    params = _params(n)
    state = ic.generate(NBodyConfig.SHELL, n, params.cluster_scale, params.velocity_scale,
                        seed=42)
    port = BodySystem(n, params, device="cpu", variant="mxu_bf16", state=state)
    vpu = BodySystem(n, params, device="cpu", variant="vpu", state=state)
    ref = JaxBodySystem(n, JaxNBodyParams(**dataclasses.asdict(params)), backend="pallas",
                        interpret=True, variant="mxu_bf16", state=state)
    e0 = total_energy_f64(*state, SOFT)
    drift = []
    for system in (port, vpu, ref):
        system.update_many(10)
        drift.append((total_energy_f64(system.positions, system.velocities, SOFT) - e0) / abs(e0))
    d_port, d_vpu, d_ref = drift
    assert abs(d_port - d_ref) <= 0.01 * abs(d_ref)
    assert drift_failed({"drift_oracle": d_vpu, "delta": abs(d_port - d_vpu)})


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("integrator", ["leapfrog", "hermite"])
def test_leapfrog_and_hermite_keep_the_one_sided_kernels(variant, integrator):
    params = _params(256)
    systems = [BodySystem(256, params, device="cpu", variant=v, integrator=integrator, seed=3)
               for v in (variant, "vpu")]
    for s in systems:
        s.update_many(2)
    assert systems[0].variant == variant and systems[0].mxu_force is None
    assert np.array_equal(systems[0].positions, systems[1].positions)
    assert np.array_equal(systems[0].velocities, systems[1].velocities)
    assert torch.equal(systems[0].accelerations(), systems[1].accelerations())


@pytest.mark.parametrize("variant", VARIANTS)
def test_compare_results_holds_the_mxu_force(variant):
    lines = []
    c = Compute(num_bodies=512, device="cpu", variant=variant, log=lines.append)
    before = c.system.positions
    p = _t(before)
    acc = c.system.accelerations()
    # the force of the QA is the mxu step's own, which is not the one-sided one
    assert torch.equal(acc, reference.compute_accel_mxu_vs(p, p, c.active_params.softening,
                                                           variant=variant))
    assert not torch.equal(acc, reference.compute_accel(p, c.active_params.softening))
    assert np.array_equal(c.system.positions, before)
    assert c.compare_results() is True
    assert f"{variant} error model" in lines[-1] and "-> OK" in lines[-1]
    assert np.array_equal(c.system.positions, before)


def test_compare_results_fails_on_a_wrong_mxu_force(monkeypatch):
    c = Compute(num_bodies=512, device="cpu", variant="mxu", log=lambda s: None)
    real = c.system.accelerations
    monkeypatch.setattr(c.system, "accelerations", lambda: real() * 1.001)
    assert c.compare_results() is False


@pytest.mark.parametrize("variant", VARIANTS)
def test_cli_qatest_on_cpu(capsys, variant):
    assert main(["--variant", variant, "--qatest", "--numbodies", "512", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"force {variant}, integrator euler" in out and "-> OK" in out


def test_cli_refuses_ds_with_mxu(capsys):
    # nbody_tpu's ds measurement modes run without the variant (_run_ds,
    # cli.py:454-462); its demo path's refusal (:487-490) has no port yet
    assert main(["--precision", "ds", "--variant", "mxu", "--qatest", "--cpu",
                 "--numbodies", "64"]) == 0
    out = capsys.readouterr().out
    assert "--precision ds: --variant mxu (the ds default, auto, runs) has no effect" in out
    assert "force mxu" not in out and "-> OK" in out


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_rollout_matches_pallas_and_the_plain_steps(shell_state_small, steps):
    pos, vel = (a[:300] for a in shell_state_small)
    p, v = _t(pos), _t(vel)
    before = dict(cuda_kernel.LAUNCHES)
    gp, gv = nbody_rollout_cuda(p, v, DT, SOFT, DAMP, steps=steps)
    rp, rv = reference.rollout(p, v, DT, SOFT, DAMP, steps=steps)
    assert torch.equal(gp, rp) and torch.equal(gv, rv)
    assert cuda_kernel.LAUNCHES == before
    if steps:
        kp, kv = nbody_rollout_pallas(jnp.asarray(pos), jnp.asarray(vel), DT, SOFT, DAMP,
                                      steps=steps, tile_i=TI, tile_j=TJ, interpret=True)
        # the step's tolerance (tests/test_torch_kernel.py)
        np.testing.assert_allclose(gp.numpy(), np.asarray(kp), atol=1e-6)
        np.testing.assert_allclose(gv.numpy(), np.asarray(kv), atol=1e-6)


@pytest.mark.parametrize("kw", [{"steps": -1}, {"steps": 2, "block_size": 48}])
def test_rollout_refuses_bad_arguments(kw):
    p = torch.zeros((8, 4))
    with pytest.raises(ValueError):
        nbody_rollout_cuda(p, p.clone(), DT, SOFT, DAMP, **kw)
