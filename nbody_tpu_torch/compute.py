"""Compute facade: demo cycling, benchmark, QA compare, perf stats.

Counterpart of ``nbody_tpu/compute.py`` (the reference's ``Compute``): owns a
BodySystem, the 7-demo preset state machine with its 10 s auto-cycle, the
N-bucketed scale tuning, the benchmark (one untimed warm-up step, then CUDA
events around the timed steps, and the reference's result formulas and
printout), the QA compare against the CPU oracle (one dt=0.001 step,
|dpos| <= 5e-4) and the energy-drift check against the oracle.

``precision="ds"`` owns a ``DSBodySystem`` (double-single, fp64-grade)
behind the same facade, as ``nbody_tpu/compute.py:135-168`` does, with its
mapping of variants; its QA and drift checks hold it to the float64 oracle
at ds-grade bounds.

``kernel="p3m"`` owns a ``BodySystem(kernel="p3m")``, the P3M fast mode,
whose force differs from the all-pairs oracle's by its mesh error by
design: as in ``nbody_tpu``, its QA gates the positions only (the force
error is reported), its benchmark rate is the pairwise-equivalent one, and
the CLI reports its drift without gating it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.oracle import accel_numpy, native_available, step_best
from nbody_tpu_torch.oracle.numpy_oracle import accel_jerk_numpy
from nbody_tpu_torch.params import (
    DEMO_PARAMS,
    DEMO_TIME_S,
    flops_per_interaction,
    gflops,
    interactions_per_second,
    tuned_scales,
)
from nbody_tpu_torch.models import BodySystem, DSBodySystem
from nbody_tpu_torch.models.body_system import not_ported, resolve_device
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.ops.cuda_kernel import DEFAULT_BLOCK_SIZE
from nbody_tpu_torch.ops.ds import ds_to_f64
from nbody_tpu_torch.ops.energy import total_energy_f64, total_energy_precise
from nbody_tpu_torch.utils.timing import elapsed_ms

QA_TOLERANCE = 5e-4
QA_DT = 0.001
# the force check beside the QA step: the kernel tolerance of
# tests/test_pallas.py:76 as a bound on max|da| against the oracle
QA_ACCEL_RTOL = 1e-4
QA_ACCEL_ATOL = 1e-4
# with integrator="hermite" the jerk of the accel + jerk kernel is held to
# the oracle's by the same rule, 1e-4 * max|j| + 1e-4; the plain version
# meets it at N=16384 (max|dj| 0.033 against a bound of 0.59, shell ICs,
# demo 0, float32 native oracle)
QA_JERK_RTOL = 1e-4
QA_JERK_ATOL = 1e-4
# precision="ds" is held to the float64 oracle at the ds grade: |dpos| <=
# 1e-10 after the QA step (nbody_tpu/cli.py:402), and the force of the
# state within 1e-10 * max|a| + 1e-12, which a float32-grade force misses
# by three orders while its dt^2-shrunk position error would pass; with
# integrator="hermite" the jerk too, within 1e-10 * max|j| + 1e-12
DS_QA_TOLERANCE = 1e-10
DS_QA_ACCEL_RTOL = 1e-10
DS_QA_ACCEL_ATOL = 1e-12
# the steps over which the ds drift check holds ds-grade parity with the
# oracle before chaos amplifies rounding differences (nbody_tpu/cli.py:338-349)
DS_PARITY_HORIZON = 50


def default_num_bodies(device, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """The reference's default N, ``4 * blockSize * SM count``
    (compute_cuda.cpp:113), on a CUDA device; 4096 on the CPU
    (compute_cpu.cpp:31)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 4096
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 * int(block_size) * int(sms)


def _oracle_accel(pos: np.ndarray, softening: float) -> np.ndarray:
    if native_available():
        from nbody_tpu_torch.oracle.native import accel_native

        return accel_native(pos, softening)
    return accel_numpy(pos, softening)


def _oracle_accel_jerk(pos: np.ndarray, vel: np.ndarray, softening: float):
    if native_available():
        from nbody_tpu_torch.oracle.native import accel_jerk_native

        return accel_jerk_native(pos, vel, softening)
    return accel_jerk_numpy(pos, vel, softening)


def _oracle_rollout(pos, vel, dt, softening, damping, *, steps: int, integrator: str):
    """`steps` oracle steps from (pos, vel): one native rollout call when
    the native library is there, else the NumPy oracle step by step."""
    if native_available():
        from nbody_tpu_torch.oracle.native import step_native

        return step_native(pos, vel, dt, softening, damping, steps=steps,
                           integrator=integrator)
    for _ in range(steps):
        pos, vel = step_best(pos, vel, dt, softening, damping, integrator=integrator)
    return pos, vel


class Compute:
    def __init__(
        self,
        *,
        num_bodies: Optional[int] = None,
        device="cuda",
        backend: str = "auto",
        block_size: Optional[int] = None,
        placement: str = "device",
        variant: str = "auto",
        integrator: str = "euler",
        precision: Optional[str] = None,
        kernel: str = "auto",
        pm_grid: int = 64,
        p3m_capacity: Optional[int] = None,
        cycle_demo: bool = True,
        seed: int = 42,
        tipsy_state: Optional[tuple] = None,
        log=print,
    ):
        device = resolve_device(device)
        precision = "fp32" if precision is None else precision
        if precision == "fp64":
            raise not_ported("precision", "fp64")
        if precision not in ("fp32", "ds"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "ds" and kernel != "auto":
            # nbody_tpu/compute.py:135-139
            raise ValueError(
                "precision='ds' runs the double-single kernels; kernel must be "
                f"'auto' (got {kernel!r})")
        if precision == "ds" and placement != "device":
            raise ValueError("precision='ds' keeps state on device (no placement='host')")
        if precision == "ds":
            # nbody_tpu/compute.py:143-158: every variant but sym and one_sided
            # runs the ds default
            if variant not in ("auto", "vpu", "sym", "one_sided"):
                raise ValueError(
                    f"precision='ds' variants are 'auto'/'sym'/"
                    f"'one_sided' (got {variant!r})")
            variant = variant if variant in ("sym", "one_sided") else "auto"
        self.precision = precision
        self.kernel = kernel
        self.log = log
        self.paused = False
        self.fp64_enabled = False
        self.cycle_demo = cycle_demo
        self.active_demo = 0
        self.active_params = DEMO_PARAMS[0]
        self.interactions_per_second = 0.0
        self.g_flops = 0.0
        self.fps = 0.0
        self._tipsy_state = tipsy_state
        self.steps_taken = 0

        if tipsy_state is not None:
            num_bodies = tipsy_state[0].shape[0]
        elif num_bodies is None:
            num_bodies = default_num_bodies(
                device, DEFAULT_BLOCK_SIZE if block_size is None else block_size)

        scales = tuned_scales(num_bodies)
        if scales is not None:
            self.active_params = self.active_params.replace(
                cluster_scale=scales[0], velocity_scale=scales[1])

        if precision == "ds":
            self.system = DSBodySystem(
                num_bodies,
                self.active_params,
                device=device,
                backend=backend,
                block_size=block_size,
                variant=variant,
                integrator=integrator,
                seed=seed,
                state=tipsy_state,
            )
        else:
            self.system = BodySystem(
                num_bodies,
                self.active_params,
                device=device,
                backend=backend,
                block_size=block_size,
                placement=placement,
                variant=variant,
                integrator=integrator,
                kernel=kernel,
                pm_grid=pm_grid,
                p3m_capacity=p3m_capacity,
                seed=seed,
                state=tipsy_state,
            )
        self.num_bodies = self.system.num_bodies
        self._demo_reset_time = time.monotonic()

    # ---- demo state machine ----

    def _select_demo(self, camera=None) -> None:
        self.active_params = DEMO_PARAMS[self.active_demo]
        if camera is not None:
            camera.reset(self.active_params.camera_origin)
        self.reset(NBodyConfig.SHELL)
        self._demo_reset_time = time.monotonic()

    def next_demo(self, camera=None) -> None:
        self.active_demo = (self.active_demo + 1) % len(DEMO_PARAMS)
        self._select_demo(camera)

    def previous_demo(self, camera=None) -> None:
        self.active_demo = (self.active_demo - 1) % len(DEMO_PARAMS)
        self._select_demo(camera)

    def toggle_cycle_demo(self) -> None:
        self.cycle_demo = not self.cycle_demo
        self._demo_reset_time = time.monotonic()

    def pause(self) -> None:
        self.paused = not self.paused

    def update_simulation(self, camera=None, steps: int = 1) -> None:
        """Advance one frame of `steps` steps, after cycling to the next
        demo every DEMO_TIME_S when cycling is on."""
        if self.cycle_demo and time.monotonic() - self._demo_reset_time > DEMO_TIME_S:
            self.next_demo(camera)
        if not self.paused:
            self.system.update_many(steps, self.active_params.time_step)
            self.steps_taken += steps

    def reset(self, config: NBodyConfig, seed: Optional[int] = None) -> None:
        if self._tipsy_state is not None:
            self.system.set_state(*self._tipsy_state)
            self.system.update_params(self.active_params)
        else:
            self.system.reset(self.active_params, config, seed=seed)

    def update_params(self, **kw) -> None:
        """Live parameter change (the reference's sliders): softening,
        damping, time_step, cluster_scale, velocity_scale."""
        self.active_params = self.active_params.replace(**kw)
        self.system.update_params(self.active_params)

    # ---- perf ----

    def compute_perf_stats(self, steps_per_second: float) -> None:
        self.interactions_per_second = interactions_per_second(
            self.num_bodies, steps_per_second)
        # ds reports at the fp64 convention, 30 flops an interaction: its
        # result is fp64-grade (nbody_tpu/compute.py:321-326)
        self.g_flops = gflops(self.num_bodies, steps_per_second,
                              self.fp64_enabled or self.precision == "ds")

    def run_benchmark(self, nb_iterations: int) -> dict:
        """The reference's benchmark: one untimed warm-up step (which also
        builds the kernels), then `nb_iterations` steps timed by CUDA events
        on the device (the host clock on the CPU)."""
        dt = self.active_params.time_step
        self.system.update(dt)
        self.system.synchronize()
        milliseconds = elapsed_ms(
            lambda: self.system.update_many(nb_iterations, dt), self.system.device)
        milliseconds = max(milliseconds, 1e-6)
        self.compute_perf_stats(nb_iterations * (1000.0 / milliseconds))
        self._print_benchmark_results(nb_iterations, milliseconds)
        return {
            "num_bodies": self.num_bodies,
            "iterations": nb_iterations,
            "milliseconds": milliseconds,
            "interactions_per_second_e9": self.interactions_per_second,
            "gflops": self.g_flops,
            "fp64": self.fp64_enabled,
        }

    def _print_benchmark_results(self, nb_iterations: int, milliseconds: float) -> None:
        # the reference's output (compute.cpp:105-112)
        self.log(
            f"{self.num_bodies} bodies, total time for {nb_iterations} "
            f"iterations: {milliseconds:.3f} ms")
        self.log(f"= {self.interactions_per_second:.3f} billion interactions per second")
        ds = self.precision == "ds"
        self.log(
            f"= {self.g_flops:.3f} {'double-single' if ds else 'single'}-precision GFLOP/s at "
            f"{flops_per_interaction(self.fp64_enabled or ds)} flops per interaction"
            + (" (fp64-convention)" if ds else ""))
        if self.kernel == "p3m":
            # the formula assumes O(N^2) work; for the mesh solver it is the
            # pairwise-EQUIVALENT rate (nbody_tpu/compute.py:398-405)
            self.log("  (pairwise-equivalent rate: the p3m solver does O(N) work per step)")

    # ---- energy drift (the JAX package's --drift-check) ----

    def drift_check(self, steps: int) -> dict:
        """Energy-drift comparison: `steps` steps at the active dt on the
        device and on the CPU oracle from the same state; reports both
        relative drifts and their difference (BASELINE.json config[2]: the
        device's drift matches the oracle's). The energy functional is
        ``total_energy_precise`` whatever the state's type: fp32 summation
        noise at N >= 65k is the order of the drifts. The oracle side is one
        native rollout of `steps` steps. The state is restored after.
        With precision="ds" see ``_drift_check_ds``."""
        if self.precision == "ds":
            return self._drift_check_ds(steps)
        p = self.active_params
        soft = p.softening
        device = self.system.device
        pos0 = self.system.positions
        vel0 = self.system.velocities
        e0 = total_energy_precise(pos0, vel0, soft, device=device)

        self.system.update_many(steps, p.time_step)
        self.system.synchronize()
        e_dev = total_energy_precise(*self.system.state, soft, device=device)

        op, ov = _oracle_rollout(pos0, vel0, p.time_step, soft, p.damping, steps=steps,
                                 integrator=self.system.integrator)
        e_ora = total_energy_precise(op, ov, soft, device=device)

        drift_dev = (e_dev - e0) / abs(e0) if e0 else 0.0
        drift_ora = (e_ora - e0) / abs(e0) if e0 else 0.0
        oracle = "native C++" if native_available() else "NumPy"
        self.log(
            f"energy drift over {steps} steps (dt={p.time_step}): "
            f"device {drift_dev:.3e} | {oracle} oracle {drift_ora:.3e} | "
            f"delta {abs(drift_dev - drift_ora):.3e}")
        self.system.set_state(pos0, vel0)
        return {
            "steps": steps,
            "drift_device": drift_dev,
            "drift_oracle": drift_ora,
            "delta": abs(drift_dev - drift_ora),
        }

    def _drift_check_ds(self, steps: int) -> dict:
        """The ds drift check, ``nbody_tpu``'s two-tier gate
        (cli.py:338-376): the device and the float64 oracle (one native
        rollout in float64) step from the same float64 state, first for
        the parity horizon, min(steps, DS_PARITY_HORIZON), where the
        trajectories still shadow each other and the drifts must agree at
        the ds grade (``horizon_delta``), then on to `steps`, where chaos
        has amplified the rounding differences and the fp32 path's scale
        gate applies (``delta``). ``cli.drift_failed`` reads both. The state
        is restored bit for bit after."""
        if steps < 1:
            raise ValueError(f"the drift check needs at least 1 step; got {steps}")
        p = self.active_params
        soft = p.softening
        planes0 = self.system.get_ds_state()
        op, ov = self.system.positions, self.system.velocities
        e0 = total_energy_f64(op, ov, soft)
        oracle = "native C++" if native_available() else "NumPy"
        out = {"steps": steps}
        done = 0
        for key, upto in (("horizon_", min(steps, DS_PARITY_HORIZON)), ("", steps)):
            n = upto - done
            if n > 0:
                self.system.update_many(n, p.time_step)
                self.system.synchronize()
                op, ov = _oracle_rollout(op, ov, p.time_step, soft, p.damping, steps=n,
                                         integrator=self.system.integrator)
                e_dev = total_energy_f64(self.system.positions, self.system.velocities, soft)
                e_ora = total_energy_f64(op, ov, soft)
                drift_dev = (e_dev - e0) / abs(e0) if e0 else 0.0
                drift_ora = (e_ora - e0) / abs(e0) if e0 else 0.0
                done = upto
                self.log(f"energy drift over {upto} steps (dt={p.time_step}): ds "
                         f"{drift_dev:.6e} | float64 {oracle} oracle {drift_ora:.6e} | delta "
                         f"{abs(drift_dev - drift_ora):.3e}")
            out[f"{key}steps"] = upto
            out[f"{key}drift_device"] = drift_dev
            out[f"{key}drift_oracle"] = drift_ora
            out[f"{key}delta"] = abs(drift_dev - drift_ora)
        self.system.set_ds_state(*planes0)
        return out

    # ---- QA compare (the reference's --compare / --qatest) ----

    def compare_results(self, tolerance: float = QA_TOLERANCE) -> bool:
        """One dt=QA_DT step on the device and on the CPU oracle from the same
        state; passes iff every position coordinate differs by at most
        `tolerance` (the reference's rule). The port also holds the
        acceleration of that state, from the system's force kernel, to the
        oracle's within 1e-4 * max|a| + 1e-4: a wrong force shrinks by dt^2
        before it reaches the positions. With variant="mxu" / "mxu_bf16" and
        Euler the force is the mxu step's, held element by element to that
        bound plus its error model (MXU_ERROR_COEF[variant] * E, logged as
        the largest ratio of error to bound). With kernel="p3m" only the
        positions are gated, as in ``nbody_tpu`` (``compute.py:455-476``):
        the mesh solver's force differs from the all-pairs force by design,
        and its median and largest relative error are logged, not gated.
        With integrator="hermite" the acceleration and the jerk come from
        the accel + jerk kernel, and the jerk is held to the oracle's within
        1e-4 * max|j| + 1e-4. With precision="ds" see
        ``_compare_results_ds``."""
        if self.precision == "ds":
            return self._compare_results_ds()
        pos0 = self.system.positions
        vel0 = self.system.velocities
        p = self.active_params
        hermite = self.system.integrator == "hermite"

        if hermite:
            acc, jerk = (t.cpu().numpy() for t in self.system.accelerations_and_jerks())
        else:
            acc = self.system.accelerations().cpu().numpy()
        self.system.update(QA_DT)
        self.system.synchronize()
        dev_pos = self.system.positions

        ref_pos, _ = step_best(pos0, vel0, QA_DT, p.softening, p.damping,
                               integrator=self.system.integrator)
        err = float(np.abs(dev_pos[:, :3] - ref_pos[:, :3]).max())
        if hermite:
            ref_acc, ref_jerk = _oracle_accel_jerk(pos0, vel0, p.softening)
        else:
            ref_acc = _oracle_accel(pos0, p.softening)
        acc_err = np.abs(acc - ref_acc)
        acc_tol = QA_ACCEL_RTOL * float(np.abs(ref_acc).max()) + QA_ACCEL_ATOL
        mxu = self.system.mxu_force
        p3m = self.kernel == "p3m"
        if p3m:
            rel = (np.sqrt((acc_err ** 2).sum(1))
                   / np.maximum(np.sqrt((ref_acc ** 2).sum(1)), 1e-12))
            checks = []
            report = (f", p3m force against the all-pairs force (not gated): median |da|/|a| "
                      f"= {np.median(rel):.3e}, max {rel.max():.3e}")
        elif mxu is None:
            checks = [("max |dacc|", float(acc_err.max()), acc_tol)]
        else:
            # the one-sided rule plus the mxu error model, element by element
            p0 = torch.as_tensor(pos0, device=self.system.device)
            bound = acc_tol + reference.MXU_ERROR_COEF[mxu] * (
                reference.mxu_error_scale(p0, p0, p.softening).cpu().numpy())
            checks = [(f"max |dacc| / ({acc_tol:.3e} + {mxu} error model)",
                       float((acc_err / bound).max()), 1.0)]
        if hermite:
            checks.append(("max |djerk|", float(np.abs(jerk - ref_jerk).max()),
                           QA_JERK_RTOL * float(np.abs(ref_jerk).max()) + QA_JERK_ATOL))
        passed = err <= tolerance and all(e <= tol for _, e, tol in checks)
        oracle = "native C++" if native_available() else "NumPy"
        self.log(
            f"QA compare vs {oracle} oracle: max |dpos| = {err:.3e} "
            f"(tolerance {tolerance:g})"
            + "".join(f", {label} = {e:.3e} (tolerance {tol:.3e})"
                      for label, e, tol in checks)
            + (report if p3m else "")
            + f" -> {'OK' if passed else 'FAILED'}")
        # restore the pre-compare state so the compare has no side effect
        self.system.set_state(pos0, vel0)
        return passed

    def _compare_results_ds(self) -> bool:
        """The ds QA: one dt=QA_DT step on the device and on the float64
        oracle from the same float64 state, |dpos| <= DS_QA_TOLERANCE
        (``nbody_tpu/cli.py:402``), and the ds force of that state, from the
        system's kernels, within DS_QA_ACCEL_RTOL * max|a| + DS_QA_ACCEL_ATOL
        of the oracle's float64 force: after one step a float32-grade force
        moves positions by only dt^2 * 1e-7 * max|a|, under the position
        bound. With integrator="hermite" the force and the jerk come from
        the accel + jerk kernels, and the jerk is held to the float64
        oracle's by the same rule of its own maximum. The state is restored
        bit for bit after."""
        p = self.active_params
        planes0 = self.system.get_ds_state()
        pos0, vel0 = self.system.positions, self.system.velocities
        hermite = self.system.integrator == "hermite"
        if hermite:
            fields = self.system.accelerations_and_jerks()
            acc, jerk = ds_to_f64(*fields[:2]), ds_to_f64(*fields[2:])
            ref_acc, ref_jerk = _oracle_accel_jerk(pos0, vel0, p.softening)
        else:
            acc = ds_to_f64(*self.system.accelerations())
            ref_acc = _oracle_accel(pos0, p.softening)
        self.system.update(QA_DT)
        self.system.synchronize()
        err = float(np.abs(self.system.positions[:, :3] - step_best(
            pos0, vel0, QA_DT, p.softening, p.damping,
            integrator=self.system.integrator)[0][:, :3]).max())
        fields = [("dacc", acc, ref_acc)]
        if hermite:
            fields.append(("djerk", jerk, ref_jerk))
        checks = [("dpos", err, DS_QA_TOLERANCE)] + [
            (name, float(np.abs(got - ref).max()),
             DS_QA_ACCEL_RTOL * float(np.abs(ref).max()) + DS_QA_ACCEL_ATOL)
            for name, got, ref in fields]
        passed = all(e <= tol for _, e, tol in checks)
        oracle = "native C++" if native_available() else "NumPy"
        self.log(
            f"ds QA compare vs float64 {oracle} oracle: max |dpos| = {err:.3e} "
            f"(tolerance {DS_QA_TOLERANCE:g}), "
            + ", ".join(f"max |{name}| = {e:.3e} (tolerance {tol:.3e})"
                        for name, e, tol in checks[1:])
            + f" -> {'OK' if passed else 'FAILED'}")
        self.system.set_ds_state(*planes0)
        return passed
