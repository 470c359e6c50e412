"""Compute facade: demo cycling, benchmark, QA compare, perf stats.

Counterpart of ``nbody_tpu/compute.py`` (the reference's ``Compute``): owns a
BodySystem, the 7-demo preset state machine with its 10 s auto-cycle, the
N-bucketed scale tuning, the benchmark (one untimed warm-up step, then CUDA
events around the timed steps, and the reference's result formulas and
printout), and the QA compare against the CPU oracle (one dt=0.001 step,
|dpos| <= 5e-4).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.oracle import accel_numpy, native_available, step_best
from nbody_tpu_torch.params import (
    DEMO_PARAMS,
    DEMO_TIME_S,
    flops_per_interaction,
    gflops,
    interactions_per_second,
    tuned_scales,
)
from nbody_tpu_torch.models import BodySystem
from nbody_tpu_torch.models.body_system import resolve_device
from nbody_tpu_torch.ops.cuda_kernel import DEFAULT_BLOCK_SIZE
from nbody_tpu_torch.utils.timing import elapsed_ms

QA_TOLERANCE = 5e-4
QA_DT = 0.001
# the force check beside the QA step: the kernel tolerance of
# tests/test_pallas.py:76 as a bound on max|da| against the oracle
QA_ACCEL_RTOL = 1e-4
QA_ACCEL_ATOL = 1e-4


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
        cycle_demo: bool = True,
        seed: int = 42,
        tipsy_state: Optional[tuple] = None,
        log=print,
    ):
        device = resolve_device(device)
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

        self.system = BodySystem(
            num_bodies,
            self.active_params,
            device=device,
            backend=backend,
            block_size=block_size,
            placement=placement,
            variant=variant,
            integrator=integrator,
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
        self.g_flops = gflops(self.num_bodies, steps_per_second, self.fp64_enabled)

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
        self.log(
            f"= {self.g_flops:.3f} single-precision GFLOP/s at "
            f"{flops_per_interaction(self.fp64_enabled)} flops per interaction")

    # ---- QA compare (the reference's --compare / --qatest) ----

    def compare_results(self, tolerance: float = QA_TOLERANCE) -> bool:
        """One dt=QA_DT step on the device and on the CPU oracle from the same
        state; passes iff every position coordinate differs by at most
        `tolerance` (the reference's rule). The port also holds the
        acceleration of that state, from the system's force kernel, to the
        oracle's within 1e-4 * max|a| + 1e-4: a wrong force shrinks by dt^2
        before it reaches the positions."""
        pos0 = self.system.positions
        vel0 = self.system.velocities
        p = self.active_params

        acc = self.system.accelerations().cpu().numpy()
        self.system.update(QA_DT)
        self.system.synchronize()
        dev_pos = self.system.positions

        ref_pos, _ = step_best(pos0, vel0, QA_DT, p.softening, p.damping,
                               integrator=self.system.integrator)
        ref_acc = _oracle_accel(pos0, p.softening)
        err = float(np.abs(dev_pos[:, :3] - ref_pos[:, :3]).max())
        acc_err = float(np.abs(acc - ref_acc).max())
        acc_tol = QA_ACCEL_RTOL * float(np.abs(ref_acc).max()) + QA_ACCEL_ATOL
        passed = bool(err <= tolerance and acc_err <= acc_tol)
        oracle = "native C++" if native_available() else "NumPy"
        self.log(
            f"QA compare vs {oracle} oracle: max |dpos| = {err:.3e} "
            f"(tolerance {tolerance:g}), max |dacc| = {acc_err:.3e} "
            f"(tolerance {acc_tol:.3e}) -> {'OK' if passed else 'FAILED'}")
        # restore the pre-compare state so the compare has no side effect
        self.system.set_state(pos0, vel0)
        return passed
