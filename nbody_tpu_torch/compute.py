"""Compute facade: demo cycling, benchmark, QA compare, perf stats.

Counterpart of ``nbody_tpu/compute.py`` (the reference's ``Compute``): owns a
BodySystem, the 7-demo preset state machine with its 10 s auto-cycle, the
N-bucketed scale tuning, the benchmark (one untimed warm-up step, then CUDA
events around the timed steps, and the reference's result formulas and
printout), the QA compare against the CPU oracle (one dt=0.001 step,
|dpos| <= 5e-4) and the energy-drift check against the oracle.

``precision="fp64"`` (or ``fp64=True``) owns a ``BodySystem(dtype=
torch.float64)`` on the double kernels, as ``nbody_tpu`` forces its XLA path
for fp64 (``compute.py:95-105,168-176``); its QA holds the force (and with
Hermite the jerk) to the float64 oracle at the ds bound beside the position
rule, and ``switch_precision`` hops between fp32 and fp64.

``precision="ds"`` owns a ``DSBodySystem`` (double-single, fp64-grade)
behind the same facade, as ``nbody_tpu/compute.py:135-168`` does, with its
mapping of variants; its QA and drift checks hold it to the float64 oracle
at ds-grade bounds.

``kernel="pm"`` / ``"p3m"`` owns a ``BodySystem(kernel=...)``, the mesh
solvers, whose force differs from the all-pairs oracle's by its mesh error
by design: as in ``nbody_tpu``, their QA gates the positions only (the
force error is reported), their benchmark rate is the pairwise-equivalent
one, and the CLI reports their drift without gating it. In fp64 a mesh
solver request runs the exact all-pairs force on the double kernels, as
``nbody_tpu``'s Compute forces its XLA path (``compute.py:175``).

``set_adaptive`` / ``set_block`` make the demo's frames step the adaptive
global timestep or the block ladder (``nbody_tpu/compute.py:221-290``), their
stats summed in ``adaptive_stats`` / ``block_stats``; in block mode the rates
charge the force rows the ladder computed.

``mesh=`` and ``strategy=`` pass through to the system
(``nbody_tpu/compute.py:162-163,179-180``): a 1-D mesh of
``parallel.make_mesh`` or a 2-D one of ``make_mesh_2d``, in fp32, fp64 or
ds. Every rank of the mesh builds
the same ``Compute`` and makes the same calls. The QA and drift checks step
the device on every rank, run the oracle on rank 0 alone, and give rank 0's
verdict to every rank, so that all of them take the same branch.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

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
from nbody_tpu_torch.models.body_system import resolve_device
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.ops.adaptive import merge_stats
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
        fp64: bool = False,
        kernel: str = "auto",
        pm_grid: int = 64,
        pm_assignment: str = "cic",
        pm_fft: str = "replicated",
        p3m_capacity: Optional[int] = None,
        p3m_short_range: str = "auto",
        p3m_auto_refresh: bool = False,
        cycle_demo: bool = True,
        seed: int = 42,
        tipsy_state: Optional[tuple] = None,
        mesh=None,
        strategy: str = "auto",
        log=print,
    ):
        device = resolve_device(device)
        # nbody_tpu/compute.py:95-105: `fp64` is the boolean of the
        # reference-shaped call sites, precision="fp64" the same request
        if precision is None:
            precision = "fp64" if fp64 else "fp32"
        if precision not in ("fp32", "fp64", "ds"):
            raise ValueError(f"unknown precision {precision!r}")
        if precision == "fp64":
            fp64 = True
        elif fp64:
            raise ValueError(f"fp64=True contradicts precision={precision!r}")
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
        if fp64:
            # nbody_tpu/compute.py:175: fp64 runs the exact force whatever the
            # kernel asked, its XLA path; the double kernels here
            kernel = "auto"
        self.precision = precision
        self.log = log
        self.paused = False
        self.fp64_enabled = fp64
        self.cycle_demo = cycle_demo
        self.active_demo = 0
        self.active_params = DEMO_PARAMS[0]
        self.interactions_per_second = 0.0
        self.g_flops = 0.0
        self.fps = 0.0
        self._tipsy_state = tipsy_state
        self.steps_taken = 0
        self.mesh = mesh
        self.adaptive = None        # {"eta", "dt_min", "dt_max"} when on
        self.adaptive_stats = None  # accumulated {"t", "dt_last", ...}
        self.block = None           # {"eta", "dt_max", "n_classes"} when on
        self.block_stats = None     # accumulated {"t", "rows", ...}
        self._block_rows_reported = 0.0

        if tipsy_state is not None:
            num_bodies = tipsy_state[0].shape[0]
        elif num_bodies is None:
            # a mesh defaults to proportionally more work (nbody_tpu's rule)
            num_bodies = default_num_bodies(
                device, DEFAULT_BLOCK_SIZE if block_size is None else block_size
            ) * (1 if mesh is None else mesh.size)

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
                mesh=mesh,
                strategy=strategy,
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
                pm_assignment=pm_assignment,
                pm_fft=pm_fft,
                p3m_capacity=p3m_capacity,
                p3m_short_range=p3m_short_range,
                p3m_auto_refresh=p3m_auto_refresh,
                dtype=torch.float64 if fp64 else torch.float32,
                seed=seed,
                state=tipsy_state,
                mesh=mesh,
                strategy=strategy,
            )
        self.num_bodies = self.system.num_bodies
        self._demo_reset_time = time.monotonic()

    @property
    def solver(self) -> Optional[str]:
        """The mesh solver the system runs ("pm" or "p3m"), else None."""
        kernel = getattr(self.system, "kernel", "auto")
        return kernel if kernel in ("pm", "p3m") else None

    def _from_rank0(self, judge):
        """judge() on rank 0 of the mesh (its oracle work runs there alone),
        its result given to every rank; judge() itself without a mesh. The
        other ranks wait on the mesh's judge group, whose timeout
        (``parallel.mesh.JUDGE_TIMEOUT``) outlasts any judge, not the body
        group's, which a long oracle run on rank 0 would outlast."""
        if self.mesh is None:
            return judge()
        box = [judge() if self.mesh.rank == 0 else None]
        if self.mesh.judge_group is None:
            dist.broadcast_object_list(box, src=0, group=self.mesh.group,
                                       device=self.mesh.device)
        else:
            dist.broadcast_object_list(box, src=0, group=self.mesh.judge_group)
        return box[0]

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

    def cycle_due(self) -> bool:
        """Whether demo cycling is on and the current demo has run
        DEMO_TIME_S by this process's clock."""
        return self.cycle_demo and time.monotonic() - self._demo_reset_time > DEMO_TIME_S

    def update_simulation(self, camera=None, steps: int = 1, *,
                          cycle: Optional[bool] = None) -> None:
        """Advance one frame of `steps` steps, after cycling to the next
        demo every DEMO_TIME_S when cycling is on: fixed dt, or block macro
        steps when set_block is on, or the adaptive criterion when
        set_adaptive is on (``nbody_tpu/compute.py:221-238``), a frame's
        steps in one call, so that an adaptive frame pays its starting
        force once. `cycle` overrides this process's clock (the demo on a
        mesh passes rank 0's decision to every rank)."""
        if self.cycle_due() if cycle is None else cycle:
            self.next_demo(camera)
        if not self.paused:
            if self.block is not None:
                self.step_block(steps)
            elif self.adaptive is not None:
                self.step_adaptive(steps)
            else:
                self.system.update_many(steps, self.active_params.time_step)
            self.steps_taken += steps

    def set_adaptive(self, eta: float, dt_min: Optional[float] = None,
                     dt_max: Optional[float] = None) -> None:
        """Step frames with the adaptive global timestep
        (``update_many_adaptive``). dt_min / dt_max None are the call's
        defaults, which follow the active demo's time_step as demos cycle."""
        self.adaptive = {"eta": eta, "dt_min": dt_min, "dt_max": dt_max}
        self.adaptive_stats = None

    def set_block(self, eta: float, dt_max: Optional[float] = None,
                  n_classes: int = 4) -> None:
        """Step frames with per-body block timesteps
        (``BodySystem.update_many_block``): a frame's `steps` become macro
        steps of dt_max (None: the active demo's time_step), so that a frame
        spans the fixed-dt demo's simulated time while tight bodies
        sub-cycle on the ladder."""
        self.block = {"eta": eta, "dt_max": dt_max, "n_classes": n_classes}
        self.block_stats = None
        self._block_rows_reported = 0.0

    def step_block(self, steps: int) -> None:
        """`steps` block macro steps; their force rows and the global-dt
        rows accumulate in block_stats."""
        st = self.system.update_many_block(steps, **self.block)
        acc = self.block_stats
        if acc is None:
            self.block_stats = st
            return
        acc["t"] += st["t"]
        acc["rows"] += st["rows"]
        acc["global_rows"] += st["global_rows"]
        acc["k_max"] = max(acc["k_max"], st["k_max"])
        acc["macro_steps"] += st["macro_steps"]

    def step_adaptive(self, steps: int) -> None:
        """`steps` adaptive steps; the simulated time sums into
        adaptive_stats and the dt extrema merge."""
        st = self.system.update_many_adaptive(steps, **self.adaptive)
        if self.adaptive_stats is None:
            self.adaptive_stats = st
        else:
            merge_stats(self.adaptive_stats, st)

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

    def switch_precision(self) -> None:
        """The reference's Enter key (``nbody_tpu/compute.py:304-313``): the
        system hops between fp32 and fp64 with the same state; ds has no
        other precision to hop to, and says so."""
        if self.precision == "ds":
            self.log("precision fixed: double-single (fp64-grade) mode")
            return
        self.system = self.system.switch_precision()
        self.fp64_enabled = not self.fp64_enabled
        self.precision = "fp64" if self.fp64_enabled else "fp32"

    # ---- perf ----

    def compute_perf_stats(self, steps_per_second: float) -> None:
        self.interactions_per_second = interactions_per_second(
            self.num_bodies, steps_per_second)
        # ds reports at the fp64 convention, 30 flops an interaction: its
        # result is fp64-grade (nbody_tpu/compute.py:321-326)
        self.g_flops = gflops(self.num_bodies, steps_per_second,
                              self.fp64_enabled or self.precision == "ds")

    def calculate_fps(self, frame_count: int, milliseconds: float,
                      *, steps_per_frame: int = 1) -> None:
        """The demo loop's report (``nbody_tpu/compute.py:328-346``): frames
        a second, and the perf rates per simulation step, not per frame; in
        block mode the rates charge the force rows the ladder computed since
        the last report (each row N interactions), not N^2 a step."""
        self.fps = frame_count * 1000.0 / max(milliseconds, 1e-9)
        if self.block_stats is not None:
            rows = self.block_stats["rows"]
            d_rows = rows - self._block_rows_reported
            self._block_rows_reported = rows
            secs = max(milliseconds / 1000.0, 1e-9)
            self.interactions_per_second = d_rows * float(self.num_bodies) * 1e-9 / secs
            self.g_flops = self.interactions_per_second * flops_per_interaction(self.fp64_enabled)
            return
        self.compute_perf_stats(self.fps * steps_per_frame)

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
        word = {"fp64": "double", "ds": "double-single", "fp32": "single"}[self.precision]
        self.log(
            f"= {self.g_flops:.3f} {word}-precision GFLOP/s at "
            f"{flops_per_interaction(self.fp64_enabled or ds)} flops per interaction"
            + (" (fp64-convention)" if ds else ""))
        if self.solver:
            # the formula assumes O(N^2) work; for the mesh solvers it is the
            # pairwise-EQUIVALENT rate (nbody_tpu/compute.py:398-405)
            self.log(f"  (pairwise-equivalent rate: the {self.solver} solver does "
                     "O(N) work per step)")

    # ---- energy drift (the JAX package's --drift-check) ----

    def drift_check(self, steps: int) -> dict:
        """Energy-drift comparison: `steps` steps at the active dt on the
        device and on the CPU oracle from the same state; reports both
        relative drifts and their difference (BASELINE.json config[2]: the
        device's drift matches the oracle's). The energy functional is
        ``total_energy_precise`` on the system's device whatever the
        state's type (fp32 summation noise at N >= 65k is the order of the
        drifts): on the card the double potential kernel, so the three
        energies (start, device, oracle) come from one float64 functional.
        The oracle side is one native rollout of `steps` steps, in the
        state's type (float64 for precision="fp64", which keeps
        ``nbody_tpu``'s fp32 gate, ``cli.py:838-841``). The state is
        restored after. With precision="ds" see ``_drift_check_ds``."""
        if self.precision == "ds":
            return self._drift_check_ds(steps)
        p = self.active_params
        soft = p.softening
        device = self.system.device
        pos0 = self.system.positions
        vel0 = self.system.velocities

        self.system.update_many(steps, p.time_step)
        self.system.synchronize()
        state = self.system.state

        def judge():
            e0 = total_energy_precise(pos0, vel0, soft, device=device)
            e_dev = total_energy_precise(*state, soft, device=device)
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
            return {
                "steps": steps,
                "drift_device": drift_dev,
                "drift_oracle": drift_ora,
                "delta": abs(drift_dev - drift_ora),
            }

        out = self._from_rank0(judge)
        self.system.set_state(pos0, vel0)
        return out

    def _drift_check_ds(self, steps: int) -> dict:
        """The ds drift check, ``nbody_tpu``'s two-tier gate
        (cli.py:338-376): the device and the float64 oracle (one native
        rollout in float64) step from the same float64 state, first for
        the parity horizon, min(steps, DS_PARITY_HORIZON), where the
        trajectories still shadow each other and the drifts must agree at
        the ds grade (``horizon_delta``), then on to `steps`, where chaos
        has amplified the rounding differences and the fp32 path's scale
        gate applies (``delta``). ``cli.drift_failed`` reads both. The state
        is restored bit for bit after. steps=0 measures the horizon tier over
        0 steps (drifts 0), as nbody_tpu's ``_run_ds`` does."""
        if steps < 0:
            raise ValueError(f"the drift check takes steps >= 0; got {steps}")
        p = self.active_params
        soft = p.softening
        planes0 = self.system.get_ds_state()
        pos0, vel0 = self.system.positions, self.system.velocities
        # the device's states at the ends of the two tiers
        tiers = []
        done = 0
        for key, upto in (("horizon_", min(steps, DS_PARITY_HORIZON)), ("", steps)):
            if upto > done or not tiers:
                self.system.update_many(upto - done, p.time_step)
                self.system.synchronize()
                tiers.append((key, upto, upto - done,
                              (self.system.positions, self.system.velocities)))
                done = upto
            else:
                tiers.append((key, upto, 0, None))

        def judge():
            e0 = total_energy_f64(pos0, vel0, soft)
            oracle = "native C++" if native_available() else "NumPy"
            op, ov = pos0, vel0
            out = {"steps": steps}
            for key, upto, n, dev in tiers:
                if dev is not None:
                    if n > 0:
                        op, ov = _oracle_rollout(op, ov, p.time_step, soft, p.damping,
                                                 steps=n, integrator=self.system.integrator)
                    e_dev = total_energy_f64(*dev, soft)
                    e_ora = total_energy_f64(op, ov, soft)
                    drift_dev = (e_dev - e0) / abs(e0) if e0 else 0.0
                    drift_ora = (e_ora - e0) / abs(e0) if e0 else 0.0
                    self.log(f"energy drift over {upto} steps (dt={p.time_step}): ds "
                             f"{drift_dev:.6e} | float64 {oracle} oracle {drift_ora:.6e} | "
                             f"delta {abs(drift_dev - drift_ora):.3e}")
                out[f"{key}steps"] = upto
                out[f"{key}drift_device"] = drift_dev
                out[f"{key}drift_oracle"] = drift_ora
                out[f"{key}delta"] = abs(drift_dev - drift_ora)
            return out

        out = self._from_rank0(judge)
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
        the largest ratio of error to bound). With kernel="pm" or "p3m" only
        the positions are gated, as in ``nbody_tpu`` (``compute.py:455-476``):
        the mesh solver's force differs from the all-pairs force by design,
        and its median and largest relative error are logged, not gated.
        With integrator="hermite" the acceleration and the jerk come from
        the accel + jerk kernel, and the jerk is held to the oracle's within
        1e-4 * max|j| + 1e-4. With precision="fp64" the oracle runs in
        float64 (the state's type), the positions keep the 5e-4 rule, and
        the force (and the jerk) are held to the float64 oracle's within
        DS_QA_ACCEL_RTOL * max + DS_QA_ACCEL_ATOL, the ds grade: one step
        hides a float32-grade force in the positions, so this is what
        catches a float32 step inside a double kernel. With precision="ds"
        see ``_compare_results_ds``."""
        if self.precision == "ds":
            return self._compare_results_ds()
        pos0 = self.system.positions
        vel0 = self.system.velocities
        p = self.active_params
        hermite = self.system.integrator == "hermite"

        jerk = None
        if hermite:
            acc, jerk = (t.cpu().numpy() for t in self.system.accelerations_and_jerks())
        else:
            acc = self.system.accelerations().cpu().numpy()
        self.system.update(QA_DT)
        self.system.synchronize()
        dev_pos = self.system.positions

        def judge():
            ref_pos, _ = step_best(pos0, vel0, QA_DT, p.softening, p.damping,
                                   integrator=self.system.integrator)
            err = float(np.abs(dev_pos[:, :3] - ref_pos[:, :3]).max())
            if hermite:
                ref_acc, ref_jerk = _oracle_accel_jerk(pos0, vel0, p.softening)
            else:
                ref_acc = _oracle_accel(pos0, p.softening)
            acc_err = np.abs(acc - ref_acc)
            rtol, atol = ((DS_QA_ACCEL_RTOL, DS_QA_ACCEL_ATOL) if self.fp64_enabled
                          else (QA_ACCEL_RTOL, QA_ACCEL_ATOL))
            acc_tol = rtol * float(np.abs(ref_acc).max()) + atol
            mxu = self.system.mxu_force
            solver = self.solver
            if solver:
                rel = (np.sqrt((acc_err ** 2).sum(1))
                       / np.maximum(np.sqrt((ref_acc ** 2).sum(1)), 1e-12))
                checks = []
                report = (f", {solver} force against the all-pairs force (not gated): median "
                          f"|da|/|a| = {np.median(rel):.3e}, max {rel.max():.3e}")
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
                jrtol, jatol = ((DS_QA_ACCEL_RTOL, DS_QA_ACCEL_ATOL) if self.fp64_enabled
                                else (QA_JERK_RTOL, QA_JERK_ATOL))
                checks.append(("max |djerk|", float(np.abs(jerk - ref_jerk).max()),
                               jrtol * float(np.abs(ref_jerk).max()) + jatol))
            passed = err <= tolerance and all(e <= tol for _, e, tol in checks)
            oracle = ("float64 " if self.fp64_enabled else "") + (
                "native C++" if native_available() else "NumPy")
            self.log(
                f"QA compare vs {oracle} oracle: max |dpos| = {err:.3e} "
                f"(tolerance {tolerance:g})"
                + "".join(f", {label} = {e:.3e} (tolerance {tol:.3e})"
                          for label, e, tol in checks)
                + (report if solver else "")
                + f" -> {'OK' if passed else 'FAILED'}")
            return passed

        passed = self._from_rank0(judge)
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
        else:
            acc = ds_to_f64(*self.system.accelerations())
        self.system.update(QA_DT)
        self.system.synchronize()
        dev_pos = self.system.positions

        def judge():
            err = float(np.abs(dev_pos[:, :3] - step_best(
                pos0, vel0, QA_DT, p.softening, p.damping,
                integrator=self.system.integrator)[0][:, :3]).max())
            if hermite:
                ref_acc, ref_jerk = _oracle_accel_jerk(pos0, vel0, p.softening)
                fields = [("dacc", acc, ref_acc), ("djerk", jerk, ref_jerk)]
            else:
                fields = [("dacc", acc, _oracle_accel(pos0, p.softening))]
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
            return passed

        passed = self._from_rank0(judge)
        self.system.set_ds_state(*planes0)
        return passed
