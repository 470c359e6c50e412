"""The benchmark's plain reference: the steps of each configuration, written
from their equations in plain PyTorch. It imports nothing of the program
under test and reads nothing the program made.

Integrators (the configurations' own):
  euler    damped semi-implicit Euler: v' = (v + a dt) * damping,
           x' = x + v' dt;
  hermite  the 4th-order P(EC) predictor-corrector with two accel + jerk
           evaluations a step: predict x_p = x + v dt + a0 dt^2/2 + j0 dt^3/6,
           v_p = v + a0 dt + j0 dt^2/2; evaluate (a1, j1) there; correct
           v' = (v + dt/2 (a0 + a1) + dt^2/12 (j0 - j1)) * damping,
           x' = x + dt/2 (v + v') + dt^2/12 (a0 - a1).
The mass (pos[:, 3]) and vel[:, 3] pass through.

The force is the configuration's solver's: ``benchmark/reference/<solver>.py``,
found by the name in the configuration's ``solver`` and loaded from its file,
gives ``accel(pos, config, *, precision, rows=None)`` (and, for Hermite,
``accel_jerk(pos, vel, softening, *, precision)``). A solver with no file
raises: a later configuration brings its reference as a file of its own.
"""

from __future__ import annotations

import torch

from benchmark.harness import spec


def solver(config: dict):
    """The reference module of the configuration's solver."""
    return spec.load_module("reference", config["solver"])


def advance(pos, vel, steps: int, *, config: dict, integrator: str, precision: str = "fp64",
            rows=None):
    """The state after `steps` steps of the configuration from (pos, vel),
    (N, 4) tensors: (pos, vel) in float64 ("fp64") or float32 ("tf32",
    the control). With `rows` (one Euler step only) just those rows."""
    par = config["params"]
    dt, damping = par["time_step"], par["damping"]
    dtype = torch.float64 if precision == "fp64" else torch.float32
    pos, vel = pos.to(dtype), vel.to(dtype)
    if rows is not None:
        if steps != 1 or integrator != "euler":
            raise ValueError("rows= takes one Euler step")
        a = solver(config).accel(pos, config, precision=precision, rows=rows).to(dtype)
        v3 = (vel[rows, :3] + a * dt) * damping
        return torch.cat([pos[rows, :3] + v3 * dt, pos[rows, 3:]], 1)
    if integrator == "euler":
        mod = solver(config)
        for _ in range(steps):
            a = mod.accel(pos, config, precision=precision).to(dtype)
            v3 = (vel[:, :3] + a * dt) * damping
            pos = torch.cat([pos[:, :3] + v3 * dt, pos[:, 3:]], 1)
            vel = torch.cat([v3, vel[:, 3:]], 1)
        return pos, vel
    if integrator == "hermite":
        soft, accel_jerk = par["softening"], solver(config).accel_jerk
        for _ in range(steps):
            x0, v0 = pos[:, :3], vel[:, :3]
            a0, j0 = (t.to(dtype) for t in accel_jerk(pos, vel, soft, precision=precision))
            xp = x0 + v0 * dt + a0 * (dt * dt / 2) + j0 * (dt * dt * dt / 6)
            vp = v0 + a0 * dt + j0 * (dt * dt / 2)
            a1, j1 = (t.to(dtype) for t in accel_jerk(
                torch.cat([xp, pos[:, 3:]], 1), torch.cat([vp, vel[:, 3:]], 1), soft,
                precision=precision))
            v1 = (v0 + (dt / 2) * (a0 + a1) + (dt * dt / 12) * (j0 - j1)) * damping
            x1 = x0 + (dt / 2) * (v0 + v1) + (dt * dt / 12) * (a0 - a1)
            pos = torch.cat([x1, pos[:, 3:]], 1)
            vel = torch.cat([v1, vel[:, 3:]], 1)
        return pos, vel
    raise ValueError(f"unknown integrator {integrator!r}")
