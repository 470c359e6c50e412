"""NumPy CPU oracle — the golden reference for every device path.

Same math as the reference CPU implementation's scalar path
(the reference's src/nbody/bodysystemcpu.cpp:244-299, re-derived): 1/r^3 via
sqrt + divide (not rsqrt), then v = (v + a*dt) * damping; p += v*dt.
Computed in the array dtype (float32 oracle accumulates in float32, like the
reference CPU float path).
"""

from __future__ import annotations

import numpy as np


def accel_numpy(pos: np.ndarray, softening: float, chunk: int = 2048) -> np.ndarray:
    """Acceleration (N,3) for AoS pos (N,4); chunked over i-rows."""
    n = pos.shape[0]
    dtype = pos.dtype
    p3 = pos[:, :3]
    m = pos[:, 3]
    eps2 = dtype.type(softening) ** 2
    out = np.empty((n, 3), dtype=dtype)
    for i0 in range(0, n, chunk):
        rows = p3[i0 : i0 + chunk]
        dx = p3[None, :, :] - rows[:, None, :]  # (C,N,3)
        r2 = np.einsum("cnk,cnk->cn", dx, dx) + eps2
        d = np.sqrt(r2)
        s = m[None, :] / (d * r2)  # m / r^3
        out[i0 : i0 + chunk] = np.einsum("cn,cnk->ck", s, dx)
    return out


def step_numpy(
    pos: np.ndarray,
    vel: np.ndarray,
    dt: float,
    softening: float,
    damping: float,
) -> tuple[np.ndarray, np.ndarray]:
    """One integration step on the host; returns new (pos, vel) copies."""
    dtype = pos.dtype
    acc = accel_numpy(pos, softening)
    v3 = (vel[:, :3] + acc * dtype.type(dt)) * dtype.type(damping)
    p3 = pos[:, :3] + v3 * dtype.type(dt)
    new_pos = pos.copy()
    new_vel = vel.copy()
    new_pos[:, :3] = p3
    new_vel[:, :3] = v3
    return new_pos, new_vel


def accel_jerk_numpy(pos: np.ndarray, vel: np.ndarray, softening: float,
                     chunk: int = 2048) -> tuple[np.ndarray, np.ndarray]:
    """(acc, jerk) each (N,3) — host evaluation for the Hermite scheme."""
    n = pos.shape[0]
    dtype = pos.dtype
    p3, v3, m = pos[:, :3], vel[:, :3], pos[:, 3]
    eps2 = dtype.type(softening) ** 2
    acc = np.empty((n, 3), dtype=dtype)
    jerk = np.empty((n, 3), dtype=dtype)
    for i0 in range(0, n, chunk):
        rp = p3[i0: i0 + chunk]
        rv = v3[i0: i0 + chunk]
        dx = p3[None, :, :] - rp[:, None, :]  # (C,N,3)
        dv = v3[None, :, :] - rv[:, None, :]
        r2 = np.einsum("cnk,cnk->cn", dx, dx) + eps2
        s = m[None, :] / (np.sqrt(r2) * r2)  # m / r^3
        rvdot = np.einsum("cnk,cnk->cn", dx, dv)
        acc[i0: i0 + chunk] = np.einsum("cn,cnk->ck", s, dx)
        jerk[i0: i0 + chunk] = (np.einsum("cn,cnk->ck", s, dv)
                                - 3.0 * np.einsum("cn,cnk->ck", s * rvdot / r2, dx))
    return acc, jerk


def step_numpy_hermite(
    pos: np.ndarray,
    vel: np.ndarray,
    dt: float,
    softening: float,
    damping: float,
) -> tuple[np.ndarray, np.ndarray]:
    """4th-order Hermite P(EC) step on the host (mirrors
    ops.reference.nbody_step_hermite)."""
    dtype = pos.dtype
    dt = dtype.type(dt)
    x0, v0 = pos[:, :3], vel[:, :3]
    a0, j0 = accel_jerk_numpy(pos, vel, softening)
    pos_p = pos.copy()
    vel_p = vel.copy()
    pos_p[:, :3] = x0 + v0 * dt + a0 * (dt * dt / 2) + j0 * (dt ** 3 / 6)
    vel_p[:, :3] = v0 + a0 * dt + j0 * (dt * dt / 2)
    a1, j1 = accel_jerk_numpy(pos_p, vel_p, softening)
    v1 = (v0 + (dt / 2) * (a0 + a1) + (dt * dt / 12) * (j0 - j1)) * dtype.type(damping)
    x1 = x0 + (dt / 2) * (v0 + v1) + (dt * dt / 12) * (a0 - a1)
    new_pos = pos.copy()
    new_vel = vel.copy()
    new_pos[:, :3] = x1
    new_vel[:, :3] = v1
    return new_pos, new_vel


def step_numpy_leapfrog(
    pos: np.ndarray,
    vel: np.ndarray,
    dt: float,
    softening: float,
    damping: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Symplectic DKD step on the host (mirrors ops.reference.nbody_step_leapfrog)."""
    dtype = pos.dtype
    half = dtype.type(dt) / 2
    p_half = pos.copy()
    p_half[:, :3] += vel[:, :3] * half
    acc = accel_numpy(p_half, softening)
    new_vel = vel.copy()
    new_vel[:, :3] = (vel[:, :3] + acc * dtype.type(dt)) * dtype.type(damping)
    new_pos = p_half
    new_pos[:, :3] += new_vel[:, :3] * half
    return new_pos, new_vel
