"""Plain PyTorch all-pairs N-body step: the port's portable path.

Counterpart of ``nbody_tpu/ops/reference.py`` (the XLA path). It runs on any
torch device and dtype, and it is the plain version that both hand-written
CUDA kernels (``ops/cuda_kernel.py``) are held to, on the CPU in the tests
and on the card in ``chip_smoke.py``.

Physics (the reference CUDA sample's bodyBodyInteraction + integrateBodies):

    d_ij = p_j - p_i
    s_ij = m_j * (|d_ij|^2 + softening^2) ** (-3/2)      (Plummer)
    a_i  = sum_j s_ij * d_ij        (the self pair adds 0 because d_ii = 0)
    v'   = (v + a * dt) * damping   (damped semi-implicit Euler)
    p'   = p + v' * dt

Memory: the broadcast over one chunk of i-rows holds a few (C, N) tensors.
Rows are zero-padded up to a multiple of the chunk, so every chunk has the
same shape and no divisor of N is searched for.
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 4096


def _chunk_and_pad(n: int, chunk_size: int | None) -> tuple[int, int]:
    """(chunk, padded_n) for n rows; padded_n is a multiple of chunk."""
    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK
    c = max(1, min(n, int(chunk_size)))
    return c, ((n + c - 1) // c) * c


def _accel_rows(rows_p, all_p, all_m, eps2):
    """Acceleration (C,3) on rows_p (C,3) due to all_p (N,3) with masses (N,)."""
    dx = all_p[None, :, 0] - rows_p[:, 0:1]  # (C, N)
    dy = all_p[None, :, 1] - rows_p[:, 1:2]
    dz = all_p[None, :, 2] - rows_p[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    s = all_m[None, :] * (inv * inv * inv)
    return torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)


def compute_accel_vs(pos_i, pos_j, softening, *, chunk_size: int | None = None):
    """Acceleration (M,3) on the i-set (M,4) due to the j-set (N,4)."""
    m_rows = pos_i.shape[0]
    ri = pos_i[:, :3]
    p3 = pos_j[:, :3]
    m = pos_j[:, 3]
    eps2 = float(softening) ** 2
    if m_rows == 0:
        return pos_i.new_zeros((0, 3))
    c, m_pad = _chunk_and_pad(m_rows, chunk_size)
    if c == m_rows:
        return _accel_rows(ri, p3, m, eps2)
    if m_pad != m_rows:
        ri = torch.cat([ri, ri.new_zeros((m_pad - m_rows, 3))])
    acc = torch.cat([_accel_rows(r, p3, m, eps2) for r in ri.split(c)])
    return acc[:m_rows]


def compute_accel(pos, softening, *, chunk_size: int | None = None):
    """Gravitational acceleration (N,3) for the AoS state pos (N,4)=[x,y,z,m]."""
    return compute_accel_vs(pos, pos, softening, chunk_size=chunk_size)


def integrate(pos, vel, acc, dt, damping):
    """Damped semi-implicit Euler update; the mass and the velocity w-lane
    pass through untouched."""
    v3 = (vel[:, :3] + acc * dt) * damping
    p3 = pos[:, :3] + v3 * dt
    return torch.cat([p3, pos[:, 3:4]], dim=1), torch.cat([v3, vel[:, 3:4]], dim=1)


def nbody_step_vs(pos_i, vel_i, pos_j, dt, softening, damping,
                  *, chunk_size: int | None = None):
    """Step the i-set under forces from the j-set (the general sharded form)."""
    acc = compute_accel_vs(pos_i, pos_j, softening, chunk_size=chunk_size)
    return integrate(pos_i, vel_i, acc, dt, damping)


def nbody_step(pos, vel, dt, softening, damping, *, chunk_size: int | None = None):
    """One integration step; returns (new_pos, new_vel) in the same (N,4) layout."""
    return nbody_step_vs(pos, vel, pos, dt, softening, damping, chunk_size=chunk_size)


def rollout(pos, vel, dt, softening, damping, *, steps: int,
            chunk_size: int | None = None):
    """`steps` integration steps, one after another."""
    for _ in range(steps):
        pos, vel = nbody_step(pos, vel, dt, softening, damping, chunk_size=chunk_size)
    return pos, vel
