"""Total-energy diagnostics (kinetic + softened potential), plain PyTorch.

Counterpart of ``nbody_tpu/ops/energy.py``. The potential is the Plummer
pair potential consistent with the step's force law,
U = -sum_{i<j} m_i m_j (r^2 + eps^2)^{-1/2}, with the self pair excluded by
its global index. The Pallas potential kernel
(``pallas_kernel.py::_potential_kernel``) is still to be ported; until then
this chunked version is the only one.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops.reference import _chunk_and_pad


def kinetic_energy(pos, vel):
    return 0.5 * torch.sum(pos[:, 3] * torch.sum(vel[:, :3] * vel[:, :3], dim=1))


def potential_energy_per_row(pos, softening, *, chunk_size: int | None = None):
    """Row i holds sum_{j != i} m_i m_j / sqrt(r^2 + eps^2); the total
    potential is -1/2 of their sum."""
    n = pos.shape[0]
    p3 = pos[:, :3]
    m = pos[:, 3]
    eps2 = float(softening) ** 2
    cols = torch.arange(n, device=pos.device)

    def rows(rp, rm, ridx):
        dx = p3[None, :, :] - rp[:, None, :]  # (C, N, 3)
        r2 = torch.sum(dx * dx, dim=-1) + eps2
        inv = torch.rsqrt(r2)
        inv = torch.where(cols[None, :] == ridx[:, None], torch.zeros_like(inv), inv)
        return torch.sum(rm[:, None] * m[None, :] * inv, dim=1)

    c, n_pad = _chunk_and_pad(n, chunk_size)
    if c == n:
        return rows(p3, m, cols)
    pad = n_pad - n
    # padded rows have zero mass and indices past N, so they add nothing
    p3p = torch.cat([p3, p3.new_zeros((pad, 3))])
    mp = torch.cat([m, m.new_zeros(pad)])
    idxp = torch.arange(n_pad, device=pos.device)
    per_row = torch.cat([rows(rp, rm, ri) for rp, rm, ri in
                         zip(p3p.split(c), mp.split(c), idxp.split(c))])
    return per_row[:n]


def potential_energy(pos, softening, *, chunk_size: int | None = None):
    return -0.5 * torch.sum(potential_energy_per_row(pos, softening, chunk_size=chunk_size))


def total_energy(pos, vel, softening, *, chunk_size: int | None = None):
    return kinetic_energy(pos, vel) + potential_energy(pos, softening, chunk_size=chunk_size)
