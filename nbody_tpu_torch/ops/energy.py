"""Total-energy diagnostics (kinetic + softened potential).

Counterpart of ``nbody_tpu/ops/energy.py``. The potential is the Plummer
pair potential consistent with the step's force law,
U = -sum_{i<j} m_i m_j (r^2 + eps^2)^{-1/2}, with the self pair excluded by
its global index. ``potential_energy_per_row`` is the plain PyTorch version
of the per-row sums; on the card the potential kernel computes them
(``ops/cuda_kernel.py::potential_energy_per_row_cuda``).

The float64 functional (``total_energy_f64``, ``total_energy_precise``) is
what drift checks read: fp32 summation noise at N >= 65k is of the order of
the drifts themselves. On the card ``total_energy_precise`` evaluates it
with the double potential kernel (``csrc/f64_kernels.cu``); on the CPU
``total_energy_f64`` runs it on the host, and stays the yardstick.
"""

from __future__ import annotations

import numpy as np
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


# ---- float64 functional, whatever the state's type ----

# pairs a slab of the host functional holds: 256K float64 (2 MB) per
# temporary, which stays in the cores' caches
_HOST_CHUNK_ELEMS = 1 << 18


def _host64(a) -> torch.Tensor:
    """A float64 CPU tensor of a numpy array or a tensor on any device."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64)
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _potential_f64(p3: torch.Tensor, m: torch.Tensor, eps2: float) -> float:
    """Chunked O(N^2) softened pair potential in float64 on the host: the
    JAX package's NumPy ``_potential_np64`` in PyTorch CPU ops, which use
    every core."""
    n = p3.shape[0]
    chunk = max(1, _HOST_CHUNK_ELEMS // max(n, 1))
    total = 0.0
    for s in range(0, n, chunk):
        rp = p3[s:s + chunk]
        c = rp.shape[0]
        r2 = torch.full((c, n), eps2, dtype=torch.float64)
        for k in range(3):
            d = p3[None, :, k] - rp[:, None, k]
            r2.addcmul_(d, d)
        inv = r2.rsqrt_()
        inv[:, s:s + c].diagonal().zero_()  # self pair
        # sum_ij m_i m_j inv_ij as a matrix-vector product
        total += float(torch.dot(m[s:s + c], torch.mv(inv, m)))
    return -0.5 * total


def _kinetic_f64(pos64: torch.Tensor, vel64: torch.Tensor) -> float:
    return 0.5 * float((pos64[:, 3] * (vel64[:, :3] ** 2).sum(dim=1)).sum())


def total_energy_f64(pos, vel, softening) -> float:
    """Total energy with float64 arithmetic end to end, for any state type
    and device: the state is pulled to the host and every pair term and the
    accumulation run in float64 (``nbody_tpu/ops/energy.py::total_energy_f64``).
    O(N^2) on the host: for drift diagnostics, not per-step use."""
    pos64, vel64 = _host64(pos), _host64(vel)
    eps2 = float(softening) ** 2
    return _kinetic_f64(pos64, vel64) + _potential_f64(pos64[:, :3], pos64[:, 3], eps2)


def total_energy_precise(pos, vel, softening, *, host_threshold: int = 131072,
                         device=None) -> float:
    """Drift-grade total energy for any state type
    (``nbody_tpu/ops/energy.py::total_energy_precise``), on `device` (a
    tensor's own device when `device` is None, else the CPU):

    * on a CUDA device, at every N: the float64 functional on the card. The
      state is taken as float64, the per-row pair sums come from the double
      potential kernel (``potential_energy_per_row_cuda``), and they and the
      kinetic term are added in float64;
    * on the CPU, N <= host_threshold: the full float64 functional on the
      host (``total_energy_f64``);
    * on the CPU, N > host_threshold: float32 pair terms summed per row by
      the plain version, and the rows and the kinetic term accumulated in
      host float64. That removes the global summation noise, the term that
      swamps 1e-5-scale drifts at large N."""
    from nbody_tpu_torch.ops.cuda_kernel import potential_energy_per_row_cuda

    if device is None:
        device = pos.device if isinstance(pos, torch.Tensor) else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        p64 = torch.as_tensor(pos).to(device=device, dtype=torch.float64).contiguous()
        v64 = torch.as_tensor(vel).to(device=device, dtype=torch.float64)
        per_row = potential_energy_per_row_cuda(p64, softening)
        return float(kinetic_energy(p64, v64)) - 0.5 * float(per_row.sum())
    n = int(pos.shape[0])
    if n <= host_threshold:
        return total_energy_f64(pos, vel, softening)
    p32 = torch.as_tensor(pos).to(device=device, dtype=torch.float32).contiguous()
    per_row = potential_energy_per_row_cuda(p32, softening)
    pe = -0.5 * float(per_row.to("cpu", torch.float64).sum())
    return _kinetic_f64(_host64(pos), _host64(vel)) + pe
