"""The plain all-pairs reference: the softened Plummer force and its jerk.

    a_i = sum_j m_j d_ij R_ij^-3
    j_i = sum_j m_j [dv_ij R_ij^-3 - 3 (d_ij . dv_ij) d_ij R_ij^-5]
    d_ij = x_j - x_i,  dv_ij = v_j - v_i,  R_ij^2 = |d_ij|^2 + eps^2

Nothing of the program under test is imported: this is written from the
equations, in plain PyTorch on whatever device it is given.

``precision="fp64"`` is the reference. Its pair terms come from matrix
products of augmented rows: R^2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j + eps^2,
and d.dv likewise, with the coordinates first centred on the j-set's mean.
The rounding of R^2 is then about |x|^2 2^-52 against R^2 >= eps^2 = 1e-2,
some 1e-12 of it for |x| up to 100: far below the float32 program's 6e-8.

``precision="tf32"`` is the control: the same sums in float32 in their
direct form (differences first), with every operand (positions, velocities,
masses) rounded to TF32's 10-bit mantissa at each evaluation, as a
tensor-core kernel in TF32 would read them. It stands in the program's place
to show that the comparison fails a precision one step below float32.
"""

from __future__ import annotations

import torch

# elements of one (rows x N) plane of the float64 pair terms: 1 GiB
_PLANE = 1 << 27


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (0xFFF + ((bits >> 13) & 1))) & -8192
    return bits.view(torch.float32)


def _rows(n_rows: int, n_cols: int) -> int:
    return max(1, min(n_rows, _PLANE // max(1, n_cols)))


def _accel_fp64(xi, xj, mj, eps2):
    c = xj.mean(0)
    xi, xj = xi - c, xj - c
    ones_j = torch.ones_like(xj[:, :1])
    b = torch.cat([-2.0 * xj, ones_j, (xj * xj).sum(1, keepdim=True) + eps2], 1)
    mx = torch.cat([mj[:, None] * xj, mj[:, None]], 1)
    out = []
    for x in xi.split(_rows(xi.shape[0], xj.shape[0])):
        a = torch.cat([x, (x * x).sum(1, keepdim=True), torch.ones_like(x[:, :1])], 1)
        w = (a @ b.T).rsqrt_().pow_(3)
        f = w @ mx
        out.append(f[:, :3] - x * f[:, 3:])
    return torch.cat(out)


def _accel_jerk_fp64(xi, vi, xj, vj, mj, eps2):
    c, cv = xj.mean(0), vj.mean(0)
    xi, xj, vi, vj = xi - c, xj - c, vi - cv, vj - cv
    ones_j = torch.ones_like(xj[:, :1])
    b = torch.cat([-2.0 * xj, ones_j, (xj * xj).sum(1, keepdim=True) + eps2], 1)
    b2 = torch.cat([ones_j, (xj * vj).sum(1, keepdim=True), xj, vj], 1)
    mx = torch.cat([mj[:, None] * xj, mj[:, None]], 1)
    mv = torch.cat([mj[:, None] * vj, mj[:, None]], 1)
    accs, jerks = [], []
    step = max(1, _rows(xi.shape[0], xj.shape[0]) // 2)
    for x, v in zip(xi.split(step), vi.split(step)):
        one = torch.ones_like(x[:, :1])
        a = torch.cat([x, (x * x).sum(1, keepdim=True), one], 1)
        a2 = torch.cat([(x * v).sum(1, keepdim=True), one, -v, -x], 1)
        inv = (a @ b.T).rsqrt_()
        w = inv ** 3
        u = (a2 @ b2.T).mul_(w).mul_(inv.square_())
        del inv
        fa, fv, fu = w @ mx, w @ mv, u @ mx
        accs.append(fa[:, :3] - x * fa[:, 3:])
        jerks.append((fv[:, :3] - v * fv[:, 3:]) - 3.0 * (fu[:, :3] - x * fu[:, 3:]))
    return torch.cat(accs), torch.cat(jerks)


def _direct_rows(n_cols: int) -> int:
    return max(1, (1 << 26) // max(1, n_cols))


def _accel_direct(xi, xj, mj, eps2):
    out = []
    for x in xi.split(_direct_rows(xj.shape[0])):
        d = xj[None, :, :] - x[:, None, :]
        r2 = (d * d).sum(2) + eps2
        s = r2.rsqrt_().pow_(3).mul_(mj[None, :])
        out.append((s[:, :, None] * d).sum(1))
    return torch.cat(out)


def _accel_jerk_direct(xi, vi, xj, vj, mj, eps2):
    accs, jerks = [], []
    step = max(1, _direct_rows(xj.shape[0]) // 2)
    for x, v in zip(xi.split(step), vi.split(step)):
        d = xj[None, :, :] - x[:, None, :]
        dv = vj[None, :, :] - v[:, None, :]
        inv = ((d * d).sum(2) + eps2).rsqrt_()
        w = inv ** 3 * mj[None, :]
        u = (d * dv).sum(2).mul_(w).mul_(inv.square_())
        accs.append((w[:, :, None] * d).sum(1))
        jerks.append((w[:, :, None] * dv).sum(1) - 3.0 * (u[:, :, None] * d).sum(1))
    return torch.cat(accs), torch.cat(jerks)


def force(pos, softening, *, precision="fp64", rows=None):
    """(len(rows) or N, 3) accelerations of the (N, 4) [x, y, z, m] state
    `pos` (the rows `rows` of it, a slice or index tensor, when given)."""
    eps2 = float(softening) ** 2
    if precision == "fp64":
        p = pos.to(torch.float64)
        xi = p[:, :3] if rows is None else p[rows, :3]
        return _accel_fp64(xi, p[:, :3], p[:, 3], eps2)
    if precision == "tf32":
        p = round_tf32(pos)
        xi = p[:, :3] if rows is None else p[rows, :3]
        return _accel_direct(xi, p[:, :3], p[:, 3], eps2)
    raise ValueError(f"unknown precision {precision!r}")


def accel(pos, config: dict, *, precision="fp64", rows=None):
    """The solver's entry point: ``force`` at `config`'s softening."""
    return force(pos, config["params"]["softening"], precision=precision, rows=rows)


def accel_jerk(pos, vel, softening, *, precision="fp64"):
    """((N, 3) accelerations, (N, 3) jerks) of the state (pos, vel)."""
    eps2 = float(softening) ** 2
    if precision == "fp64":
        p, v = pos.to(torch.float64), vel.to(torch.float64)
        return _accel_jerk_fp64(p[:, :3], v[:, :3], p[:, :3], v[:, :3], p[:, 3], eps2)
    if precision == "tf32":
        p, v = round_tf32(pos), round_tf32(vel)
        return _accel_jerk_direct(p[:, :3], v[:, :3], p[:, :3], v[:, :3], p[:, 3], eps2)
    raise ValueError(f"unknown precision {precision!r}")
