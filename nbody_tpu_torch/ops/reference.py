"""Plain PyTorch all-pairs N-body step: the port's portable path.

Counterpart of ``nbody_tpu/ops/reference.py`` (the XLA path). It runs on any
torch device and dtype, and it is the plain version that both hand-written
CUDA kernels (``ops/cuda_kernel.py``) are held to, on the CPU in the tests
and on the card in ``chip_smoke.py``. The second half holds the
each-pair-once (symmetric) force, its rectangle and blocked composition,
and the leapfrog step.

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

import functools

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


def integrate_into(pos, vel, acc, dt, damping, out) -> None:
    """`integrate` written into out=(new_pos, new_vel), preallocated (N,4)
    tensors that do not overlap the inputs: the step of the ping-pong
    buffers, in five elementwise passes."""
    new_pos, new_vel = out
    new_vel.copy_(vel)
    new_vel[:, :3].add_(acc * dt).mul_(damping)
    new_pos.copy_(pos)
    new_pos[:, :3].add_(new_vel[:, :3] * dt)


def nbody_step_leapfrog(pos, vel, dt, softening, damping, *, accel_fn=None,
                        chunk_size: int | None = None):
    """Symplectic drift-kick-drift (leapfrog) step, line for line the JAX
    package's ``ops/reference.py::nbody_step_leapfrog``:

        p½ = p + v·dt/2
        v' = (v + a(p½)·dt) · damping
        p' = p½ + v'·dt/2

    `accel_fn(pos4) -> (N,3)` plugs in a force kernel; it defaults to the
    plain one-sided force."""
    if accel_fn is None:
        def accel_fn(p4):
            return compute_accel(p4, softening, chunk_size=chunk_size)

    p_half = pos[:, :3] + vel[:, :3] * (dt / 2)
    pos_half = torch.cat([p_half, pos[:, 3:4]], dim=1)
    acc = accel_fn(pos_half)
    v3 = (vel[:, :3] + acc * dt) * damping
    p3 = p_half + v3 * (dt / 2)
    return torch.cat([p3, pos[:, 3:4]], dim=1), torch.cat([v3, vel[:, 3:4]], dim=1)


# ---- each pair once (Newton's third law) ----
#
# Counterparts of nbody_tpu/ops/symmetric_kernel.py's public functions, with
# its layouts: each pair (i, j) is evaluated once, with
#   d = x_j - x_i,  c = (|d|^2 + eps^2)^(-3/2),
# the i-side taking +m_j c d and the reaction on j taking -m_i c d.


def _sym_rows(ri, mi, pj, mj, eps2, keep=None):
    """(action (C,3) on the rows, reaction (M,3) on the columns) of the pairs
    of rows ri (C,3) x columns pj (M,3); `keep` (C,M) masks pairs out."""
    dx = pj[None, :, 0] - ri[:, 0:1]  # (C, M)
    dy = pj[None, :, 1] - ri[:, 1:2]
    dz = pj[None, :, 2] - ri[:, 2:3]
    r2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(r2)
    c = inv * inv * inv
    if keep is not None:
        # a select, not a product: the masked self pair is inf at eps = 0
        c = torch.where(keep, c, torch.zeros((), dtype=c.dtype, device=c.device))
    s = mj[None, :] * c
    t = mi[:, None] * c
    act = torch.stack([(s * dx).sum(1), (s * dy).sum(1), (s * dz).sum(1)], dim=1)
    react = -torch.stack([(t * dx).sum(0), (t * dy).sum(0), (t * dz).sum(0)], dim=1)
    return act, react


def compute_accel_symmetric(pos, softening, *, chunk_size: int | None = None):
    """(N,4) -> (N,3) accelerations of the set on itself, each pair once over
    the strict upper triangle j > i (which drops the self pair). Row chunk
    [r0, r1) meets the columns [r0, N), so no N x N slab is held."""
    n = pos.shape[0]
    p3, m = pos[:, :3], pos[:, 3]
    eps2 = float(softening) ** 2
    act = pos.new_zeros((n, 3))
    react = pos.new_zeros((n, 3))
    c = max(1, min(n, int(chunk_size or DEFAULT_CHUNK)))
    cols = torch.arange(n, device=pos.device)
    for r0 in range(0, n, c):
        r1 = min(n, r0 + c)
        keep = cols[None, r0:] > cols[r0:r1, None]
        a, r = _sym_rows(p3[r0:r1], m[r0:r1], p3[r0:], m[r0:], eps2, keep)
        act[r0:r1] += a
        react[r0:] += r
    return act + react


def sym_cross(pos_i, pos_j, softening, *, chunk_size: int | None = None):
    """The mask-free rectangle of two sets, each (i, j) pair once: returns
    (acc_i (Bi,4) with w = 0, react_j (3,Bj)), the layout of the JAX
    package's ``_sym_cross``; the j-set is AoS (Bj,4)."""
    bi, bj = pos_i.shape[0], pos_j.shape[0]
    eps2 = float(softening) ** 2
    acc = pos_i.new_zeros((bi, 4))
    react = pos_i.new_zeros((bj, 3))
    c = max(1, min(max(bi, 1), int(chunk_size or DEFAULT_CHUNK)))
    for r0 in range(0, bi, c):
        r1 = min(bi, r0 + c)
        a, r = _sym_rows(pos_i[r0:r1, :3], pos_i[r0:r1, 3], pos_j[:, :3], pos_j[:, 3], eps2)
        acc[r0:r1, :3] = a
        react += r
    return acc, react.t()


def sym_blocking(n: int, tile_j: int, block_cap: int) -> tuple[int, int]:
    """(k, B): the superblock count and size of the blocked composition for
    N bodies, the fewest blocks with B <= block_cap, B a tile_j multiple
    (the JAX package's ``sym_blocking``)."""
    cap_t = (block_cap // tile_j) * tile_j
    if cap_t <= 0:
        raise ValueError(
            f"blocked sym needs tile_j <= block_cap: got tile_j={tile_j}, "
            f"block_cap={block_cap}")
    k = -(-n // cap_t)
    per = -(-n // k)
    return k, -(-per // tile_j) * tile_j


def compose_symmetric_blocked(pos, softening, *, block_cap: int, tile_j: int,
                              triangle, cross):
    """Each pair once at any N: the triangle of N bodies as k superblock
    triangles plus k(k-1)/2 mask-free cross rectangles,

        triangle(N) = sum_a triangle(block a) + sum_{a<b} rectangle(a x b),

    summed per block in a fixed order (the triangle, then the rectangles
    in loop order), as ``compute_accel_symmetric_blocked`` of the JAX
    package does. N <= block_cap is one triangle. The last block is
    ragged instead of zero-mass padded; padding is inert, so the sums are
    the same. `triangle(pos, softening)` and `cross(pos_i, pos_j,
    softening)` are the plain versions or the kernels' wrappers."""
    n = pos.shape[0]
    if n <= block_cap:
        return triangle(pos, softening)
    k, blk = sym_blocking(n, tile_j, block_cap)
    blocks = [pos[a * blk:min(n, (a + 1) * blk)] for a in range(k)]
    contrib = [[triangle(b, softening)] for b in blocks]
    for a in range(k):
        for b in range(a + 1, k):
            acc_i, react_j = cross(blocks[a], blocks[b], softening)
            contrib[a].append(acc_i[:, :3])
            contrib[b].append(react_j.t())
    out = []
    for parts in contrib:
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        out.append(total)
    return torch.cat(out)


def compute_accel_symmetric_blocked(pos, softening, *, block_cap: int, tile_j: int = 256,
                                    chunk_size: int | None = None):
    """The plain blocked composition: (N,4) -> (N,3), each pair once."""
    return compose_symmetric_blocked(
        pos, softening, block_cap=block_cap, tile_j=tile_j,
        triangle=functools.partial(compute_accel_symmetric, chunk_size=chunk_size),
        cross=functools.partial(sym_cross, chunk_size=chunk_size))
