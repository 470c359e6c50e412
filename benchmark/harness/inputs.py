"""The cells' initial conditions, made from the seed: a frozen copy of the
shell generator of the CUDA nbody sample's ``randomiseBodies`` (SHELL), as
the port's ``ic.generate`` draws it, so that the benchmark's inputs do not
move when the program's generator does.

Directions uniform on the unit sphere (normalised rejection samples of the
unit ball), each coordinate at its own radius in [2.5 s, 4 s] (the sample's
three separate draws), s = cluster_scale; velocity = cross(pos, axis) *
s * velocity_scale, axis = z-hat except at the +z pole; unit masses.
"""

from __future__ import annotations

import numpy as np


def _uniform_ball(rng, n: int) -> np.ndarray:
    out = np.empty((n, 3), dtype=np.float64)
    filled = 0
    while filled < n:
        need = n - filled
        cand = rng.uniform(-1.0, 1.0, size=(int(need * 2.2) + 16, 3))
        acc = cand[(cand * cand).sum(axis=1) <= 1.0][:need]
        out[filled:filled + len(acc)] = acc
        filled += len(acc)
    return out


def shell(n: int, cluster_scale: float, velocity_scale: float, seed: int):
    """(pos, vel), float32 (n, 4) arrays: [x, y, z, m] and [vx, vy, vz, 0]."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    pts = _uniform_ball(rng, n)
    norm = np.linalg.norm(pts, axis=1, keepdims=True)
    d = pts / np.where(norm > 1e-6, norm, 1.0)
    scale = cluster_scale
    inner, outer = 2.5 * scale, 4.0 * scale
    radii = inner + (outer - inner) * rng.uniform(0.0, 1.0, size=(n, 3))
    p = d * radii
    axis = np.broadcast_to(np.array([0.0, 0.0, 1.0]), (n, 3)).copy()
    pole = (1.0 - d[:, 2]) < 1e-6
    if pole.any():
        a = np.stack([d[pole, 1], d[pole, 0], np.ones(pole.sum())], axis=1)
        axis[pole] = a / np.linalg.norm(a, axis=1, keepdims=True)
    v = np.cross(p, axis) * (scale * velocity_scale)
    pos = np.zeros((n, 4), dtype=np.float32)
    vel = np.zeros((n, 4), dtype=np.float32)
    pos[:, 3] = 1.0
    pos[:, :3] = p.astype(np.float32)
    vel[:, :3] = v.astype(np.float32)
    return pos, vel
