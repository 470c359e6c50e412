"""Adversarial states for the P3M pair kernel's pruning: (N, 4) float32
numpy arrays, shared by tests/test_torch_p3m.py (the tables and a numpy
emulation of the kernel, on the CPU) and tests/test_torch_cuda.py (the
kernel on the card). Each state holds two bodies at the corners of the unit
cube and the rest inside, so the fitted box, and with it the rcut-cell
lattice, is known before the rest is placed. About one body in ten has zero
mass: zero-mass bodies enter the cluster boxes and pair like the others."""

import numpy as np
import torch

from nbody_tpu_torch.ops import p3m

GRID = 32
KINDS = ("rcut_pairs", "collapsed", "faces", "odd")


def lattice(grid: int = GRID):
    """(lo (3,), rcut) of the rcut-cell lattice of any state spanning the
    unit cube, as float32 numpy values."""
    frame = torch.tensor([[0, 0, 0, 1], [1, 1, 1, 1]], dtype=torch.float32)
    _, _, lo, _, rcut, _, _ = p3m._cells(frame, grid)
    return lo.numpy(), np.float32(rcut)


def _on_sphere(rng, m):
    u = rng.normal(size=(m, 3))
    return u / np.linalg.norm(u, axis=1, keepdims=True)


def state(kind: str, grid: int = GRID, seed: int = 0) -> np.ndarray:
    """The state `kind`:

      * ``rcut_pairs``: 300 pairs at rcut * (1 + e), e in {-1e-7, 0, 1e-7},
        their first body within 1e-3 of a cell face, so that most straddle
        a cell border, among 60 scattered bodies: many cells hold one or
        two bodies, whose clusters' boxes are points, so the box and row
        tests meet r^2 within a few ulps of rcut^2 on both sides;
      * ``collapsed``: 400 bodies at one point and 100 within 1e-3 of it
        (13 clusters of one cell, most with a box of a point), 60 at
        rcut * (1 + e) from it, among 200 scattered bodies;
      * ``faces``: a lattice of spacing rcut / 2 from the cell lattice's
        origin, every other plane a cell face, pairs at rcut along the axes;
      * ``odd``: 1037 bodies of a Gaussian cloud, not a multiple of 32.
    """
    rng = np.random.default_rng(seed)
    lo, rcut = (x.astype(np.float64) for x in lattice(grid))
    if kind == "rcut_pairs":
        a = rng.uniform(0.25, 0.75, (300, 3))
        axis = rng.integers(0, 3, 300)
        rows = np.arange(300)
        face = lo[axis] + np.round((a[rows, axis] - lo[axis]) / rcut) * rcut
        a[rows, axis] = np.clip(face + rng.uniform(-1e-3, 1e-3, 300), 0.25, 0.75)
        e = rng.choice([-1e-7, 0.0, 1e-7], (300, 1))
        pts = np.concatenate([a, a + _on_sphere(rng, 300) * rcut * (1 + e),
                              rng.uniform(0.02, 0.98, (60, 3))])
    elif kind == "collapsed":
        p0 = np.array([0.5, 0.5, 0.5])
        e = rng.choice([-1e-7, 0.0, 1e-7], (60, 1))
        pts = np.concatenate([np.tile(p0, (400, 1)), p0 + rng.uniform(-1e-3, 1e-3, (100, 3)),
                              p0 + _on_sphere(rng, 60) * rcut * (1 + e),
                              rng.uniform(0.02, 0.98, (200, 3))])
    elif kind == "faces":
        ks = np.arange(np.ceil((0.02 - lo.max()) / (rcut / 2)),
                       np.floor((0.98 - lo.min()) / (rcut / 2)) + 1)
        axes = [lo[a] + ks * (rcut / 2) for a in range(3)]
        axes = [x[(x >= 0.02) & (x <= 0.98)] for x in axes]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    elif kind == "odd":
        pts = np.clip(rng.normal(0.5, 0.15, (1035, 3)), 0.02, 0.98)
    else:
        raise ValueError(f"unknown state {kind!r}")
    mass = rng.uniform(0.5, 2.0, len(pts))
    mass[rng.random(len(pts)) < 0.1] = 0.0
    body = np.concatenate([pts, mass[:, None]], axis=1)
    frame = np.array([[0, 0, 0, 1], [1, 1, 1, 1]], np.float64)
    return np.concatenate([frame, body]).astype(np.float32)
