"""Camera with inertia smoothing and perspective projection.

Mirrors the reference camera semantics
(the reference's src/nbody/camera.cpp:5-26): a translation + (x,y) rotation
pair smoothed with 0.1 inertia per frame, zoom scaling with distance, and a
per-demo reset origin; plus the projection the reference gets from
gluPerspective (60 deg fov, 0.1..1000 z-range, the reference's src/nbody.cpp
GL setup).
"""

from __future__ import annotations

import math

import numpy as np

INERTIA = 0.1


def _rot_x(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


class Camera:
    def __init__(self, origin=(0.0, -2.0, -100.0)):
        self.translation = np.array(origin, dtype=np.float32)
        self.rotation = np.zeros(3, dtype=np.float32)
        self._translation_lag = self.translation.copy()
        self._rotation_lag = np.zeros(3, dtype=np.float32)

    def reset(self, origin) -> None:
        self.translation = np.array(origin, dtype=np.float32)
        self.rotation = np.zeros(3, dtype=np.float32)
        # lag state intentionally persists: the reference keeps its static
        # lag arrays across demo switches, giving the smooth fly-over

    def zoom(self, dy: float) -> None:
        self.translation[2] += (dy / 100.0) * 0.5 * abs(self.translation[2])

    def rotate(self, dx: float, dy: float) -> None:
        self.rotation[0] += dy / 5.0
        self.rotation[1] += dx / 5.0

    def translate(self, dx: float, dy: float) -> None:
        self.translation[0] += dx / 100.0
        self.translation[1] -= dy / 100.0

    def view_matrix(self) -> np.ndarray:
        """Advance inertia lag one frame and return the 4x4 modelview."""
        self._translation_lag += (self.translation - self._translation_lag) * INERTIA
        self._rotation_lag += (self.rotation - self._rotation_lag) * INERTIA
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = self._translation_lag
        return t @ _rot_x(self._rotation_lag[0]) @ _rot_y(self._rotation_lag[1])


def perspective(fov_deg: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_deg) / 2)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m
