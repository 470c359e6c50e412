"""Simulation parameters and demo presets.

Behavioral parity targets:
* ``NBodyParams`` mirrors the reference struct
  (the reference's src/nbody/params.hpp:8-17): time step, cluster scale,
  velocity scale, Plummer softening, velocity damping, camera origin.
* ``DEMO_PARAMS`` mirrors the 7 hard-coded demo presets
  (the reference's src/nbody/compute.hpp:90-97) and ``DEMO_TIME_S`` the 10 s
  auto-cycle (the reference's src/nbody/compute.hpp:101).
* ``tuned_scales`` mirrors the N-bucketed cluster/velocity-scale tuning table
  (the reference's src/nbody/compute.cpp:74-92).
* ``flops_per_interaction`` keeps the reference's 20 fp32 / 30 fp64 flops
  accounting (the reference's src/nbody/compute.cpp:16-18).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class NBodyParams:
    time_step: float = 0.016
    cluster_scale: float = 1.54
    velocity_scale: float = 8.0
    softening: float = 0.1
    damping: float = 1.0
    camera_origin: Tuple[float, float, float] = (0.0, -2.0, -100.0)

    def replace(self, **kw) -> "NBodyParams":
        return dataclasses.replace(self, **kw)

    def print_values(self) -> str:
        """Source-pasteable parameter dump (reference 'o' key,
        the reference's src/nbody/params.cpp:5-7)."""
        c = self.camera_origin
        return (
            f"{{ {self.time_step}, {self.cluster_scale}, {self.velocity_scale}, "
            f"{self.softening}, {self.damping}, {c[0]}, {c[1]}, {c[2]} }},"
        )


# The 7 demo presets (time_step, cluster_scale, velocity_scale, softening,
# damping, camera xyz) — same values as the reference's table.
DEMO_PARAMS: Tuple[NBodyParams, ...] = (
    NBodyParams(0.016, 1.54, 8.0, 0.1, 1.0, (0.0, -2.0, -100.0)),
    NBodyParams(0.016, 0.68, 20.0, 0.1, 1.0, (0.0, -2.0, -30.0)),
    NBodyParams(0.0006, 0.16, 1000.0, 1.0, 1.0, (0.0, 0.0, -15.0)),
    NBodyParams(0.0006, 0.16, 1000.0, 1.0, 1.0, (0.0, 0.0, -15.0)),
    NBodyParams(0.0019, 0.32, 276.0, 1.0, 1.0, (0.0, 0.0, -50.0)),
    NBodyParams(0.0016, 0.32, 272.0, 0.145, 1.0, (0.0, 0.0, -50.0)),
    NBodyParams(0.016, 6.04, 0.0, 1.0, 1.0, (0.0, 0.0, -50.0)),
)

DEMO_TIME_S = 10.0

FLOPS_PER_INTERACTION_FP32 = 20
FLOPS_PER_INTERACTION_FP64 = 30


def flops_per_interaction(fp64: bool) -> int:
    return FLOPS_PER_INTERACTION_FP64 if fp64 else FLOPS_PER_INTERACTION_FP32


# N-bucketed (cluster_scale, velocity_scale) tuning, applied on engine
# construction for the default (shell) demo.
_SCALE_BUCKETS = (
    (1024, (1.52, 2.0)),
    (2048, (1.56, 2.64)),
    (4096, (1.68, 2.98)),
    (8192, (1.98, 2.9)),
    (16384, (1.54, 8.0)),
    (32768, (1.44, 11.0)),
)


def tuned_scales(num_bodies: int) -> Tuple[float, float] | None:
    """(cluster_scale, velocity_scale) for the given N, or None to keep the
    active demo preset's values (N > 32768)."""
    for upper, scales in _SCALE_BUCKETS:
        if num_bodies <= upper:
            return scales
    return None


def interactions_per_second(num_bodies: int, steps_per_second: float) -> float:
    """Billions of body-body interactions per second: N^2 * freq * 1e-9
    (the reference's src/nbody/compute.cpp:118)."""
    return float(num_bodies) * float(num_bodies) * 1e-9 * steps_per_second


def gflops(num_bodies: int, steps_per_second: float, fp64: bool) -> float:
    return interactions_per_second(num_bodies, steps_per_second) * flops_per_interaction(fp64)
