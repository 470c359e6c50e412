"""nbody_tpu_torch — the PyTorch / CUDA port of nbody_tpu for NVIDIA Hopper.

The JAX package ``nbody_tpu`` stays the reference. This package imports
nothing of it and never JAX: it keeps its own copies of the plain-numpy
modules (parameters, configurations, initial conditions, the CPU oracle,
checkpoints and tipsy files). Its hot path is hand-written CUDA for
sm_90a (``nbody_tpu_torch/csrc``), built with nvcc at first use.

State convention, the same as ``nbody_tpu``'s: ``pos`` is an ``(N, 4)``
float32 tensor with columns ``x, y, z, mass`` and ``vel`` is ``(N, 4)`` with
columns ``vx, vy, vz, 0``.
"""

from nbody_tpu_torch import ic
from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.params import DEMO_PARAMS, NBodyParams, tuned_scales

__all__ = [
    "NBodyParams",
    "DEMO_PARAMS",
    "NBodyConfig",
    "tuned_scales",
    "ic",
    "Compute",
    "BodySystem",
    "DSBodySystem",
]

__version__ = "0.1.0"


def __getattr__(name):
    # torch-heavy exports load on first use
    if name == "Compute":
        from nbody_tpu_torch.compute import Compute

        return Compute
    if name in ("BodySystem", "DSBodySystem"):
        from nbody_tpu_torch import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
