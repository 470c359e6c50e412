"""CPU oracles: NumPy reference stepper + native C++ (OpenMP) engine.

The port's own copy of ``nbody_tpu.oracle``, with the same names and
behaviour. It plays the role of the reference's ``BodySystemCPU`` golden
oracle: the device path is compared element-wise against a CPU step from
identical state, |dpos| <= 5e-4 after one dt=0.001 step.

``step_best`` dispatches to the native C++ engine when its shared library
builds (``python -m nbody_tpu_torch.oracle.build``), else NumPy.
"""

from nbody_tpu_torch.oracle.numpy_oracle import step_numpy, step_numpy_leapfrog, accel_numpy
from nbody_tpu_torch.oracle.native import (
    native_available,
    step_native,
    step as step_best,
)

__all__ = [
    "step_numpy",
    "step_numpy_leapfrog",
    "accel_numpy",
    "native_available",
    "step_native",
    "step_best",
]
