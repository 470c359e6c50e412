"""ctypes bindings for the native C++ oracle, with NumPy fallback.

The shared library is built on demand (first use) into
``build/nbody_tpu_torch/`` if a compiler is present (``oracle/build.py``);
otherwise ``step`` silently uses the NumPy oracle. A library is named by a
hash of its sources, so a stale one is never loaded.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Optional

import numpy as np

from nbody_tpu_torch.oracle.numpy_oracle import step_numpy, step_numpy_leapfrog

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from nbody_tpu_torch.oracle.build import build

    try:
        lib = ctypes.CDLL(str(build(verbose=False)))
    except (OSError, subprocess.CalledProcessError):
        return None

    i64 = ctypes.c_int64
    for suffix, ct in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        ptr = ctypes.POINTER(ct)
        getattr(lib, f"nbody_accel_{suffix}").argtypes = [ptr, i64, ct, ptr]
        getattr(lib, f"nbody_accel_jerk_{suffix}").argtypes = [
            ptr, ptr, i64, ct, ptr, ptr]
        for integ in ("", "_leapfrog", "_hermite"):
            getattr(lib, f"nbody_step{integ}_{suffix}").argtypes = [
                ptr, ptr, i64, ct, ct, ct]
            getattr(lib, f"nbody_rollout{integ}_{suffix}").argtypes = [
                ptr, ptr, i64, ct, ct, ct, i64]
    lib.nbody_oracle_num_threads.restype = ctypes.c_int
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.nbody_tipsy_count.argtypes = [ctypes.c_char_p]
    lib.nbody_tipsy_count.restype = i64
    lib.nbody_tipsy_read.argtypes = [ctypes.c_char_p, dptr, dptr]
    lib.nbody_tipsy_read.restype = ctypes.c_int
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _fns(dtype, integrator: str = "euler"):
    lib = _load()
    assert lib is not None
    integ = {"euler": "", "leapfrog": "_leapfrog", "hermite": "_hermite"}[integrator]
    if dtype == np.float32:
        return (getattr(lib, f"nbody_step{integ}_f32"),
                getattr(lib, f"nbody_rollout{integ}_f32"),
                lib.nbody_accel_f32, ctypes.c_float)
    if dtype == np.float64:
        return (getattr(lib, f"nbody_step{integ}_f64"),
                getattr(lib, f"nbody_rollout{integ}_f64"),
                lib.nbody_accel_f64, ctypes.c_double)
    raise TypeError(f"unsupported dtype {dtype}")


def accel_native(pos: np.ndarray, softening: float) -> np.ndarray:
    _, _, accel, ct = _fns(pos.dtype.type)
    pos = np.ascontiguousarray(pos)
    n = pos.shape[0]
    acc = np.empty((n, 3), dtype=pos.dtype)
    ptr = ctypes.POINTER(ct)
    accel(pos.ctypes.data_as(ptr), n, ct(softening), acc.ctypes.data_as(ptr))
    return acc


def accel_jerk_native(pos: np.ndarray, vel: np.ndarray, softening: float):
    """(acc, jerk) each (N,3) from the native Hermite force engine."""
    lib = _load()
    assert lib is not None
    pos = np.ascontiguousarray(pos)
    vel = np.ascontiguousarray(vel)
    n = pos.shape[0]
    if pos.dtype.type == np.float32:
        fn, ct = lib.nbody_accel_jerk_f32, ctypes.c_float
    else:
        fn, ct = lib.nbody_accel_jerk_f64, ctypes.c_double
    acc = np.empty((n, 3), dtype=pos.dtype)
    jerk = np.empty((n, 3), dtype=pos.dtype)
    ptr = ctypes.POINTER(ct)
    fn(pos.ctypes.data_as(ptr), vel.ctypes.data_as(ptr), n, ct(softening),
       acc.ctypes.data_as(ptr), jerk.ctypes.data_as(ptr))
    return acc, jerk


def step_native(pos, vel, dt, softening, damping, steps: int = 1,
                integrator: str = "euler"):
    """`steps` in-place native steps on copies; returns new (pos, vel).
    All three integrators run fully inside the C++ engine (euler /
    DKD leapfrog / 4th-order Hermite P(EC)) so the oracle is a single
    ground truth independent of NumPy — the reference's single-oracle
    discipline (the reference's src/nbody/bodysystemcpu.cpp:140-303)."""
    step1, rollout, _, ct = _fns(pos.dtype.type, integrator)
    pos = np.ascontiguousarray(pos).copy()
    vel = np.ascontiguousarray(vel).copy()
    n = pos.shape[0]
    ptr = ctypes.POINTER(ct)
    rollout(
        pos.ctypes.data_as(ptr),
        vel.ctypes.data_as(ptr),
        n,
        ct(dt),
        ct(softening),
        ct(damping),
        steps,
    )
    return pos, vel


def step_native_leapfrog(pos, vel, dt, softening, damping):
    """DKD leapfrog inside the native engine."""
    return step_native(pos, vel, dt, softening, damping,
                       integrator="leapfrog")


def step_native_hermite(pos, vel, dt, softening, damping):
    """4th-order Hermite P(EC) inside the native engine."""
    return step_native(pos, vel, dt, softening, damping,
                       integrator="hermite")


def step(pos, vel, dt, softening, damping, integrator: str = "euler"):
    """Best available CPU oracle step (native if built, else NumPy), with the
    integrator matching the device's (QA must compare like with like)."""
    if native_available():
        return step_native(pos, vel, dt, softening, damping,
                           integrator=integrator)
    if integrator == "hermite":
        from nbody_tpu_torch.oracle.numpy_oracle import step_numpy_hermite

        return step_numpy_hermite(pos, vel, dt, softening, damping)
    if integrator == "leapfrog":
        return step_numpy_leapfrog(pos, vel, dt, softening, damping)
    return step_numpy(pos, vel, dt, softening, damping)


def read_tipsy_native(path):
    """Native tipsy loader; returns (pos, vel) float64 AoS, padded to 256,
    or raises ValueError. Caller ensures native_available()."""
    lib = _load()
    assert lib is not None
    encoded = str(path).encode()
    n = lib.nbody_tipsy_count(encoded)
    if n < 0:
        raise ValueError(f"cannot read tipsy file {path}")
    pos = np.zeros((n, 4), dtype=np.float64)
    vel = np.zeros((n, 4), dtype=np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = lib.nbody_tipsy_read(
        encoded, pos.ctypes.data_as(dptr), vel.ctypes.data_as(dptr)
    )
    if rc != 0:
        raise ValueError(f"tipsy read failed for {path} (code {rc})")
    return pos, vel
