"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built from ``nbody_tpu_torch/csrc/*.cu`` at the first CUDA
launch, into ``build/nbody_tpu_torch/`` beside the package, under a name
that carries a hash of the sources and the flags, so an edited source
builds anew. The build writes a temporary file and renames it into place,
as ``nbody_tpu/oracle/build.py`` does, so a process that has an older
library mapped keeps a valid file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
SOURCES = (CSRC / "nbody_kernels.cu",)
BUILD_DIR = PKG.parent / "build" / "nbody_tpu_torch"

# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg) that
# later kernels use exist only for the 'a' target
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, else nvcc on PATH. Raises
    RuntimeError naming what is missing."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        nvcc = pathlib.Path(cuda_home) / "bin" / "nvcc"
        if nvcc.is_file():
            return str(nvcc)
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc (the CUDA toolkit's compiler) was not found: set CUDA_HOME to "
        "the toolkit's root or put nvcc on PATH; the CUDA kernels of "
        "nbody_tpu_torch are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libnbody_kernels_{_digest()}.so"


def nvcc_command(nvcc: str, out: pathlib.Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(s) for s in SOURCES)]


def build() -> pathlib.Path:
    """Build the library if no library of these sources exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = nvcc_command(nvcc, tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures (once per process)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.nbody_step_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                   f32, f32, f32, i64, ptr]
    lib.nbody_step_f32.restype = ctypes.c_int
    lib.nbody_accel_f32.argtypes = [ptr, ptr, ptr, i64, i64, f32, i64, ptr]
    lib.nbody_accel_f32.restype = ctypes.c_int
    lib.nbody_error_string.argtypes = [ctypes.c_int]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
