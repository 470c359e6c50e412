"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built from ``nbody_tpu_torch/csrc/*.cu`` at the first CUDA
launch, into ``build/nbody_tpu_torch/`` beside the package, under a name
that carries a hash of the sources, their shared headers and the flags, so
an edited source builds anew. Each source is compiled by its own nvcc, all started
together, and the objects are linked into one library. The build writes a
temporary file and renames it into place, so a process that has an older
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
SOURCES = (CSRC / "nbody_kernels.cu", CSRC / "symmetric_kernels.cu",
           CSRC / "symmetric_aj_kernels.cu", CSRC / "ds_kernels.cu",
           CSRC / "ds_symmetric_kernels.cu", CSRC / "ds_aj_kernels.cu",
           CSRC / "ds_symmetric_aj_kernels.cu", CSRC / "mxu_kernels.cu",
           CSRC / "p3m_kernels.cu")
HEADERS = (CSRC / "sym_common.cuh", CSRC / "ds_common.cuh", CSRC / "ds_sym_common.cuh")
BUILD_DIR = PKG.parent / "build" / "nbody_tpu_torch"

# sm_90a, not sm_90: the Hopper-only instructions (wgmma, setmaxnreg) that
# later kernels use exist only for the 'a' target
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libnbody_kernels_{_digest()}.so"


def nvcc_commands(nvcc: str, out: pathlib.Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) that build `out`;
    the objects go beside it."""
    objs = [out.with_name(f"{out.name}.{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(out), *(str(o) for o in objs)]
    return compiles, link


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{text}")


def build() -> pathlib.Path:
    """Build the library if no library of these sources exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    compiles, link = nvcc_commands(nvcc, tmp)
    objs = [pathlib.Path(c[c.index("-o") + 1]) for c in compiles]
    try:
        _run_all(compiles)
        _run_all([link])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures (once per process)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.nbody_step_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64,
                                   f32, f32, f32, i64, ptr]
    lib.nbody_step_f32.restype = ctypes.c_int
    lib.nbody_step_t_f32.argtypes = [ptr] * 6 + [i64, f32, f32, f32, i64, ptr]
    lib.nbody_step_t_f32.restype = ctypes.c_int
    for name in ("nbody_mxu_step_f32", "nbody_mxu_step_bf16"):
        getattr(lib, name).argtypes = [ptr] * 5 + [i64, i64, f32, f32, f32, ptr]
        getattr(lib, name).restype = ctypes.c_int
    lib.nbody_accel_f32.argtypes = [ptr, ptr, ptr, i64, i64, f32, i64, ptr]
    lib.nbody_accel_f32.restype = ctypes.c_int
    lib.nbody_sym_accel_f32.argtypes = [ptr, i64, f32, i64, ptr, ptr, ptr]
    lib.nbody_sym_accel_f32.restype = ctypes.c_int
    lib.nbody_sym_cross_f32.argtypes = [ptr, i64, ptr, i64, f32, i64, ptr, ptr,
                                        ptr, ptr, ptr]
    lib.nbody_sym_cross_f32.restype = ctypes.c_int
    lib.nbody_accel_jerk_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, f32, i64, ptr]
    lib.nbody_accel_jerk_f32.restype = ctypes.c_int
    lib.nbody_potential_f32.argtypes = [ptr, ptr, i64, f32, i64, ptr]
    lib.nbody_potential_f32.restype = ctypes.c_int
    lib.nbody_aj_sym_f32.argtypes = [ptr, ptr, i64, f32, i64, ptr, ptr, ptr, ptr]
    lib.nbody_aj_sym_f32.restype = ctypes.c_int
    lib.nbody_aj_cross_f32.argtypes = [ptr, ptr, i64, ptr, ptr, i64, f32, i64, ptr, ptr,
                                       ptr, ptr, ptr, ptr, ptr]
    lib.nbody_aj_cross_f32.restype = ctypes.c_int
    # the ds entry points take the (2, 4) scalar block as a host pointer
    lib.nbody_ds_step.argtypes = [ptr] * 10 + [i64, i64, ptr, i64, ptr]
    lib.nbody_ds_step.restype = ctypes.c_int
    lib.nbody_ds_leapfrog.argtypes = [ptr] * 12 + [i64, i64, ptr, i64, ptr]
    lib.nbody_ds_leapfrog.restype = ctypes.c_int
    lib.nbody_ds_sym_accel.argtypes = [ptr, ptr, i64, ptr, i64, ptr, ptr, ptr, ptr]
    lib.nbody_ds_sym_accel.restype = ctypes.c_int
    lib.nbody_ds_sym_cross.argtypes = [ptr, ptr, i64, ptr, ptr, i64, ptr, i64] + [ptr] * 7
    lib.nbody_ds_sym_cross.restype = ctypes.c_int
    lib.nbody_ds_integrate.argtypes = [ptr] * 10 + [i64, ptr, ptr]
    lib.nbody_ds_integrate.restype = ctypes.c_int
    lib.nbody_ds_accel_jerk.argtypes = [ptr] * 12 + [i64, i64, ptr, i64, ptr]
    lib.nbody_ds_accel_jerk.restype = ctypes.c_int
    lib.nbody_ds_aj_sym.argtypes = [ptr] * 4 + [i64, ptr, i64] + [ptr] * 6
    lib.nbody_ds_aj_sym.restype = ctypes.c_int
    lib.nbody_ds_aj_cross.argtypes = ([ptr] * 4 + [i64] + [ptr] * 4 + [i64, ptr, i64]
                                      + [ptr] * 11)
    lib.nbody_ds_aj_cross.restype = ctypes.c_int
    lib.nbody_ds_hermite_predict.argtypes = [ptr] * 8 + [i64] + [ptr] * 4 + [i64, ptr, ptr]
    lib.nbody_ds_hermite_predict.restype = ctypes.c_int
    lib.nbody_ds_hermite_correct.argtypes = [ptr] * 12 + [i64] + [ptr] * 4 + [i64, ptr, ptr]
    lib.nbody_ds_hermite_correct.restype = ctypes.c_int
    lib.nbody_p3m_sr_f32.argtypes = [ptr] * 7 + [i64, i64, i64, ptr]
    lib.nbody_p3m_sr_f32.restype = ctypes.c_int
    lib.nbody_error_string.argtypes = [ctypes.c_int]
    lib.nbody_error_string.restype = ctypes.c_char_p
    return lib
