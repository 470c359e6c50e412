"""Build the native C++ oracle shared library of nbody_tpu_torch.

Usage: ``python -m nbody_tpu_torch.oracle.build``
Produces ``build/nbody_tpu_torch/libnbody_oracle_<hash>.so`` beside the
package, named by a hash of the sources and flags, so an edited source
builds anew. The loader (:mod:`nbody_tpu_torch.oracle.native`) builds it at
first use and falls back to the NumPy oracle when the toolchain is
unavailable. The sources and flags are those of ``nbody_tpu``'s oracle, so
the two libraries step alike.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SOURCES = (HERE / "nbody_oracle.cpp", HERE / "nbody_io.cpp")
BUILD_DIR = HERE.parents[1] / "build" / "nbody_tpu_torch"

# warnings-as-errors mirrors the reference's dev-mode discipline
_WARN = ["-Wall", "-Wextra", "-Werror"]
FLAGS = ("-O3", "-march=native", "-fopenmp", "-std=c++17", *_WARN,
         "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libnbody_oracle_{h.hexdigest()[:16]}.so"


def build(verbose: bool = True) -> pathlib.Path:
    """Build the library if no library of these sources exists; return its
    path. Compiles to a temporary name and renames it into place, so a
    process that has an older library mapped keeps a valid file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = ["g++", *FLAGS, *(str(s) for s in SOURCES), "-o", str(tmp)]
    if verbose:
        print("+", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    try:
        print(f"built {build()}")
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"native oracle build failed ({e}); NumPy oracle will be used", file=sys.stderr)
        sys.exit(1)
