"""Build the native C++ oracle shared library of nbody_tpu_torch.

Usage: ``python -m nbody_tpu_torch.oracle.build [--sanitize]``
Produces ``build/nbody_tpu_torch/libnbody_oracle_<hash>.so`` beside the
package, named by a hash of the sources and flags, so an edited source
builds anew. The loader (:mod:`nbody_tpu_torch.oracle.native`) builds it at
first use and falls back to the NumPy oracle when the toolchain is
unavailable. The sources and flags are those of ``nbody_tpu``'s oracle, so
the two libraries step alike.

``build_cli`` builds the standalone benchmark / QA binary
(``nbody_cli.cpp`` on the same engine) as ``nbody_cli_<hash>`` in the same
directory; ``sanitize=True`` builds it with AddressSanitizer and
UndefinedBehaviorSanitizer, as ``nbody_tpu``'s ``--sanitize`` build does.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SOURCES = (HERE / "nbody_oracle.cpp", HERE / "nbody_io.cpp")
CLI_SOURCES = (HERE / "nbody_cli.cpp", *SOURCES)
BUILD_DIR = HERE.parents[1] / "build" / "nbody_tpu_torch"

# warnings-as-errors mirrors the reference's dev-mode discipline
_WARN = ["-Wall", "-Wextra", "-Werror"]
_COMMON = ("-march=native", "-fopenmp", "-std=c++17", *_WARN)
FLAGS = ("-O3", *_COMMON, "-shared", "-fPIC")
CLI_FLAGS = ("-O3", *_COMMON)
# ASan + UBSan, the reference's sanitize-ci preset (nbody_tpu/oracle/build.py)
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all")


def _hashed(stem: str, sources, flags, suffix: str = "") -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def _cli_flags(sanitize: bool) -> tuple:
    # the sanitized build swaps -O3 for SAN_FLAGS' -O1 -g
    return (*CLI_FLAGS[1:], *SAN_FLAGS) if sanitize else CLI_FLAGS


def library_path() -> pathlib.Path:
    return _hashed("libnbody_oracle", SOURCES, FLAGS, ".so")


def cli_path(sanitize: bool = False) -> pathlib.Path:
    return _hashed("nbody_cli_asan" if sanitize else "nbody_cli", CLI_SOURCES,
                   _cli_flags(sanitize))


def _build(out: pathlib.Path, sources, flags, verbose: bool) -> pathlib.Path:
    """Build `out` if it does not exist yet; return its path. Compiles to a
    temporary name and renames it into place, so a process that has an
    older library mapped (or an older binary running) keeps a valid file."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + f".tmp{os.getpid()}")
    cmd = ["g++", *flags, *(str(s) for s in sources), "-o", str(tmp)]
    if verbose:
        print("+", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def build(verbose: bool = True) -> pathlib.Path:
    """The oracle library of these sources, built if missing."""
    return _build(library_path(), SOURCES, FLAGS, verbose)


def build_cli(verbose: bool = True, *, sanitize: bool = False) -> pathlib.Path:
    """The native benchmark / QA binary of these sources, built if missing."""
    return _build(cli_path(sanitize), CLI_SOURCES, _cli_flags(sanitize), verbose)


if __name__ == "__main__":
    sanitize = "--sanitize" in sys.argv
    try:
        print(f"built {build()}")
        print(f"built {build_cli(sanitize=sanitize)}")
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"native oracle build failed ({e}); NumPy oracle will be used", file=sys.stderr)
        sys.exit(1)
