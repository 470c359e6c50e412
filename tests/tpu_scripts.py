"""Load the JAX package's experiment scripts (scripts/tpu_*.py) as modules,
for the tests that hold the port's counterparts of their Pallas kernels.

Importing a script runs its top level. tpu_r4_sym_budget.py reads
sys.argv[1] as N, so the loader sets argv to the script's path alone.
tpu_r3_dualbank.py and tpu_r3_packed.py enable the persistent compile
cache, which would point JAX's cache away from the suite's, so the loader
sets NBODY_NO_COMPILE_CACHE=1 around the import. They also put "." on
sys.path, which the loader restores. The scripts' own step functions have
no interpret argument, and pltpu's compiler parameters cannot lower on the
CPU. So each test builds its own ``pl.pallas_call(..., interpret=True)``
around a script's kernel body, with the script's block specs at small
tiles.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import pytest

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def load_script(name: str):
    """scripts/<name>.py as a module, imported with argv, the compile cache
    and sys.path as the docstring says."""
    path = SCRIPTS / f"{name}.py"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NBODY_NO_COMPILE_CACHE", "1")
        mp.setattr(sys, "argv", [str(path)])
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(f"tpu_script_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module
