"""The check that the process measured nothing of the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``nbody_tpu_torch`` is not ``nbody_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
