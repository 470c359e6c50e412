"""Scatter-adds summed in one order on every run.

An atomic scatter-add on the card sums the values that meet in one slot in
whatever order its threads arrive, so the same inputs give other bits on
each run. ``index_add_`` under ``torch.use_deterministic_algorithms(True)``
sorts the indices (stably) and sums each slot's values in their order, as
the CPU's sequential loop does. The P3M deposit and the rasterizer use it.
"""

from __future__ import annotations

import torch


def index_add_ordered(buf: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``buf.index_add_(0, index, values)`` in deterministic mode, the
    caller's mode restored after; returns `buf`."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        buf.index_add_(0, index, values)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
    return buf
