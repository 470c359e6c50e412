"""Profiling and observability: torch.profiler traces, named spans, and
device-memory introspection (the port of ``nbody_tpu.utils.profiling``).

* ``trace(dir)`` — context manager around ``torch.profiler.profile``
  (the CPU, and the card's kernels where there is one); at its end a Chrome
  trace (``trace_<pid>.json``) is written into DIR, which opens in
  Perfetto or chrome://tracing. CLI: ``--profile DIR``.
* ``annotate(name)`` — a named span (``torch.profiler.record_function``)
  so framework phases are labeled inside the timeline.
* ``format_memory_line(device)`` — the card's allocator: in use, peak and
  the card's memory, from ``torch.cuda.memory_stats`` and
  ``max_memory_allocated``; None on the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block and write its Chrome trace into `log_dir`; a no-op
    (yielding None) when `log_dir` is falsy."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """Named span in the profiler timeline; usable as a context manager,
    cheap when no trace is active.

        with annotate("nbody.step"):
            system.update()
    """
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """The CUDA allocator's bytes in use, peak and the card's memory for
    `device` (default: the current card) as a plain dict; {} on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }


def format_memory_line(device=None) -> Optional[str]:
    """One-line summary of the card's memory; None where there is none."""
    s = device_memory_stats(device)
    if not s:
        return None
    gib = 1024.0 ** 3
    return (f"device memory: in use {s['bytes_in_use'] / gib:.2f} GiB, "
            f"peak {s['peak_bytes_in_use'] / gib:.2f} GiB, "
            f"limit {s['bytes_limit'] / gib:.2f} GiB")
