"""Profiling and observability: torch.profiler traces, named spans, and
device-memory introspection (the port of ``nbody_tpu.utils.profiling``).

* ``trace(dir)`` — context manager around ``torch.profiler.profile``
  (the CPU, and the card's kernels where there is one); at its end a Chrome
  trace (``trace_<pid>.json``) is written into DIR, which opens in
  Perfetto or chrome://tracing. CLI: ``--profile DIR``.
* ``annotate(name, args)`` — a named span (``torch.profiler.record_function``)
  so framework phases are labeled inside the timeline; a shared no-op when
  no profiler is active. The names the package uses are in SPANS.
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


# The spans of the package, outermost first where they nest: a step holds a
# force evaluation, which holds a CUDA graph's capture (around the P3M and
# PM stages) or replay, or the stages themselves, and the exchanges of a
# mesh. Names are fixed; what varies (a segment, a hop, what a read is for)
# goes in the span's args.
SPANS = (
    "nbody.step",                 # one step of update_many: force and update
    "nbody.force",                # a force evaluation, with its sums
    "nbody.integrate",            # the O(N) update apart from the force
    "nbody.p3m.tables",           # P3M binning, sorts and work items
    "nbody.p3m.pairs",            # the pair sums and their map back to bodies
    "nbody.pm.deposit",           # mass onto the mesh
    "nbody.pm.solve",             # the FFT solve
    "nbody.pm.gather",            # the mesh's force at the bodies
    "nbody.pm.influence_table",   # the optimal influence table (once)
    "nbody.graph.capture",        # a force's capture into a CUDA graph (once a key)
    "nbody.graph.replay",         # a force's replay: input copy, graph launch, output copy
    "nbody.p3m.probe",            # the capacity probe of each step, its read
    "nbody.p3m.refresh",          # a rewind and re-size of the P3M capacity
    "nbody.ring.exchange",        # a hop's send and receive
    "nbody.allgather",            # an all-gather of the ranks' rows
    "nbody.reduce_scatter",       # the fixed-order reduce-scatter
    "nbody.readback",             # the state copied to the host
    "nbody.host_read",            # a counted blocking read (utils.timing.host_read)
    "nbody.setup.library",        # loading, or building, the kernels' library
    "nbody.adaptive_rollout",     # a segment of an adaptive rollout
    "nbody.block_rollout",        # a segment of a block-timestep rollout
    "nbody.ds_adaptive_rollout",  # a segment of a ds adaptive rollout
)

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, args: Optional[str] = None):
    """Named span in the profiler timeline, as a context manager: a
    ``torch.profiler.record_function(name, args)`` while a profiler is
    active, so the span sits in the same trace and on the same clock as the
    card's kernels; else one shared no-op, which costs a flag check. It
    never synchronises and never allocates on the device.

        with annotate("nbody.host_read", "what=p3m_probe"):
            ...
    """
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name, args)


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
