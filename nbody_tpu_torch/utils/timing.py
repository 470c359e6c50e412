"""Timing on the device the work runs on.

The reference times with CUDA events around the kernel loop, after one
untimed warm-up step (compute_cuda.cpp:183-195). On a CUDA device this
module does the same; on the CPU it reads the host clock, since the CPU's
work is done when the call returns.
"""

from __future__ import annotations

import time

import torch


def synchronize(device) -> None:
    """Wait until all work queued on `device` has finished (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn, device) -> float:
    """Milliseconds that fn() takes on `device`: CUDA events on the current
    stream around the call on a CUDA device, the host clock on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
