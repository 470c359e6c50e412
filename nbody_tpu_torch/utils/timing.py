"""Timing on the device the work runs on.

The reference times with CUDA events around the kernel loop, after one
untimed warm-up step (compute_cuda.cpp:183-195). On a CUDA device this
module does the same; on the CPU it reads the host clock, since the CPU's
work is done when the call returns.
"""

from __future__ import annotations

import collections
import time

import torch

from nbody_tpu_torch.utils.profiling import annotate

# blocking reads of device values on the host, by what read them
# (``host_read``)
HOST_READS: collections.Counter = collections.Counter()


def host_read(t: torch.Tensor, what: str) -> list:
    """`t`'s values on the host as a (nested) list, counted in
    ``HOST_READS[what]`` and spanned as ``nbody.host_read`` (`what` in its
    args): the one host synchronisation that an adaptive segment (its
    stats), a block macro step (its class counts) or a P3M ``update_many``
    (its contract probe) makes."""
    HOST_READS[what] += 1
    with annotate("nbody.host_read", f"what={what}"):
        return t.tolist()


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


def best_of_ms(fn, device, *, rounds: int = 3) -> float:
    """The least of `rounds` ``elapsed_ms(fn, device)`` after one untimed
    warm-up call: a roll of steps timed as the TPU scripts time their
    ``lax.scan`` rolls, best of a few because noise only slows a round."""
    fn()
    return min(elapsed_ms(fn, device) for _ in range(rounds))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card), to stand beside every time taken on it."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
