"""The traced run's device records: torch.profiler over the measured window,
reduced to the device's busy time, its time by operation and its idle gaps.

Busy time is the union of the intervals in which a kernel, a copy or a set
ran on the device inside the window (the harness's ``bench.window`` span);
the profiler's own spans mirrored onto the device and the harness's spans
are not operations. An idle gap is a stretch of the window with nothing on
the device, labelled by the innermost host span or CPU operation that was
running at its midpoint.
"""

from __future__ import annotations

import numpy as np

SPAN_PREFIX = "bench."


def profiler():
    """A torch.profiler context over the CPU and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _span(e):
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def _is_annotation(e) -> bool:
    name = e.name()
    if name.startswith(SPAN_PREFIX) or name.startswith("ProfilerStep"):
        return True
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (k, 2) intervals of the (n, 2) array `iv`."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def reduce(prof, *, top: int = 10) -> dict:
    """{"window_s", "busy_s", "ops": {name: device s}, "nccl_s",
    "gaps": [[label, s], ...] the `top` longest} of the profiled window."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, dev_names, cpu, cpu_names = [], [], [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        s, t = _span(e)
        if e.device_type() == cuda:
            if not _is_annotation(e):
                dev.append((s, t))
                dev_names.append(e.name())
        else:
            if e.name() == SPAN_PREFIX + "window":
                window = (s, t)
            cpu.append((s, t))
            cpu_names.append(e.name())
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = window
    dev = np.asarray(dev, dtype=np.int64).reshape(-1, 2)
    clipped = np.clip(dev, w0, w1)
    busy_iv = _union(clipped[clipped[:, 1] > clipped[:, 0]])
    busy_ns = int((busy_iv[:, 1] - busy_iv[:, 0]).sum()) if len(busy_iv) else 0
    ops: dict = {}
    for (s, t), name in zip(clipped.tolist(), dev_names):
        if t > s:
            ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
    nccl = sum(v for k, v in ops.items() if k.lower().startswith("nccl"))
    # the idle gaps: the window less the busy intervals
    edges = np.concatenate([[w0], busy_iv.reshape(-1), [w1]]).reshape(-1, 2)
    lengths = edges[:, 1] - edges[:, 0]
    longest = np.argsort(-lengths, kind="stable")[:top]
    cpu = np.asarray(cpu, dtype=np.int64).reshape(-1, 2)
    gaps = []
    for g in longest:
        if lengths[g] <= 0:
            continue
        mid = (edges[g, 0] + edges[g, 1]) // 2
        inside = np.flatnonzero((cpu[:, 0] <= mid) & (cpu[:, 1] >= mid))
        label = "host idle"
        if len(inside):
            label = cpu_names[inside[np.argmin(cpu[inside, 1] - cpu[inside, 0])]]
        gaps.append([label, float(lengths[g] * 1e-9)])
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9, "ops": ops,
            "nccl_s": nccl, "gaps": gaps}


def top_ops(ops: dict, top: int = 10) -> list:
    return [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]]
