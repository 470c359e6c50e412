"""The traced window by span: device time, host time, launches and idle time
of each program span (``nbody.*``, the names of
``nbody_tpu_torch.utils.profiling.SPANS``) and harness span (``bench.*``),
read from the same torch.profiler events as ``trace.reduce``, on the
profiler's clock.

Attribution. A device op (a kernel, a copy or a set, as ``trace.reduce``
counts them) goes to the innermost span open on the launching thread when
its launch began. The profiler links the op to the host op that was
innermost at its launch (``linked_correlation_id``: an aten op, or a span
itself where a hand-written kernel is launched straight under it); failing
that, to the runtime call that launched it (``correlation_id``). An op that
neither finds, or that was launched under no span but ``bench.window``,
goes to ``unattributed``.

Per span name, inclusive of the spans nested in it: ``device_s`` the union
of its ops' intervals clipped to the window, ``compute_s`` the same without
the ``nccl*`` ops, ``launches`` the count of its ops, ``host_s`` the union
of the span's own intervals in the window. ``idle_s`` is exclusive: each
idle stretch of the window (the complement of the busy union, as
``trace.reduce`` computes it) goes to the innermost span open on the
window's thread at each instant, ``host idle`` where none is.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import trace

PROGRAM = "nbody."
UNATTRIBUTED = "unattributed"
HOST_IDLE = "host idle"
COMM_SPANS = ("nbody.ring.exchange", "nbody.allgather", "nbody.reduce_scatter")
NUMBERS = ("device_s", "compute_s", "host_s", "idle_s", "launches")
TOP = ("device_s", "host_s", "idle_s", "launches")


def _is_span(name: str) -> bool:
    return name.startswith(PROGRAM) or (name.startswith(trace.SPAN_PREFIX)
                                        and name != trace.SPAN_PREFIX + "window")


def _is_runtime(name: str) -> bool:
    """A call into the CUDA runtime (cudaLaunchKernel, ...) or its lower
    API (cuLaunchKernelEx, ...), told by name: not every torch version's
    profiler events carry their activity type."""
    return name.startswith("cuda") or (name[:2] == "cu" and name[2:3].isupper())


def _tid(e) -> int:
    """The host thread of a CPU-side event: the system thread id, which the
    profiler gives aten ops, spans and runtime calls alike."""
    return int(e.device_resource_id())


def events(prof) -> dict:
    """The profiled events that attribution reads, as plain numbers:
    {"window": (start, end), "main": the window's thread, "spans": [(name,
    start, end, thread)], "host": {host op id: (start, thread)}, "runtime":
    {correlation id: (start, thread)}, "device": [(name, start, end, linked
    host op id, correlation id)]}, times in ns."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = {"window": None, "main": None, "spans": [], "host": {}, "runtime": {}, "device": []}
    for e in prof.profiler.kineto_results.events():
        s, t = trace._span(e)
        name = e.name()
        if e.device_type() == cuda:
            if not trace._is_annotation(e):
                out["device"].append((name, s, t, int(e.linked_correlation_id()),
                                      int(e.correlation_id())))
            continue
        if _is_runtime(name):
            out["runtime"][int(e.correlation_id())] = (s, _tid(e))
            continue
        if name == trace.SPAN_PREFIX + "window":
            out["window"], out["main"] = (s, t), _tid(e)
        elif _is_span(name):
            out["spans"].append((name, s, t, _tid(e)))
        if e.correlation_id():
            out["host"][int(e.correlation_id())] = (s, _tid(e))
    if out["window"] is None:
        raise RuntimeError("the trace holds no bench.window span")
    return out


class _Thread:
    """One thread's spans as a sequence of segments, each labelled by the
    innermost span open in it (-1: none), and each span's parent."""

    def __init__(self, spans: list):
        order = sorted((i for i in range(len(spans)) if spans[i][2] > spans[i][1]),
                       key=lambda i: (spans[i][1], -spans[i][2]))
        marks = sorted([(spans[i][2], 0, i) for i in order]
                       + [(spans[i][1], 1, k, i) for k, i in enumerate(order)])
        self.parent = [-1] * len(spans)
        stack, points, labels = [], [], []
        for m in marks:
            if m[1] == 0:  # an end: its span leaves the stack
                if m[2] in stack:
                    stack.remove(m[2])
            else:
                i = m[3]
                self.parent[i] = stack[-1] if stack else -1
                stack.append(i)
            top = stack[-1] if stack else -1
            if points and points[-1] == m[0]:
                labels[-1] = top
            else:
                points.append(m[0])
                labels.append(top)
        self.points = np.asarray(points, dtype=np.int64)
        self.labels = np.asarray(labels, dtype=np.int64)

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """The innermost span open at each time in `t` (-1: none)."""
        if not len(self.points):
            return np.full(len(t), -1, dtype=np.int64)
        k = np.searchsorted(self.points, t, side="right") - 1
        return np.where(k >= 0, self.labels[np.maximum(k, 0)], -1)


def _measure(iv: list, w0: int, w1: int) -> float:
    """Seconds in the union of the (start, end) intervals `iv`, clipped to
    [w0, w1]."""
    if not iv:
        return 0.0
    a = np.clip(np.asarray(iv, dtype=np.int64).reshape(-1, 2), w0, w1)
    u = trace._union(a[a[:, 1] > a[:, 0]])
    return float((u[:, 1] - u[:, 0]).sum()) * 1e-9 if len(u) else 0.0


def attribute(ev: dict) -> dict:
    """The attribution of ``events``' record: {"window_s", "busy_s",
    "spans": {name: {"device_s", "compute_s", "host_s", "idle_s",
    "launches"}}, "program_launches", "program_idle_s", "comm_exposed_s" (and
    "comm_exposed_by" communication span), "unattributed_s", "routes":
    {"host_op", "runtime", "none"}}. An op's communication span is the
    innermost of COMM_SPANS that holds an ``nccl*`` op; it is exposed where
    it runs and no other op does."""
    w0, w1 = ev["window"]
    spans = ev["spans"]
    by_tid: dict = {}
    for i, sp in enumerate(spans):
        by_tid.setdefault(sp[3], []).append(i)
    threads = {tid: (_Thread([spans[i] for i in idx]), idx) for tid, idx in by_tid.items()}
    chains: dict = {}

    def chain(tid, j):
        """The span names open around span j of thread tid, innermost first."""
        key = (tid, j)
        if key not in chains:
            th, idx = threads[tid]
            names = []
            while j >= 0:
                name = spans[idx[j]][0]
                if name not in names:
                    names.append(name)
                j = th.parent[j]
            chains[key] = tuple(names)
        return chains[key]

    # each device op's launch point: the linked host op, else the runtime call
    routes = {"host_op": 0, "runtime": 0, "none": 0}
    launch = []
    for name, s, t, linked, corr in ev["device"]:
        if linked and linked in ev["host"]:
            launch.append(ev["host"][linked])
            routes["host_op"] += 1
        elif corr and corr in ev["runtime"]:
            launch.append(ev["runtime"][corr])
            routes["runtime"] += 1
        else:
            launch.append(None)
            routes["none"] += 1
    owner = [()] * len(ev["device"])
    for tid, (th, _) in threads.items():
        rows = [k for k, lp in enumerate(launch) if lp is not None and lp[1] == tid]
        if rows:
            inner = th.innermost(np.asarray([launch[k][0] for k in rows], dtype=np.int64))
            for k, j in zip(rows, inner.tolist()):
                owner[k] = chain(tid, j) if j >= 0 else ()

    ops, compute, launches = {}, {}, {}
    program_launches = 0
    kinds = []  # each op's communication span, for the nccl ops launched in one
    for (name, s, t, _, _), names in zip(ev["device"], owner):
        nccl = name.lower().startswith("nccl")
        for n in names or (UNATTRIBUTED,):
            ops.setdefault(n, []).append((s, t))
            launches[n] = launches.get(n, 0) + 1
            if not nccl:
                compute.setdefault(n, []).append((s, t))
        if any(n.startswith(PROGRAM) for n in names):
            program_launches += 1
        kinds.append(next((n for n in names if n in COMM_SPANS), None) if nccl else None)

    # the idle stretches of the window, split by the window thread's spans
    busy = np.clip(np.asarray([(s, t) for _, s, t, _, _ in ev["device"]],
                              dtype=np.int64).reshape(-1, 2), w0, w1)
    busy = trace._union(busy[busy[:, 1] > busy[:, 0]])
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    idle = edges[edges[:, 1] > edges[:, 0]]
    idle_by: dict = {}
    main = threads.get(ev["main"])
    if len(idle):
        cum = np.concatenate([[0], np.cumsum(idle[:, 1] - idle[:, 0])])

        def idle_before(t):
            k = np.clip(np.searchsorted(idle[:, 0], t, side="right") - 1, 0, len(idle) - 1)
            return cum[k] + np.clip(t - idle[k, 0], 0, idle[k, 1] - idle[k, 0])

        if main is not None and len(main[0].points):
            th, idx = main
            pts = np.clip(np.concatenate([[w0], th.points, [w1]]), w0, w1)
            lab = np.concatenate([[-1], th.labels])
            lab[0] = th.innermost(np.asarray([w0]))[0]
            amount = idle_before(pts[1:]) - idle_before(pts[:-1])
            for j, a in zip(lab.tolist(), amount.tolist()):
                if a > 0:
                    name = spans[idx[j]][0] if j >= 0 else HOST_IDLE
                    idle_by[name] = idle_by.get(name, 0) + a
        else:
            idle_by[HOST_IDLE] = int(cum[-1])

    table: dict = {}
    names = set(ops) | set(idle_by) | {sp[0] for sp in spans}
    for n in names:
        table[n] = {"device_s": _measure(ops.get(n, []), w0, w1),
                    "compute_s": _measure(compute.get(n, []), w0, w1),
                    "host_s": _measure([(s, t) for m, s, t, _ in spans if m == n], w0, w1),
                    "idle_s": idle_by.get(n, 0) * 1e-9,
                    "launches": launches.get(n, 0)}
    intervals = [(s, t) for _, s, t, _, _ in ev["device"]]

    def alone(pick):
        """Seconds in which the ops whose kind `pick` takes run and no other
        op runs; None where it takes none."""
        mine = [iv for iv, k in zip(intervals, kinds) if pick(k)]
        rest = [iv for iv, k in zip(intervals, kinds) if not pick(k)]
        return _measure(mine + rest, w0, w1) - _measure(rest, w0, w1) if mine else None

    by_span = {n: alone(lambda k, n=n: k == n) for n in COMM_SPANS}
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) else 0.0,
            "spans": table, "program_launches": program_launches,
            "program_idle_s": sum(v * 1e-9 for k, v in idle_by.items()
                                  if k.startswith(PROGRAM)),
            "comm_exposed_s": alone(lambda k: k is not None),
            "comm_exposed_by": {n: v for n, v in by_span.items() if v is not None},
            "unattributed_s": table.get(UNATTRIBUTED, {}).get("device_s", 0.0),
            "routes": routes}


def reduce(prof) -> dict:
    """``attribute`` of the profiled window."""
    return attribute(events(prof))


def mean(records: list) -> dict:
    """The mean of the ranks' ``attribute`` records, number by number (a
    span a rank lacks counts 0 there; ``comm_exposed_s`` over the ranks
    that have it)."""
    n = len(records)
    out = {k: sum(r[k] for r in records) / n
           for k in ("window_s", "busy_s", "program_launches", "program_idle_s",
                     "unattributed_s")}
    comm = [r["comm_exposed_s"] for r in records if r["comm_exposed_s"] is not None]
    out["comm_exposed_s"] = sum(comm) / len(comm) if comm else None
    out["comm_exposed_by"] = {}
    for name in COMM_SPANS:
        got = [r["comm_exposed_by"][name] for r in records if name in r["comm_exposed_by"]]
        if got:
            out["comm_exposed_by"][name] = sum(got) / len(got)
    out["routes"] = {k: sum(r["routes"][k] for r in records) / n for k in records[0]["routes"]}
    names = set().union(*(r["spans"] for r in records))
    out["spans"] = {name: {f: sum(r["spans"].get(name, {}).get(f, 0) for r in records) / n
                           for f in NUMBERS}
                    for name in names}
    return out


def top(rec: dict, k: int = 12) -> list:
    """The `k` spans with the most device time, as [name, device_s, host_s,
    idle_s, launches]."""
    rows = sorted(rec["spans"].items(), key=lambda kv: -kv[1]["device_s"])[:k]
    return [[name] + [v[f] for f in TOP] for name, v in rows]
