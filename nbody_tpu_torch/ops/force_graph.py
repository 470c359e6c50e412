"""CUDA graphs of a system's one-card mesh-solver force.

The P3M force on one card (``p3m.p3m_accel`` with the pair kernel: the box
fit, the CIC or TSC deposit, the padded FFT solve, the gather, the pair
tables, the pair kernel and the map back) and plain PM (``pm.pm_accel``)
are static chains of a few hundred small launches with no host
synchronisation: every shape follows from N, the grid and the capacity.
Queued one by one, they leave the card idle while the host queues them.
``ForceGraphs`` captures the chain once per key into a CUDA graph
(``torch.cuda.CUDAGraph``) and replays it: one launch of the same
hand-written kernels and the same glue in the same order, so the bits are
the eager chain's.

* The first call under a key runs eagerly, which warms up what a capture
  cannot do (cuFFT's plans, the sorts' scratch, the kernels' library, the
  influence table), then captures the chain without running it, and
  returns the eager force. Every later call under the key replays. So a
  single warm-up call covers a key's capture.
* A system's captures share one side stream and one private memory pool,
  so a capture reuses the blocks that the earlier ones freed (their
  temporaries) and only each graph's output is its own. That is safe
  because the graphs replay one at a time on the caller's stream and each
  replay's output is copied out before anything else runs there.
* The key holds every value that the captured launches bake in (the body
  count, grid, assignment, capacity, blk and softening: the caller builds
  it). A system keeps at most ``MAX_GRAPHS`` keys, the least recently used
  going first, so a run that keeps changing its softening holds a bounded
  number of graphs.
* The graph reads a static float32 input, into which each replay first
  copies the state (the cast of a float64 state included), and each replay
  returns a copy of the graph's output in the state's type: nothing a
  caller keeps aliases the graph's buffers.
* ``cuda_kernel.LAUNCHES`` counts executions: a capture's launches are
  taken back, and each replay adds them.
* The spans ``nbody.graph.capture`` (after the eager call's stage spans;
  the captured chain's stage spans open inside it) and
  ``nbody.graph.replay`` (the input copy, the graph's launch, the output
  copy) open inside the caller's ``nbody.force``.

A replay reads what the capture's launches read outside the private pool:
the static input, the cached influence table (``pm._influence_table``,
kept for the life of the process) and cuFFT's plans in PyTorch's plan
cache. Clearing that cache (``torch.backends.cuda.cufft_plan_cache``)
while a system holds graphs leaves them reading freed plans.

Graphs engage only where ``graph_engages`` says: a CUDA state on one
device with the CUDA backend, and P3M's pair-kernel short range or plain
PM. Elsewhere ``ForceGraphs`` runs every call eagerly: the CPU, the plain
backend, the cell-list short range (which reads on the host every call),
meshes (whose steps hold collectives) and the all-pairs forces.
"""

from __future__ import annotations

import collections

import torch

from nbody_tpu_torch.ops import cuda_kernel
from nbody_tpu_torch.utils.profiling import annotate

# graphs (keys) that one system keeps
MAX_GRAPHS = 4


def graph_engages(device, *, mesh, kernel: str, backend: str, short_range: str) -> bool:
    """Whether a system's force is replayed as a CUDA graph: a CUDA device,
    no mesh, the CUDA backend, and kernel "pm" or kernel "p3m" with the
    pair kernel's short range ("auto" or "pallas")."""
    return (torch.device(device).type == "cuda" and mesh is None and backend == "cuda"
            and (kernel == "pm" or (kernel == "p3m" and short_range in ("auto", "pallas"))))


class _Graph:
    """One captured force: its static float32 input, its output in the
    graph's pool, and the counted launches it holds."""

    def __init__(self, fn, pos: torch.Tensor, pool, side: torch.cuda.Stream):
        dev = pos.device
        self.input = torch.empty(pos.shape, dtype=torch.float32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        before = dict(cuda_kernel.LAUNCHES)
        try:
            with torch.cuda.stream(side):
                # thread_local: other threads (a profiler's) may call the
                # runtime while this one captures
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.output = fn(self.input)
                finally:
                    self.graph.capture_end()
        finally:
            self.launches = {k: v - before[k] for k, v in cuda_kernel.LAUNCHES.items()
                             if v != before[k]}
            cuda_kernel.LAUNCHES.update(before)
        torch.cuda.current_stream(dev).wait_stream(side)

    def replay(self, pos: torch.Tensor) -> torch.Tensor:
        self.input.copy_(pos)
        self.graph.replay()
        for k, v in self.launches.items():
            cuda_kernel.LAUNCHES[k] += v
        return self.output.to(pos.dtype, copy=True)


class ForceGraphs:
    """One system's force calls: eager, or replayed from CUDA graphs by key
    where `enabled` (``graph_engages``). ``calls`` counts them by kind:
    "eager" and "replay" count force evaluations (every call where not
    enabled, and a key's first, is eager), "capture" counts the captures
    that follow a key's eager call (each runs nothing)."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self.calls = {"eager": 0, "capture": 0, "replay": 0}
        # key -> _Graph, least recently used first
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        # the captures' memory pool and stream, made at the first
        self._pool = self._side = None

    def __call__(self, key, fn, pos: torch.Tensor) -> torch.Tensor:
        """The force of `pos`: `fn(pos)` (`fn` maps an (N, 4) state to its
        float32 (N, 3) force, and `key` holds every value it bakes into its
        launches) in `pos`'s type, a tensor of the caller's own."""
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            self.calls["replay"] += 1
            with annotate("nbody.graph.replay"):
                return graph.replay(pos)
        self.calls["eager"] += 1
        out = fn(pos).to(pos.dtype)
        if self.enabled:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._side = torch.cuda.Stream(pos.device)
            with annotate("nbody.graph.capture"):
                self._graphs[key] = _Graph(fn, pos, self._pool, self._side)
            self.calls["capture"] += 1
            if len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        return out
