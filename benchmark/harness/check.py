"""What decides ``correct``: the snapshots the window read, held to the
plain reference (``benchmark/reference``).

The window keeps, for a sample of its segments drawn from the seed (always
the first), the program's state at the segment's start (a copy on the
device) and the positions the segment's snapshot read back. After the
window the reference steps each kept start state as many steps as the
segment took, in float64, and each snapshot is compared with it:

  dpos_rel     max over bodies of |x_snapshot - x_reference|, over the
               largest distance a body moved in the segment (reference),
               the widest over the sampled segments;
  start_exact  elements of the state the window started from that differ
               from the seed's initial state, which the benchmark made
               itself (the reference follows the program's own state from
               there on, so the start is checked by itself), limit 0.

On a mesh (one step a segment) each rank works out the rows it holds and
the largest gap and distance are reduced over the ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import reference


def sample_segments(seed: int, check: dict) -> list:
    """Segment 0 and `check["samples"]` others drawn from the seed in
    [1, check["span"]): the segments whose snapshots are compared."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0xC0FFEE])
    extra = rng.choice(np.arange(1, check["span"]), size=check["samples"], replace=False)
    return [0] + sorted(int(s) for s in extra)


def segment_gap(start, snapshot, *, steps: int, config: dict, integrator: str,
                precision: str = "fp64", candidate=None, rows=None, group=None):
    """(largest |x - x_ref|, largest distance moved) of one segment: the
    reference run `steps` steps from `start` = (pos, vel) against the
    `snapshot` positions (N, 4) (or, with `candidate`, against the state
    that stepper gives from `start`: the control). With `rows`, only those
    rows, reduced (MAX) over `group`."""
    pos, vel = start
    if rows is None:
        ref, _ = reference.advance(pos, vel, steps, config=config, integrator=integrator)
        x0 = pos[:, :3]
    else:
        ref = reference.advance(pos, vel, steps, config=config, integrator=integrator,
                                rows=rows)
        x0 = pos[rows, :3]
    if candidate is not None:
        got = candidate(pos, vel)
    else:
        got = torch.as_tensor(snapshot, device=ref.device)
        if rows is not None:
            got = got[rows]
    got = got[:, :3].to(torch.float64)
    gap = torch.linalg.vector_norm(got - ref[:, :3], dim=1).max()
    moved = torch.linalg.vector_norm(ref[:, :3] - x0.to(torch.float64), dim=1).max()
    out = torch.stack([gap, moved]).nan_to_num(nan=math.inf)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return float(out[0]), float(out[1])


def judge(samples: dict, snapshots: dict, ic, *, steps: int, config: dict,
          integrator: str, limits: dict, rows=None, group=None) -> dict:
    """{"numbers": {name: [value, limit]}, "correct", "compared", "failed"}
    of the kept samples: seg -> start state (device tensors), seg ->
    snapshot (host array). `ic` is the seed's initial (pos, vel)."""
    rels = []
    for seg in sorted(samples):
        gap, moved = segment_gap(samples[seg], snapshots[seg], steps=steps, config=config,
                                 integrator=integrator, rows=rows, group=group)
        rels.append(gap / moved if moved > 0 else math.inf)
    start = samples.get(0)
    mismatch = math.inf
    if start is not None:
        mismatch = sum(int((s.cpu() != torch.as_tensor(a)).sum()) if s.shape == a.shape
                       else math.inf for s, a in zip(start, ic))
    value = max(rels) if rels else math.inf
    limit = limits["dpos_rel"]
    numbers = {"dpos_rel": [value, limit], "start_exact": [mismatch, 0]}
    failed = sum(1 for r in rels if not r <= limit)
    correct = bool(rels) and failed == 0 and mismatch == 0
    return {"numbers": numbers, "correct": correct, "compared": len(rels), "failed": failed,
            "readings": rels}
