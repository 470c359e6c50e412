"""Per-body block timesteps on a power-of-two ladder.

Counterpart of ``nbody_tpu/ops/block_timestep.py``: each body steps at the
largest rung dt_max / 2^k not exceeding its own criterion dt_i = eta *
sqrt(eps / |a_i|), so that a collapsing core no longer drags every halo body
down to the global minimum. K rungs; a macro step of dt_max is S = 2^(K-1)
substeps of dt_small. The integrator is KDK leapfrog per class: an opening
half kick at the macro start (from the synchronised force, which also
classifies), full kicks a(t_s) dt_k at the interior boundaries a class
crosses, a drift of every body each substep, and a closing half kick from the
synchronised force at the macro end, which is carried into the next macro
step. Classes are frozen within a macro step.

Bodies are sorted by class, smallest dt first (``torch.argsort(-k,
stable=True)``, so ties fall as in ``nbody_tpu``), once a macro step, which
makes every boundary's active set a prefix of the sorted bodies. Where
``nbody_tpu`` walks that prefix with a ``lax.while_loop`` over 256-row tiles
(a traced trip count), this module reads the K class counts on the host once
a macro step (``utils.timing.host_read``, counted as "block_counts"): the
schedule of interior boundaries is fixed on the host (``block_schedule``),
so every boundary's n_active follows, and the one-sided force
(`accel_vs_fn`) runs once at (n_active, N) on the prefix rows against every
body. That read is the macro step's one host synchronisation.

The stats are ``nbody_tpu``'s: simulated time, the force rows computed (the
interior prefixes and the macro ends), the rows a global dt at the deepest
occupied rung would have computed, and that rung, k_max. ``nbody_tpu`` pads
N to a multiple of its 256-row tile with far-field zero-mass bodies (rung 0,
active only at the macro ends), and bills its macro ends and its global rows
on the padded N: the stats here count the same, without the padding rows,
which no force needs.

Damping: block kicks take damping = 1 only (``BodySystem.update_many_block``
refuses others).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_tpu_torch.utils import timing

# nbody_tpu's tile of the prefix walk, the unit its stats pad N to
TILE = 256


def block_schedule(n_classes: int) -> tuple[np.ndarray, int]:
    """(t_arr, S): S = 2^(K-1) substeps a macro step and, for the S-1
    interior boundaries s = 1..S-1, t_arr[s-1] = trailing_zeros(s): the
    classes active at s are k >= K-1-t."""
    if n_classes < 1:
        raise ValueError(f"need n_classes >= 1, got {n_classes}")
    s_count = 1 << (n_classes - 1)
    s = np.arange(1, s_count, dtype=np.int32)
    t = np.round(np.log2(s & -s)).astype(np.int32)
    return t, s_count


def classify(acc, softening, eta, dt_max, n_classes: int) -> torch.Tensor:
    """Each body's rung: the smallest k with dt_max / 2^k <= eta *
    sqrt(eps / |a_i|), clipped to [0, K-1], as int32; log2 and ceil in the
    state's type."""
    def full(v):
        return torch.full((), v, dtype=acc.dtype, device=acc.device)

    tiny = torch.finfo(acc.dtype).tiny
    amax = torch.sqrt(torch.sum(acc * acc, dim=-1))
    dt_i = eta * torch.sqrt(full(softening) / torch.clamp(amax, min=tiny))
    k = torch.ceil(torch.log2(full(dt_max) / torch.clamp(dt_i, min=tiny)))
    return torch.clamp(k, 0, n_classes - 1).to(torch.int32)


def make_block_rollout(*, softening, eta: float, dt_max: float, n_classes: int,
                       macro_steps: int, accel_vs_fn):
    """`run(pos, vel, acc0) -> (pos, vel, acc, stats)`: `macro_steps` macro
    steps of dt_max. `acc0` is the synchronised force of the start state
    (the previous run's returned `acc` chains calls without an evaluation);
    `accel_vs_fn(pos_i, pos_j) -> (M, 3)` is the one-sided force of the i-set
    under the j-set. stats is a (4,) numpy array in the state's type: [the
    simulated time, force rows computed, the rows of a global dt at the
    deepest occupied rung, k_max], ``nbody_tpu``'s stats."""
    if n_classes < 1:
        raise ValueError(f"need n_classes >= 1, got {n_classes}")
    t_arr, s_count = block_schedule(n_classes)
    dt_small = dt_max / s_count

    def macro(pos, vel, acc, n_pad: int):
        n = pos.shape[0]
        dev, dtype = pos.device, pos.dtype
        k = classify(acc, softening, eta, dt_max, n_classes)
        order = torch.argsort(-k, stable=True)
        p, v, ks = pos[order], vel[order], k[order]
        rungs = torch.full((), 2, dtype=torch.int64, device=dev) ** torch.arange(
            n_classes, device=dev)
        dt_k = (torch.full((), dt_max, dtype=dtype, device=dev) / rungs.to(dtype))[ks.long()]
        counts = torch.zeros(n_classes, dtype=torch.int64, device=dev).scatter_add_(
            0, ks.long(), torch.ones(n, dtype=torch.int64, device=dev))
        counts = timing.host_read(counts, "block_counts")
        # n_active for trailing zeros t: the classes k >= K-1-t
        suffix = np.cumsum(counts[::-1])
        ds = torch.full((), dt_small, dtype=dtype, device=dev)
        # the opening half kick of every body
        v[:, :3] += acc[order] * (dt_k * 0.5)[:, None]
        rows = 0
        for t in t_arr:
            p[:, :3] += v[:, :3] * ds
            na = int(suffix[t])
            if na:
                v[:na, :3] += accel_vs_fn(p[:na], p) * dt_k[:na, None]
            rows += na
        # the last drift to the macro boundary, the synchronised closing force
        p[:, :3] += v[:, :3] * ds
        a_end = accel_vs_fn(p, p)
        v[:, :3] += a_end * (dt_k * 0.5)[:, None]
        rows += n_pad
        k_max = max(c for c, count in enumerate(counts) if count) if n else 0
        # unsort: row i of the sorted arrays is body order[i]
        out = [torch.empty_like(x) for x in (p, v, a_end)]
        for o, x in zip(out, (p, v, a_end)):
            o[order] = x
        return (*out, rows, (1 << k_max) * n_pad, k_max)

    def run(pos, vel, acc0):
        n_pad = pos.shape[0] + (-pos.shape[0]) % TILE
        rows = grows = kmax = 0
        acc = acc0
        for _ in range(macro_steps):
            pos, vel, acc, r, gr, km = macro(pos, vel, acc, n_pad)
            rows, grows, kmax = rows + r, grows + gr, max(kmax, km)
        np_dtype = np.float64 if pos.dtype == torch.float64 else np.float32
        stats = np.asarray([macro_steps * dt_max, rows, grows, kmax], np_dtype)
        return pos, vel, acc, stats

    return run
