"""Each pair once across a 1-D body mesh: which rank computes which pairs.

Counterpart of the partition of ``nbody_tpu/parallel/sharded.py:139-368``
(``_sym_sharded_accel_fn``, ``_sym_sharded_aj_fn``). Rank d of D holds
shard d; with the shards gathered, it computes

* the triangle of its own shard (``compute_accel_symmetric_blocked_cuda``,
  or ``compute_accel_jerk_symmetric_blocked_cuda`` for Hermite),
* the mask-free rectangles of its shard against the shards at ring offsets
  1..(D-1)//2 (``sym_cross_cuda`` / ``aj_sym_cross_cuda``): every unordered
  pair of shards lands on one rank, offset o from one end or D-o from the
  other,
* for even D, the antipodal pair (offset D/2) as two quarter rectangles:
  ranks in the first half of the ring take the aligned quarters (i-half h
  against j-half h), the second half the crossed ones, so the four quarters
  of each antipodal rectangle are covered once and the work stays balanced.

A rank's work is a function of (the gathered set, d, D) with no collective
in it: ``rank_contributions`` returns the (D·B, k) contributions of rank d,
its reactions on every shard's rows (its own triangle and actions in its
own rows), and the caller sums them over the ranks, rows of shard e to
rank e, in a fixed order (``ring_reduce_scatter`` on a mesh,
``emulated_reduce_scatter`` in one process). ``emulated_sym`` runs all D
ranks' work and that sum in one process.

The kernels take any N, so a shard is padded only to an even length when D
is even (the antipodal halves), with zero-mass rows at its end that exert
no force and are cut off after the sum. A rectangle's j-span is cut into
sub-blocks at the kernels' dispatch cap (``SYM_BLOCK_CAP`` = 131072 for the
force, ``AJ_SYM_BLOCK_CAP`` = 65536 for accel + jerk; ``reference.
sym_blocking``), as the triangle's blocked composition is: a launch's
reaction scratch is (ceil(Bj/tile), 3, Bi) + (ceil(Bi/tile), 3, Bj) floats,
0.8 GB at (262144, 131072) and tile 1024, twice that with the jerk's six
planes at (262144, 65536) and tile 512.

The wrappers take their plain versions on CPU tensors, so the same code
runs on a gloo mesh on the host.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference


def padded_rows(nloc: int, ndev: int) -> int:
    """The rows B of a padded shard: nloc, rounded up to even for an even D
    > 1 (the antipodal quarters split each shard in halves)."""
    return nloc + (nloc % 2) if ndev % 2 == 0 and ndev > 1 else nloc


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """`x` (n, 4) with zero rows appended up to `rows` (x itself if n ==
    rows): zero-mass bodies at the origin."""
    n = x.shape[0]
    if n == rows:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((rows - n, x.shape[1]))]).contiguous()


def _triangle(sets, softening):
    """The shard's each-pair-once fields on itself, joined: (B, 3) for the
    force, (B, 6) acc | jerk for Hermite."""
    if len(sets) == 1:
        return ck.compute_accel_symmetric_blocked_cuda(sets[0], softening)
    return torch.cat(ck.compute_accel_jerk_symmetric_blocked_cuda(*sets, softening), 1)


def _cross(i_sets, j_sets, softening):
    """The mask-free rectangle of the i-rows and the j-span, the span in
    sub-blocks at the dispatch cap: (action on the i-rows (rows, k), the
    reaction on the span (span, k)), the actions summed in sub-block
    order."""
    aj = len(i_sets) == 2
    span = j_sets[0].shape[0]
    cap, tile = (ck.aj_sym_default_dispatch if aj else ck.sym_default_dispatch)(span)
    blk = span if span <= cap else reference.sym_blocking(span, tile, cap)[1]
    kernel = ck.aj_sym_cross_cuda if aj else ck.sym_cross_cuda
    act, reacts = None, []
    for s0 in range(0, span, blk):
        sides = kernel(*i_sets, *(s[s0:s0 + blk] for s in j_sets), softening, tile=tile)
        nf = len(sides) // 2
        part = torch.cat([f[:, :3] for f in sides[:nf]], 1)
        act = part if act is None else act + part
        reacts.append(torch.cat([f.t() for f in sides[nf:]], 1))
    return act, torch.cat(reacts)


def rank_contributions(sets, d: int, ndev: int, softening) -> torch.Tensor:
    """Rank d's contributions, (D·B, k): `sets` is (pos,) for the force or
    (pos, vel) for accel + jerk, each the (D·B, 4) gathered padded shards;
    rows e·B..(e+1)·B are rank d's reactions on shard e, and its own rows
    its triangle plus its actions, summed in the order of
    ``_sym_sharded_accel_fn`` (the triangle, the offsets in order, then the
    two quarters). No collective."""
    b = sets[0].shape[0] // ndev

    def shard(e, lo=0, hi=b):
        return tuple(s[e * b + lo:e * b + hi] for s in sets)

    own = _triangle(shard(d), softening)
    contrib = own.new_zeros((ndev, b, own.shape[1]))
    for off in range(1, (ndev - 1) // 2 + 1):
        e = (d + off) % ndev
        act, react = _cross(shard(d), shard(e), softening)
        own = own + act
        contrib[e] = react
    if ndev % 2 == 0 and ndev > 1:
        e = (d + ndev // 2) % ndev
        half = b // 2
        first_half = d < ndev // 2
        for ih in (0, 1):
            # aligned quarters in the first half of the ring, crossed in
            # the second: disjoint and exhaustive
            jh = (ih if first_half else 1 - ih) * half
            act, react = _cross(shard(d, ih * half, (ih + 1) * half),
                                shard(e, jh, jh + half), softening)
            own[ih * half:(ih + 1) * half] += act
            contrib[e, jh:jh + half] = react
    contrib[d] = own
    return contrib.reshape(ndev * b, own.shape[1])


def emulated_reduce_scatter(partials, add) -> list:
    """The sum of ``ring_reduce_scatter`` in one process: `partials[r]` is
    rank r's tuple of (D·m, k) fields; chunk c is summed as the ring sums
    it, P_{c+1} + P_{c+2} + ... + P_{c} (indices mod D), each step
    ``add(acc, part)``. Returns the D chunks' tuples."""
    ndev = len(partials)
    m = partials[0][0].shape[0] // ndev
    out = []
    for c in range(ndev):
        acc = None
        for s in range(1, ndev + 1):
            part = tuple(f[c * m:(c + 1) * m] for f in partials[(c + s) % ndev])
            acc = part if acc is None else add(acc, part)
        out.append(acc)
    return out


def emulated_sym(pos, ndev: int, softening, *, vel=None):
    """Each pair once as a D-rank mesh computes it, in one process: the
    (N,4) state split into D shards of N/D, every rank's
    ``rank_contributions`` and their sum in the ring's order. Returns the
    force (N,3), or (acc, jerk) with `vel`; a rank of a real mesh gets its
    shard's rows of it bit for bit."""
    n = pos.shape[0]
    if n % ndev:
        raise ValueError(f"N={n} not divisible by {ndev} ranks; pad first")
    nloc = n // ndev
    b = padded_rows(nloc, ndev)
    sets = tuple(torch.cat([pad_rows(x[r * nloc:(r + 1) * nloc], b) for r in range(ndev)])
                 for x in ((pos,) if vel is None else (pos, vel)))
    partials = [(rank_contributions(sets, d, ndev, softening),) for d in range(ndev)]
    total = torch.cat([chunk[0][:nloc] for chunk in
                       emulated_reduce_scatter(partials, reference.add_fields)])
    return total if vel is None else (total[:, :3], total[:, 3:])
