"""Body-sharded N-body steps over a torch.distributed mesh.

Counterpart of ``nbody_tpu/parallel/sharded.py`` but for its adaptive
rollouts (ROADMAP.md Queue 1 #7); the sharded PM and P3M steps live beside
their solvers, in ``ops/pm.py`` and ``ops/p3m.py``, as in ``nbody_tpu``.
On a 1-D mesh each rank holds N/D bodies (its i-shard) and computes their
forces from every body. Four strategies move the j-bodies:

* ``allgather``: one all-gather of the shards' planes, then one kernel
  launch of the local i-shard against the whole j-set (for Euler the fused
  step, for ds leapfrog the fused drift-kick-drift step).
* ``ring``: the j-shard travels around the ring. Rank r sends to r+1 and
  receives from r−1 (the reference's ``perm = [(d, (d+1) % D)]``), so at
  hop k it holds rank (r−k)'s shard. Hop 0, the local shard, runs before
  any exchange and exactly D−1 exchanges follow. The partial forces are
  summed in hop order, ``acc + a_k`` in fp32 and ``ds_add(acc, a_k)`` in ds,
  as the reference sums them, so the bits follow its ring. Each exchange is
  a paired isend/irecv (``batch_isend_irecv``) into the other of two
  buffers, posted before the current hop's kernel so that the transfer
  overlaps it; it is waited on before the received shard is read. A ds
  ring hop is the ds accel-only kernel (``compute_accel_ds_cuda_vs``), or
  for Hermite the ds accel + jerk kernel, and the integration runs once
  after the last hop.
* ``ring_fused`` (fp32 Euler and leapfrog): the same ring, all D hops in
  one launch of the fused ring kernel (``csrc/ring_kernels.cu``), which
  carries the j-shards between the ranks' buffers itself: each rank's two
  j-slots and flags, mapped into its neighbours by CUDA IPC once per shard
  shape (the handles exchanged with ``all_gather_object``, then a
  barrier), so the ranks must share one host. Its partial forces are the
  ring's ``accel`` launches' and are summed in the same order, so its
  force equals the ring's bit for bit. On a CPU mesh it runs the plain
  ring, the exchanges of ``ring`` with the plain force. Hermite and
  ``backend="torch"`` are refused with ``nbody_tpu``'s words; ``close()``
  frees the buffers.
* ``sym`` (fp32 Euler, leapfrog and Hermite): each pair once across the
  mesh (``parallel/sym.py``). The padded shards are all-gathered once (with
  the velocities for Hermite), each rank runs its triangle, its offset
  rectangles and its antipodal quarters on the each-pair-once kernels, and
  one ``ring_reduce_scatter`` sums the (D, B, 3) contributions (6 planes
  for Hermite) onto their owners. ``backend="torch"`` is refused, as
  ``nbody_tpu`` refuses its XLA kernel; on a CPU mesh the kernels'
  wrappers take their plain versions.

``make_sharded_step`` also takes ``auto``, one of allgather and ring by
``choose_strategy``, as ``nbody_tpu``'s does (it never picks
``ring_fused`` or ``sym``); the systems resolve ``auto`` themselves for
both precisions.

On a 2-D mesh (``make_mesh_2d``) ``make_sharded_step_2d`` (fp32 or float64)
and ``make_sharded_ds_step_2d`` gather rank (r, c)'s i-set over its row
(the contiguous row block) and its j-set over its column (the strided
column block), run the one-sided force or accel + jerk kernel on the
block, and ``ring_reduce_scatter`` over the row sums the C column partials
onto each chunk's owner: ``torch.add`` in fp32 and float64, the anchored
``ds_add`` in ds.

``ring_reduce_scatter`` is the one reduce-scatter of the package: D−1
point-to-point hops on the ring of any 1-D mesh, chunk c summed in the
fixed order P_{c+1} + ... + P_{c}, so its bits depend on D alone, not on
the collective library's algorithm, and it runs on gloo as on NCCL.

The collectives are torch.distributed's synchronous ones (on the card NCCL
makes the current stream wait for them) and every rank runs the same ones
in the same order. A step is a function of this rank's shard:
``step(pos, vel, dt, softening, damping) -> (pos, vel)`` in fp32 and
float64, ``step(pos_hi, pos_lo, vel_hi, vel_lo, scal) -> four planes`` in
ds, new tensors each time. ``backend`` is "cuda" (the hand-written kernels;
on a CPU tensor their wrappers take the plain versions) or "torch" (the
plain versions, on any device). A float64 state runs the double kernels
(``csrc/f64_kernels.cu``) with allgather, ring and auto and on a 2-D mesh;
``ring_fused`` and ``sym`` are float32 kernel paths and refuse it.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import ds, reference
from nbody_tpu_torch.parallel import sym
from nbody_tpu_torch.parallel.mesh import Mesh, Mesh2D, all_gather_rows

BODY_AXIS = "bodies"

# strategy="auto": nbody_tpu's cost model, copied as it is for parity
# (nbody_tpu/parallel/sharded.py:49-81). Both strategies move the same
# bytes; the ring hides the transfer behind the hop's force tile but pays a
# latency per hop, so it wins once a shard is large enough. The constant is
# the reference's rule for TPU ICI links (45 GB/s a link, ~5 µs a hop); it
# was not measured on NVLink or on this card.
RING_AUTO_MIN_SHARD = 16384


def choose_strategy(num_bodies: int, ndev: int) -> str:
    """'ring' or 'allgather' for a global body count on an ndev ring (the
    cost model above); ring_fused and sym are never picked."""
    if ndev <= 1:
        return "allgather"
    return "ring" if num_bodies // ndev >= RING_AUTO_MIN_SHARD else "allgather"


def _check_backend(backend: str, mesh: Mesh) -> str:
    if backend == "auto":
        return "cuda" if mesh.device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _ring(mesh: Mesh, shard: torch.Tensor):
    """The j-shards of the ring in hop order: `shard` (this rank's, hop 0),
    then at hop k the shard of rank r−k. A generator: the exchange of hop
    k+1 is posted before hop k's shard is handed out, and waited on after
    the caller is done with it; the received shards alternate between two
    buffers, so a buffer is never written while it is read."""
    d = mesh.size
    send_to, recv_from = mesh.peer(mesh.rank + 1), mesh.peer(mesh.rank - 1)
    cur, bufs = shard, []
    for k in range(d):
        reqs = []
        if k < d - 1:
            if len(bufs) < 2:
                bufs.append(torch.empty_like(shard))
            nxt = bufs[k % 2]
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, send_to, mesh.group),
                dist.P2POp(dist.irecv, nxt, recv_from, mesh.group),
            ])
        yield cur
        for req in reqs:
            req.wait()
        if reqs:
            cur = nxt


def ring_reduce_scatter(mesh: Mesh, fields, add) -> tuple:
    """The fixed-order reduce-scatter on the ring of a 1-D mesh (the whole
    1-D mesh, or one line of a 2-D one): `fields` is this rank's tuple of
    (D·m, k) partials, and this returns its (m, k) chunk of their sum over
    the D ranks, a tuple of the same fields. The counterpart of
    ``_make_ds_col_reduce_scatter`` (nbody_tpu/parallel/sharded.py:
    1239-1279): rank c seeds chunk c−1 with its own partial; at hop s it
    receives its left neighbour's running sum and adds its own partial of
    chunk c−s−1, ``add(received, own)``, and sends the sum on. After D−1
    hops it holds chunk c, summed as P_{c+1} + P_{c+2} + ... + P_{c}
    (indices mod D), whatever the library's collective algorithms, on gloo
    as on NCCL. ``add`` adds two tuples of fields: ``reference.add_fields``
    (``torch.add``) in fp32 and float64, ``ds.ds_add`` / ``ds.ds_add_aj`` in
    ds. One rank returns the fields as they are."""
    d = mesh.size
    if d == 1:
        return tuple(fields)
    m = fields[0].shape[0] // d
    c = mesh.rank
    send_to, recv_from = mesh.peer(c + 1), mesh.peer(c - 1)

    def chunk(k):
        k %= d
        return tuple(f[k * m:(k + 1) * m] for f in fields)

    acc = tuple(t.contiguous() for t in chunk(c - 1))
    for s in range(1, d):
        got = tuple(torch.empty_like(t) for t in acc)
        ops = ([dist.P2POp(dist.isend, t, send_to, mesh.group) for t in acc]
               + [dist.P2POp(dist.irecv, t, recv_from, mesh.group) for t in got])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        acc = tuple(t.contiguous() for t in add(got, chunk(c - s - 1)))
    return acc


def _gather_planes(mesh: Mesh, *planes) -> torch.Tensor:
    """The (nloc,4) planes of every rank, gathered in one collective: a
    (k, N, 4) tensor of the k planes."""
    packed = torch.stack(planes, 1)  # (nloc, k, 4): one row a body
    return all_gather_rows(mesh, packed).transpose(0, 1).contiguous()


def _ring_sum(mesh: Mesh, shard: torch.Tensor, partial, add):
    """Σ over the hops of partial(j-shard), summed in hop order by `add`."""
    total = None
    for j in _ring(mesh, shard):
        part = partial(j)
        total = part if total is None else add(total, part)
    return total


def _check_1d(mesh, builder_2d: str) -> None:
    if isinstance(mesh, Mesh2D):
        raise ValueError(f"a {mesh.rows}x{mesh.cols} mesh is a 2-D decomposition: use "
                         f"{builder_2d}")


def _resolve(strategy: str, mesh: Mesh, nloc: int) -> str:
    return choose_strategy(nloc * mesh.size, mesh.size) if strategy == "auto" else strategy


def open_fused_ring(mesh: Mesh, m: int, block_size: int) -> ck.FusedRing:
    """This rank's side of the fused ring for shards of m bodies; every rank
    of the mesh calls it together. On a card: the ranks' hosts and their
    block counts are gathered (CUDA IPC maps memory only within one host, so
    a mesh over several hosts is refused; every rank takes the smallest
    count), the region is made, the ranks' IPC handles are gathered and the
    neighbours' regions mapped, and a barrier holds every rank until all
    are mapped. On the CPU: the plain ring, with the exchanges of
    ``_ring``."""
    d, r = mesh.size, mesh.rank
    if mesh.device.type != "cuda":
        return ck.FusedRing(m, d, r, device=mesh.device, block_size=block_size,
                            hops=lambda shard: _ring(mesh, shard))
    seen = [None] * d
    dist.all_gather_object(seen, (socket.gethostname(),
                                  ck.ring_groups(m, 1, block_size, mesh.device)),
                           group=mesh.group)
    hosts = sorted({host for host, _ in seen})
    if len(hosts) > 1:
        raise ValueError(
            "strategy='ring_fused' maps its neighbours' buffers with CUDA IPC, which works "
            f"within one host; this mesh spans {len(hosts)} ({', '.join(hosts)}): use "
            "strategy='ring'")
    ring = ck.FusedRing(m, d, r, device=mesh.device, block_size=block_size,
                        groups=min(g for _, g in seen))
    if d > 1:
        handles = [None] * d
        dist.all_gather_object(handles, ring.ipc_handle(), group=mesh.group)
        ring.connect(handles[(r - 1) % d], handles[(r + 1) % d])
    device_ids = [mesh.device.index] if dist.get_backend(mesh.group) == "nccl" else None
    dist.barrier(group=mesh.group, device_ids=device_ids)
    return ring


class ShardedStep:
    """The fp32 body-sharded step of ``make_sharded_step``; also gives the
    force (``accel``) and the Hermite evaluation (``accel_jerk``) of this
    rank's shard under the whole body set, by the same strategy."""

    def __init__(self, mesh: Mesh, *, backend: str, strategy: str, block_size: int,
                 variant: str, integrator: str):
        self.mesh = mesh
        self.backend = backend
        self.strategy = strategy
        self.block_size = block_size
        self.variant = variant
        self.integrator = integrator
        self._rings = {}  # shard length -> FusedRing (ring_fused)

    def _ring_on(self, pos) -> bool:
        """Whether the j-shards travel the ring (ring, ring_fused) rather
        than gather (allgather, and auto below the cost model's shard)."""
        return _resolve(self.strategy, self.mesh, pos.shape[0]) in ("ring", "ring_fused")

    def _fused_ring(self, m: int) -> ck.FusedRing:
        ring = self._rings.get(m)
        if ring is None:
            ring = self._rings[m] = open_fused_ring(self.mesh, m, self.block_size)
        return ring

    def close(self) -> None:
        """Free the fused ring's buffers (no rank may step again). A ring
        call returns only after the peers' last writes into this rank's
        buffers, so no barrier is needed."""
        for ring in self._rings.values():
            ring.close()
        self._rings.clear()

    def _accel_vs(self, pos_i, pos_j, soft):
        if self.backend == "cuda":
            return ck.compute_accel_cuda(pos_i, pos_j, soft, block_size=self.block_size)
        return reference.compute_accel_vs(pos_i, pos_j, soft)

    def _aj_vs(self, pos_i, vel_i, pos_j, vel_j, soft):
        if self.backend == "cuda":
            return ck.compute_accel_jerk_cuda(pos_i, vel_i, pos_j, vel_j, soft,
                                              block_size=self.block_size)
        return reference.compute_accel_jerk_vs(pos_i, vel_i, pos_j, vel_j, soft)

    def _step_vs(self, pos, vel, pos_j, dt, soft, damp):
        """The fused Euler step of the i-shard under the gathered j-set, in
        the variant's kernel (nbody_tpu/parallel/sharded.py:458-467)."""
        if self.variant in reference.MXU_VARIANTS:
            if self.backend == "cuda":
                return ck.nbody_step_mxu_cuda_vs(pos, vel, pos_j, dt, soft, damp,
                                                 variant=self.variant)
            return reference.nbody_step_mxu_vs(pos, vel, pos_j, dt, soft, damp,
                                               mxu_dtype=reference.MXU_DTYPES[self.variant])
        if self.backend == "cuda":
            return ck.nbody_step_cuda_vs(pos, vel, pos_j, dt, soft, damp,
                                         block_size=self.block_size)
        return reference.nbody_step_vs(pos, vel, pos_j, dt, soft, damp)

    def _sym(self, sets, softening) -> torch.Tensor:
        """Each pair once across the mesh (``parallel/sym.py``): `sets` is
        this rank's (pos,) or (pos, vel); returns its rows of the summed
        contributions, (nloc, 3) or (nloc, 6) acc | jerk."""
        if sets[0].dtype != torch.float32:
            raise ValueError("strategy='sym' runs the float32 each-pair-once kernels; a "
                             f"{sets[0].dtype} state takes allgather, ring or auto")
        mesh, nloc = self.mesh, sets[0].shape[0]
        b = sym.padded_rows(nloc, mesh.size)
        gathered = _gather_planes(mesh, *(sym.pad_rows(x, b) for x in sets))
        contrib = sym.rank_contributions(tuple(gathered), mesh.rank, mesh.size, softening)
        (total,) = ring_reduce_scatter(mesh, (contrib,), reference.add_fields)
        return total[:nloc]

    def accel(self, pos, softening):
        """(nloc,3) acceleration of the shard `pos` from every body."""
        if self.strategy == "sym":
            return self._sym((pos,), softening)
        if self.strategy == "ring_fused":
            return ck.ring_accel_fused_cuda(pos, softening, self._fused_ring(pos.shape[0]))
        if self._ring_on(pos):
            return _ring_sum(self.mesh, pos, lambda j: self._accel_vs(pos, j, softening),
                             torch.add)
        return self._accel_vs(pos, all_gather_rows(self.mesh, pos), softening)

    def accel_jerk(self, pos, vel, softening):
        """(acc, jerk), each (nloc,3), of the shard from every body: the
        positions and velocities travel together (also for ring_fused, whose
        kernel computes the force only)."""
        if self.strategy == "sym":
            total = self._sym((pos, vel), softening)
            return total[:, :3], total[:, 3:]
        if self._ring_on(pos):
            return _ring_sum(self.mesh, torch.stack((pos, vel)),
                             lambda j: self._aj_vs(pos, vel, j[0], j[1], softening),
                             lambda x, y: (x[0] + y[0], x[1] + y[1]))
        j = _gather_planes(self.mesh, pos, vel)
        return self._aj_vs(pos, vel, j[0], j[1], softening)

    def __call__(self, pos, vel, dt, softening, damping):
        if self.integrator == "hermite":
            return reference.nbody_step_hermite(
                pos, vel, dt, softening, damping,
                accel_jerk_fn=lambda p, v: self.accel_jerk(p, v, softening))
        if self.integrator == "leapfrog":
            return reference.nbody_step_leapfrog(pos, vel, dt, softening, damping,
                                                 accel_fn=lambda p: self.accel(p, softening))
        if self.strategy == "sym" or self._ring_on(pos):
            return reference.integrate(pos, vel, self.accel(pos, softening), dt, damping)
        return self._step_vs(pos, vel, all_gather_rows(self.mesh, pos), dt, softening, damping)


def make_sharded_step(mesh: Mesh, *, axis: str = BODY_AXIS, backend: str = "auto",
                      strategy: str = "allgather", block_size: int | None = None,
                      variant: str = "vpu", integrator: str = "euler") -> ShardedStep:
    """The fp32 (or float64) body-sharded step: (pos, vel, dt, softening,
    damping) -> (pos, vel), each this rank's (N/D, 4) shard.

    backend: "cuda", "torch" or "auto" (the mesh device's). strategy:
    "allgather", "ring", "ring_fused" (the fused ring kernel; Euler and
    leapfrog, backend "cuda" or "auto", which on a CPU mesh is its plain
    ring), "sym" (each pair once across the mesh, every integrator; backend
    "cuda" or "auto", the plain versions on a CPU mesh) or "auto"
    (``choose_strategy`` by shard size).
    variant: the kernel of the allgather Euler step, "vpu", "mxu" or
    "mxu_bf16"; the ring, leapfrog and Hermite run the one-sided force
    kernels and sym its own, as in ``nbody_tpu``. integrator: "euler",
    "leapfrog" (the shard drifts dt/2 first and the half-step positions are
    the j-side) or "hermite" (two accel + jerk evaluations a step, positions
    and velocities travelling together). A float64 state runs the double
    kernels, but for ring_fused and sym, which are float32 kernels."""
    _check_1d(mesh, "make_sharded_step_2d")
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if integrator not in ("euler", "leapfrog", "hermite"):
        raise ValueError(f"unknown integrator {integrator!r}")
    if strategy not in ("allgather", "ring", "ring_fused", "auto", "sym"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if strategy == "sym":
        # nbody_tpu/parallel/sharded.py:444-447, backend for kernel
        if backend == "torch":
            raise ValueError("strategy='sym' runs the Newton's-third-law CUDA kernels; "
                             "use backend='cuda'")
        # the kernels' wrappers take their plain versions on a CPU mesh
        backend = "cuda"
    if strategy == "ring_fused":
        # nbody_tpu/parallel/sharded.py:437-443, backend for kernel
        if backend == "torch":
            raise ValueError("strategy='ring_fused' is a CUDA kernel; use backend='cuda'")
        if integrator == "hermite":
            raise ValueError(
                "integrator='hermite' supports strategies "
                "'allgather'/'ring'/'auto' (ring_fused fuses the Euler "
                "update into its kernel)")
        # the kernel's wrapper takes the plain ring on a CPU mesh
        backend = "cuda"
    if variant not in ("vpu", *reference.MXU_VARIANTS):
        raise ValueError(f"unknown kernel variant {variant!r} for a sharded step "
                         "(vpu, mxu or mxu_bf16)")
    return ShardedStep(mesh, backend=_check_backend(backend, mesh), strategy=strategy,
                       block_size=ck.DEFAULT_BLOCK_SIZE if block_size is None
                       else ck.check_block_size(block_size),
                       variant=variant, integrator=integrator)


class ShardedDSStep:
    """The ds body-sharded step of ``make_sharded_ds_step``; also gives the
    ds force (``accel``) and the ds Hermite evaluation (``accel_jerk``) of
    this rank's shard under the whole body set, by the same strategy."""

    def __init__(self, mesh: Mesh, *, backend: str, strategy: str, block_size: int | None,
                 integrator: str):
        self.mesh = mesh
        self.backend = backend
        self.strategy = strategy
        self.block_size = block_size
        self.integrator = integrator

    def _bs(self, m: int) -> int:
        return ck.ds_default_block_size(m) if self.block_size is None else self.block_size

    def _accel_vs(self, ph, plo, jh, jl, scal):
        if self.backend == "cuda":
            return ck.compute_accel_ds_cuda_vs(ph, plo, jh, jl, scal,
                                               block_size=self._bs(ph.shape[0]))
        return ds.ds_accel_vs(ph, plo, jh, jl, scal)

    def _aj_vs(self, planes, jplanes, scal):
        if self.backend == "cuda":
            return ck.compute_accel_jerk_ds_cuda_vs(*planes, *jplanes, scal,
                                                    block_size=self._bs(planes[0].shape[0]))
        return ds.ds_accel_jerk_vs(*planes, *jplanes, scal)

    def accel(self, ph, plo, scal):
        """(acc_hi, acc_lo), each (nloc,3), of the shard from every body."""
        if self.strategy == "ring":
            return _ring_sum(self.mesh, torch.stack((ph, plo)),
                             lambda j: self._accel_vs(ph, plo, j[0], j[1], scal), ds.ds_add)
        j = _gather_planes(self.mesh, ph, plo)
        return self._accel_vs(ph, plo, j[0], j[1], scal)

    def accel_jerk(self, ph, plo, vh, vlo, scal):
        """(acc_hi, acc_lo, jerk_hi, jerk_lo), each (nloc,4) with w = 0, of
        the shard from every body: the four planes travel together."""
        planes = (ph, plo, vh, vlo)
        if self.strategy == "ring":
            return _ring_sum(self.mesh, torch.stack(planes),
                             lambda j: self._aj_vs(planes, tuple(j), scal), ds.ds_add_aj)
        return self._aj_vs(planes, tuple(_gather_planes(self.mesh, *planes)), scal)

    def _integrate(self, planes, acc, scal):
        if self.backend == "cuda":
            return ck.ds_integrate_cuda(*planes, *acc, scal)
        return ds.ds_integrate(*planes, acc, scal)

    def _hermite(self, planes, scal):
        """ds Hermite P(EC): accel + jerk of the shard, the predictor on the
        shard, accel + jerk of the predicted state (gathered or travelling
        anew: a prediction exists only where its shard's a0 and j0 are),
        the corrector."""
        f0 = self.accel_jerk(*planes, scal)
        if self.backend == "cuda":
            pred = ck.ds_hermite_predict_cuda(*planes, *f0, scal)
            return ck.ds_hermite_correct_cuda(*planes, *f0, *self.accel_jerk(*pred, scal), scal)
        pred = ds.ds_hermite_predict(*planes, f0[:2], f0[2:], scal)
        f1 = self.accel_jerk(*pred, scal)
        return ds.ds_hermite_correct(*planes, f0[:2], f0[2:], f1[:2], f1[2:], scal)

    def __call__(self, ph, plo, vh, vlo, scal):
        planes = (ph, plo, vh, vlo)
        if self.integrator == "hermite":
            return self._hermite(planes, scal)
        ring = self.strategy == "ring"
        if self.integrator == "leapfrog":
            if ring:
                # every shard half-drifts once and the drifted positions
                # travel: two planes on the ring instead of four
                hh, hl = ds.ds_half_drift(*planes, scal)
                return ds.ds_leapfrog_finish(hh, hl, vh, vlo, self.accel(hh, hl, scal), scal)
            j = _gather_planes(self.mesh, *planes)
            if self.backend == "cuda":
                return ck.nbody_step_ds_leapfrog_cuda_vs(*planes, *j, scal,
                                                         block_size=self._bs(ph.shape[0]))
            return ds.nbody_step_ds_leapfrog_vs(*planes, *j, scal)
        if ring:
            return self._integrate(planes, self.accel(ph, plo, scal), scal)
        j = _gather_planes(self.mesh, ph, plo)
        if self.backend == "cuda":
            return ck.nbody_step_ds_cuda_vs(*planes, j[0], j[1], scal,
                                            block_size=self._bs(ph.shape[0]))
        return ds.nbody_step_ds_vs(*planes, j[0], j[1], scal)


def make_sharded_ds_step(mesh: Mesh, *, axis: str = BODY_AXIS, backend: str = "auto",
                         block_size: int | None = None, integrator: str = "euler",
                         strategy: str = "allgather") -> ShardedDSStep:
    """The double-single (fp64-grade) body-sharded step: (pos_hi, pos_lo,
    vel_hi, vel_lo, scal) -> the four new planes, each this rank's (N/D, 4)
    shard; `scal` is the host block of ops/ds.py for the integrator
    (``scal_ds``, ``scal_ds_leapfrog``, ``scal_ds_hermite``).

    allgather: the planes gather (hi and lo positions for Euler, also the
    velocities for leapfrog, whose fused kernel half-drifts both sides),
    one fused one-sided ds kernel launch. ring: one ds accel-only launch a
    hop, the partials summed in anchored ds (``ds_add``) in hop order, then
    the ds Euler update or the leapfrog finish once (leapfrog half-drifts
    every shard once first and the drifted planes travel). Hermite: two
    rounds a step, each gathering or ring-rotating the four planes with ds
    (acc, jerk) partials, around the ds predictor and corrector. block_size
    defaults to ``ds_default_block_size`` of the shard."""
    _check_1d(mesh, "make_sharded_ds_step_2d")
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if integrator not in ("euler", "leapfrog", "hermite"):
        raise ValueError(
            f"make_sharded_ds_step: integrator must be 'euler', "
            f"'leapfrog', or 'hermite', got {integrator!r}")
    if strategy not in ("allgather", "ring"):
        raise ValueError(
            f"make_sharded_ds_step: strategy must be 'allgather' or "
            f"'ring', got {strategy!r}")
    return ShardedDSStep(mesh, backend=_check_backend(backend, mesh), strategy=strategy,
                         block_size=None if block_size is None
                         else ck.check_block_size(block_size),
                         integrator=integrator)


class Sharded2DStep(ShardedStep):
    """The 2-D step of ``make_sharded_step_2d``; also gives the force
    (``accel``) and the Hermite evaluation (``accel_jerk``) of this rank's
    chunk under the whole body set."""

    def __init__(self, mesh: Mesh2D, *, backend: str, block_size: int, integrator: str):
        super().__init__(mesh, backend=backend, strategy="2d", block_size=block_size,
                         variant="vpu", integrator=integrator)

    def accel(self, pos, softening):
        """(nloc,3): the row block's force under the column block, summed
        over the row's C ranks onto their chunks."""
        i = all_gather_rows(self.mesh.along_cols, pos)
        j = all_gather_rows(self.mesh.along_rows, pos)
        (acc,) = ring_reduce_scatter(self.mesh.along_cols, (self._accel_vs(i, j, softening),),
                                     reference.add_fields)
        return acc

    def accel_jerk(self, pos, vel, softening):
        i = _gather_planes(self.mesh.along_cols, pos, vel)
        j = _gather_planes(self.mesh.along_rows, pos, vel)
        return ring_reduce_scatter(self.mesh.along_cols,
                                   self._aj_vs(i[0], i[1], j[0], j[1], softening),
                                   reference.add_fields)

    def __call__(self, pos, vel, dt, softening, damping):
        if self.integrator == "euler":
            return reference.integrate(pos, vel, self.accel(pos, softening), dt, damping)
        return super().__call__(pos, vel, dt, softening, damping)


def emulated_accel_2d(pos, rows: int, cols: int, softening, *,
                      block_size: int = ck.DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """The force of ``make_sharded_step_2d``'s R x C grid in one process:
    every rank's block on the one-sided force kernel (its plain version on
    the CPU) and each row's C partials summed as ``ring_reduce_scatter``
    sums them. (N,4) -> (N,3); a rank of a real grid gets its chunk's rows
    of it bit for bit."""
    n = pos.shape[0]
    if n % (rows * cols):
        raise ValueError(f"N={n} not divisible by {rows}x{cols} ranks; pad first")
    m = n // (rows * cols)
    out = []
    for r in range(rows):
        i_set = pos[r * cols * m:(r + 1) * cols * m]
        partials = []
        for c in range(cols):
            j_set = torch.cat([pos[(k * cols + c) * m:(k * cols + c + 1) * m]
                               for k in range(rows)])
            partials.append((ck.compute_accel_cuda(i_set, j_set, softening,
                                                   block_size=block_size),))
        out += [chunk[0] for chunk in sym.emulated_reduce_scatter(partials,
                                                                   reference.add_fields)]
    return torch.cat(out)


def _check_2d(mesh, axes, integrator: str, builder_1d: str) -> None:
    if not isinstance(mesh, Mesh2D):
        raise ValueError(f"the 2-D decomposition needs a (rows, cols) mesh "
                         f"(parallel.make_mesh_2d); got axes "
                         f"{tuple(getattr(mesh, 'axis_names', ()))}: use {builder_1d}")
    if tuple(axes) != mesh.axis_names:
        raise ValueError(f"the mesh's axes are {mesh.axis_names!r}, not {tuple(axes)!r}")
    if integrator not in ("euler", "leapfrog", "hermite"):
        raise ValueError(f"unknown integrator {integrator!r}")


def make_sharded_step_2d(mesh: Mesh2D, *, axes: tuple = ("rows", "cols"), backend: str = "auto",
                         block_size: int | None = None,
                         integrator: str = "euler") -> Sharded2DStep:
    """The 2-D (rows x cols) force decomposition, the counterpart of
    ``nbody_tpu/parallel/sharded.py:624-750``: (pos, vel, dt, softening,
    damping) -> (pos, vel), each this rank's (N/(R·C), 4) chunk, fp32 or
    float64. Rank (r, c) gathers its i-set (the N/R bodies of row block r)
    over its row and its j-set (the N/C bodies of column block c) over its
    column, runs the one-sided force (accel + jerk for Hermite, the
    velocities gathered beside) on the (N/R x N/C) block, and
    ``ring_reduce_scatter`` over the row sums the C partials onto each
    chunk, where ``nbody_tpu`` runs a psum and keeps its chunk's slice: the
    same sum with half the bytes. Euler integrates the chunk; leapfrog
    half-drifts it first; Hermite makes two evaluations a step."""
    _check_2d(mesh, axes, integrator, "make_sharded_step")
    return Sharded2DStep(mesh, backend=_check_backend(backend, mesh),
                         block_size=ck.DEFAULT_BLOCK_SIZE if block_size is None
                         else ck.check_block_size(block_size),
                         integrator=integrator)


class ShardedDS2DStep(ShardedDSStep):
    """The ds 2-D step of ``make_sharded_ds_step_2d``, with the force and
    the Hermite evaluation of this rank's chunk as ``ShardedDSStep`` gives
    them."""

    def __init__(self, mesh: Mesh2D, *, backend: str, block_size: int | None, integrator: str):
        super().__init__(mesh, backend=backend, strategy="2d", block_size=block_size,
                         integrator=integrator)

    def accel(self, ph, plo, scal):
        i = _gather_planes(self.mesh.along_cols, ph, plo)
        j = _gather_planes(self.mesh.along_rows, ph, plo)
        return ring_reduce_scatter(self.mesh.along_cols,
                                   self._accel_vs(i[0], i[1], j[0], j[1], scal), ds.ds_add)

    def accel_jerk(self, ph, plo, vh, vlo, scal):
        i = _gather_planes(self.mesh.along_cols, ph, plo, vh, vlo)
        j = _gather_planes(self.mesh.along_rows, ph, plo, vh, vlo)
        return ring_reduce_scatter(self.mesh.along_cols, self._aj_vs(tuple(i), tuple(j), scal),
                                   ds.ds_add_aj)

    def __call__(self, ph, plo, vh, vlo, scal):
        planes = (ph, plo, vh, vlo)
        if self.integrator == "hermite":
            return self._hermite(planes, scal)
        if self.integrator == "leapfrog":
            # each chunk half-drifts once and the drifted planes gather
            hh, hl = ds.ds_half_drift(*planes, scal)
            return ds.ds_leapfrog_finish(hh, hl, vh, vlo, self.accel(hh, hl, scal), scal)
        return self._integrate(planes, self.accel(ph, plo, scal), scal)


def make_sharded_ds_step_2d(mesh: Mesh2D, *, axes: tuple = ("rows", "cols"),
                            backend: str = "auto", block_size: int | None = None,
                            integrator: str = "euler") -> ShardedDS2DStep:
    """The 2-D (rows x cols) decomposition in double-single, the
    counterpart of ``nbody_tpu/parallel/sharded.py:1282-1414``: (pos_hi,
    pos_lo, vel_hi, vel_lo, scal) -> the four new planes of this rank's
    chunk. The planes gather as in ``make_sharded_step_2d`` (hi and lo
    positions, also the velocities for Hermite) and the one-sided ds force
    or accel + jerk kernel runs on the block; the C column partials are
    summed by ``ring_reduce_scatter`` with the anchored ``ds_add``, where a
    float32 psum would lose the low words. Euler: the ds update once;
    leapfrog: each chunk half-drifts once and the drifted planes gather;
    Hermite: two rounds around the ds predictor and corrector. block_size
    defaults to ``ds_default_block_size`` of the row block."""
    _check_2d(mesh, axes, integrator, "make_sharded_ds_step")
    return ShardedDS2DStep(mesh, backend=_check_backend(backend, mesh),
                           block_size=None if block_size is None
                           else ck.check_block_size(block_size),
                           integrator=integrator)


def make_sharded_rollout(step_fn, steps: int):
    """`steps` sharded steps in a row, the counterpart of
    ``nbody_tpu/parallel/sharded.py:753-765``: rollout(pos, vel, dt,
    softening, damping) -> (pos, vel) of this rank's shard, each step's
    launches queued with no host synchronisation in between."""
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"steps must be >= 0; got {steps}")

    def rollout(pos, vel, dt, softening, damping):
        for _ in range(steps):
            pos, vel = step_fn(pos, vel, dt, softening, damping)
        return pos, vel

    return rollout


def make_sharded_ds_adaptive_rollout(*args, **kwargs):
    """The sharded ds adaptive rollout: not ported yet (it needs the
    adaptive steps)."""
    from nbody_tpu_torch.models.body_system import not_ported

    raise not_ported("adaptive", True)


make_sharded_ds_adaptive_rollout_2d = make_sharded_ds_adaptive_rollout
