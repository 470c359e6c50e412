"""The body mesh on torch.distributed, and state sharding helpers.

Counterpart of ``nbody_tpu/parallel/mesh.py``. A JAX mesh is a grid of
devices that one program addresses; here a mesh is the default process
group, one process (rank) per device, and each rank holds its own shard of
the bodies. ``Mesh`` records what a sharded step needs: the axis name, the
number of ranks, this rank, the group and the device its shard lives on.
``Mesh2D`` is the rows x cols grid of the 2-D decomposition: rank r·C + c
holds body chunk r·C + c, and a 1-D ``Mesh`` along each axis (this rank's
row, this rank's column) runs that axis's collectives.

A CUDA mesh runs on NCCL, a CPU mesh on gloo; neither falls back to the
other.
"""

from __future__ import annotations

import dataclasses
import datetime
import weakref

import numpy as np
import torch
import torch.distributed as dist

from nbody_tpu_torch.utils.profiling import annotate

BODY_AXIS = "bodies"
# how long the other ranks wait for rank 0's host-side verdict (Compute's QA
# and drift checks run the oracle on rank 0 alone): beyond any check, so the
# wait does not end at the process group's own timeout, as the JAX package's
# single controller never times out on its own oracle. The price: a rank 0
# that hangs inside a check (not one that raises, whose exit ends the wait)
# holds the other ranks this long, not the group's timeout
JUDGE_TIMEOUT = datetime.timedelta(hours=24)
# the judge group of each default process group, made once (new_group is a
# collective of every rank), keyed weakly on the default group: so that
# dist.destroy_process_group() frees it with the default group. A destroyed
# gloo group that a reference keeps to the interpreter's shutdown is freed
# there, and that can abort the process ("terminate called without an
# active exception"; ROADMAP.md, Queue 3)
_JUDGE_GROUP: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
# the line groups of each (rows, cols) grid, made once a default process
# group for the same reason
_LINE_GROUPS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D body mesh: `size` ranks of `group`, this process `rank`, its
    shard on `device`. ``axis_names`` and ``shape`` read as a JAX mesh's.
    `judge_group` is a gloo group of the same ranks with the timeout
    JUDGE_TIMEOUT, on which rank 0's verdicts travel (None, as for one
    rank: on `group`)."""

    axis: str
    size: int
    rank: int
    group: object
    device: torch.device
    judge_group: object = None
    # the global ranks of the axis's positions, when they are not 0..size-1
    # (a line of a 2-D mesh); `rank` is this process's position
    ranks: tuple = ()

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    def peer(self, index: int) -> int:
        """The global rank at position `index` (mod size) of the axis: the
        address of a point-to-point message."""
        index %= self.size
        return self.ranks[index] if self.ranks else index


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (rows x cols) body mesh of ``size`` = rows·cols ranks: rank r·C + c
    is (r, c) and holds body chunk r·C + c, as ``P(("rows", "cols"), None)``
    lays the bodies out. ``along_cols`` is the 1-D mesh of this rank's row
    (its C ranks, in c order: the row block's chunks, contiguous) and
    ``along_rows`` that of its column (its R ranks, in r order: the column
    block's strided chunks). `group` and `judge_group` span every rank, as a
    1-D mesh's do."""

    axes: tuple
    rows: int
    cols: int
    rank: int
    group: object
    device: torch.device
    along_rows: Mesh
    along_cols: Mesh
    judge_group: object = None

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def axis_names(self) -> tuple:
        return tuple(self.axes)

    @property
    def shape(self) -> dict:
        return {self.axes[0]: self.rows, self.axes[1]: self.cols}


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(num_devices: int | None = None, *, axis: str = BODY_AXIS, device=None) -> Mesh:
    """1-D body mesh over the ranks of the default process group, one rank
    a device. `device` is this rank's device: by default the current CUDA
    device under NCCL and the CPU under gloo. With no group started and
    `num_devices` None or 1, a one-rank group is started over a
    ``HashStore``: NCCL on a CUDA device (the default), gloo on the CPU; a
    process that started it so destroys it before it exits
    (``dist.destroy_process_group()``, as the CLI does): a gloo group still
    alive when the interpreter shuts down can abort the process ("terminate
    called without an active exception"). Raises, as ``nbody_tpu`` does,
    when more devices are requested than the group has ranks; fewer is an
    error too, since a rank is one device."""
    from nbody_tpu_torch.models.body_system import resolve_device

    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(
                f"requested {num_devices} devices but only 1 available (one process; "
                f"start {num_devices} with torchrun --nproc_per_node {num_devices})")
        device = resolve_device("cuda" if device is None else device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(_backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if num_devices is not None and num_devices > world:
        raise ValueError(f"requested {num_devices} devices but only {world} available")
    if num_devices is not None and num_devices < world:
        raise ValueError(
            f"requested {num_devices} devices but the process group has {world} ranks, "
            "one a device; start one process per device of the mesh")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = resolve_device(device)
    if backend != _backend_for(device):
        raise ValueError(
            f"a mesh on {device} needs the {_backend_for(device)} backend; the process "
            f"group runs {backend}")
    return Mesh(axis=axis, size=world, rank=dist.get_rank(), group=dist.group.WORLD,
                device=device, judge_group=_judge_group(world))


def _judge_group(world: int):
    """The gloo group of every rank with the timeout JUDGE_TIMEOUT, one per
    default process group (None for one rank, which waits for no one)."""
    if world == 1:
        return None
    default = dist.group.WORLD
    if default not in _JUDGE_GROUP:
        _JUDGE_GROUP[default] = dist.new_group(backend="gloo", timeout=JUDGE_TIMEOUT)
    return _JUDGE_GROUP[default]


def shard_rows(mesh: Mesh, n: int) -> slice:
    """The rows of an N-body state that this rank holds. N must divide
    evenly by the mesh size (pad_to_multiple first; zero-mass padding bodies
    exert no force)."""
    if n % mesh.size:
        raise ValueError(f"N={n} not divisible by {mesh.size} devices; pad first")
    nloc = n // mesh.size
    return slice(mesh.rank * nloc, (mesh.rank + 1) * nloc)


def shard_state(mesh: Mesh, pos, vel):
    """This rank's shard of (pos, vel), (N,4) arrays or tensors, as float32
    tensors on the mesh's device."""
    rows = shard_rows(mesh, pos.shape[0])
    return tuple(torch.as_tensor(a[rows], dtype=torch.float32).to(mesh.device).contiguous()
                 for a in (pos, vel))


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The shards `x` (nloc, ...) of every rank, concatenated in rank order:
    a tiled all-gather along rows (``jax.lax.all_gather(..., tiled=True)``).
    Synchronous: on the card, the current stream waits for it."""
    with annotate("nbody.allgather"):
        x = x.contiguous()
        out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out


def make_mesh_2d(rows: int, cols: int, *, axes=("rows", "cols"), device=None) -> Mesh2D:
    """The 2-D (rows x cols) mesh of the i-block x j-block decomposition
    (``make_sharded_step_2d``) over the ranks of the default process group,
    which must number rows·cols (a one-rank group is started as
    ``make_mesh`` starts it for 1x1). Every rank makes the groups of every
    row and every column, in the same order (``new_group`` is a collective
    of every rank), once a default group and grid."""
    rows, cols = int(rows), int(cols)
    if rows < 1 or cols < 1:
        raise ValueError(f"a mesh needs rows, cols >= 1; got {rows}x{cols}")
    if len(axes) != 2:
        raise ValueError(f"need a (rows, cols) axis pair, got {axes!r}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if rows * cols > world:
        raise ValueError(f"requested {rows}x{cols} devices but only {world} available")
    base = make_mesh(rows * cols, device=device)
    row_lines, col_lines = _line_groups(rows, cols)
    r, c = divmod(base.rank, cols)
    along_cols = Mesh(axis=axes[1], size=cols, rank=c, group=col_lines[r], device=base.device,
                      ranks=tuple(r * cols + k for k in range(cols)))
    along_rows = Mesh(axis=axes[0], size=rows, rank=r, group=row_lines[c], device=base.device,
                      ranks=tuple(k * cols + c for k in range(rows)))
    return Mesh2D(axes=tuple(axes), rows=rows, cols=cols, rank=base.rank, group=base.group,
                  device=base.device, along_rows=along_rows, along_cols=along_cols,
                  judge_group=base.judge_group)


def _line_groups(rows: int, cols: int) -> tuple:
    """(row_lines, col_lines): for each column c the group of its R ranks
    (the "rows" axis), for each row r the group of its C ranks (the "cols"
    axis); made by every rank, columns first, then rows."""
    default = dist.group.WORLD
    grids = _LINE_GROUPS.setdefault(default, {})
    if (rows, cols) not in grids:
        row_lines = [dist.new_group([k * cols + c for k in range(rows)]) for c in range(cols)]
        col_lines = [dist.new_group([r * cols + k for k in range(cols)]) for r in range(rows)]
        grids[(rows, cols)] = (row_lines, col_lines)
    return grids[(rows, cols)]


def pad_to_multiple(pos, vel, multiple: int):
    """Zero-mass-pad state so N is a multiple (shards and tiles both need it).

    Returns (pos, vel, original_n)."""
    n = pos.shape[0]
    n_pad = ((n + multiple - 1) // multiple) * multiple
    if n_pad == n:
        return pos, vel, n
    pad = ((0, n_pad - n), (0, 0))
    return np.pad(np.asarray(pos), pad), np.pad(np.asarray(vel), pad), n
