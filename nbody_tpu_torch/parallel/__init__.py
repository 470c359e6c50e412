"""Body-sharded meshes and steps on torch.distributed.

Counterpart of ``nbody_tpu/parallel``: positions and velocities sharded by
bodies over a 1-D mesh of ranks (``make_mesh``) or a 2-D rows x cols grid
of them (``make_mesh_2d``), one rank a device, with NCCL collectives on the
card (gloo on the CPU) each step. It exports what ``nbody_tpu``'s package
exports, and ``make_sharded_rollout``, ``ring_reduce_scatter``, ``emulated_sym`` and
``emulated_accel_2d`` beside.
"""

from nbody_tpu_torch.parallel.mesh import (
    Mesh,
    Mesh2D,
    all_gather_rows,
    make_mesh,
    make_mesh_2d,
    pad_to_multiple,
    shard_rows,
    shard_state,
)
from nbody_tpu_torch.parallel.multihost import initialize_multihost, is_multihost
from nbody_tpu_torch.parallel.sharded import (
    choose_strategy,
    emulated_accel_2d,
    make_sharded_adaptive_rollout,
    make_sharded_adaptive_rollout_2d,
    make_sharded_ds_adaptive_rollout,
    make_sharded_ds_adaptive_rollout_2d,
    make_sharded_ds_step,
    make_sharded_ds_step_2d,
    make_sharded_rollout,
    make_sharded_step,
    make_sharded_step_2d,
    ring_reduce_scatter,
)
from nbody_tpu_torch.parallel.sym import emulated_sym

__all__ = [
    "Mesh",
    "Mesh2D",
    "all_gather_rows",
    "make_mesh",
    "make_mesh_2d",
    "pad_to_multiple",
    "shard_rows",
    "shard_state",
    "choose_strategy",
    "make_sharded_step",
    "make_sharded_adaptive_rollout",
    "make_sharded_adaptive_rollout_2d",
    "make_sharded_ds_adaptive_rollout",
    "make_sharded_ds_adaptive_rollout_2d",
    "make_sharded_ds_step",
    "make_sharded_ds_step_2d",
    "make_sharded_step_2d",
    "make_sharded_rollout",
    "ring_reduce_scatter",
    "emulated_sym",
    "emulated_accel_2d",
    "initialize_multihost",
    "is_multihost",
]
