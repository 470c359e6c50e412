"""Host I/O of the port: tipsy galaxy files, npz checkpoints, PNG export
(copies of ``nbody_tpu.io``; the orbax checkpoint directories need JAX and
are not ported)."""

from nbody_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_checkpoint_ds_planes,
    save_checkpoint,
)
from nbody_tpu_torch.io.tipsy import read_tipsy_file, write_tipsy_file

__all__ = [
    "read_tipsy_file",
    "write_tipsy_file",
    "save_checkpoint",
    "load_checkpoint",
    "load_checkpoint_ds_planes",
]
