"""Host I/O of the port: tipsy galaxy files and npz checkpoints (copies of
``nbody_tpu.io``'s readers)."""

from nbody_tpu_torch.io.checkpoint import load_checkpoint
from nbody_tpu_torch.io.tipsy import read_tipsy_file, write_tipsy_file

__all__ = ["read_tipsy_file", "write_tipsy_file", "load_checkpoint"]
