"""Body systems: simulation state on a torch device, and stepping."""

from nbody_tpu_torch.models.body_system import BodySystem, load_checkpoint, state_from_numpy

__all__ = ["BodySystem", "load_checkpoint", "state_from_numpy"]
