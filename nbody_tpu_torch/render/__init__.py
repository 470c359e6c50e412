"""On-device rendering: camera, point-splat rasterizer, PNG export.

The reference's OpenGL/GLUT pipeline, as ``nbody_tpu.render`` rebuilt it:
points are projected and splatted additively into an RGB framebuffer on
the state's device (PyTorch, deterministic ``index_add_`` deposits), and
only the finished uint8 frame crosses to the host for PNG export.
"""

from nbody_tpu_torch.render.camera import Camera
from nbody_tpu_torch.render.rasterizer import DisplayMode, FrameRenderer

__all__ = ["Camera", "FrameRenderer", "DisplayMode"]
