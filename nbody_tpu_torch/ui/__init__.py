"""Interactive UI equivalents: keyboard controls, adjustable-parameter panel,
HUD overlay — the reference's GLUT/OpenGL UI layer for a headless host
(copies of ``nbody_tpu.ui``)."""

from nbody_tpu_torch.ui.controls import Controls
from nbody_tpu_torch.ui.params_panel import AdjustableParam, ParamPanel
from nbody_tpu_torch.ui.hud import draw_hud

__all__ = ["Controls", "AdjustableParam", "ParamPanel", "draw_hud"]
