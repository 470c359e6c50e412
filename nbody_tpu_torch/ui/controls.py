"""Keyboard controls for the interactive demo loop.

Same key map as the reference (the reference's src/nbody/controls.cpp:75-149):
space=pause, q/Esc=quit, Enter=precision toggle, backquote=sliders panel,
g=GFLOPs<->interactions HUD toggle, p=display mode cycle, c=toggle demo
cycling, [ / ]=previous/next demo, d=display off, o=print params,
1/2/3/4=reset shell/random/expand/plummer. Mouse camera control maps to keys since
the host is a terminal: w/s=zoom, a/e=rotate, and SHIFT+H/J/K/L=translate
(the reference's shift/middle-drag, controls.cpp:38-55).

The dispatcher is pure: ``Controls.handle(key)`` mutates the engine/camera
it was built with and returns False when the loop should quit — so it is
unit-testable without a terminal. ``read_keys()`` drains stdin non-blockingly
when attached to a tty.
"""

from __future__ import annotations

import select
import sys

from nbody_tpu_torch.config import NBodyConfig
from nbody_tpu_torch.render.rasterizer import DisplayMode

# the reference cycles its 3 GL modes; SPRITES_ALPHA (depth-ordered
# compositing) is nbody_tpu's extension to the cycle
_DISPLAY_ORDER = [DisplayMode.POINTS, DisplayMode.SPRITES,
                  DisplayMode.SPRITES_COLOR, DisplayMode.SPRITES_ALPHA]


class Controls:
    def __init__(self, compute, camera=None, log=print):
        self.compute = compute
        self.camera = camera
        self.log = log
        self.display_mode = DisplayMode.SPRITES_COLOR
        self.display_enabled = True
        self.show_sliders = False
        self.show_interactions = False  # g: report interactions/s vs GFLOP/s
        self.panel = None  # created on first backquote

    def handle(self, key: str) -> bool:
        """Apply one keypress; returns False if the loop should quit."""
        c = self.compute
        if key in ("q", "\x1b"):  # q or Esc
            return False
        elif key == " ":
            c.pause()
        elif key in ("\r", "\n"):
            try:
                c.switch_precision()
                self.log(f"precision: {getattr(c, 'precision', 'fp64' if c.fp64_enabled else 'fp32')}")
            except ValueError as e:
                # e.g. fp64 without x64 enabled — report, don't kill the loop
                self.log(f"precision switch unavailable: {e}")
        elif key == "`":
            self.show_sliders = not self.show_sliders
            if self.show_sliders:
                if self.panel is None:
                    from nbody_tpu_torch.ui.params_panel import ParamPanel

                    self.panel = ParamPanel.for_compute(c)
                self.log(self.panel.render_text())
        # slider navigation while the panel is shown (the reference's GL
        # panel arrow keys): j/k = next/previous, h/l = decrease/increase
        elif self.show_sliders and key in "jkhl":
            if key == "j":
                self.panel.select_next()
            elif key == "k":
                self.panel.select_previous()
            elif key == "h":
                self.panel.adjust_selected(-1)
            else:
                self.panel.adjust_selected(+1)
            self.log(self.panel.render_text())
        elif key == "g":
            self.show_interactions = not self.show_interactions
        elif key == "p":
            i = _DISPLAY_ORDER.index(self.display_mode)
            self.display_mode = _DISPLAY_ORDER[(i + 1) % len(_DISPLAY_ORDER)]
            self.log(f"display mode: {self.display_mode.value}")
        elif key == "c":
            c.toggle_cycle_demo()
        elif key == "[":
            c.previous_demo(self.camera)
        elif key == "]":
            c.next_demo(self.camera)
        elif key == "d":
            self.display_enabled = not self.display_enabled
        elif key == "o":
            self.log(c.active_params.print_values())
        elif key == "1":
            c.reset(NBodyConfig.SHELL)
        elif key == "2":
            c.reset(NBodyConfig.RANDOM)
        elif key == "3":
            c.reset(NBodyConfig.EXPAND)
        # "4" extends the reference's 1/2/3 reset keys
        # (the reference's src/nbody/controls.cpp:133-149) with the
        # equilibrium model the reference lacks
        elif key == "4":
            c.reset(NBodyConfig.PLUMMER)
        # terminal camera nudges (the reference uses mouse drags)
        elif self.camera is not None and key == "w":
            self.camera.zoom(10.0)
        elif self.camera is not None and key == "s":
            self.camera.zoom(-10.0)
        elif self.camera is not None and key == "a":
            self.camera.rotate(-25.0, 0.0)
        elif self.camera is not None and key == "e":
            self.camera.rotate(25.0, 0.0)
        # SHIFT+vim-keys = camera translate, mirroring the reference's
        # shift/middle-button drag (the reference's src/nbody/controls.cpp:38-55)
        elif self.camera is not None and key in "HJKL":
            dx = {"H": -25.0, "L": 25.0}.get(key, 0.0)
            dy = {"J": 25.0, "K": -25.0}.get(key, 0.0)
            self.camera.translate(dx, dy)
        return True

    @staticmethod
    def read_keys() -> str:
        """Drain pending stdin characters without blocking (tty or pipe)."""
        stdin = sys.stdin
        try:
            stdin.fileno()
        except (OSError, ValueError, AttributeError):
            # non-selectable stdin (e.g. StringIO in tests): drain directly
            try:
                return stdin.read() or ""
            except Exception:
                return ""
        keys = ""
        try:
            while select.select([stdin], [], [], 0)[0]:
                ch = stdin.read(1)
                if not ch:
                    break
                keys += ch
        except (OSError, ValueError):
            pass
        return keys
