"""HUD text overlay burned into rendered frames.

The reference draws device name / FPS / GFLOP-s / body count as GL bitmap
text over the frame (the reference's src/nbody/interface.cpp:41-59,
gl_print.hpp). Frames here are uint8 numpy arrays, so the HUD is a tiny
built-in 3x5 pixel font stamped on the host after device rasterization —
no GL, no font dependency.
"""

from __future__ import annotations

import numpy as np

_GLYPHS = {
    "0": ["###", "# #", "# #", "# #", "###"],
    "1": [" # ", "## ", " # ", " # ", "###"],
    "2": ["###", "  #", "###", "#  ", "###"],
    "3": ["###", "  #", "###", "  #", "###"],
    "4": ["# #", "# #", "###", "  #", "  #"],
    "5": ["###", "#  ", "###", "  #", "###"],
    "6": ["###", "#  ", "###", "# #", "###"],
    "7": ["###", "  #", " # ", " # ", " # "],
    "8": ["###", "# #", "###", "# #", "###"],
    "9": ["###", "# #", "###", "  #", "###"],
    "A": [" # ", "# #", "###", "# #", "# #"],
    "B": ["## ", "# #", "## ", "# #", "## "],
    "C": ["###", "#  ", "#  ", "#  ", "###"],
    "D": ["## ", "# #", "# #", "# #", "## "],
    "E": ["###", "#  ", "## ", "#  ", "###"],
    "F": ["###", "#  ", "## ", "#  ", "#  "],
    "G": ["###", "#  ", "# #", "# #", "###"],
    "H": ["# #", "# #", "###", "# #", "# #"],
    "I": ["###", " # ", " # ", " # ", "###"],
    "J": ["  #", "  #", "  #", "# #", "###"],
    "K": ["# #", "## ", "#  ", "## ", "# #"],
    "L": ["#  ", "#  ", "#  ", "#  ", "###"],
    "M": ["# #", "###", "###", "# #", "# #"],
    "N": ["# #", "###", "###", "###", "# #"],
    "O": ["###", "# #", "# #", "# #", "###"],
    "P": ["###", "# #", "###", "#  ", "#  "],
    "Q": ["###", "# #", "# #", "###", "  #"],
    "R": ["###", "# #", "## ", "## ", "# #"],
    "S": ["###", "#  ", "###", "  #", "###"],
    "T": ["###", " # ", " # ", " # ", " # "],
    "U": ["# #", "# #", "# #", "# #", "###"],
    "V": ["# #", "# #", "# #", "# #", " # "],
    "W": ["# #", "# #", "###", "###", "# #"],
    "X": ["# #", "# #", " # ", "# #", "# #"],
    "Y": ["# #", "# #", " # ", " # ", " # "],
    "Z": ["###", "  #", " # ", "#  ", "###"],
    ".": ["   ", "   ", "   ", "   ", " # "],
    ",": ["   ", "   ", "   ", " # ", "#  "],
    ":": ["   ", " # ", "   ", " # ", "   "],
    "-": ["   ", "   ", "###", "   ", "   "],
    "+": ["   ", " # ", "###", " # ", "   "],
    "/": ["  #", "  #", " # ", "#  ", "#  "],
    "|": [" # ", " # ", " # ", " # ", " # "],
    "=": ["   ", "###", "   ", "###", "   "],
    "%": ["# #", "  #", " # ", "#  ", "# #"],
    "(": [" # ", "#  ", "#  ", "#  ", " # "],
    ")": [" # ", "  #", "  #", "  #", " # "],
    " ": ["   ", "   ", "   ", "   ", "   "],
}

GLYPH_W, GLYPH_H = 3, 5


def render_text_mask(text: str, scale: int = 2) -> np.ndarray:
    """Boolean mask (h, w) of the rendered text."""
    text = text.upper()
    rows = GLYPH_H
    cols = sum(GLYPH_W + 1 for _ in text)
    mask = np.zeros((rows, cols), dtype=bool)
    x = 0
    for ch in text:
        glyph = _GLYPHS.get(ch, _GLYPHS[" "])
        for r, line in enumerate(glyph):
            for c, px in enumerate(line):
                if px == "#":
                    mask[r, x + c] = True
        x += GLYPH_W + 1
    if scale > 1:
        mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
    return mask


def draw_hud(frame: np.ndarray, lines, *, color=(255, 255, 255), scale: int = 2,
             margin: int = 4) -> np.ndarray:
    """Stamp HUD text lines onto an (H, W, 3) uint8 frame (in place)."""
    y = margin
    h, w = frame.shape[:2]
    for line in lines:
        mask = render_text_mask(str(line), scale=scale)
        mh, mw = mask.shape
        if y + mh > h:
            break
        mw = min(mw, w - margin)
        region = frame[y : y + mh, margin : margin + mw]
        region[mask[:, :mw]] = color
        y += mh + scale * 2
    return frame


def hud_lines(compute, device_name: str, show_interactions: bool = False):
    """The reference's HUD content: device, body count, perf line
    (interface.cpp:44-55)."""
    if show_interactions:
        perf = f"{compute.interactions_per_second:.2f} B interactions/s"
    else:
        perf = f"{compute.g_flops:.1f} GFLOP/s"
    precision = {"fp64": "FP64", "ds": "DS64", "fp32": "FP32"}[
        getattr(compute, "precision", "fp64" if compute.fp64_enabled
                else "fp32")]
    return [
        device_name,
        f"{compute.num_bodies} bodies ({precision})",
        f"{compute.fps:.1f} FPS | {perf}",
    ]
