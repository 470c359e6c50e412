"""Live terminal viewer: the real-time graphical session, display-server-free.

The reference's default mode is a live OpenGL window (GLUT event loop
with continuous redisplay, the reference's src/nbody/graphics_loop.cpp:
104-121). A remote-attached accelerator has no display server, but every
terminal this framework is driven from can show 24-bit color: this
module renders each simulation frame INTO THE TERMINAL using the
classic half-block technique — one character cell shows two vertical
pixels via '▀' with the top pixel as foreground and the bottom as
background color — giving a live ~interactive view over plain SSH with
zero display dependencies.

The device-side rasterizer stays unchanged (frames come from
render.rasterizer at terminal resolution, which is tiny — ~100×60
cells = 100×120 pixels — so frame compute is microseconds-scale next
to the simulation step); this module only owns the terminal protocol:
alternate screen buffer, cursor home instead of clear (flicker-free),
cursor hide/show, and run-length elision of repeated colors to keep
the per-frame byte volume small.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np

_ENTER = "\x1b[?1049h\x1b[?25l"   # alternate screen + hide cursor
_EXIT = "\x1b[?1049l\x1b[?25h"    # restore screen + show cursor
_HOME = "\x1b[H"
_RESET = "\x1b[0m"


def terminal_cell_size(margin_rows: int = 2) -> tuple[int, int]:
    """(cols, rows) of drawable character cells (rows minus a status
    margin), from the attached terminal, with a sane headless default."""
    size = shutil.get_terminal_size(fallback=(100, 40))
    cols = max(20, size.columns)
    rows = max(10, size.lines - margin_rows)
    return cols, rows


def frame_to_ansi(frame: np.ndarray) -> str:
    """(2R, C, 3) uint8 -> R rows of half-block cells ('▀', fg=top px,
    bg=bottom px) in 24-bit ANSI color. Odd-height frames drop the last
    pixel row. Repeated colors are elided (the dominant cost of a
    terminal frame is escape-sequence bytes, not the characters)."""
    frame = np.asarray(frame)
    if frame.ndim != 3 or frame.shape[2] != 3 or frame.dtype != np.uint8:
        raise ValueError(
            f"expected (H, W, 3) uint8, got {frame.shape} {frame.dtype}")
    h = frame.shape[0] - (frame.shape[0] % 2)
    top = frame[0:h:2]
    bot = frame[1:h:2]
    out = []
    for r in range(top.shape[0]):
        prev_fg = prev_bg = None
        row = []
        for c in range(top.shape[1]):
            fg = tuple(int(v) for v in top[r, c])
            bg = tuple(int(v) for v in bot[r, c])
            esc = ""
            if fg != prev_fg:
                esc += f"\x1b[38;2;{fg[0]};{fg[1]};{fg[2]}m"
                prev_fg = fg
            if bg != prev_bg:
                esc += f"\x1b[48;2;{bg[0]};{bg[1]};{bg[2]}m"
                prev_bg = bg
            row.append(esc + "▀")
        out.append("".join(row) + _RESET)
    return "\n".join(out)


class TerminalViewer:
    """Owns the terminal session: enter the alternate screen on first
    show(), repaint in place (cursor home, no clear — flicker-free),
    restore the terminal on close(). Writes to ``stream`` (stdout)."""

    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stdout
        self._active = False

    def show(self, frame: np.ndarray, status: str = "") -> None:
        body = frame_to_ansi(frame)
        if not self._active:
            self.stream.write(_ENTER)
            self._active = True
        self.stream.write(_HOME + body)
        if status:
            # multi-line statuses (e.g. the interactive param panel) are
            # painted as discrete erased lines under the frame
            for line in status.split("\n"):
                self.stream.write("\n" + _RESET + line + "\x1b[K")
        # erase below: clears shrunken statuses and any stray writes, so
        # a raw print cannot accumulate garbage in the alternate screen
        self.stream.write(_RESET + "\x1b[0J")
        self.stream.flush()

    def close(self) -> None:
        if self._active:
            self.stream.write(_RESET + _EXIT)
            self.stream.flush()
            self._active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
