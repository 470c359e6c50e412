"""Minimal dependency-free animated-PNG (APNG) writer.

Demo frame sequences become a single lossless animation every browser plays
— the headless stand-in for the reference's live GL window. stdlib only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from nbody_tpu_torch.io.png import _chunk


def _scanlines(frame: np.ndarray) -> bytes:
    h, w = frame.shape[:2]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), frame.reshape(h, w * 3)], axis=1
    )
    return raw.tobytes()


def write_apng(frames, path, *, fps: int = 30, loops: int = 0) -> None:
    """Write a list/iterable of (H, W, 3) uint8 frames as an APNG."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError("all frames must be identical (H, W, 3) uint8")

    delay_num, delay_den = 1, int(fps)
    seq = 0
    out = [b"\x89PNG\r\n\x1a\n"]
    out.append(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
    out.append(_chunk(b"acTL", struct.pack(">II", len(frames), loops)))

    for idx, frame in enumerate(frames):
        fctl = struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0
        )
        out.append(_chunk(b"fcTL", fctl))
        seq += 1
        data = zlib.compress(_scanlines(frame), 6)
        if idx == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1

    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))
