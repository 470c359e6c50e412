"""Minimal dependency-free PNG writer (RGB8), stdlib zlib only."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(frame: np.ndarray, path) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG."""
    frame = np.asarray(frame)
    if frame.ndim != 3 or frame.shape[2] != 3 or frame.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) uint8, got {frame.shape} {frame.dtype}")
    h, w = frame.shape[:2]
    # filter byte 0 per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), frame.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(payload)
