"""Minimal dependency-free AVI (RIFF) video writer.

Closes the ROADMAP "MP4 export" item within this image's constraints:
ffmpeg is absent and a pure-Python H.264/MPEG encoder is out of scope,
but an *uncompressed* DIB ('DIB '/BI_RGB) AVI is a pure-struct
container every player (VLC, ffplay, QuickTime, browsers via
conversion) opens. Frames are stored bottom-up BGR with 4-byte row
alignment, one '00db' chunk each, plus the idx1 index old players
expect. stdlib + numpy only.

The APNG writer (io/apng.py) remains the lossless-and-small default;
AVI is for toolchains that want a video container (reference analogue:
the GL window's live animation, interface.cpp — the reference never
exports video at all).
"""

from __future__ import annotations

import struct

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _dib(frame: np.ndarray, stride: int) -> bytes:
    """(H, W, 3) RGB -> bottom-up BGR rows padded to `stride` bytes."""
    h, w = frame.shape[:2]
    bgr = frame[::-1, :, ::-1]  # bottom-up, RGB->BGR
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    return rows.tobytes()


def write_avi(frames, path, *, fps: int = 30) -> None:
    """Write a list/iterable of (H, W, 3) uint8 frames as an
    uncompressed AVI."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    if frames[0].ndim != 3 or frames[0].shape[2] != 3:
        raise ValueError(
            f"frames must be (H, W, 3) RGB; got shape {frames[0].shape}")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != frames[0].shape or f.dtype != np.uint8:
            raise ValueError("all frames must be identical-shape uint8")
    stride = (w * 3 + 3) & ~3
    frame_bytes = stride * h
    n = len(frames)

    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        1_000_000 // fps,        # microseconds per frame
        frame_bytes * fps,       # max bytes per second
        0,                       # padding granularity
        _AVIF_HASINDEX,
        n,                       # total frames
        0,                       # initial frames
        1,                       # streams
        frame_bytes,             # suggested buffer size
        w, h,
        0, 0, 0, 0,              # reserved
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIIi4H",
        b"vids", b"DIB ",
        0, 0, 0,                 # flags, priority, language
        0,                       # initial frames
        1, fps,                  # scale, rate -> fps frames/s
        0, n,                    # start, length (in frames)
        frame_bytes,             # suggested buffer size
        0xFFFFFFFF,              # quality (default)
        0,                       # sample size (0 = varies)
        0, 0, w, h,              # destination rectangle
    )
    strf = struct.pack(
        "<IiiHHIIiiII",
        40, w, h,                # BITMAPINFOHEADER: size, width, height
        1, 24,                   # planes, bits per pixel
        0,                       # BI_RGB (uncompressed)
        frame_bytes,
        0, 0, 0, 0,              # pels-per-meter, color table
    )

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload \
            + (b"\x00" if len(payload) % 2 else b"")

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

    # every size is known up front (fixed frame_bytes, even -> no chunk
    # pad bytes), so frames stream straight to the file — no whole-video
    # buffer — and the 32-bit RIFF limit is enforced BEFORE writing
    movi_payload_len = 4 + n * (8 + frame_bytes)   # 'movi' + 00db chunks
    idx_len = 16 * n
    body_len = 4 + len(hdrl) + (8 + movi_payload_len) + (8 + idx_len)
    if body_len > 0xFFFFFFFF:
        raise ValueError(
            f"video too large for the AVI 1.0 32-bit container: "
            f"{n} frames x {frame_bytes} B = {body_len / 2**30:.1f} GiB "
            f"(limit 4 GiB) — lower the resolution, write fewer frames, "
            f"or use the APNG writer")

    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", body_len) + b"AVI ")
        fh.write(hdrl)
        fh.write(b"LIST" + struct.pack("<I", movi_payload_len) + b"movi")
        for f in frames:
            fh.write(b"00db" + struct.pack("<I", frame_bytes))
            fh.write(_dib(f, stride))
        # idx1 offsets are relative to the first byte after the 'movi'
        # kind fourcc; chunks are laid out back to back
        fh.write(b"idx1" + struct.pack("<I", idx_len))
        for i in range(n):
            fh.write(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME,
                                 4 + i * (8 + frame_bytes), frame_bytes))


def read_avi(path):
    """Minimal reader for round-trip tests: returns (frames, fps) with
    frames a list of (H, W, 3) uint8 RGB arrays. Parses only the
    containers this writer emits."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    # main header: first 'avih' chunk
    i = data.index(b"avih")
    (usec, _, _, _, n, _, _, _, w, h) = struct.unpack_from("<10I", data, i + 8)
    fps = round(1_000_000 / usec)
    stride = (w * 3 + 3) & ~3
    frames = []
    pos = data.index(b"movi") + 4
    for _ in range(n):
        assert data[pos:pos + 4] == b"00db", "unexpected chunk"
        size = struct.unpack_from("<I", data, pos + 4)[0]
        raw = np.frombuffer(data, np.uint8, count=size, offset=pos + 8)
        rows = raw.reshape(h, stride)[:, : w * 3].reshape(h, w, 3)
        frames.append(rows[::-1, :, ::-1].copy())  # top-down, BGR->RGB
        pos += 8 + size + (size % 2)
    return frames, fps
