"""Dependency-free PNG writer — port of ``tpurt.render.png.write_png``
(the zlib path; the native C++ encoder and the PNG reader the loaders use
are not ported yet, ROADMAP §1 item 12)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file."""
    img = np.ascontiguousarray(image_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    # filter byte 0 (None) per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)
    data = zlib.compress(raw.tobytes(), 6)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", data))
        f.write(_chunk(b"IEND", b""))

