"""Dependency-free PNG codec — port of ``tpurt.render.png``.

``write_png`` encodes RGB8 through the native host library
(``utils.native``) when it loads, else through zlib here (the same
pixels either way); ``read_png``/``decode_png`` read 8-bit gray, RGB and
RGBA with filters 0–4 (goldens, and the loaders' texture images), and
``srgb_to_linear`` converts a texture to the linear space it is stored in
on the device.
"""

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
    from tpurt_torch.utils import native

    if native.png_write(path, img):
        return
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



def read_png(path: str) -> np.ndarray:
    """Read a PNG file as (H, W, 3) uint8 (alpha dropped, gray
    broadcast)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, w * bpp), np.int32)
    for y in range(h):
        filt = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y > 0 else np.zeros(w * bpp, np.int32)
        if filt == 0:
            out[y] = line
        elif filt == 1:
            cur = line.copy()
            for x in range(bpp, w * bpp):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
            out[y] = cur
        elif filt == 2:
            out[y] = (line + prev) & 0xFF
        elif filt == 3:
            cur = line.copy()
            for x in range(w * bpp):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
            out[y] = cur
        elif filt == 4:
            cur = line.copy()
            for x in range(w * bpp):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else c)
                cur[x] = (cur[x] + pred) & 0xFF
            out[y] = cur
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
    return out


def decode_png(data: bytes, keep_alpha: bool = False) -> np.ndarray:
    """Decode PNG bytes to (H, W, 3) uint8; ``keep_alpha`` returns
    (H, W, 4) for an RGBA source (alpha-cutout textures). 8-bit gray, RGB
    and RGBA, not interlaced."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG stream")
    pos = 8
    idat = b""
    w = h = color = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color, _comp, _filt, interlace = struct.unpack_from(
                ">IIBBBBB", payload)
            if depth != 8 or color not in (0, 2, 6) or interlace != 0:
                raise ValueError(
                    "only 8-bit, non-interlaced gray/RGB/RGBA PNGs are "
                    f"supported (depth {depth}, color type {color}, "
                    f"interlace {interlace})")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    bpp = {0: 1, 2: 3, 6: 4}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, bpp * w + 1)
    img = _unfilter(raw, h, w, bpp).astype(np.uint8).reshape(h, w, bpp)
    if bpp == 1:
        img = np.repeat(img, 3, axis=2)
    elif bpp == 4 and not keep_alpha:
        img = img[:, :, :3]
    return np.ascontiguousarray(img)


def srgb_to_linear(img_u8: np.ndarray) -> np.ndarray:
    """sRGB-encoded uint8 image to linear float32 (the exact IEC 61966-2-1
    transfer function, in float32 as the reference computes it)."""
    c = img_u8.astype(np.float32) / 255.0
    return np.where(
        c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)
