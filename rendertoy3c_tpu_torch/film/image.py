"""PNG output (sutil::saveImage, sutil/sutil.cpp:542-709).

Port of `write_png` of rendertoy3c_tpu/film/image.py: stdlib zlib, no row
filter, so a frame needs no extra dependency and the bytes match.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write an 8-bit RGB/RGBA PNG. rgb_u8: [H, W, 3|4] uint8."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("write_png expects a [H, W, 3|4] uint8 array")
    h, w, c = img.shape
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                           0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)
