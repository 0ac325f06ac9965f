"""PNG output and input (sutil::saveImage / sutil::loadImage,
sutil/sutil.cpp:542-709 and :271-378).

Port of `write_png` and `read_png` of rendertoy3c_tpu/film/image.py: stdlib
zlib, no row filter on output, so a frame needs no extra dependency and the
bytes match; input through PIL when it imports, else a stdlib decoder of
non-interlaced 8-bit PNGs, so textures load on a machine without Pillow.
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


def read_png(path: str) -> np.ndarray:
    """Read a PNG to [H, W, 4] uint8 RGBA: PIL when it imports, else
    `read_png_stdlib`."""
    try:
        from PIL import Image
    except ImportError:
        return read_png_stdlib(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def read_png_stdlib(path: str) -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG (grey, grey+alpha, RGB, RGBA or
    palette) to [H, W, 4] uint8 RGBA with zlib alone. Raises ValueError on
    anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = color = None
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if bitdepth != 8 or interlace != 0 or color not in (0, 2, 3, 4,
                                                                6):
                raise ValueError(f"{path}: unsupported PNG")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(idat)
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    stride = w * nchan
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    p = 0
    for y in range(h):
        filt = raw[p]
        row = np.frombuffer(raw, np.uint8, stride, p + 1).copy()
        p += 1 + stride
        if filt == 1:  # Sub
            for x in range(nchan, stride):
                row[x] = (int(row[x]) + int(row[x - nchan])) & 0xFF
        elif filt == 2:  # Up
            row = row + prev  # uint8 arithmetic wraps mod 256
        elif filt == 3:  # Average
            for x in range(stride):
                left = int(row[x - nchan]) if x >= nchan else 0
                row[x] = (int(row[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - nchan]) if x >= nchan else 0
                b = int(prev[x])
                c = int(prev[x - nchan]) if x >= nchan else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
        out[y] = row
        prev = row
    img = out.reshape(h, w, nchan)
    if color == 3:  # palette
        img = palette[img[..., 0]]
        nchan = 3
    if nchan == 1:
        img = np.repeat(img, 3, axis=-1)
        nchan = 3
    if nchan == 2:
        img = np.concatenate(
            [np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
        nchan = 4
    if nchan == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)],
                             axis=-1)
    return img
