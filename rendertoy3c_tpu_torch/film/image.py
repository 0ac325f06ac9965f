"""Image output and input (sutil::saveImage / sutil::loadImage,
sutil/sutil.cpp:542-709 and :271-378).

Port of `write_png`, `write_ppm`, `write_exr` and `read_png` (here
`read_image`, since it reads more than PNG) of
rendertoy3c_tpu/film/image.py: PNG through stdlib zlib with no row filter,
binary P6 PPM, and uncompressed float32 scanline OpenEXR, byte for byte the
reference's files; and of its `read_ppm`, `read_exr` (uncompressed
scanline HALF and FLOAT channels) and `load_image`, which picks the reader
by extension. Other input goes through PIL when it imports, else through
stdlib decoders of what a texture is likely to be (`read_image_stdlib`;
`decode_image_bytes` for an image already in memory, inside a .glb or a
data URI), so textures load on a machine without Pillow and decode to the
array PIL's `convert("RGBA")` gives:

  * PNG: grey, grey+alpha, RGB, RGBA and palette images at every bit depth
    PNG allows, non-interlaced or Adam7-interlaced. 16-bit samples keep
    their high byte (PIL's ";16B" raw modes), except 16-bit grey, which
    PIL opens as "I;16" and converts by clipping to 255; 1-, 2- and 4-bit
    grey scale to 0-255 as PIL's "1", "L;2" and "L;4" do. The tRNS chunk is
    not applied (PIL applies it to the alpha channel, which no kernel
    reads).
  * TGA: uncompressed or RLE; true colour (24- and 32-bit), 8-bit grey,
    16-bit grey + alpha, and 8-bit colour-mapped with a 24- or 32-bit map;
    any origin corner.
  * BMP: BI_RGB at 24 and 32 bits (the fourth byte is not alpha, as PIL
    reads it) and 8-bit palette images, bottom-up or top-down.

Anything else raises ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------- output
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


def write_ppm(path: str, rgb_u8: np.ndarray) -> None:
    """Binary P6 PPM (the format sutil's PPMLoader handles). rgb_u8:
    [H, W, >=3] uint8; channels past the third are dropped."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] < 3:
        raise ValueError("write_ppm expects a [H, W, >=3] uint8 array")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img[..., :3]).tobytes())


_EXR_MAGIC = 20000630
_PIXEL_FLOAT = 2  # the FLOAT pixel type


def _exr_attr(name: bytes, type_: bytes, payload: bytes) -> bytes:
    return (name + b"\x00" + type_ + b"\x00" + struct.pack("<I", len(payload))
            + payload)


def write_exr(path: str, rgb_f32: np.ndarray) -> None:
    """Write an uncompressed float32 RGB(A) scanline OpenEXR (version 2).
    rgb_f32: [H, W, 3|4]; row 0 is the top scanline."""
    img = np.asarray(rgb_f32, dtype=np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("write_exr expects a [H, W, 3|4] array")
    h, w, nc = img.shape
    names = [b"R", b"G", b"B"] + ([b"A"] if nc == 4 else [])
    order = sorted(range(nc), key=lambda k: names[k])  # A, B, G, R
    chlist = b"".join(names[k] + b"\x00" + struct.pack("<iiii", _PIXEL_FLOAT,
                                                       0, 1, 1)
                      for k in order) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_exr_attr(b"channels", b"chlist", chlist)
              + _exr_attr(b"compression", b"compression", b"\x00")
              + _exr_attr(b"dataWindow", b"box2i", box)
              + _exr_attr(b"displayWindow", b"box2i", box)
              + _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
              + _exr_attr(b"pixelAspectRatio", b"float",
                          struct.pack("<f", 1.0))
              + _exr_attr(b"screenWindowCenter", b"v2f",
                          struct.pack("<ff", 0.0, 0.0))
              + _exr_attr(b"screenWindowWidth", b"float",
                          struct.pack("<f", 1.0))
              + b"\x00")
    preamble = struct.pack("<iI", _EXR_MAGIC, 2)
    first_chunk = len(preamble) + len(header) + 8 * h
    chunk_size = 8 + 4 * w * nc  # (y, data size) + the channels' rows
    offsets = struct.pack("<" + "Q" * h, *[first_chunk + y * chunk_size
                                           for y in range(h)])
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, 4 * w * nc))
            for k in order:
                f.write(img[y, :, k].tobytes())


# ---------------------------------------------------------------- input
def read_ppm(path: str) -> np.ndarray:
    """Read a binary P6 PPM of maxval 255 (comments allowed in the
    header) to [H, W, 3] uint8 (image.py:51-73)."""
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        if j == i:
            raise ValueError(f"{path}: truncated PPM header")
        tokens.append(data[i:j])
        i = j
    i += 1  # the single whitespace after maxval
    if tokens[0] != b"P6" or tokens[3] != b"255":
        raise ValueError(f"{path}: only binary P6 PPMs of maxval 255 are "
                         "read")
    w, h = int(tokens[1]), int(tokens[2])
    return np.frombuffer(data, np.uint8, count=w * h * 3,
                         offset=i).reshape(h, w, 3)


_EXR_BYTES = {1: 2, 2: 4}  # HALF, FLOAT


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed scanline OpenEXR of HALF and FLOAT channels
    (write_exr's files and their like) to [H, W, C] float32, the channels
    R, G, B, A first where present, then the others in the file's order
    (image.py:224-283). Each chunk is found through the offset table."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<iI", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    pos = 8
    channels = []  # (name, pixel type)
    compression, box = 0, None
    while data[pos] != 0:
        zn = data.index(b"\x00", pos)
        name = data[pos:zn].decode()
        zt = data.index(b"\x00", zn + 1)
        (ln,) = struct.unpack_from("<I", data, zt + 1)
        payload = data[zt + 5:zt + 5 + ln]
        pos = zt + 5 + ln
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cz = payload.index(b"\x00", cp)
                ptype, _, xs, ys = struct.unpack_from("<iiii", payload,
                                                      cz + 1)
                if ptype not in _EXR_BYTES or (xs, ys) != (1, 1):
                    raise ValueError(f"{path}: channel of pixel type "
                                     f"{ptype}, sampling {xs}x{ys}; only "
                                     "unsampled HALF and FLOAT are read")
                channels.append((payload[cp:cz].decode(), ptype))
                cp = cz + 17
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            box = struct.unpack("<iiii", payload)
    if compression != 0 or box is None:
        raise ValueError(f"{path}: only uncompressed scanline EXRs are read")
    x0, y0, x1, y1 = box
    w, h = x1 - x0 + 1, y1 - y0 + 1
    offsets = struct.unpack_from("<" + "Q" * h, data, pos + 1)
    out = {name: np.empty((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, _size = struct.unpack_from("<ii", data, off)
        p = off + 8
        for name, ptype in channels:
            n = w * _EXR_BYTES[ptype]
            row = np.frombuffer(data, np.float32 if ptype == 2
                                else np.float16, count=w, offset=p)
            out[name][y - y0] = row
            p += n
    order = [c for c in ("R", "G", "B", "A") if c in out]
    order += [c for c, _ in channels if c not in order]
    return np.stack([out[c] for c in order], axis=-1)


def load_image(path: str) -> np.ndarray:
    """An image by its extension (sutil::loadImage's dispatch,
    image.py:286-293): .exr through read_exr ([H, W, C] float32), .ppm
    through read_ppm ([H, W, 3] uint8), anything else through read_image
    ([H, W, 4] uint8 RGBA)."""
    p = path.lower()
    if p.endswith(".exr"):
        return read_exr(path)
    if p.endswith(".ppm"):
        return read_ppm(path)
    return read_image(path)


def read_image(path: str) -> np.ndarray:
    """Read an image to [H, W, 4] uint8 RGBA, row 0 at the top: PIL when it
    imports, else `read_image_stdlib`."""
    try:
        from PIL import Image
    except ImportError:
        return read_image_stdlib(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def read_image_stdlib(path: str) -> np.ndarray:
    """Decode a PNG, BMP (by their signatures) or TGA (by its extension,
    TGA has no signature) with the stdlib alone to [H, W, 4] uint8 RGBA.
    Raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_bytes(data, path)


def decode_image_bytes(data: bytes, name: str, tga: bool | None = None):
    """`read_image_stdlib` on bytes already read (an image inside a GLB or
    a data URI): PNG and BMP by their signatures, TGA where `tga` is true
    or, with tga None, where `name` ends in .tga or .tpic. `name` names
    the image in errors. Raises ValueError on anything else."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _decode_png(data, name)
    if data[:2] == b"BM":
        return _decode_bmp(data, name)
    if tga or (tga is None and name.lower().endswith((".tga", ".tpic"))):
        return _decode_tga(data, name)
    raise ValueError(f"{name}: no stdlib decoder for this image format")


def _rgba(img: np.ndarray) -> np.ndarray:
    """[H, W, 1|2|3|4] uint8 -> [H, W, 4]: grey spread to rgb, opaque
    alpha added where there is none."""
    h, w, c = img.shape
    if c in (1, 2):
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1),
                              img[..., 1:]], axis=-1)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)],
                             axis=-1)
    return np.ascontiguousarray(img)


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, pos: int, rows: int, stride: int, bpp: int):
    """Undo the PNG row filters of `rows` scanlines of `stride` bytes (bpp:
    bytes per complete pixel, at least 1) starting at raw[pos]. Returns
    ([rows, stride] uint8, the position after them)."""
    out = np.empty((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        filt = raw[pos]
        row = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if filt == 1:  # Sub: a running sum per byte of the pixel, mod 256
            for j in range(min(bpp, stride)):
                row[j::bpp] = np.cumsum(row[j::bpp], dtype=np.uint64) & 0xFF
        elif filt == 2:  # Up
            row = row + prev  # uint8 arithmetic wraps mod 256
        elif filt == 3:  # Average
            for x in range(stride):
                left = int(row[x - bpp]) if x >= bpp else 0
                row[x] = (int(row[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
        elif filt != 0:
            raise ValueError(f"PNG row filter {filt}")
        out[y] = row
        prev = row
    return out, pos


def _png_samples(rows: np.ndarray, width: int, nchan: int, depth: int):
    """Unfiltered scanlines [H, stride] -> samples [H, width, nchan]
    (uint16 for 16-bit images, else uint8 values of `depth` bits)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        s = rows
    else:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        s = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return s[:, :width * nchan].reshape(h, width, nchan)


def _decode_png(data: bytes, path: str) -> np.ndarray:
    pos = 8
    idat = []
    hdr = None
    palette = None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + ln]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + ln
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if (depth not in _PNG_DEPTHS.get(color, ()) or interlace not in (0, 1)
            or (color == 3 and palette is None)):
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    nchan = _PNG_CHANNELS[color]
    bpp = max(1, nchan * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        rows, _ = _unfilter(raw, 0, h, (w * nchan * depth + 7) // 8, bpp)
        samples = _png_samples(rows, w, nchan, depth)
    else:
        samples = np.zeros((h, w, nchan),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            rows, pos = _unfilter(raw, pos, ph, (pw * nchan * depth + 7) // 8,
                                  bpp)
            samples[y0::dy, x0::dx] = _png_samples(rows, pw, nchan, depth)
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        return _rgba(pal[samples[..., 0]])
    if depth == 16:
        # PIL: the high byte, but 16-bit grey ("I;16") clipped to 255
        samples = (np.minimum(samples, 255) if color == 0
                   else samples >> 8).astype(np.uint8)
    elif depth < 8:  # grey below 8 bits, scaled to 0-255 as PIL does
        samples = (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return _rgba(samples)


def _decode_tga(data: bytes, path: str) -> np.ndarray:
    if len(data) < 18:
        raise ValueError(f"{path}: truncated TGA")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_start, cmap_len, cmap_depth = struct.unpack_from("<HHB", data, 3)
    w, h, depth, flags = struct.unpack_from("<HHBB", data, 12)
    kind = itype & 7
    ok = (cmap_type in (0, 1) and w > 0 and h > 0 and itype in (1, 2, 3, 9,
                                                                10, 11)
          and ((kind == 2 and depth in (24, 32))
               or (kind == 3 and depth in (8, 16))
               or (kind == 1 and depth == 8))
          and (not cmap_type or cmap_depth in (24, 32)))
    if not ok:
        raise ValueError(f"{path}: unsupported TGA (type {itype}, depth "
                         f"{depth}, colour map {cmap_type}/{cmap_depth})")
    pos = 18 + id_len
    palette = None
    if cmap_type:
        nb = cmap_depth // 8
        entries = np.frombuffer(data, np.uint8, cmap_len * nb, pos).reshape(
            -1, nb)
        pos += cmap_len * nb
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        end = min(256, cmap_start + cmap_len)
        palette[cmap_start:end, :3] = entries[:end - cmap_start, 2::-1]
        if nb == 4:
            palette[cmap_start:end, 3] = entries[:end - cmap_start, 3]
    nb = depth // 8
    n = w * h * nb
    if itype & 8:  # RLE packets: a count byte, then 1 or count pixels
        out = bytearray()
        while len(out) < n:
            if pos >= len(data):
                raise ValueError(f"{path}: truncated TGA RLE data")
            c = data[pos]
            pos += 1
            count = (c & 0x7F) + 1
            if c & 0x80:
                out += data[pos:pos + nb] * count
                pos += nb
            else:
                out += data[pos:pos + nb * count]
                pos += nb * count
        pix = np.frombuffer(bytes(out[:n]), np.uint8)
    else:
        if pos + n > len(data):
            raise ValueError(f"{path}: truncated TGA")
        pix = np.frombuffer(data, np.uint8, n, pos)
    pix = pix.reshape(h, w, nb)
    if not flags & 0x20:  # bottom-left origin: the first row is the bottom
        pix = pix[::-1]
    if flags & 0x10:  # right-to-left
        pix = pix[:, ::-1]
    if kind == 2:  # BGR(A)
        return _rgba(np.concatenate([pix[..., 2::-1], pix[..., 3:]], axis=-1))
    if kind == 1 and palette is not None:
        return np.ascontiguousarray(palette[pix[..., 0]])
    return _rgba(pix)  # grey (a colour-mapped type without a map reads so)


def _decode_bmp(data: bytes, path: str) -> np.ndarray:
    if len(data) < 54:
        raise ValueError(f"{path}: truncated BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    hsize, w, h, planes, bits, comp = struct.unpack_from("<IiiHHI", data, 14)
    if hsize < 40 or w <= 0 or h == 0 or comp != 0 or bits not in (8, 24,
                                                                   32):
        raise ValueError(f"{path}: unsupported BMP (header {hsize}, "
                         f"{bits} bits, compression {comp})")
    top_down = h < 0
    h = abs(h)
    stride = (w * bits // 8 + 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError(f"{path}: truncated BMP")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        (n_col,) = struct.unpack_from("<I", data, 46)
        n_col = n_col or 256
        entries = np.frombuffer(data, np.uint8, 4 * n_col, 14 + hsize)
        palette = np.zeros((256, 3), np.uint8)
        palette[:n_col] = entries.reshape(-1, 4)[:256, 2::-1]
        return _rgba(palette[rows[:, :w]])
    nb = bits // 8
    pix = rows[:, :w * nb].reshape(h, w, nb)
    return _rgba(pix[..., 2::-1])  # BGR, and BGRX: the 4th byte is not alpha
