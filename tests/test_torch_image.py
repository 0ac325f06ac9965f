"""The port's image codecs (film/image.py) and the CLI's output by
extension.

Decoders: with the stdlib alone, every PNG layout (grey at 1, 2, 4, 8 and
16 bits, grey+alpha, RGB and RGBA at 8 and 16 bits, palette at 1-8 bits;
each non-interlaced and Adam7-interlaced, the rows under all five filter
types), TGA (grey, RGB, RGBA and colour-mapped, raw and RLE, bottom-up and
top-down) and BMP (24- and 32-bit BI_RGB, 8-bit palette and grey,
bottom-up and top-down) decode to the array PIL's `convert("RGBA")` gives,
exactly. PIL writes the TGA and BMP files; the PNGs come from a small
encoder here, since PIL writes neither interlaced nor 16-bit colour PNGs,
and PIL decodes them as the oracle. 16-bit grey follows PIL's rule
(clipped to 255, not shifted) and is tested on values both sides of 255.

The .obj loader with PIL hidden: an .mtl naming a .tga, a .bmp, a 16-bit
and an interlaced PNG loads 4 textures with the arrays PIL decodes; a
.jpg gets texture id -1 and a warning that names it; a missing file -1
without one.

Writers: write_ppm and write_exr give the reference writers' bytes for the
same arrays; the CLI's -o out.exr and -o out.ppm write the bytes the
reference writers give for the film it rendered (the linear accum flipped
to top-first for EXR; for PPM its make_color), and -o out.png a PNG.
"""
import io
import os
import struct
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch

from rendertoy3c_tpu.film import image as j_image
from rendertoy3c_tpu_torch.film import image
from torch_port_util import cornell_pair  # noqa: F401 (sets the threads)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _pil_rgba(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


# ---------------------------------------------------------------- PNG
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(samples, depth):
    """[H, W, C] integer samples -> [H, stride] uint8 scanlines."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    pad = np.zeros((h, -(-n // per) * per), np.uint16)
    pad[:, :n] = flat
    pad = pad.reshape(h, -1, per)
    shifts = 8 - depth * (1 + np.arange(per))
    return (pad << shifts).sum(axis=2).astype(np.uint8)


def _filter_rows(rows, bpp, first_filter):
    """Filter each scanline with types cycling from first_filter."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        ftype = (first_filter + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 1:
            f = row - left
        elif ftype == 2:
            f = row - prev
        elif ftype == 3:
            f = row - (left + prev) // 2
        elif ftype == 4:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            f = row - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, ul))
        else:
            f = row
        out.append(bytes([ftype]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _write_png(path, samples, depth, color, interlace, palette=None):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(
            _filter_rows(_pack_rows(samples[y0::dy, x0::dx], depth), bpp, k)
            for k, (x0, y0, dx, dy) in enumerate(_ADAM7)
            if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, 0)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


PNG_LAYOUTS = [(d, 0) for d in (1, 2, 4, 8, 16)] + [
    (8, 2), (16, 2), (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
    (16, 6)]


@pytest.mark.parametrize("interlace", [False, True],
                         ids=["plain", "adam7"])
@pytest.mark.parametrize("depth, color", PNG_LAYOUTS)
def test_png_stdlib_decoder_equals_pil(tmp_path, depth, color, interlace):
    rng = np.random.default_rng(depth * 10 + color)
    nchan = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    h, w = 13, 11  # every Adam7 pass non-empty, odd row lengths
    samples = rng.integers(0, 1 << depth, (h, w, nchan))
    if depth == 16 and color == 0:  # both sides of PIL's clip at 255
        samples[::2] = rng.integers(0, 256, samples[::2].shape)
    palette = (rng.integers(0, 256, (1 << depth, 3)) if color == 3 else None)
    path = str(tmp_path / "t.png")
    _write_png(path, samples, depth, color, interlace, palette)
    got = image.read_image_stdlib(path)
    assert got.shape == (h, w, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgba(path))


# ---------------------------------------------------------------- TGA/BMP
def _pil_image(mode, rng, h=7, w=9):
    if mode == "P":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)
                               ).convert("P")
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, c), np.uint8)
    return Image.fromarray(arr[..., 0] if c == 1 else arr, mode)


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_tga_stdlib_decoder_equals_pil(tmp_path, mode, rle):
    im = _pil_image(mode, np.random.default_rng(3))
    path = str(tmp_path / "t.tga")
    im.save(path, compression="tga_rle" if rle else None)
    np.testing.assert_array_equal(image.read_image_stdlib(path),
                                  _pil_rgba(path))


def test_tga_top_down_and_runs(tmp_path):
    """A top-left-origin RLE file with runs that cross rows."""
    rng = np.random.default_rng(4)
    h, w = 5, 6
    px = np.repeat(rng.integers(0, 256, (h * w // 3, 1, 3), np.uint8), 3,
                   axis=1).reshape(h, w, 3)
    data = bytearray(struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0,
                                 w, h, 24, 0x20))
    flat = px[..., ::-1].reshape(-1, 3)  # BGR, first row at the top
    for k in range(0, len(flat), 3):
        data += bytes([0x80 | 2]) + flat[k].tobytes()
    path = str(tmp_path / "td.tga")
    with open(path, "wb") as f:
        f.write(bytes(data))
    got = image.read_image_stdlib(path)
    np.testing.assert_array_equal(got, _pil_rgba(path))
    np.testing.assert_array_equal(got[..., :3], px)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L"])
def test_bmp_stdlib_decoder_equals_pil(tmp_path, mode):
    im = _pil_image(mode, np.random.default_rng(5))
    path = str(tmp_path / "t.bmp")
    im.save(path)
    np.testing.assert_array_equal(image.read_image_stdlib(path),
                                  _pil_rgba(path))


def test_bmp_top_down(tmp_path):
    """A negative height: the first row in the file is the top."""
    im = _pil_image("RGB", np.random.default_rng(6))
    buf = io.BytesIO()
    im.save(buf, format="BMP")
    data = bytearray(buf.getvalue())
    w, h = struct.unpack_from("<ii", data, 18)
    stride = (w * 3 + 3) & ~3
    off = struct.unpack_from("<I", data, 10)[0]
    rows = [bytes(data[off + y * stride: off + (y + 1) * stride])
            for y in range(h)]
    data[off:off + h * stride] = b"".join(rows[::-1])
    struct.pack_into("<i", data, 22, -h)
    path = str(tmp_path / "td.bmp")
    with open(path, "wb") as f:
        f.write(bytes(data))
    np.testing.assert_array_equal(image.read_image_stdlib(path),
                                  _pil_rgba(str(tmp_path / "td.bmp")))
    np.testing.assert_array_equal(image.read_image_stdlib(path)[..., :3],
                                  np.asarray(im))


def test_undecodable_raises_value_error(tmp_path):
    path = tmp_path / "t.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="t.jpg"):
        image.read_image_stdlib(str(path))


# ---------------------------------------------------------------- loader
def test_obj_textures_load_without_pil(tmp_path, monkeypatch):
    """With PIL hidden, .tga, .bmp, 16-bit and interlaced PNG textures load
    with the arrays PIL decodes (flipped to the loader's bottom-up rows);
    the .jpg gets id -1 with a warning naming it, a missing file -1."""
    from rendertoy3c_tpu_torch.io.obj import load_obj

    rng = np.random.default_rng(8)
    names = ["a.tga", "b.bmp", "c16.png", "d_adam7.png", "e.jpg",
             "missing.png"]
    _pil_image("RGBA", rng, 6, 5).save(tmp_path / "a.tga",
                                       compression="tga_rle")
    _pil_image("RGB", rng, 5, 7).save(tmp_path / "b.bmp")
    _write_png(str(tmp_path / "c16.png"), rng.integers(0, 65536, (4, 6, 3)),
               16, 2, False)
    _write_png(str(tmp_path / "d_adam7.png"), rng.integers(0, 256, (9, 10, 4)),
               8, 6, True)
    _pil_image("RGB", rng).save(tmp_path / "e.jpg")
    want = {n: _pil_rgba(str(tmp_path / n))[::-1] for n in names[:4]}
    mtl = "".join(f"newmtl m{k}\nKd 0.5 0.5 0.5\nmap_Kd {n}\n"
                  for k, n in enumerate(names))
    (tmp_path / "s.mtl").write_text(mtl)
    obj = ["mtllib s.mtl"]
    for k in range(len(names)):
        obj += [f"v {k} 0 0", f"v {k + 1} 0 0", f"v {k} 1 0", "vt 0 0",
                "vt 1 0", "vt 0 1", f"usemtl m{k}",
                f"f {3 * k + 1}/{3 * k + 1} {3 * k + 2}/{3 * k + 2} "
                f"{3 * k + 3}/{3 * k + 3}"]
    (tmp_path / "s.obj").write_text("\n".join(obj) + "\n")
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        meshes, textures = load_obj([str(tmp_path / "s.obj")])
    ids = [m.material.diffuse_texture_id for m in meshes]
    assert ids == [0, 1, 2, 3, -1, -1]
    assert len(textures) == 4
    for tex, n in zip(textures, names[:4]):
        got = getattr(tex, "data", tex)
        np.testing.assert_array_equal(np.asarray(got), want[n], err_msg=n)
    msgs = [str(w.message) for w in caught]
    assert any("e.jpg" in m for m in msgs), msgs
    assert not any("missing.png" in m for m in msgs), msgs


# ---------------------------------------------------------------- writers
def test_writers_match_reference_bytes(tmp_path):
    rng = np.random.default_rng(10)
    u8 = rng.integers(0, 256, (5, 7, 3), np.uint8)
    f32 = rng.normal(size=(5, 7, 3)).astype(np.float32)
    f32a = rng.normal(size=(4, 3, 4)).astype(np.float32)
    for name, ours, theirs, arr in (
            ("a.ppm", image.write_ppm, j_image.write_ppm, u8),
            ("b.exr", image.write_exr, j_image.write_exr, f32),
            ("c.exr", image.write_exr, j_image.write_exr, f32a),
            ("d.png", image.write_png, j_image.write_png, u8)):
        ours(str(tmp_path / ("p_" + name)), arr)
        theirs(str(tmp_path / ("j_" + name)), arr)
        assert ((tmp_path / ("p_" + name)).read_bytes()
                == (tmp_path / ("j_" + name)).read_bytes()), name
    # the reference's PPM reader reads ours back
    np.testing.assert_array_equal(j_image.read_ppm(str(tmp_path / "p_a.ppm")),
                                  u8)


CLI_ARGS = ["--scene", "cornell", "--size", "20x16", "--spp", "1",
            "--subframes", "2", "--max-depth", "3", "--ray-block", "512",
            "--device", "cpu"]


def _cli_film():
    """The film the CLI renders under CLI_ARGS."""
    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, cam = cornell_box()
    cam.aspect_ratio = 20 / 16
    cfg = RenderConfig(width=20, height=16, samples_per_launch=1,
                       max_depth=3, ray_block=512, integrator="pool",
                       pool_pixel_major=True)
    step = make_render_fn(build_scene(meshes), cfg, device="cpu")
    film = film_create(16, 20, device="cpu")
    for _ in range(2):
        film, _ = step(cam.params(), film)
    return film


@pytest.mark.parametrize("ext", [".exr", ".ppm", ".png"])
def test_cli_output_by_extension(tmp_path, ext):
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.film.tonemap import make_color

    out = str(tmp_path / f"out{ext}")
    assert cli.main(CLI_ARGS + ["-o", out]) == 0
    accum = _cli_film().accum.numpy()[::-1]
    ref = str(tmp_path / f"ref{ext}")
    if ext == ".exr":
        j_image.write_exr(ref, np.ascontiguousarray(accum))
    else:
        rgb = make_color(torch.as_tensor(accum.copy()), alpha=False).numpy()
        (j_image.write_ppm if ext == ".ppm" else j_image.write_png)(ref, rgb)
    assert open(out, "rb").read() == open(ref, "rb").read()
    magic = {".exr": struct.pack("<i", 20000630), ".ppm": b"P6\n20 16\n",
             ".png": b"\x89PNG"}[ext]
    assert open(out, "rb").read().startswith(magic)
    assert os.path.getsize(out) > 100
