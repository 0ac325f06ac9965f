"""The port's texture path against the reference, piece by piece.

The atlas (data and meta) array-equal to the reference's
`build_texture_atlas` on the town's two PNGs and on odd sizes with mixed
wrap modes, and `build_quad_table` to the reference atlas's quad table;
`sample_texture_bilinear` (four gathers) against the reference's on random
uvs in [-2, 3] for the three wrap modes and texture id -1, through its
quad table and through its four gathers: texel indices exact, rgb within
1e-6;
the stdlib PNG decoder equal to PIL, and the .obj loader's textures equal
to the reference loader's with and without PIL; the textured shade tables
array-equal; the texture gates; and the CLI's textured scenes against the
reference CLI's loader."""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.io.genassets import generate_town as j_generate_town
from rendertoy3c_tpu.io.obj import load_obj as j_load_obj
from rendertoy3c_tpu.scene import texture as jtx
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.pallas_shade import build_shade_tables as j_tables
from rendertoy3c_tpu_torch.film.image import read_image, read_image_stdlib
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.io import obj as tobj
from rendertoy3c_tpu_torch.io.genassets import generate_town
from rendertoy3c_tpu_torch.scene import texture as tx
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import (assert_light_rows_equal, textured_quad_meshes,
                             textured_quad_pair)

CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=256, integrator="pool", pool_pixel_major=True)
MODES = {"repeat": tx.WRAP_REPEAT, "clamp": tx.WRAP_CLAMP,
         "mirror": tx.WRAP_MIRROR}


@pytest.fixture(scope="module")
def town_pngs(tmp_path_factory):
    """The generated town's directory and .obj path."""
    d = tmp_path_factory.mktemp("town")
    paths, _ = generate_town(str(d), faces_target=4000)
    return d, paths[0]


def _odd_images(rng):
    """Three textures of odd sizes with mixed wrap modes, in both
    packages' TextureImage."""
    specs = [((5, 7), tx.WRAP_REPEAT, tx.WRAP_CLAMP),
             ((13, 3), tx.WRAP_MIRROR, tx.WRAP_REPEAT),
             ((9, 11), tx.WRAP_CLAMP, tx.WRAP_MIRROR)]
    ims = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
           for (h, w), _, _ in specs]
    return ([tx.TextureImage(im, s, t) for im, (_, s, t) in zip(ims, specs)],
            [jtx.TextureImage(im, s, t) for im, (_, s, t) in zip(ims, specs)])


def _atlas_pair(name, town_pngs):
    if name == "town":
        d = town_pngs[0]
        ims = [read_image(str(d / f))[::-1].copy()
               for f in ("checker.png", "brick.png")]
        return tx.build_texture_atlas(ims), jtx.build_texture_atlas(ims)
    ours, theirs = _odd_images(np.random.default_rng(3))
    return tx.build_texture_atlas(ours), jtx.build_texture_atlas(theirs)


@pytest.mark.parametrize("name", ["town", "odd_mixed"])
def test_atlas_matches_reference(town_pngs, name):
    got, want = _atlas_pair(name, town_pngs)
    for k in ("data", "meta"):
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got._fields == ("data", "meta")  # no quad table unless asked
    empty, j_empty = tx.empty_atlas(), jtx._empty_atlas()
    np.testing.assert_array_equal(empty.data, np.asarray(j_empty.data))
    np.testing.assert_array_equal(empty.meta, np.asarray(j_empty.meta))
    assert j_empty.quad is None


@pytest.mark.parametrize("name", ["town", "odd_mixed"])
def test_build_quad_table_matches_reference(town_pngs, name):
    got, want = _atlas_pair(name, town_pngs)
    quad = tx.build_quad_table(got)
    assert quad.dtype == np.float32
    np.testing.assert_array_equal(quad, np.asarray(want.quad))


@pytest.mark.parametrize("path", ["quad", "four_gathers"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sample_texture_bilinear_matches_reference(mode, path):
    rng = np.random.default_rng(11)
    ims = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
           for h, w in ((5, 7), (16, 9), (3, 12))]
    m = MODES[mode]
    atlas = tx.build_texture_atlas([tx.TextureImage(im, m, m) for im in ims])
    j_atlas = jtx.build_texture_atlas([jtx.TextureImage(im, m, m)
                                       for im in ims])
    if path == "four_gathers":  # else the reference's quad-table path
        j_atlas = j_atlas._replace(quad=None)
    n = 4096
    tid = rng.integers(-1, len(ims), n).astype(np.int32)
    u = rng.uniform(-2, 3, n).astype(np.float32)
    v = rng.uniform(-2, 3, n).astype(np.float32)
    u[:8] = [-2, -1, 0, 0.5, 1, 2, 3, -1e-9]  # period edges
    got = tx.sample_texture_bilinear(atlas, torch.as_tensor(tid),
                                     torch.as_tensor(u), torch.as_tensor(v))
    want = np.asarray(jtx.sample_texture_bilinear(
        j_atlas, jnp.asarray(tid), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[tid < 0] == 0).all() and (tid < 0).any()
    # the footprint's texel indices, exactly
    flats, fu, fv = tx.bilinear_footprint(atlas, torch.as_tensor(tid),
                                          torch.as_tensor(u),
                                          torch.as_tensor(v))
    jm = np.asarray(j_atlas.meta)[np.maximum(tid, 0)]
    iu0, iu1, jfu = (np.asarray(x) for x in jtx._wrap_footprint(
        jnp.asarray(u), jnp.asarray(jm[:, 3]), jnp.asarray(jm[:, 4])))
    iv0, iv1, jfv = (np.asarray(x) for x in jtx._wrap_footprint(
        jnp.asarray(v), jnp.asarray(jm[:, 2]), jnp.asarray(jm[:, 5])))
    aw = atlas.data.shape[1]
    for f, iy, ix in zip(flats, (iv0, iv0, iv1, iv1), (iu0, iu1, iu0, iu1)):
        np.testing.assert_array_equal(
            f.numpy(), (jm[:, 0] + iy) * aw + jm[:, 1] + ix)
    np.testing.assert_array_equal(fu.numpy(), jfu)
    np.testing.assert_array_equal(fv.numpy(), jfv)


def _pil_png(path, img):
    from PIL import Image

    Image.fromarray(img).save(path)  # PIL picks its own row filters


@pytest.mark.parametrize("name", ["checker.png", "brick.png", "pil_rgb",
                                  "pil_rgba", "pil_grey", "pil_palette"])
def test_read_png_stdlib_equals_pil(town_pngs, tmp_path, name):
    from PIL import Image

    if name.endswith(".png"):
        path = town_pngs[0] / name
    else:
        rng = np.random.default_rng(5)
        yy, xx = np.mgrid[0:37, 0:29]
        smooth = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
        noise = rng.integers(0, 256, (37, 29), dtype=np.uint8)
        rgb = np.stack([smooth, noise, 255 - smooth], axis=-1)
        path = tmp_path / f"{name}.png"
        if name == "pil_rgb":
            _pil_png(path, rgb)
        elif name == "pil_rgba":
            _pil_png(path, np.concatenate([rgb, noise[..., None]], axis=-1))
        elif name == "pil_grey":
            _pil_png(path, smooth)
        else:
            Image.fromarray(rgb).quantize(64).save(path)  # 8-bit indices
    got = read_image_stdlib(str(path))
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGBA"), np.uint8)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_image(str(path)), want)


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "no_pil"])
def test_load_obj_textures_match_reference(town_pngs, monkeypatch, pil):
    """The town's textures as the reference loader gives them; without PIL
    the PNGs still load (stdlib decoder), v-flipped."""
    _, obj = town_pngs
    jm, jtex = j_load_obj(obj)
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL fails
        with pytest.raises(ImportError):
            import PIL  # noqa: F401
    tm, ttex = tobj.load_obj(obj)
    assert len(ttex) == len(jtex) == 2
    for a, b in zip(ttex, jtex):
        np.testing.assert_array_equal(a, b)
    assert [m.material.diffuse_texture_id for m in tm] == \
        [m.material.diffuse_texture_id for m in jm]
    assert sorted({m.material.diffuse_texture_id for m in tm}) == [-1, 0, 1]


def test_texture_loading_flips_rows_and_missing_is_minus_one(tmp_path):
    """tests/test_obj.py:94-130 for the port's loader."""
    img = np.zeros((4, 4, 3), np.uint8)
    img[0, 0] = (255, 0, 0)  # top-left red in file
    _pil_png(tmp_path / "tex.png", img)
    (tmp_path / "t.obj").write_text(
        "mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\nusemtl m\nf 1/1 2/2 3/3\n")
    (tmp_path / "t.mtl").write_text("newmtl m\nKd 1 1 1\nmap_Kd tex.png\n")
    meshes, textures = tobj.load_obj(str(tmp_path / "t.obj"))
    assert len(textures) == 1 and meshes[0].material.diffuse_texture_id == 0
    assert textures[0].shape == (4, 4, 4)
    np.testing.assert_array_equal(textures[0][3, 0, :3], [255, 0, 0])
    (tmp_path / "t.mtl").write_text("newmtl m\nmap_Kd nonexistent.png\n")
    meshes, textures = tobj.load_obj(str(tmp_path / "t.obj"))
    assert meshes[0].material.diffuse_texture_id == -1 and textures == []


@pytest.mark.parametrize("variant", ["repeat", "uv_transform", "normal_map",
                                     "features"])
def test_textured_scene_and_shade_tables_array_equal(variant):
    js, ts, _, _ = textured_quad_pair(variant)
    for k in ts.materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, k),
                                      np.asarray(getattr(js.materials, k)),
                                      err_msg=k)
    for k in ("data", "meta"):
        np.testing.assert_array_equal(getattr(ts.atlas, k),
                                      np.asarray(getattr(js.atlas, k)))
    assert (ts.any_uv_transform, ts.any_normal_map) == (
        js.any_uv_transform, js.any_normal_map)
    assert shade.texture_state(ts) == "diffuse"
    uv_xform, nmap = ts.any_uv_transform, ts.any_normal_map
    got = shade.build_shade_tables(ts, True, uv_xform, nmap, f_limit=128)
    want = j_tables(js, textured=True, f_limit=128, uv_xform=uv_xform,
                    normal_maps=nmap)
    assert got[0].shape == np.asarray(want[0]).shape
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert_light_rows_equal(got[1], want[1], ts)
    assert got[0].shape[0] == {"repeat": 24, "uv_transform": 32,
                               "normal_map": 32, "features": 40}[variant]


@pytest.mark.parametrize("two_key", [False, True])
def test_textured_town_tables_array_equal(tmp_path, two_key):
    """The textured town, Morton-ordered by choose_tracer as the reference
    orders it: scene, atlas and [F, 24] attribute rows equal."""
    from rendertoy3c_tpu.accel.lbvh import morton_order_scene as j_morton
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from torch_port_util import j_town_scene

    js, _ = j_town_scene(4000, two_key, tmp_path, textured=True)
    ts, _ = town_scene(4000, two_key, textured=True)
    ts, pipe = choose_tracer(ts, RenderConfig(**CFG), "cpu")
    if not two_key:
        js = j_morton(js)
    assert isinstance(pipe, shade.ExternalPipeline)
    assert pipe.tables.tex is not None and pipe.tables.attr.shape[1] == 24
    want, _ = j_tables(js, textured=True)
    np.testing.assert_array_equal(pipe.tables.attr.numpy(),
                                  np.asarray(want).T)
    np.testing.assert_array_equal(pipe.tables.tex.atlas.data.numpy(),
                                  np.asarray(js.atlas.data))
    np.testing.assert_array_equal(ts.geom.uv0, np.asarray(js.geom.uv0))


def _renders_like_reference(jscene, scene):
    """A22's general shading, ported: the scene takes the bare MT tracer
    (the kernels refuse it) and its pool render passes the gate
    (bench.py:115-116) against the reference's over its brute tracer."""
    from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
    from rendertoy3c_tpu.integrate.path import render_frame as j_render
    from rendertoy3c_tpu.trace.intersect import make_bruteforce_tracer
    from rendertoy3c_tpu_torch.integrate.path import render_frame

    _, tracer = choose_tracer(scene, RenderConfig(**CFG), "cpu")
    assert isinstance(tracer, tuple) and len(tracer) == 2
    cam = textured_quad_meshes("torch")[2].params()
    f_ref, _ = j_render(jscene, cam, JConfig(**CFG), subframes=1,
                        tracer=make_bruteforce_tracer(jscene))
    f, _ = render_frame(scene, cam, RenderConfig(**CFG), device="cpu")
    d = np.abs(f.accum.numpy() - np.asarray(f_ref.accum))
    assert d.mean() <= 2e-3 and (d.max(-1) > 0.35).sum() <= 8
    assert d.max() <= 8.0 and f.accum.numpy().mean() > 0


@pytest.mark.parametrize("which", ["emissive", "roughness"])
def test_emissive_and_roughness_textures_raise_naming_a22(which):
    """Emissive and roughness textures (A22's general shading, ported)
    render through the bare tracer, as the reference's general pool
    renders them."""
    scenes = []
    for pkg, build in (("jax", j_build_scene), ("torch", build_scene)):
        meshes, textures, _ = textured_quad_meshes(pkg)
        meshes[0].material = dataclasses.replace(
            meshes[0].material, **{f"{which}_texture_id": 0})
        scenes.append(build(meshes, textures=textures))
    assert shade.texture_state(scenes[1]) == "unsupported"
    _renders_like_reference(*scenes)


@pytest.mark.parametrize("which", ["diffuse", "normal"])
def test_texture_id_past_the_atlas_raises(which):
    """A material naming a texture that was not passed: the kernels would
    read the atlas's meta out of bounds, so the tables refuse it."""
    meshes, textures, _ = textured_quad_meshes("torch", "normal_map")
    meshes[0].material = dataclasses.replace(
        meshes[0].material, **{f"{which}_texture_id": len(textures)})
    scene = build_scene(meshes, textures=textures)
    with pytest.raises(ValueError, match=f"{which} texture id 2"):
        choose_tracer(scene, RenderConfig(**CFG), "cpu")


def test_normal_map_without_textures_raises_naming_a22():
    """A normal map whose image is not given (A22's general shading,
    ported) renders through the bare tracer, as the reference's does."""
    jm, _, _ = textured_quad_meshes("jax", "normal_map")
    meshes, _, _ = textured_quad_meshes("torch", "normal_map")
    scene = build_scene(meshes)  # the normal map's image is not given
    assert scene.any_normal_map and shade.texture_state(scene) == "none"
    _renders_like_reference(j_build_scene(jm), scene)


def _cli_scene(monkeypatch, tmp_path, scene_args):
    """The scene the port's CLI renders for these --scene arguments."""
    from rendertoy3c_tpu_torch.app import cli

    seen = []

    class Stop(Exception):
        pass

    def fake_render_fn(scene, cfg, device):
        seen.append(scene)
        raise Stop

    monkeypatch.setattr(cli, "make_render_fn", fake_render_fn)
    with pytest.raises(Stop):
        cli.main(["--scene", *scene_args, "--size", "16x16", "--device",
                  "cpu", "-o", str(tmp_path / "x.png")])
    return seen[0]


@pytest.mark.parametrize("name", ["textured", "obj"])
def test_cli_scene_matches_reference_cli(monkeypatch, tmp_path, name):
    """--scene textured and a textured .obj: the scene the port's CLI
    builds equals the one the reference CLI's loader builds
    (rendertoy3c_tpu/app/cli.py:157-198, :277)."""
    from rendertoy3c_tpu.app.cli import _load_scene, build_parser

    if name == "obj":
        paths, _ = j_generate_town(str(tmp_path), faces_target=4000)
        args = [paths[0]]
    else:
        args = ["textured"]
    ts = _cli_scene(monkeypatch, tmp_path, args)
    meshes, textures, _, _, _ = _load_scene(
        build_parser().parse_args(["--scene", *args]))
    js = j_build_scene(meshes, textures=textures or None)
    assert ts.textured and shade.texture_state(ts) == "diffuse"
    for k in ("data", "meta"):
        np.testing.assert_array_equal(getattr(ts.atlas, k),
                                      np.asarray(getattr(js.atlas, k)))
    for k in ts.materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, k),
                                      np.asarray(getattr(js.materials, k)))
    np.testing.assert_array_equal(ts.geom.uv1, np.asarray(js.geom.uv1))
