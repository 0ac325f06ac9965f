"""Environment maps in the port (scene/envmap.py, film/image.py read_ppm,
read_exr and load_image, the miss radiance of integrate/path.py) against
the reference's (rendertoy3c_tpu/scene/envmap.py, film/image.py).

`build_env_map` and the image readers array-equal. `sample_env_map` on
seeded directions, the poles, y = +-1 exactly and both sides of the atan2
seam, within rtol = atol = 1e-5 of the map's values (the two packages'
atan2 and acos differ in the last ulps, which move the bilinear weights
by as much; a tap index that floor() flips at a texel edge changes the
result continuously). Whole renders of an env-lit Cornell box on the
wave integrator and the general pool against the reference's
render_frame: at max_depth 1 within rtol = atol = 1e-5 with equal ray
counts, at max_depth 3 by bench.py's gate (:115-116) as
tests/test_torch_general_pool.py holds its renders; the analogs of the
reference's test_render_with_env_map and test_render_env_pool_matches_wave
on the port alone."""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.film import image as j_image
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.scene.builtin import cornell_box as j_cornell_box
from rendertoy3c_tpu.scene.envmap import EnvMap as JEnvMap
from rendertoy3c_tpu.scene.envmap import build_env_map as j_build_env_map
from rendertoy3c_tpu.scene.envmap import sample_env_map as j_sample_env_map
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.intersect import \
    make_bruteforce_tracer as j_brute
from rendertoy3c_tpu_torch.film import image
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.scene.builtin import cornell_box
from rendertoy3c_tpu_torch.scene.envmap import (EnvMap, build_env_map,
                                                sample_env_map)
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from torch_port_util import hdr_sky

SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_torch_general_pool.py's bound on the ray counts' difference
MAX_RAY_DIFF = 12


def gate(a, b):
    """bench.py's gate (:115-116)."""
    d = np.abs(a - b)
    return d.mean() <= 2e-3 and (d.max(-1) > 0.35).sum() <= 8 and \
        d.max() <= 8.0


@pytest.mark.parametrize("kind", ["uint8", "float", "rgba_float"])
def test_build_env_map_matches_reference(kind):
    r = np.random.default_rng(1)
    if kind == "uint8":
        img = r.integers(0, 256, (6, 10, 4), dtype=np.uint8)
    else:
        img = r.uniform(0, 50, (6, 10, 4 if kind == "rgba_float" else 3))
        img = img.astype(np.float32)
    got = build_env_map(img, 1.7, device="cpu")
    want = j_build_env_map(img, 1.7)
    assert got.data.dtype == torch.float32 and got.data.shape == (6, 10, 3)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def _directions():
    """Seeded unit directions, the poles, y = +-1 with x = z = 0, and
    directions on both sides of the atan2 seam (x = +-0, z > 0)."""
    r = np.random.default_rng(2)
    d = r.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    eps = np.array([0.0, 1e-7, 1e-4, 1e-2])
    seam = []
    for e in eps:
        for s in (1.0, -1.0):
            x = s * e
            seam.append([x, 0.3, np.sqrt(1 - x * x - 0.09)])
    seam.append([-0.0, 0.0, 1.0])
    special = [[0, 1, 0], [0, -1, 0], [0, 1.0000001, 0], [1e-8, -1, 0],
               [1, 0, 0], [-1, 0, 0], [0, 0, -1]]
    return np.concatenate([d, seam, special]).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 8), (16, 32), (7, 13)])
def test_sample_env_map_matches_reference(shape):
    img = hdr_sky(*shape, seed=shape[0])
    d = _directions()
    got = sample_env_map(EnvMap(data=torch.as_tensor(img)),
                         torch.as_tensor(d)).numpy()
    want = np.asarray(j_sample_env_map(JEnvMap(data=jnp.asarray(img)),
                                       jnp.asarray(d)))
    assert got.shape == want.shape == (d.shape[0], 3)
    scale = np.abs(img).max()
    np.testing.assert_allclose(got / scale, want / scale, **SAMPLE_TOL)
    # the poles read the first and the last rows, whatever the azimuth
    top = sample_env_map(EnvMap(data=torch.as_tensor(img)),
                         torch.tensor([[0.0, 1.0, 0.0]])).numpy()[0]
    assert np.isfinite(top).all() and np.all(top >= 0)


def test_sample_env_map_wraps_at_the_seam():
    """The reference's test_azimuth_wrap_continuity and
    test_sample_directions on the port."""
    r = np.random.default_rng(0)
    img = r.uniform(0, 1, (8, 16, 3)).astype(np.float32)
    env = EnvMap(data=torch.as_tensor(img))
    e = 1e-4
    d1 = torch.tensor([[np.sin(np.pi - e), 0.0, np.cos(np.pi - e)]],
                      dtype=torch.float32)
    d2 = torch.tensor([[np.sin(-np.pi + e), 0.0, np.cos(-np.pi + e)]],
                      dtype=torch.float32)
    np.testing.assert_allclose(sample_env_map(env, d1).numpy(),
                               sample_env_map(env, d2).numpy(), atol=1e-2)
    img = np.zeros((4, 8, 3), np.float32)
    img[0], img[3] = (0, 1, 0), (1, 0, 0)
    env = EnvMap(data=torch.as_tensor(img))
    up = sample_env_map(env, torch.tensor([[0.0, 1.0, 0.0]]))[0]
    down = sample_env_map(env, torch.tensor([[0.0, -1.0, 0.0]]))[0]
    assert up[1] > 0.9 and up[0] < 0.1 and down[0] > 0.9 and down[1] < 0.1


def _half_exr(path, img16: np.ndarray, names=(b"B", b"G", b"R", b"Z")):
    """A hand-built uncompressed scanline EXR of HALF channels (in the
    file's alphabetical order), with a data window offset from 0."""
    h, w, _ = img16.shape
    chl = b"".join(n + b"\x00" + struct.pack("<iiii", 1, 0, 1, 1)
                   for n in names) + b"\x00"

    def attr(name, typ, payload):
        return (name + b"\x00" + typ + b"\x00" + struct.pack("<I",
                                                             len(payload))
                + payload)

    box = struct.pack("<iiii", 3, 5, 3 + w - 1, 5 + h - 1)
    header = (attr(b"channels", b"chlist", chl)
              + attr(b"compression", b"compression", b"\x00")
              + attr(b"dataWindow", b"box2i", box)
              + attr(b"displayWindow", b"box2i", box)
              + attr(b"lineOrder", b"lineOrder", b"\x00") + b"\x00")
    pre = struct.pack("<iI", 20000630, 2)
    first = len(pre) + len(header) + 8 * h
    size = 8 + 2 * w * len(names)
    with open(path, "wb") as f:
        f.write(pre + header)
        f.write(struct.pack("<" + "Q" * h,
                            *[first + y * size for y in range(h)]))
        for y in range(h):
            f.write(struct.pack("<ii", 5 + y, 2 * w * len(names)))
            for k in range(len(names)):
                f.write(img16[y, :, k].tobytes())


@pytest.mark.parametrize("case", ["float_rgb", "float_rgba", "half"])
def test_read_exr_matches_reference(tmp_path, case):
    r = np.random.default_rng(3)
    p = str(tmp_path / "x.exr")
    if case == "half":
        img = r.uniform(0, 60, (5, 7, 4)).astype(np.float16)
        _half_exr(p, img)
        got = image.read_exr(p)
        # B G R Z in the file: R G B first, then Z
        np.testing.assert_array_equal(
            got, img[..., [2, 1, 0, 3]].astype(np.float32))
    else:
        img = r.uniform(0, 1e3, (9, 11, 4 if case == "float_rgba" else 3))
        img = img.astype(np.float32)
        j_image.write_exr(p, img)
        got = image.read_exr(p)
        np.testing.assert_array_equal(got, img)
        # the port's writer, byte for byte the reference's, reads back
        image.write_exr(str(tmp_path / "y.exr"), img)
        np.testing.assert_array_equal(image.read_exr(str(tmp_path / "y.exr")),
                                      img)
    np.testing.assert_array_equal(got, j_image.read_exr(p))
    assert got.dtype == np.float32


def test_load_image_dispatches_by_extension(tmp_path):
    r = np.random.default_rng(4)
    u8 = r.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    f32 = r.uniform(0, 4, (6, 5, 3)).astype(np.float32)
    image.write_ppm(str(tmp_path / "a.ppm"), u8)
    image.write_png(str(tmp_path / "a.png"), u8)
    image.write_exr(str(tmp_path / "a.EXR"), f32)
    # a header comment, which the reader skips
    with open(tmp_path / "a.ppm", "rb") as f:
        raw = f.read()
    with open(tmp_path / "c.ppm", "wb") as f:
        f.write(raw.replace(b"P6\n", b"P6\n# made by a test\n", 1))
    for name, want in (("a.ppm", u8), ("c.ppm", u8),
                       ("a.png", np.concatenate(
                           [u8, np.full((6, 5, 1), 255, np.uint8)], -1)),
                       ("a.EXR", f32)):
        got = image.load_image(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, j_image.load_image(str(tmp_path / name)))
    with pytest.raises(ValueError):
        with open(tmp_path / "bad.exr", "wb") as f:
            f.write(b"\x00" * 16)
        image.read_exr(str(tmp_path / "bad.exr"))


def _env_pair(n_meshes, img):
    """(reference scene, port scene, reference camera, port camera) of
    the first n_meshes meshes of the blockless Cornell box lit by img."""
    jm, jcam = j_cornell_box(with_blocks=False)
    tm, tcam = cornell_box(with_blocks=False)
    js = j_build_scene(jm[:n_meshes], env_map=JEnvMap(data=jnp.asarray(img)))
    ts = build_scene(tm[:n_meshes],
                     env_map=build_env_map(img, device="cpu"))
    return js, ts, jcam, tcam


@pytest.mark.parametrize("integrator", ["wave", "pool"])
@pytest.mark.parametrize("depth", [1, 3])
def test_env_render_matches_reference(integrator, depth):
    """The floor and ceiling of the Cornell box (the walls gone, so most
    paths miss into the sky) under hdr_sky, through render_frame's tracer
    choice (the plain MT tracer on the CPU) against the reference's over
    its brute tracer."""
    js, ts, jcam, tcam = _env_pair(2, hdr_sky())
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=depth,
              ray_block=256, integrator=integrator,
              pool_pixel_major=integrator == "pool")
    f_ref, s_ref = j_render_frame(js, jcam.params(), JConfig(**kw),
                                  subframes=1, tracer=j_brute(js))
    f, s = render_frame(ts, tcam.params(), RenderConfig(**kw), subframes=1,
                        device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert np.isfinite(a).all() and a.mean() > 0.05
    if depth == 1:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert int(s.radiance_rays) == int(s_ref.radiance_rays)
        assert int(s.shadow_rays) == int(s_ref.shadow_rays)
        return
    assert gate(a, b), (np.abs(a - b).mean(), np.abs(a - b).max())
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= MAX_RAY_DIFF


def test_render_with_env_map():
    """The reference's test_render_with_env_map on the port: a blue sky
    of 0.5-0.9 lights the floor and ceiling far above the 0.01 ambient,
    and tints them blue."""
    meshes, camera = cornell_box(with_blocks=False)
    sky = np.zeros((4, 8, 3), np.float32)
    sky[:] = (0.5, 0.6, 0.9)
    scene_env = build_scene(meshes[:2],
                            env_map=build_env_map(sky, device="cpu"))
    scene_const = build_scene(meshes[:2])
    cfg = RenderConfig(width=16, height=16, samples_per_launch=2,
                       max_depth=3, ray_block=256)
    cam = camera.params()
    a = render_frame(scene_env, cam, cfg, device="cpu")[0].accum.numpy()
    b = render_frame(scene_const, cam, cfg, device="cpu")[0].accum.numpy()
    assert np.isfinite(a).all()
    assert a.mean() > b.mean() * 3
    assert a[..., 2].mean() > a[..., 0].mean()


def test_env_pool_matches_wave():
    """The reference's test_render_env_pool_matches_wave on the port, at
    its tolerance (rtol = atol = 2e-5), over the brute tracer."""
    meshes, camera = cornell_box(with_blocks=False)
    scene = build_scene(meshes[:3], env_map=build_env_map(
        np.full((4, 8, 3), 0.4, np.float32), device="cpu"))
    base = dict(width=16, height=16, samples_per_launch=2, max_depth=3,
                ray_block=256)
    cam = camera.params()
    tracer = make_bruteforce_tracer(scene)
    f_w, _ = render_frame(scene, cam, RenderConfig(integrator="wave", **base),
                          tracer=tracer, device="cpu")
    f_p, _ = render_frame(scene, cam, RenderConfig(integrator="pool", **base),
                          tracer=tracer, device="cpu")
    np.testing.assert_allclose(f_p.accum.numpy(), f_w.accum.numpy(),
                               rtol=2e-5, atol=2e-5)
