"""Whole textured renders through the port's choose_tracer against the
reference's render over its own pipeline (Pallas in interpret mode).

Fused pipeline (the textured quad, 4 faces): the diffuse texture under
repeat, CLAMP/MIRROR with stretched uvs, a uv transform and a normal map on
a DIFFUSE floor (mirrors of tests/test_fused.py:110-244), pixel-major
(textured K4), sorted and sample-major (textured K5), and the 2-key quad
(the motion variants), by the `_match` rule of tests/test_fused.py: >98% of
pixels within rtol = atol = 3e-5, means within rtol 2e-3, ray counts
within 1% + 8, pool iterations equal.

External pipeline (the textured 4294-face town, static and 2-key):
pixel-major, sorted and sample-major, by the strict rule of
tests/test_external.py: >98% of pixels within 3e-5, means within 5e-3, ray
counts within 2% + 16, pool iterations equal.

An atlas above the reference's MAX_ATLAS_TEXELS (one 256^2 texture): the
reference sends the scene to its general pool, the port renders it through
textured K4; the images agree by the fused rule."""
import numpy as np
import pytest

from rendertoy3c_tpu.film.film import film_create as j_film_create
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import make_render_fn as j_render_fn
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu.trace.pallas_shade import (MAX_ATLAS_TEXELS,
                                                fused_shade_eligible,
                                                make_fused_pipeline)
from rendertoy3c_tpu_torch.film.film import film_create
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import make_render_fn
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import (j_town_scene, textured_quad_meshes,
                             textured_quad_pair)

KW = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
          ray_block=256, integrator="pool", pool_pixel_major=True)
SCHEDULES = {"pixel_major": {}, "sorted": dict(sort_rays=True),
             "sample_major": dict(pool_pixel_major=False)}


def _subframe(j_scene, j_tracer, scene, cam, kw):
    """One subframe of each side through its make_render_fn: ((image,
    radiance rays, shadow rays, pool iterations) of the port, of the
    reference), and the port's pipeline."""
    jstep = j_render_fn(j_scene, JConfig(**kw), tracer=j_tracer)
    jf, js = jstep(cam.params(), j_film_create(kw["height"], kw["width"]))
    cfg = RenderConfig(**kw)
    scene, pipe = choose_tracer(scene, cfg, "cpu")
    step = make_render_fn(scene, cfg, tracer=pipe, device="cpu")
    f, s = step(cam.params(), film_create(cfg.height, cfg.width,
                                          device="cpu"))
    return ((f.accum.numpy(), int(s.radiance_rays), int(s.shadow_rays),
             int(s.pool_iters)),
            (np.asarray(jf.accum), int(js.radiance_rays),
             int(js.shadow_rays), int(js.pool_iters)), pipe)


def _assert_match(got, want, mean_rtol, count_rel, count_abs, iters=True):
    a, b = got[0], want[0]
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=mean_rtol)
    assert np.isfinite(a).all() and a.mean() > 0.02
    for g, w in zip(got[1:3], want[1:3]):
        assert abs(g - w) <= count_rel * w + count_abs, (g, w)
    if iters:
        assert got[3] == want[3], ("pool iterations", got[3], want[3])


@pytest.mark.parametrize("variant, motion, schedule", [
    ("repeat", False, "pixel_major"), ("clamp_mirror", False, "pixel_major"),
    ("uv_transform", False, "pixel_major"),
    ("normal_map", False, "pixel_major"), ("features", False, "sorted"),
    ("repeat", False, "sample_major"), ("features", True, "pixel_major"),
    ("repeat", True, "sorted"), ("normal_map", True, "sample_major")])
def test_textured_quad_matches_reference(variant, motion, schedule):
    js, ts, jcam, tcam = textured_quad_pair(variant, motion)
    kw = dict(KW, **SCHEDULES[schedule])
    assert fused_shade_eligible(js, JConfig(**kw))
    j_pipe = make_fused_pipeline(js, JConfig(**kw), interpret=True)
    got, want, pipe = _subframe(js, j_pipe, ts, tcam, kw)
    assert isinstance(pipe, shade.FusedPipeline) and pipe.motion == motion
    tex = pipe.tables.tex
    assert tex is not None and (tex.uv_xform, tex.normal_maps) == (
        js.any_uv_transform, js.any_normal_map)
    _assert_match(got, want, 2e-3, 0.01, 8)


@pytest.fixture(scope="module")
def textured_towns(tmp_path_factory):
    """{two_key: (reference scene, port scene, camera)}: the textured
    4294-face town."""
    out = {}
    for two_key in (False, True):
        js, _ = j_town_scene(4000, two_key, tmp_path_factory.mktemp(
            f"town{int(two_key)}"), textured=True)
        ts, cam = town_scene(4000, two_key, textured=True)
        out[two_key] = (js, ts, cam)
    return out


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("two_key", [False, True], ids=["static", "2key"])
def test_textured_town_matches_reference(textured_towns, two_key, schedule):
    js, ts, cam = textured_towns[two_key]
    assert ts.textured and len(ts.atlas.meta) == 2
    kw = dict(KW, **SCHEDULES[schedule])
    js, j_pipe = j_choose_tracer(js, JConfig(**kw), on_tpu=True)
    assert type(j_pipe).__name__ == "ExternalPipeline"
    got, want, pipe = _subframe(js, j_pipe, ts, cam, kw)
    assert isinstance(pipe, shade.ExternalPipeline)
    assert pipe.tables.tex is not None
    _assert_match(got, want, 5e-3, 0.02, 16)


def test_atlas_above_tpu_limit_matches_reference_route():
    """One 256^2 texture: 65536 texels, above MAX_ATLAS_TEXELS, so the
    reference renders the scene on its general pool (a bare MT tracer);
    the port has no such limit and renders it through textured K4."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, (256, 256, 4), dtype=np.uint8)
    big[..., 3] = 255
    jm, _, jcam = textured_quad_meshes("jax")
    tm, _, tcam = textured_quad_meshes("torch")
    js, ts = j_build_scene(jm, textures=[big]), build_scene(tm, textures=[big])
    assert ts.atlas.data.shape[0] * ts.atlas.data.shape[1] > MAX_ATLAS_TEXELS
    assert not fused_shade_eligible(js, JConfig(**KW))
    js, j_tracer = j_choose_tracer(js, JConfig(**KW), on_tpu=True)
    assert type(j_tracer).__name__ not in ("FusedPipeline",
                                            "ExternalPipeline")
    got, want, pipe = _subframe(js, j_tracer, ts, tcam, KW)
    assert isinstance(pipe, shade.FusedPipeline) and pipe.tables.tex
    _assert_match(got, want, 2e-3, 0.01, 8, iters=False)
