"""Whole renders of trace-time instanced scenes against the reference's
pipelines, and the baked world table against the space-switching walk.

24^2, 2 spp, depth 4, through render_pixels of each package on the same
split-ordered scene: the trace-time external pipeline (the instanced walk
under K6's plain version with instance rows, the XLA-refill pool; the
reference's make_external_pipeline over make_inst_hierwalk_tracer in
interpret mode), the instanced walk pool on bench's instance field at
grid 4, static and 2-key, and on the normal-mapped quad, and the walk
pool over the baked world table (the reference's RT3C_INST_BAKE=2). Held
at tests/test_walkpool.py:339's rtol = atol = 2e-4 on every pixel, the
radiance rays equal and the shadow rays within 4: XLA contracts the hit
point's a * b + c into FMAs, which flips the sign test of a few grazing
NEE directions (at most 2 in these scenes, of 285-2335). The baked table
against the space-switching walk, in the port alone (VERDICT r5 weak #5): the
same image within 2e-4, the same ray counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inst_util import (forced_bake, j_field, j_multi_instance_cornell,
                       ref_bumpy_quad, to_port_iscene)
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_pixels as j_render_pixels
from rendertoy3c_tpu.integrate.walkpool import \
    make_inst_walkpool_pipeline as j_inst_walkpool
from rendertoy3c_tpu.scene.instanced import \
    build_instanced_scene as j_build_instanced
from rendertoy3c_tpu.trace.hier_instanced import \
    make_inst_hierwalk_tracer as j_inst_tracer
from rendertoy3c_tpu.trace.hier_instanced import \
    split_order_instanced as j_split
from rendertoy3c_tpu.trace.pallas_shade import make_external_pipeline
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_pixels
from rendertoy3c_tpu_torch.integrate.walkpool import (
    WalkPoolPipeline, make_inst_walkpool_pipeline)
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer

KW = dict(width=24, height=24, integrator="pool", pool_pixel_major=True,
          samples_per_launch=2, ray_block=1024, max_depth=4)
N = 24 * 24


def _cam(jcam):
    jcam.aspect_ratio = 1.0
    return jcam, Camera(eye=jcam.eye, lookat=jcam.lookat, up=jcam.up,
                        fov_y=jcam.fov_y, aspect_ratio=1.0)


def _scene(case):
    """(reference scene, port scene, reference camera, port camera),
    split-ordered."""
    if case == "normal_map":
        m, i, t, jcam = ref_bumpy_quad()
        js = j_build_instanced(m, i, textures=t)
    elif case == "cornell9":
        js, _, _, jcam = j_multi_instance_cornell()
    else:
        js, jcam = j_field(case == "field_2key", 4)
        jcam.eye, jcam.lookat = (0.0, 6.0, 9.0), (0.0, 0.5, 0.0)
    js = j_split(js)
    return (js, to_port_iscene(js)) + _cam(jcam)


def _numpy(res):
    rgb, _, n_rad, n_shad, steps = res
    return np.asarray(rgb), int(n_rad), int(n_shad), int(steps)


def _render(ts, tcam, pipe, **change):
    cfg = RenderConfig(**dict(KW, **change))
    return _numpy(render_pixels(ts, cfg, tcam.params(), pipe,
                                torch.arange(N), 0))


def _j_render(js, jcam, jpipe, **change):
    jcfg = JConfig(**dict(KW, **change))
    pix = jnp.arange(N, dtype=jnp.int32)
    return _numpy(jax.jit(lambda c: j_render_pixels(
        js, jcfg, c, jpipe, pix, jnp.uint32(0)))(jcam.params()))


def _assert_match(got, want):
    a, b = got[0], want[0]
    assert np.isfinite(a).all() and a.mean() > 0.01
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= 4


def test_tracetime_external_pipeline_matches_reference():
    """bench's multi_instance_tracetime at 24^2: choose_tracer's
    ExternalPipeline over the instanced walk."""
    js, ts, jcam, tcam = _scene("cornell9")
    ordered, pipe = choose_tracer(ts, RenderConfig(**KW), "cpu")
    assert isinstance(pipe, shade.ExternalPipeline) and pipe.instanced
    jpipe = make_external_pipeline(js, JConfig(**KW), j_inst_tracer(js),
                                   interpret=True)
    _assert_match(_render(ordered, tcam, pipe), _j_render(js, jcam, jpipe))


@pytest.mark.parametrize("case", ["field", "field_2key", "normal_map"])
def test_inst_walk_pool_matches_reference(case):
    js, ts, jcam, tcam = _scene(case)
    pipe = make_inst_walkpool_pipeline(ts, RenderConfig(**KW), "cpu",
                                       bake=False)
    assert pipe.instanced and not pipe.inst_stride
    assert pipe.motion == (case == "field_2key")
    jpipe = j_inst_walkpool(js, JConfig(**KW))
    got, want = _render(ts, tcam, pipe), _j_render(js, jcam, jpipe)
    _assert_match(got, want)
    assert got[3] % 20 == 0  # K = 20 rounds per boundary


def test_baked_walk_pool_matches_reference():
    js, ts, jcam, tcam = _scene("field")
    pipe = make_inst_walkpool_pipeline(ts, RenderConfig(**KW), "cpu",
                                       bake=True)
    with forced_bake():
        jpipe = j_inst_walkpool(js, JConfig(**KW))
    assert jpipe.inst_stride == pipe.inst_stride == ts.num_faces
    _assert_match(_render(ts, tcam, pipe), _j_render(js, jcam, jpipe))


def test_baked_matches_space_switching():
    """VERDICT r5 weak #5: the baked world table (K9's walk in world
    space, hits decoded to (face, instance)) renders the space-switching
    walk's image (K9-inst) within 2e-4, the radiance rays equal and the
    shadow rays within 4 (world-space and object-space arithmetic round a
    grazing NEE direction apart: 1 of 1293), static field."""
    _, ts, _, tcam = _scene("field")
    cfg = RenderConfig(**KW)
    baked = make_inst_walkpool_pipeline(ts, cfg, "cpu", bake=True)
    walk = make_inst_walkpool_pipeline(ts, cfg, "cpu", bake=False)
    assert isinstance(baked, WalkPoolPipeline) and baked.inst_stride
    a, b = _render(ts, tcam, baked), _render(ts, tcam, walk)
    assert a[0].mean() > 0.05
    np.testing.assert_allclose(a[0], b[0], rtol=2e-4, atol=2e-4)
    assert a[1] == b[1] and abs(a[2] - b[2]) <= 4
