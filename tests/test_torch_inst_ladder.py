"""Instanced scenes in the port's tracer ladder, as the reference's
trace/auto.py routes them (:56-76, :117-150), BASELINE config 3 (bench's
multi_instance_tlas, baked by build_scene) on the fused pipeline, and the
instanced cases the port refuses, each naming its ROADMAP item, or routes
where it once refused them."""
import dataclasses

import numpy as np
import pytest

from inst_util import j_field, j_multi_instance_cornell, to_port_iscene
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.integrate.walkpool import \
    WalkPoolPipeline as JWalkPool
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose
from rendertoy3c_tpu.trace.auto import tune_config as j_tune
from rendertoy3c_tpu.trace.pallas_shade import (ExternalPipeline as JExt,
                                                make_fused_pipeline)
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.integrate.walkpool import WalkPoolPipeline
from rendertoy3c_tpu_torch.scene.builtin import multi_instance_cornell
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer, tune_config
from rendertoy3c_tpu_torch.trace.hier_instanced import InstHierTable
from rendertoy3c_tpu_torch.trace.hierwalk import FANOUT32, HierTable

POOL = dict(integrator="pool", pool_pixel_major=True, ray_block=32768)


@pytest.fixture(scope="module")
def scenes():
    """{name: (reference scene, port scene)} of bench's trace-time
    configurations, full size."""
    out = {"cornell9": j_multi_instance_cornell()[0],
           "field": j_field(False, 24)[0], "field_2key": j_field(True, 24)[0]}
    return {k: (v, to_port_iscene(v)) for k, v in out.items()}


@pytest.mark.parametrize("name", ["cornell9", "field", "field_2key"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_tune_config_matches_reference(scenes, name, device):
    js, ts = scenes[name]
    for kw in (dict(POOL, sort_rays=True), dict(POOL, ray_block=4096,
                                                flush_every=3)):
        got = tune_config(ts, RenderConfig(**kw), device)
        want = j_tune(js, JConfig(**kw), on_tpu=device == "cuda")
        assert (got.ray_block, got.flush_every, got.sort_rays) == (
            want.ray_block, want.flush_every, want.sort_rays)
    if device == "cuda":
        got = tune_config(ts, RenderConfig(**POOL), device)
        assert got.ray_block == {"cornell9": 8192, "field": 16384,
                                 "field_2key": 8192}[name]


@pytest.mark.parametrize("name", ["cornell9", "field", "field_2key"])
def test_choose_tracer_routes_as_reference(scenes, name):
    """cornell9 (1920 effective faces): the instanced walk under the
    external pipeline; the static 578-instance field: the walk pool on the
    baked world table; its 2-key form: the walk pool on the instanced
    table at fanout 32."""
    js, ts = scenes[name]
    kw = dict(POOL, width=16, height=16)
    ordered, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    jo, jpipe = j_choose(js, JConfig(**kw), on_tpu=True)
    np.testing.assert_array_equal(ordered.geom.v0, np.asarray(jo.geom.v0))
    assert ordered.instance_mesh == jo.instance_mesh
    if name == "cornell9":
        assert isinstance(jpipe, JExt) and isinstance(pipe,
                                                      shade.ExternalPipeline)
        assert pipe.instanced and pipe.tables.inst_rows.shape == (15, 18)
        return
    assert isinstance(jpipe, JWalkPool) and isinstance(pipe,
                                                       WalkPoolPipeline)
    assert pipe.instanced and jpipe.instanced
    assert pipe.inst_stride == jpipe.inst_stride
    assert pipe.motion == jpipe.motion == (name == "field_2key")
    assert (pipe.n_levels, pipe.fanout) == (jpipe.n_levels, jpipe.fanout)
    if name == "field":
        assert isinstance(pipe.table, HierTable) and pipe.inst_stride == 1280
    else:
        assert isinstance(pipe.table, InstHierTable)
        assert pipe.fanout == FANOUT32 and pipe.n_levels == 4


def test_baseline_config3_renders_on_the_fused_pipeline():
    """multi_instance_tlas: the instances baked by build_scene render on
    the fused pipeline (K4) as the reference's, by tests/test_fused.py's
    `_match` rule (>98% of pixels within 3e-5, means within 2e-3, ray
    counts within 1% + 8)."""
    _, jm, ji, jcam = j_multi_instance_cornell()
    tm, ti, tcam = multi_instance_cornell()
    js, ts = j_build_scene(jm, instances=ji), build_scene(tm, instances=ti)
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=256, integrator="pool", pool_pixel_major=True)
    _, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, shade.FusedPipeline)
    f_ref, s_ref = j_render_frame(
        js, jcam.params(), JConfig(**kw), subframes=1,
        tracer=make_fused_pipeline(js, JConfig(**kw), interpret=True))
    f, s = render_frame(ts, tcam.params(), RenderConfig(**kw), subframes=1,
                        device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= 0.01 * int(want) + 8


@pytest.mark.parametrize("case, item", [
    ("three_keys", "C1"), ("wave", "A6/A7"), ("no_lights_tracetime", "A7"),
    ("physical_field", "A22")])
def test_out_of_slice_raises_naming_roadmap_item(scenes, case, item):
    """More than 2 keys (C1) still raise; the wave integrator and a scene
    without lights (A6/A7, ported) take the bare instanced walk tracer, as
    the reference routes them; the physical throughput model on the baked
    578-instance field (A22, ported) takes the walk pool with the general
    shade stage, as the reference's takes its XLA stage."""
    js, ts = scenes["field" if case == "physical_field" else "cornell9"]
    kw = dict(POOL, width=16, height=16)
    if case == "three_keys":
        ts = dataclasses.replace(ts, num_keys=3)
    elif case == "wave":
        kw["integrator"] = "wave"
    elif case == "no_lights_tracetime":
        js = dataclasses.replace(js, num_lights=0)
        ts = dataclasses.replace(ts, num_lights=0)
    else:
        kw["throughput_model"] = "physical"
    if item.startswith("A6") or item == "A7":
        _, want = j_choose(js, JConfig(**kw), on_tpu=True)
        _, got = choose_tracer(ts, RenderConfig(**kw), "cpu")
        assert isinstance(want, tuple) and isinstance(got, tuple)
        return
    if item == "A22":
        _, want = j_choose(js, JConfig(**kw), on_tpu=True)
        _, got = choose_tracer(ts, RenderConfig(**kw), "cpu")
        assert isinstance(want, JWalkPool) and isinstance(got,
                                                          WalkPoolPipeline)
        assert not want.kernel and not got.kernel
        assert got.inst_stride == want.inst_stride > 0
        return
    with pytest.raises(NotImplementedError, match=item):
        choose_tracer(ts, RenderConfig(**kw), "cpu")
