"""Whole renders through the port's walk pool (plain versions on the CPU)
against the reference's (`render_pixels` over `make_walkpool_pipeline`,
Pallas K6 in interpret mode), at tests/test_walkpool.py's 24^2, 2 spp,
ray_block 1024, depth 4, by the `_match` rule of the earlier port tests
(tests/walk_render_util.py): the split-ordered Cornell box, a box field of
3 table levels, the 2-key Cornell box, and a scene of more than 16384
faces through both packages' choose_tracer."""
import numpy as np

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.integrate.walkpool import WalkPoolPipeline
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from rendertoy3c_tpu_torch.trace.hierwalk import HIER_LEAF, build_hier_table
from torch_port_util import (box_field_pair, cornell_pair, lit_grid_scene,
                             moving_cornell_pair)
from walk_render_util import KW, assert_match, render_pair


def test_cornell():
    got, want = render_pair(*cornell_pair())
    assert_match(got, want)
    assert got[4] == want[4]  # walk rounds: same boundaries, same K


def test_box_field_of_three_levels():
    js, ts, cam = box_field_pair(24)
    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene

    t2 = split_order_scene(ts, leaf=HIER_LEAF)
    assert build_hier_table(t2.geom, t2.num_faces, fanout=0).n_levels >= 3
    assert_match(*render_pair(js, ts, cam, cam))


def test_two_key_cornell():
    js, ts, jcam, tcam = moving_cornell_pair()
    assert ts.num_keys == 2
    assert_match(*render_pair(js, ts, jcam, tcam))


def test_more_than_16384_faces_through_choose_tracer():
    """The 40 x 40 grid (19202 faces) takes the walk pool in both ladders;
    16^2, 2 spp, one subframe through render_frame."""
    js, ts = lit_grid_scene("jax"), lit_grid_scene("torch")
    from rendertoy3c_tpu_torch.scene.camera import Camera

    cam = Camera(eye=(20.0, 14.0, 50.0), lookat=(20.0, 0.0, 20.0),
                 fov_y=50.0)
    kw = dict(KW, width=16, height=16)
    t_scene, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, WalkPoolPipeline) and t_scene.num_faces > 16384
    j_scene, j_pipe = j_choose_tracer(js, JConfig(**kw), on_tpu=True)
    assert type(j_pipe).__name__ == "WalkPoolPipeline"
    f_ref, s_ref = j_render_frame(j_scene, cam.params(), JConfig(**kw),
                                  tracer=j_pipe)
    f, s = render_frame(ts, cam.params(), RenderConfig(**kw), device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert_match((a, None, int(s.radiance_rays), int(s.shadow_rays)),
                 (b, None, int(s_ref.radiance_rays),
                  int(s_ref.shadow_rays)))
