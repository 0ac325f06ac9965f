"""Whole renders through the pool schedules this port adds, against the
reference's render over its own pipeline (Pallas in interpret mode).

Fused pipeline (scenes of up to 2048 faces): the 2-key Cornell box on the
pixel-major pool (the refill megakernel's motion variant), and the static
and 2-key Cornell box on sorted and sample-major pools (the merged
non-refill megakernel K5 inside the XLA-refill loop), by the `_match` rule
of tests/test_fused.py: >98% of pixels within rtol = atol = 3e-5, means
within rtol 2e-3, ray counts within 1% + 8. `pool_stash=0` on the
pixel-major fused pool renders bit for bit the stash render, as in
tests/test_fused.py:247-264.

External pipeline (2049-16384 faces): the static and 2-key 4294-face town
on sorted and sample-major pools, by the strict rule of
tests/test_external.py: >98% of pixels within 3e-5, means within 5e-3, ray
counts within 2% + 16.

Each case also holds the pool's iteration count to the reference's."""
import numpy as np
import pytest

from rendertoy3c_tpu.film.film import film_create as j_film_create
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import make_render_fn as j_render_fn
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu.trace.pallas_shade import make_fused_pipeline
from rendertoy3c_tpu_torch.film.film import film_create
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import make_render_fn, render_frame
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import cornell_pair, j_town_scene, moving_cornell_pair

KW = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
          ray_block=256, integrator="pool", pool_pixel_major=True)
SCHEDULES = {"pixel_major": {}, "sorted": dict(sort_rays=True),
             "sample_major": dict(pool_pixel_major=False)}


def _subframe(j_scene, j_tracer, scene, cam, kw):
    """One subframe of each side through its make_render_fn: ((image,
    radiance rays, shadow rays, pool iterations) of the port, of the
    reference)."""
    jstep = j_render_fn(j_scene, JConfig(**kw), tracer=j_tracer)
    jf, js = jstep(cam.params(), j_film_create(kw["height"], kw["width"]))
    cfg = RenderConfig(**kw)
    step = make_render_fn(scene, cfg, device="cpu")
    f, s = step(cam.params(), film_create(cfg.height, cfg.width,
                                          device="cpu"))
    return ((f.accum.numpy(), int(s.radiance_rays), int(s.shadow_rays),
             int(s.pool_iters)),
            (np.asarray(jf.accum), int(js.radiance_rays),
             int(js.shadow_rays), int(js.pool_iters)))


def _assert_match(got, want, mean_rtol, count_rel, count_abs):
    a, b = got[0], want[0]
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=mean_rtol)
    assert np.isfinite(a).all() and a.mean() > 0.05
    for g, w in zip(got[1:3], want[1:3]):
        assert abs(g - w) <= count_rel * w + count_abs, (g, w)
    assert got[3] == want[3], ("pool iterations", got[3], want[3])


@pytest.mark.parametrize("motion, schedule", [
    (True, "pixel_major"), (False, "sorted"), (True, "sorted"),
    (False, "sample_major"), (True, "sample_major")],
    ids=["2key-pixel_major", "static-sorted", "2key-sorted",
         "static-sample_major", "2key-sample_major"])
def test_fused_schedules_match_reference(motion, schedule):
    """(The static pixel-major pool is test_torch_render.py
    test_render_matches_reference_fused_pipeline.)"""
    js, ts, jcam, tcam = moving_cornell_pair() if motion else cornell_pair()
    kw = dict(KW, **SCHEDULES[schedule])
    _, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, shade.FusedPipeline) and pipe.motion == motion
    j_pipe = make_fused_pipeline(js, JConfig(**kw), interpret=True)
    got, want = _subframe(js, j_pipe, ts, tcam, kw)
    _assert_match(got, want, 2e-3, 0.01, 8)


def test_stashless_fused_pool_renders_the_stash_image():
    """pool_stash=0 on the pixel-major fused pool: the in-kernel refill
    always stashes, so the image and the ray counts equal the stash
    render's bit for bit (tests/test_fused.py:247-264), and the reference
    renders the same image."""
    js, ts, jcam, tcam = cornell_pair()
    out = {}
    for stash in (0, 1):
        f, s = render_frame(ts, tcam.params(),
                            RenderConfig(**KW, pool_stash=stash),
                            device="cpu")
        out[stash] = (f.accum.numpy(), int(s.radiance_rays),
                      int(s.shadow_rays))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    kw = dict(KW, pool_stash=0)
    got, want = _subframe(js, make_fused_pipeline(js, JConfig(**kw),
                                                  interpret=True),
                          ts, tcam, kw)
    _assert_match(got, want, 2e-3, 0.01, 8)


@pytest.fixture(scope="module")
def towns(tmp_path_factory):
    """{two_key: (reference scene, port scene, camera)}: the 4294-face
    town."""
    out = {}
    for two_key in (False, True):
        j_scene, _ = j_town_scene(4000, two_key, tmp_path_factory.mktemp(
            f"town{int(two_key)}"))
        ts, cam = town_scene(4000, two_key)
        out[two_key] = (j_scene, ts, cam)
    return out


@pytest.mark.parametrize("schedule", ["sorted", "sample_major"])
@pytest.mark.parametrize("two_key", [False, True], ids=["static", "2key"])
def test_external_schedules_match_reference(towns, two_key, schedule):
    j_scene, ts, cam = towns[two_key]
    kw = dict(KW, **SCHEDULES[schedule])
    j_scene, j_pipe = j_choose_tracer(j_scene, JConfig(**kw), on_tpu=True)
    assert type(j_pipe).__name__ == "ExternalPipeline"
    _, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, shade.ExternalPipeline)
    got, want = _subframe(j_scene, j_pipe, ts, cam, kw)
    _assert_match(got, want, 5e-3, 0.02, 16)


def test_sort_rays_renders_the_unsorted_image():
    """The sort only reorders lanes and every pixel's sample streams are
    keyed by pixel and sample, so on the 2-key Cornell box the sorted pool
    (K5 in the XLA-refill loop) renders the unsorted pool's image (the
    refill megakernel) up to float order."""
    _, ts, _, tcam = moving_cornell_pair()
    images = [render_frame(ts, tcam.params(), RenderConfig(**dict(
        KW, **SCHEDULES[s])), device="cpu")[0].accum.numpy()
        for s in ("sorted", "pixel_major")]
    np.testing.assert_allclose(images[0], images[1], rtol=1e-5, atol=1e-6)


def test_sample_major_extra_window_iterations_change_nothing():
    """The sample-major loop reads its condition once per window of
    flush_every iterations; the iterations past its end must leave the
    image and the counts as a window of 1 leaves them."""
    _, ts, _, tcam = cornell_pair()
    outs = []
    for fe in (1, 64):
        cfg = RenderConfig(**dict(KW, **SCHEDULES["sample_major"]),
                           flush_every=fe)
        step = make_render_fn(ts, cfg, device="cpu")
        f, s = step(tcam.params(), film_create(16, 16, device="cpu"))
        outs.append((f.accum.numpy(), int(s.radiance_rays),
                     int(s.shadow_rays), int(s.pool_iters)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1:] == outs[1][1:]
