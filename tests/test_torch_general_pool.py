"""The general pool of the port (integrate/path.py `_render_pool`) over
the brute tracer against the reference's `_render_pool` over its brute
tracer, at 24^2, 2 spp: the Cornell box, the material Cornell box (all
four material types) and the 2-key Cornell box, pixel-major, sample-major
and sorted, with AOV.

Images by bench.py's gate (:115-116: mean|d| <= 2e-3, at most 8 pixels
above 0.35, max|d| <= 8). The radiance and shadow ray counts are not
equal: they differ by up to 3 and 10 rays of ~3150 and ~2400 (the plain
Cornell box), and the test holds them within MAX_RAY_DIFF. The cause is
XLA's CPU backend, which contracts a + b * c into fused multiply-adds:
the reference's hit point org + t * d then rounds once in x and y where
the port's rounds twice (test_reference_hit_point_is_fused). A ceiling point at
y = 1.99 becomes 1.9899999, its light direction leaves the ceiling's
plane, and the facing test n.l > 0 and the shadow ray flip; at a seam
(a block on the floor) the next hit is another face. Teacher-forcing the
reference's rsqrt, sin, cos, sqrt, exp and log into the port leaves the
counts apart (worst 9); an FMA hit point alone takes the worst case from
10 to 4 rays; the other contractions (the brute tracer's, the shading's
dot products) hold the rest. At max_depth = 1, where no bounce follows,
the radiance counts are equal, the shadow counts within 2, and every
pixel agrees at rtol = atol = 1e-5, the AOV guides likewise."""
import dataclasses

import numpy as np
import pytest

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace.intersect import \
    make_bruteforce_tracer as j_brute
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from torch_port_util import (cornell_pair, material_cornell_pair,
                             moving_cornell_pair)

KW = dict(width=24, height=24, samples_per_launch=2, max_depth=6,
          ray_block=4096, integrator="pool")
SCHEDULES = {
    "pixel_major": dict(pool_pixel_major=True),
    "sample_major": dict(pool_pixel_major=False),
    "sorted": dict(pool_pixel_major=True, sort_rays=True),
    "sorted_sample_major_aov": dict(pool_pixel_major=False, sort_rays=True,
                                    aov=True),
    "pixel_major_aov": dict(pool_pixel_major=True, aov=True),
}
# the most the ray counts may differ from the reference's: 10 observed
MAX_RAY_DIFF = 12
SCENES = {"cornell": cornell_pair, "material": material_cornell_pair,
          "two_key": moving_cornell_pair}


def gate(a, b):
    d = np.abs(a - b)
    return d.mean() <= 2e-3 and (d.max(-1) > 0.35).sum() <= 8 and \
        d.max() <= 8.0


def _pair(scene, kw, subframes=1):
    js, ts, jcam, tcam = SCENES[scene]()
    f_ref, s_ref = j_render_frame(js, jcam.params(), JConfig(**kw),
                                  subframes=subframes, tracer=j_brute(js))
    f, s = render_frame(ts, tcam.params(), RenderConfig(**kw),
                        subframes=subframes,
                        tracer=make_bruteforce_tracer(ts), device="cpu")
    return f, s, f_ref, s_ref


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_pool_matches_reference(scene, schedule):
    kw = dict(KW, **SCHEDULES[schedule])
    f, s, f_ref, s_ref = _pair(scene, kw)
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert gate(a, b), (np.abs(a - b).mean(), np.abs(a - b).max())
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= MAX_RAY_DIFF
    if kw.get("aov"):
        for name in ("albedo", "normal"):
            np.testing.assert_allclose(getattr(f, name).numpy(),
                                       np.asarray(getattr(f_ref, name)),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scene", ["cornell", "material"])
def test_pool_depth_one_is_tight(scene):
    """max_depth = 1: one segment per path, no draw past the shading
    decides anything: every pixel within 1e-5."""
    kw = dict(KW, max_depth=1, pool_pixel_major=False, aov=True)
    f, s, f_ref, s_ref = _pair(scene, kw, subframes=2)
    for name in ("accum", "albedo", "normal"):
        np.testing.assert_allclose(getattr(f, name).numpy(),
                                   np.asarray(getattr(f_ref, name)),
                                   rtol=1e-5, atol=1e-5)
    assert int(s.radiance_rays) == int(s_ref.radiance_rays) == 2 * 24 * 24 \
        * 2
    assert abs(int(s.shadow_rays) - int(s_ref.shadow_rays)) <= 2


def test_pool_ray_block_not_multiple_of_256():
    """A ray_block that is not a multiple of 256 routes to the bare MT
    tracer under the general pool (the reference's auto.py:154-156),
    which renders like the reference's general pool."""
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    js, ts, jcam, tcam = cornell_pair()
    kw = dict(KW, ray_block=1000, pool_pixel_major=True)
    _, tracer = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(tracer, tuple)
    f_ref, _ = j_render_frame(js, jcam.params(), JConfig(**kw), subframes=1,
                              tracer=j_brute(js))
    f, _ = render_frame(ts, tcam.params(), RenderConfig(**kw), device="cpu")
    assert gate(f.accum.numpy(), np.asarray(f_ref.accum))


def test_pool_without_lights():
    """A scene without lights (A7): the bare tracer, no shadow rays, the
    ambient and the emission seen directly, as the reference."""
    from torch_port_util import to_port_scene

    js, _, jcam, tcam = cornell_pair()
    js = dataclasses.replace(js, num_lights=0)
    ts = to_port_scene(js)
    kw = dict(KW, pool_pixel_major=True)
    f_ref, s_ref = j_render_frame(js, jcam.params(), JConfig(**kw),
                                  subframes=1, tracer=j_brute(js))
    f, s = render_frame(ts, tcam.params(), RenderConfig(**kw), device="cpu")
    assert int(s.shadow_rays) == int(s_ref.shadow_rays) == 0
    assert gate(f.accum.numpy(), np.asarray(f_ref.accum))


def test_reference_hit_point_is_fused():
    """XLA's CPU backend evaluates the reference's hit point org + t * d
    (integrate/path.py:164) with fused multiply-adds in x and y (z, the
    last of the three columns, rounds the product first): bit-equal to
    torch.addcmul there, not to the port's product-then-sum, on seeded
    inputs."""
    import jax
    import torch

    rng = np.random.default_rng(9)
    org = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    t = rng.uniform(0, 4, 4096).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda o, t, d: o + t[:, None] * d)(org, t, d))
    o_t, t_t, d_t = (torch.from_numpy(x) for x in (org, t, d))
    fused = torch.addcmul(o_t, t_t[:, None], d_t).numpy()
    port = (o_t + t_t[:, None] * d_t).numpy()
    np.testing.assert_array_equal(want[:, :2], fused[:, :2])
    np.testing.assert_array_equal(want[:, 2], port[:, 2])
    assert (want[:, :2] != port[:, :2]).any()
