"""K5's plain version (trace_shade_ref, behind FusedPipeline.trace_shade)
and the ray sort against the reference.

K5 is teacher-forced against the reference's merged megakernel
(make_fused_shader(merged=True) `trace_shade`, Pallas interpret mode) for 8
iterations at pool 512 on the static and the 2-key Cornell box (and its
textured variant on the textured quad with CLAMP/MIRROR, a uv transform
and a normal map, and on the 2-key quad with a normal map): both get
the same lanes at every step (the reference's output of the step before,
dead lanes restarted as fresh camera paths, random times for motion), with
the live count alternating between the whole pool and 300 lanes (the
second 256-ray tile then holds live and skipped lanes). The closest hits
are exact against the reference's closest kernel; the integer columns
(seed bits, depth, alive, pixel, sample, want_shadow) exact and the float
columns within rtol = atol = 3e-5, each on at least 98% of the lanes that
were alive (last-ulp differences of sqrt/cos between XLA and torch may
flip one lane's Russian roulette).

The sort: `morton3d` bit-equal to the reference's on 1e5 points, and the
sort key and its stable permutation equal to the reference's on a pool
state recorded from a render, where the dead lanes and the lanes that
share the camera's origin tie."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.morton import morton3d as j_morton3d
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.pallas_shade import (make_fused_pipeline,
                                                make_fused_shader)
from rendertoy3c_tpu_torch.accel.morton import morton3d
from rendertoy3c_tpu_torch.integrate import path
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.trace import shade
from torch_port_util import (cornell_pair, moving_cornell_pair,
                             textured_quad_pair)

CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=512, integrator="pool", pool_pixel_major=True)
POOL = 512
INT_COLS = [0, 8, 9, 13, 14, 15]  # seed bits, depth, alive, pixel, samp, shadow
FLOAT_COLS = [c for c in range(16) if c not in INT_COLS]


def _fresh_lanes(cam, n, rng):
    """A first-bounce pool state: camera rays, fresh paths, random seeds,
    90% of the lanes alive."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = p.eye
    rays[:, 3:6] = d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((n, 16), np.float32)
    misc[:, 0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[:, 1:7] = 1.0
    misc[:, 9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[:, 13] = np.arange(n)
    misc[:, 14] = 1.0
    return rays, misc


def _lanes_agree(got, want, cols, exact):
    if exact:
        ok = got[:, cols].view(np.uint32) == want[:, cols].view(np.uint32)
    else:
        ok = np.isclose(got[:, cols], want[:, cols], rtol=3e-5, atol=3e-5)
    return ok.all(axis=1)


@pytest.mark.parametrize("motion", [False, True])
def test_trace_shade_ref_matches_reference_kernel(motion):
    _teacher_force(motion, moving_cornell_pair() if motion
                   else cornell_pair())


@pytest.mark.parametrize("variant, motion", [("features", False),
                                             ("normal_map", True)])
def test_textured_trace_shade_ref_matches_reference_kernel(variant, motion):
    """Textured K5 on the textured quad, as the Cornell test above."""
    _teacher_force(motion, textured_quad_pair(variant, motion))


def _teacher_force(motion, scenes, cfg=CFG):
    js, ts, jcam, tcam = scenes
    j_pipe = make_fused_pipeline(js, JConfig(**cfg), interpret=True)
    j_shade = make_fused_shader(js, JConfig(**cfg), j_pipe.soup,
                                j_pipe.soup1 if motion else None,
                                interpret=True, merged=True)
    pipe = shade.FusedPipeline(ts, RenderConfig(**cfg), "cpu")
    assert pipe.motion == motion and j_pipe.motion == motion
    rng = np.random.default_rng(31 + int(motion))
    rays, misc = _fresh_lanes(tcam, POOL, rng)
    deepest = 0
    for step in range(8):
        count = POOL if step % 2 == 0 else 300
        tm = rng.uniform(0, 1, POOL).astype(np.float32)
        time8 = jnp.asarray(np.repeat(tm[:, None], 8, axis=1)) if motion \
            else None
        want = [np.asarray(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(misc), count, time8)]
        c = torch.tensor([count], dtype=torch.int32)
        got = [x.numpy() for x in pipe.trace_shade(
            torch.as_tensor(rays), torch.as_tensor(misc), c,
            torch.as_tensor(tm))]
        if count == POOL:  # the closest sweep, prims exact
            j_hit = np.asarray(j_pipe.closest_raw(
                jnp.asarray(rays), count,
                jnp.asarray(tm[:, None]) if motion else None))
            hit = shade._plain_sweeps(pipe.tables, c, torch.as_tensor(tm))[0](
                torch.as_tensor(rays)).numpy()
            np.testing.assert_array_equal(hit[:, 1], j_hit[:, 1])
            np.testing.assert_allclose(hit, j_hit, rtol=1e-5, atol=1e-5)
        alive = misc[:, 9] > 0
        ok_int = _lanes_agree(got[1], want[1], INT_COLS, exact=True)
        ok_float = (_lanes_agree(got[1], want[1], FLOAT_COLS, exact=False)
                    & _lanes_agree(got[0], want[0], list(range(8)), False))
        assert ok_int[alive].mean() >= 0.98, step
        assert ok_float[alive].mean() >= 0.98, step
        rays, misc = want[0].copy(), want[1].copy()
        deepest = max(deepest, int(misc[:, 8].max()))
        dead = misc[:, 9] <= 0
        fresh = _fresh_lanes(tcam, POOL, rng)
        rays[dead], misc[dead] = fresh[0][dead], fresh[1][dead]
    assert deepest >= 3  # paths went several bounces deep


def test_morton3d_matches_reference():
    pts = np.random.default_rng(5).uniform(-0.2, 1.2, (100_000, 3)).astype(
        np.float32)
    got = morton3d(torch.as_tensor(pts)).numpy()
    want = np.asarray(j_morton3d(jnp.asarray(pts)))
    assert got.dtype == np.int64 and (got >= 0).all()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert (got < 2**30).all() and (got.astype(np.uint32) == want).all()


def _j_sort(js, rays, alive):
    """path.py:1067-1071 and :1250-1258 of the reference, on numpy
    inputs: (key uint32 [P], order [P])."""
    v0s = js.geom.v0[0][: js.num_faces]
    sort_lo = jnp.min(v0s, axis=0)
    s_hi = jnp.max(v0s, axis=0)
    sort_inv = 1.0 / jnp.maximum(s_hi - sort_lo, 1e-6)
    rays = jnp.asarray(rays)
    oct_key = ((rays[:, 3] >= 0).astype(jnp.uint32)
               + 2 * (rays[:, 4] >= 0).astype(jnp.uint32)
               + 4 * (rays[:, 5] >= 0).astype(jnp.uint32))
    om = j_morton3d((rays[:, 0:3] - sort_lo) * sort_inv)
    key = (oct_key << jnp.uint32(27)) | (om >> jnp.uint32(3))
    key = jnp.where(jnp.asarray(alive), key, jnp.uint32(0xFFFFFFFF))
    return np.asarray(key), np.asarray(jnp.argsort(key))


def test_sort_key_and_stable_order_match_reference():
    """On the state entering trace_shade at iteration 3 of a sample-major
    render: many lanes are dead and many live ones share an origin."""
    js, ts, _, tcam = cornell_pair()
    cfg = RenderConfig(**dict(CFG, pool_pixel_major=False))
    pipe = shade.FusedPipeline(ts, cfg, "cpu")
    seen = []

    def record(rays, misc, count, time=None):
        seen.append((rays.clone(), misc.clone()))
        return shade.trace_shade(rays, misc, count, pipe.tables, pipe.config)

    pipe.trace_shade = record
    path.render_frame(ts, tcam.params(), cfg, tracer=pipe, device="cpu")
    rays, misc = seen[3]
    alive = misc[:, 9] > 0
    assert 0 < int(alive.sum()) < POOL
    lo, inv = (torch.as_tensor(x) for x in path.sort_box(ts))
    key = path.sort_key(rays, alive, lo, inv)
    order = torch.argsort(key, stable=True).numpy()
    j_key, j_order = _j_sort(js, rays.numpy(), alive.numpy())
    np.testing.assert_array_equal(key.numpy(), j_key.astype(np.int64))
    assert len(np.unique(j_key)) < POOL // 2  # ties the order must keep
    np.testing.assert_array_equal(order, j_order)
