"""The non-merged K5 (trace/shade.py `make_fused_shader`, the
reference's make_fused_shader(merged=False); its plain version
`trace_shade_hit_ref`) and `FusedPipeline.closest_raw` against the
reference's, and the split pipeline against the merged one.

The non-merged K5 is teacher-forced against the reference's
make_fused_shader(merged=False) `shade` (Pallas interpret mode) for 8
launches at pool 512, both given the same closest hits (the reference's
closest_raw of the step's rays) and the same lanes at every step, as
tests/test_torch_trace_shade.py does for the merged K5: static and 2-key
Cornell, the textured quad (CLAMP/MIRROR, a uv transform, a normal map)
and its 2-key normal-mapped form, the material Cornell box with the power
pick (the dispatch), and the Cornell box with AOV; the live count
alternates between the pool and 300 lanes. Integer columns exact and
float columns within rtol = atol = 3e-5 on at least 98% of the live
lanes, as there. closest_raw: prims exact against the reference's, t, u,
v within 1e-5. On the CPU, closest_raw followed by the non-merged K5 is
bit-equal to the merged K5 on the same inputs, and a render through a
pipeline split so (`SplitPipeline`) bit-equal to the merged pipeline's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.pallas_shade import (make_fused_pipeline,
                                                make_fused_shader as
                                                j_make_fused_shader)
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.trace import shade
from split_util import SplitPipeline
from test_torch_trace_shade import (INT_COLS, POOL, _fresh_lanes,
                                    _lanes_agree)
from torch_port_util import (cornell_pair, material_cornell_pair,
                             moving_cornell_pair, textured_quad_pair)

CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=512, integrator="pool", pool_pixel_major=True)
CASES = {
    "cornell": (cornell_pair, {}),
    "two_key": (moving_cornell_pair, {}),
    "textured": (lambda: textured_quad_pair("features"), {}),
    "two_key_normal_map": (lambda: textured_quad_pair("normal_map", True),
                           {}),
    "dispatch_power": (material_cornell_pair,
                       dict(light_sampler="power")),
    "aov": (cornell_pair, dict(aov=True)),
}


def _widen(misc, aov, rng):
    if not aov:
        return misc
    out = np.zeros((misc.shape[0], 24), np.float32)
    out[:, :16] = misc
    out[:, 16:22] = rng.uniform(-1, 1, (misc.shape[0], 6))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_non_merged_k5_matches_reference_kernel(case):
    make, change = CASES[case]
    js, ts, jcam, tcam = make()
    cfg = dict(CFG, **change)
    aov = bool(change.get("aov"))
    j_pipe = make_fused_pipeline(js, JConfig(**cfg), interpret=True)
    motion = j_pipe.motion
    j_shade = j_make_fused_shader(js, JConfig(**cfg), j_pipe.soup,
                                  j_pipe.soup1 if motion else None,
                                  interpret=True, merged=False)
    pipe = shade.FusedPipeline(ts, RenderConfig(**cfg), "cpu")
    soup1 = (shade.build_tri_soup(ts.geom, "cpu", key=1,
                                  num_faces=ts.num_faces) if motion else None)
    shade_hit = shade.make_fused_shader(ts, RenderConfig(**cfg), pipe.soup,
                                        soup1)
    rng = np.random.default_rng(53 + len(case))
    rays, misc = _fresh_lanes(tcam, POOL, rng)
    misc = _widen(misc, aov, rng)
    float_cols = [c for c in range(misc.shape[1]) if c not in INT_COLS]
    deepest = 0
    for step in range(8):
        count = POOL if step % 2 == 0 else 300
        tm = rng.uniform(0, 1, POOL).astype(np.float32)
        j_hit = j_pipe.closest_raw(jnp.asarray(rays), count,
                                   jnp.asarray(tm[:, None]) if motion
                                   else None)
        want = [np.asarray(x) for x in j_shade(
            jnp.asarray(rays), j_hit, jnp.asarray(misc), count)]
        c = torch.tensor([count], dtype=torch.int32)
        hit = pipe.closest_raw(torch.as_tensor(rays), c,
                               torch.as_tensor(tm[:, None]))
        j_hit = np.array(j_hit)
        np.testing.assert_array_equal(hit[:, 1].numpy(), j_hit[:, 1])
        np.testing.assert_allclose(hit.numpy(), j_hit, rtol=1e-5, atol=1e-5)
        got = [x.numpy() for x in shade_hit(
            torch.as_tensor(rays), torch.as_tensor(j_hit),
            torch.as_tensor(misc), c)]
        alive = misc[:, 9] > 0
        ok_int = _lanes_agree(got[1], want[1], INT_COLS, exact=True)
        ok_float = (_lanes_agree(got[1], want[1], float_cols, exact=False)
                    & _lanes_agree(got[0], want[0], list(range(8)), False))
        assert ok_int[alive].mean() >= 0.98, step
        assert ok_float[alive].mean() >= 0.98, step
        if count < POOL:
            # K3's 128-ray tiles skip lanes past the count that the merged
            # K5's 256-ray tiles sweep; the pools leave those lanes dead
            rays, misc = _next(want, tcam, rng, aov)
            continue
        # the split equals the merged K5 on the port's own hits
        merged = shade.trace_shade_ref(
            torch.as_tensor(rays), torch.as_tensor(misc), c, pipe.tables,
            pipe.config, torch.as_tensor(tm))
        unmerged = shade.trace_shade_hit_ref(
            torch.as_tensor(rays), hit, torch.as_tensor(misc), c,
            pipe.tables, pipe.config)
        for a, b in zip(unmerged, merged):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        deepest = max(deepest, int(want[1][:, 8].max()))
        rays, misc = _next(want, tcam, rng, aov)
    assert deepest >= 2  # paths went several bounces deep


def _next(want, cam, rng, aov):
    """The reference's output lanes, the dead ones restarted fresh."""
    rays, misc = want[0].copy(), want[1].copy()
    dead = misc[:, 9] <= 0
    fresh = _fresh_lanes(cam, POOL, rng)
    rays[dead] = fresh[0][dead]
    misc[dead] = _widen(fresh[1], aov, rng)[dead]
    return rays, misc


@pytest.mark.parametrize("motion", [False, True])
def test_split_pipeline_renders_as_merged(motion):
    """A sorted 16^2 render (K5's schedule) through SplitPipeline,
    closest_raw and the non-merged K5, bit-equal to the merged pipeline's,
    the ray counts equal."""
    from rendertoy3c_tpu_torch.integrate.path import render_frame

    _, ts, _, tcam = moving_cornell_pair() if motion else cornell_pair()
    cfg = RenderConfig(**dict(CFG, sort_rays=True))
    out = []
    for cls in (shade.FusedPipeline, SplitPipeline):
        pipe = cls(ts, cfg, "cpu")
        out.append(render_frame(ts, tcam.params(), cfg, subframes=1,
                                tracer=pipe, device="cpu"))
    (f_m, s_m), (f_s, s_s) = out
    assert torch.equal(f_s.accum.view(torch.int32),
                       f_m.accum.view(torch.int32))
    assert int(s_s.radiance_rays) == int(s_m.radiance_rays)
    assert int(s_s.shadow_rays) == int(s_m.shadow_rays)
