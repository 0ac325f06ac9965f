"""K6 with C-major misc (transposed=True, the walk pool's layout) against
the reference's make_external_shader(transposed=True) in interpret mode.

Teacher-forced for 4 iterations at 512 lanes on the variants the walk pool
reaches: untextured (Cornell), textured (the textured quad), the material
dispatch with the power pick (the Cornell box with all four material
types) and AOV (Cornell, misc 24 in, 32 out). Both get the same rays,
closest hits (the port's brute tracer) and C-major misc; lanes that died
restart as fresh camera paths. Every output is compared by the rule of
tests/k6_agree_util.py: the integer columns bit-equal on every lane, the
light-pick and roulette draws pinned to the seed's LCG stream, the
decisions equal off their edges, and every float of every live lane
within 1e-6 times the lane's amplification of a last-ulp difference. The
outputs' shapes and the C-major misc_out layout exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.pallas_shade import make_external_shader
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.walkpool import make_walkpool_pipeline
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.intersect import trace_closest_bruteforce
from k6_agree_util import check_iteration
from torch_port_util import (cornell_pair, material_cornell_pair,
                             textured_quad_pair)

POOL = 512


def _scenes(variant):
    if variant == "textured":
        return textured_quad_pair()
    if variant == "dispatch_power":
        return material_cornell_pair()
    return cornell_pair()


def _fresh(cam, n, rng, mw):
    """Camera rays, fresh paths (random seeds), 90% of the lanes alive;
    misc C-major [mw, n], the AOV accs random."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3], rays[:, 3:6] = p.eye, d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((mw, n), np.float32)
    misc[0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[1:7] = 1.0
    misc[9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[13] = np.arange(n)
    misc[14] = 1.0
    misc[16:] = rng.uniform(0, 1, (mw - 16, n))
    return rays, misc


@pytest.mark.parametrize("variant", ["untextured", "textured",
                                     "dispatch_power", "aov"])
def test_transposed_external_shade_ref_matches_reference(variant):
    js, ts, _, cam = _scenes(variant)
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=POOL, integrator="pool", pool_pixel_major=True,
              aov=variant == "aov",
              light_sampler="power" if variant == "dispatch_power"
              else "uniform")
    js = j_split_order(js, leaf=14)
    ts = split_order_scene(ts, leaf=14)
    pipe = make_walkpool_pipeline(ts, RenderConfig(**kw), "cpu")
    assert (pipe.shade_tables.tex is not None) == (variant == "textured")
    assert (pipe.shade_tables.params_base > 0) == (variant == "dispatch_power")
    j_shade, attr_rows, presample = make_external_shader(
        js, JConfig(**kw), motion=False, interpret=True, transposed=True)
    attr_rows = np.asarray(attr_rows)
    np.testing.assert_array_equal(pipe.shade_tables.attr.numpy(), attr_rows)
    mw = pipe.misc_w
    rng = np.random.default_rng(23)
    rays, misc = _fresh(cam, POOL, rng, mw)
    for _ in range(4):
        rt = torch.as_tensor(rays)
        hit = trace_closest_bruteforce(ts, rt[:, 0:3], rt[:, 3:6], rt[:, 6],
                                       rt[:, 7])
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        hit8 = np.concatenate([hit4.numpy(), np.zeros((POOL, 4), np.float32)],
                              axis=1)
        attr_g = attr_rows[np.maximum(hit.prim.numpy(), 0)]
        if presample is not None:  # the texel rows ride the gathered block
            attr_g = np.concatenate([attr_g, np.asarray(presample(
                jnp.asarray(attr_g), jnp.asarray(hit.u.numpy()),
                jnp.asarray(hit.v.numpy())))], axis=1)
        want = [np.array(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(hit8), jnp.asarray(misc),
            jnp.asarray(attr_g.T), POOL)]
        got = [x.numpy() for x in shade.external_shade_ref(
            rt, hit4, torch.as_tensor(misc), pipe.shade_tables,
            pipe.shade_config, transposed=True)]
        assert [g.shape for g in got] == [w.shape for w in want]
        assert got[1].shape == (mw + 8, POOL)
        check_iteration(rays, hit4.numpy(), misc, got, want,
                        pipe.shade_tables, pipe.shade_config,
                        transposed=True)
        # the next state: the reference's, with its NEE added on every
        # lane that wanted a shadow ray (no occluder in this forcing)
        rays = want[0]
        misc = want[1][:mw].copy()
        misc[10:13] += want[1][mw:mw + 3]
        dead = misc[9] <= 0
        fresh = _fresh(cam, POOL, rng, mw)
        rays[dead], misc[:, dead] = fresh[0][dead], fresh[1][:, dead]
