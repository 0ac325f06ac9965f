"""The walk pool's whole renders against the reference's, shared by
tests/test_torch_walk_render*.py."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_pixels as j_render_pixels
from rendertoy3c_tpu.integrate.walkpool import \
    make_walkpool_pipeline as j_make_walkpool
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_pixels
from rendertoy3c_tpu_torch.integrate.walkpool import make_walkpool_pipeline
from rendertoy3c_tpu_torch.trace.hierwalk import HIER_LEAF, HIER_LEAF_MOTION

# tests/test_walkpool.py:46-58's render, at depth 4
KW = dict(width=24, height=24, integrator="pool", pool_pixel_major=True,
          samples_per_launch=2, ray_block=1024, max_depth=4)


def render_pair(js, ts, jcam, tcam, order=True, **change):
    """(port, reference) results of render_pixels over each package's walk
    pool on its split-ordered scene (order=False: already ordered):
    (rgb [N, 3], aov, n_rad, n_shad, walk rounds) as numpy."""
    kw = dict(KW, **change)
    jcam.aspect_ratio = tcam.aspect_ratio = 1.0
    if order:
        leaf = HIER_LEAF if ts.num_keys == 1 else HIER_LEAF_MOTION
        js, ts = j_split_order(js, leaf=leaf), split_order_scene(ts, leaf=leaf)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    n = cfg.width * cfg.height
    jp = j_make_walkpool(js, jcfg)
    pix = jnp.arange(n, dtype=jnp.int32)
    ref = jax.jit(lambda c: j_render_pixels(js, jcfg, c, jp, pix,
                                            jnp.uint32(0)))(jcam.params())
    got = render_pixels(ts, cfg, tcam.params(),
                        make_walkpool_pipeline(ts, cfg, "cpu"),
                        torch.arange(n), 0)
    return _numpy(got), _numpy(ref)


def _numpy(res):
    rgb, aov, n_rad, n_shad, rounds = res
    return (np.asarray(rgb), None if aov is None else
            tuple(np.asarray(a) for a in aov), int(n_rad), int(n_shad),
            int(rounds))


def assert_match(got, want):
    """tests/test_torch_external.py's `_match` rule: >98% of pixels within
    rtol = atol = 3e-5, means within 5e-3, ray counts within 2% + 16."""
    a, b = got[0], want[0]
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=5e-3)
    assert np.isfinite(a).all() and a.mean() > 0.01
    for g, w in zip(got[2:4], want[2:4]):
        assert abs(g - w) <= 0.02 * w + 16
