"""The wave integrator of the port (integrate/path.py `_trace_block`)
against the reference's goldens (tests/goldens/*_24.npz, rendered by the
reference's wave integrator over its brute tracers, tests/test_golden.py
:20-60's config: 24^2, 2 spp, max_depth 4, ray_block 576, 2 subframes),
over the brute tracers as the goldens were made and over the bare tracers
of the port's tracer choice (the MT tracer; the instanced walk).

What holds across the two frameworks, asserted here:
  textured_24  every pixel at rtol = atol = 5e-6;
  cornell_24   all but 7 of the 576 pixels at 5e-6 (3 beyond 1e-4, max
               |d| 0.038);
  instanced_24 all but 6 pixels over the brute tracer (1 beyond 1e-4, max
               |d| 0.0024) and 8 over the walk (3 beyond 1e-4, max 0.085).
Those pixels are paths that part at depth 3 or 4, where a last-bit
difference flips a Russian-roulette draw, a light's facing test or the
face hit at a seam: XLA's CPU backend contracts a + b * c into fused
multiply-adds, the hit point among them (tests/test_torch_general_pool.py
`test_reference_hit_point_is_fused`; every pixel agrees within 3e-6 at
max_depth <= 2, and that file holds the pool at depth 1). The test
holds all but 10 pixels at 5e-6 and the rest by bench.py's gate."""
import os

import numpy as np
import pytest

from inst_util import to_port_iscene
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.scene.builtin import (cornell_box,
                                                  textured_quad_scene)
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = dict(width=24, height=24, samples_per_launch=2, max_depth=4,
           ray_block=576, integrator="wave")
TOL = dict(rtol=5e-6, atol=5e-6)
# the pixels allowed past TOL: paths parted by a last-bit difference
MAX_OFF = {"cornell_24.npz": 10, "textured_24.npz": 0,
           "instanced_24.npz": 10}


def _scene(name):
    if name == "cornell_24.npz":
        meshes, cam = cornell_box()
        return build_scene(meshes), cam
    if name == "textured_24.npz":
        meshes, textures, cam = textured_quad_scene()
        return build_scene(meshes, textures=textures), cam
    from rendertoy3c_tpu.scene.builtin import instanced_cornell
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene

    meshes, instances, cam = instanced_cornell()
    return to_port_iscene(build_instanced_scene(meshes, instances)), cam


@pytest.mark.parametrize("route", ["brute", "auto"])
@pytest.mark.parametrize("name", sorted(MAX_OFF))
def test_wave_matches_golden(name, route):
    scene, cam = _scene(name)
    cfg = RenderConfig(**CFG)
    tracer = None
    if route == "brute":
        tracer = (make_instanced_tracer(scene, "cpu")
                  if name == "instanced_24.npz"
                  else make_bruteforce_tracer(scene))
    else:
        scene, tracer = choose_tracer(scene, cfg, "cpu")
        assert isinstance(tracer, tuple)  # a bare tracer under the waves
    golden = np.load(os.path.join(GOLDEN_DIR, name))["accum"]
    film, stats = render_frame(scene, cam.params(), cfg, subframes=2,
                               tracer=tracer, device="cpu")
    got = film.accum.numpy()
    assert got.shape == golden.shape and np.isfinite(got).all()
    off = (~np.isclose(got, golden, **TOL)).any(-1)
    assert off.sum() <= MAX_OFF[name], off.sum()
    d = np.abs(got - golden)
    assert d.mean() <= 2e-3 and (d.max(-1) > 0.35).sum() <= 8
    assert d.max() <= 8.0
    assert int(stats.radiance_rays) > 2 * 2 * 24 * 24


def test_wave_aov_and_padding():
    """A frame that is not a multiple of the block (pixel -1 padding
    lanes never come alive) gives the pixels of the unpadded render; the
    AOV guides are the first-hit albedo and normal."""
    meshes, cam = cornell_box()
    scene = build_scene(meshes)
    kw = dict(CFG, width=20, height=20, aov=True)
    tracer = make_bruteforce_tracer(scene)
    f1, s1 = render_frame(scene, cam.params(), RenderConfig(**kw),
                          tracer=tracer, device="cpu")
    f2, s2 = render_frame(scene, cam.params(), RenderConfig(**dict(
        kw, ray_block=128)), tracer=tracer, device="cpu")
    for name in ("accum", "albedo", "normal"):
        np.testing.assert_array_equal(getattr(f1, name).numpy(),
                                      getattr(f2, name).numpy())
    assert int(s1.radiance_rays) == int(s2.radiance_rays)
    # unit normals, averaged over the pixel's 2 samples
    nrm = np.linalg.norm(f1.normal.numpy(), axis=-1)
    assert nrm.max() <= 1.0 + 1e-5 and np.median(nrm) > 0.999
    assert 0.1 < f1.albedo.numpy().mean() < 1.0


@pytest.mark.parametrize("motion", [False, True])
def test_wave_bare_hierwalk_tracer(motion):
    """Past 16384 faces the wave integrator takes the bare hierwalk tracer
    (make_hierwalk_tracer over the split order, the reference's auto.py
    :157-181), static or 2-key; its render equals the brute tracer's
    over the same scene pixel for pixel within 1e-5."""
    import dataclasses

    from torch_port_util import lit_grid_scene

    scene = lit_grid_scene("torch", n=38)
    if motion:
        g = scene.geom
        scene = dataclasses.replace(scene, num_keys=2, geom=g._replace(
            v0=np.concatenate([g.v0, g.v0 + np.float32([0.2, 0.0, 0.1])]),
            **{k: np.concatenate([getattr(g, k)] * 2)
               for k in ("e1", "e2", "n0", "n1", "n2")}))
    cfg = RenderConfig(**dict(CFG, width=8, height=8, samples_per_launch=1,
                              max_depth=3))
    ordered, tracer = choose_tracer(scene, cfg, "cpu")
    assert isinstance(tracer, tuple) and ordered.num_faces > 16384
    from rendertoy3c_tpu_torch.scene.camera import Camera

    cam = Camera(eye=(19.0, 14.0, 50.0), lookat=(19.0, 0.0, 19.0),
                 fov_y=45.0).params()
    f_w, s_w = render_frame(ordered, cam, cfg, tracer=tracer, device="cpu")
    f_b, s_b = render_frame(ordered, cam, cfg,
                            tracer=make_bruteforce_tracer(ordered),
                            device="cpu")
    np.testing.assert_allclose(f_w.accum.numpy(), f_b.accum.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert int(s_w.radiance_rays) == int(s_b.radiance_rays) > 64
    assert f_w.accum.numpy().mean() > 0.01
