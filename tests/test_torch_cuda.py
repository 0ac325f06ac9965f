"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the reference package, so it runs on a GPU machine without
them (conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.scene.builtin import box_mesh, cornell_box
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import mt, shade

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda:0")


def _box_grid_scene(n=8):
    rng = np.random.default_rng(7)
    white = Material(diffuse=(0.7, 0.7, 0.7))
    v_all, f_all, off = [], [], 0
    for gx in range(n):
        for gz in range(n):
            m = box_mesh([gx, 0, gz],
                         [gx + 0.8, rng.uniform(0.3, 2.0), gz + 0.8], white)
            v_all.append(m.vertices[0])
            f_all.append(m.indices + off)
            off += m.vertices.shape[1]
    return build_scene([Mesh(vertices=np.concatenate(v_all)[None],
                             indices=np.concatenate(f_all), material=white)])


def _rays(n, seed, lo, hi, down=False):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    if down:
        d[:, 1] = -np.abs(d[:, 1])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("scene_name", ["cornell", "box_grid"])
def test_mt_kernels_match_plain_versions(dev, scene_name):
    """Cornell: one 128-wide tile; box grid: two 512-wide tiles, culled."""
    if scene_name == "cornell":
        scene = build_scene(cornell_box()[0])
        o, d = _rays(8192, 0, (-0.9, 0.05, -0.9), (0.9, 1.9, 0.9))
    else:
        scene = _box_grid_scene()
        o, d = _rays(8192, 3, (0, 3, 0), (8, 6, 8), down=True)
    soup = mt.build_tri_soup(scene.geom, dev, num_faces=scene.num_faces)
    rays, r = mt.pack_rays(torch.as_tensor(o, device=dev),
                           torch.as_tensor(d, device=dev), 0.01, 2.5)
    for count in (r, r - 300):
        c = torch.tensor([count], dtype=torch.int32, device=dev)
        for kern, ref, col in ((mt.mt_closest, mt.closest_ref, 1),
                               (mt.mt_any, mt.any_ref, 0)):
            got = kern(rays, c, soup).cpu().numpy()
            want = ref(rays, c, soup).cpu().numpy()
            np.testing.assert_array_equal(got[:, col], want[:, col])
            np.testing.assert_allclose(got, want, **TOL)


def test_refill_kernel_matches_plain_version_on_one_block(dev):
    """Teacher-forced for 8 launches from the plain version's states: on one
    256-lane block pixel claims are deterministic, so lanes must agree."""
    scene = build_scene(cornell_box()[0])
    cfg = RenderConfig(width=64, height=64, samples_per_launch=4,
                       max_depth=8, ray_block=256, integrator="pool",
                       pool_pixel_major=True)
    p = cornell_box()[1].params()
    scf = tuple(float(x) for x in np.concatenate(
        [p.eye, p.u, p.v, p.w]).astype(np.float32))
    kern = shade.FusedPipeline(scene, cfg, dev).refill_shader(4096, True)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096,
                                                                     True)
    state = [torch.zeros((256, w), dtype=torch.float32, device=dev)
             for w in (8, 16, 16)]
    state[1][:, 13] = -1.0
    state[2][:, 0] = -1.0
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(8):
        outs = []
        for fn in (kern, ref):
            out = [x.clone() for x in state]
            st = torch.zeros(4, dtype=torch.int32, device=dev)
            fn(*out, stats, st, 0, 2, scf)
            outs.append((out, st))
        (got, st_k), (want, st_r) = outs
        assert torch.equal(st_k, st_r)
        for g, w in zip(got, want):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            same = np.isclose(g, w, rtol=1e-5, atol=1e-5).all(axis=1)
            assert same.mean() >= 0.99
        np.testing.assert_array_equal(
            got[1][:, 0].cpu().numpy().view(np.uint32),
            want[1][:, 0].cpu().numpy().view(np.uint32))
        state, stats = want, st_r


def test_kernels_pass_gate_against_plain_versions(dev):
    """bench.py:115-116 at 96^2, 2 spp, max_depth 6, ray_block 4096."""
    meshes, camera = cornell_box()
    scene = build_scene(meshes)
    cfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=True)
    images = []
    for fn in (shade.trace_shade_refill, shade.trace_shade_refill_ref):
        pipe = shade.FusedPipeline(scene, cfg, dev, refill_fn=fn)
        f, _ = render_frame(scene, camera.params(), cfg, tracer=pipe,
                            device=dev)
        images.append(f.accum.cpu().numpy())
    diff = np.abs(images[0] - images[1])
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0


@pytest.fixture(scope="module")
def towns():
    """(static, 2-key) town scenes of 4294 faces, loaded from .obj files."""
    from rendertoy3c_tpu_torch.scene.town import town_scene

    return town_scene(4000, False), town_scene(4000, True)


def _town_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-20, 0.2, -20), (20, 8, 20), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rng.uniform(0, 1, n).astype(np.float32)


def test_motion_kernels_match_plain_versions_and_brute(dev, towns):
    """K3 on the 2-key town: exact prims and occlusion, t/u/v within 1e-6,
    and the count skip at 128-ray granularity."""
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    scene = towns[1][0]
    msoup = mt.build_motion_soup(scene.geom, dev, num_faces=scene.num_faces)
    o, d, tm = (torch.as_tensor(x, device=dev) for x in _town_rays(8192, 4))
    rays, r = mt.pack_rays(o, d, 0.01, 30.0, mt.MOTION_RAY_TILE)
    for count in (r, r - 200):  # 128- and 256-ray tiles end apart
        c = torch.tensor([count], dtype=torch.int32, device=dev)
        for kern, ref, col in ((mt.mt_closest_motion, mt.closest_motion_ref,
                                1),
                               (mt.mt_any_motion, mt.any_motion_ref, 0)):
            got = kern(rays, tm, c, msoup).cpu().numpy()
            want = ref(rays, tm, c, msoup).cpu().numpy()
            np.testing.assert_array_equal(got[:, col], want[:, col])
            np.testing.assert_allclose(got, want, **TOL)
            tail = -(-count // 128) * 128
            assert (got[tail:, 1] == (-1.0 if col == 1 else 0.0)).all()
    hit = mt.trace_closest_mt_motion(msoup, o, d, 0.01, 30.0, tm)
    brute = trace_closest_bruteforce(scene, o, d, 0.01, 30.0, tm)
    assert torch.equal(hit.prim, brute.prim)
    np.testing.assert_allclose(hit.t.cpu().numpy(), brute.t.cpu().numpy(),
                               **TOL)
    assert torch.equal(mt.trace_any_mt_motion(msoup, o, d, 0.01, 3.0, tm),
                       trace_any_bruteforce(scene, o, d, 0.01, 3.0, tm))


def _lane_state(scene, cam, n, seed, dev):
    """A first-bounce pool state: camera rays, fresh paths, random seeds."""
    rng = np.random.default_rng(seed)
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
    return (torch.as_tensor(rays, device=dev),
            torch.as_tensor(misc, device=dev))


@pytest.mark.parametrize("motion", [False, True])
def test_external_shade_matches_plain_version(dev, towns, motion):
    """K6 teacher-forced for 8 iterations from the plain pipeline's states:
    every output bit for bit."""
    scene, cam = towns[int(motion)]
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=True)
    pipe = shade.ExternalPipeline(scene, cfg,
                                  mt.make_mt_tracer(scene, dev, plain=True),
                                  dev, shade_fn=shade.external_shade_ref)
    rays, misc = _lane_state(scene, cam, 4096, 5 + int(motion), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    count = torch.tensor([4096], dtype=torch.int32, device=dev)
    for _ in range(8):
        time = torch.rand(4096, device=dev, generator=gen) if motion else None
        hit = pipe._closest(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                            rays[:, 7], time, count)
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        got = shade.external_shade(rays, hit4, misc, pipe.tables,
                                   pipe.config)
        want = shade.external_shade_ref(rays, hit4, misc, pipe.tables,
                                        pipe.config)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = pipe.trace_shade(rays, misc, count, time)
    assert (misc[:, 8] > 2).any()  # paths went several bounces deep


@pytest.mark.parametrize("motion", [False, True])
def test_external_pipeline_passes_gate(dev, towns, motion):
    """bench.py:115-116, kernels against plain versions, on the town."""
    scene, cam = towns[int(motion)]
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=True)
    images = []
    for plain in (False, True):
        from rendertoy3c_tpu_torch.trace.auto import choose_tracer

        s2, pipe = choose_tracer(scene, cfg, dev)
        if plain:
            pipe = shade.ExternalPipeline(
                s2, cfg, mt.make_mt_tracer(s2, dev, plain=True), dev,
                shade_fn=shade.external_shade_ref)
        f, _ = render_frame(s2, cam.params(), cfg, tracer=pipe, device=dev)
        images.append(f.accum.cpu().numpy())
    diff = np.abs(images[0] - images[1])
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0
