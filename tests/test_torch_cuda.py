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
