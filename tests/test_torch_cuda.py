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
    kern = shade.FusedPipeline(scene, cfg, dev).refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)
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


def _moving_cornell():
    """The 2-key Cornell box: the last block given a second key at +0.1 in
    x (36 faces)."""
    import dataclasses

    meshes, cam = cornell_box()
    v = meshes[-1].vertices
    meshes[-1] = dataclasses.replace(
        meshes[-1], vertices=np.concatenate([v, v + np.float32([0.1, 0, 0])]))
    return build_scene(meshes), cam


def _scf(cam):
    p = cam.params()
    return tuple(float(x) for x in np.concatenate(
        [p.eye, p.u, p.v, p.w]).astype(np.float32))


def test_motion_refill_kernel_matches_plain_version_on_one_block(dev):
    """K4's motion variant teacher-forced for 8 launches on one block of
    the 2-key Cornell box: stats and the time buffer exact, seeds exact,
    lanes within 1e-5 on at least 99%."""
    scene, cam = _moving_cornell()
    cfg = RenderConfig(width=64, height=64, samples_per_launch=4,
                       max_depth=8, ray_block=256, integrator="pool",
                       pool_pixel_major=True)
    kern = shade.FusedPipeline(scene, cfg, dev).refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)
    state = [torch.zeros((256, w), dtype=torch.float32, device=dev)
             for w in (8, 16, 16)]
    state[1][:, 13] = -1.0
    state[2][:, 0] = -1.0
    time = torch.zeros(256, dtype=torch.float32, device=dev)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(8):
        outs = []
        for fn in (kern, ref):
            out = [x.clone() for x in state]
            tm = time.clone()
            st = torch.zeros(4, dtype=torch.int32, device=dev)
            fn(*out, stats, st, 0, 2, _scf(cam), tm)
            outs.append((out, st, tm))
        (got, st_k, tm_k), (want, st_r, tm_r) = outs
        assert torch.equal(st_k, st_r)
        assert torch.equal(tm_k.view(torch.int32), tm_r.view(torch.int32))
        for g, w in zip(got, want):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            same = np.isclose(g, w, rtol=1e-5, atol=1e-5).all(axis=1)
            assert same.mean() >= 0.99
        assert torch.equal(got[1][:, 0].view(torch.int32),
                           want[1][:, 0].view(torch.int32))
        state, stats, time = want, st_r, tm_r
    assert (time > 0).any()


@pytest.mark.parametrize("motion", [False, True], ids=["static", "motion"])
def test_trace_shade_kernel_matches_plain_version(dev, motion):
    """K5 teacher-forced for 8 iterations from the plain version's states,
    the live count alternating between the pool and a count inside a
    block: every output bit for bit."""
    scene, cam = (_moving_cornell() if motion
                  else (build_scene(cornell_box()[0]), cornell_box()[1]))
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    assert pipe.motion == motion
    rays, misc = _lane_state(scene, cam, 4096, 9 + int(motion), dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for it in range(8):
        count = torch.tensor([4096 if it % 2 == 0 else 3000],
                             dtype=torch.int32, device=dev)
        time = torch.rand(4096, device=dev, generator=gen) if motion else None
        got = shade.trace_shade(rays, misc, count, pipe.tables, pipe.config,
                                time)
        want = shade.trace_shade_ref(rays, misc, count, pipe.tables,
                                     pipe.config, time)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = want
        fr, fm = _lane_state(scene, cam, 4096, 20 + it, dev)
        dead = misc[:, 9] <= 0
        rays = torch.where(dead[:, None], fr, rays)
        misc = torch.where(dead[:, None], fm, misc)
    assert (misc[:, 8] > 2).any()


@pytest.mark.parametrize("case", ["motion_pixel_major", "sorted",
                                  "sample_major", "motion_sample_major"])
def test_fused_schedules_pass_gate(dev, case):
    """bench.py:115-116 at 96^2, kernels against plain versions, through
    K4's motion variant or K5; the run must launch the kernel."""
    motion = case.startswith("motion")
    scene, cam = (_moving_cornell() if motion
                  else (build_scene(cornell_box()[0]), cornell_box()[1]))
    cfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=not case.endswith("sample_major"),
                       sort_rays=case == "sorted")
    kernel = (shade.trace_shade_refill if case == "motion_pixel_major"
              else shade.trace_shade)
    images = []
    for plain in (False, True):
        pipe = shade.FusedPipeline(
            scene, cfg, dev,
            **(dict(refill_fn=shade.trace_shade_refill_ref,
                    shade_fn=shade.trace_shade_ref) if plain else {}))
        kernel.launches = 0
        f, _ = render_frame(scene, cam.params(), cfg, tracer=pipe,
                            device=dev)
        assert (kernel.launches > 0) != plain
        images.append(f.accum.cpu().numpy())
    diff = np.abs(images[0] - images[1])
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0


def _write_cornell_keys(out_dir, shifts):
    """The Cornell box as .obj keyframes with one .mtl: key k moves the
    last block by shifts[k] in x. Returns the .obj paths."""
    meshes, _ = cornell_box()
    mtl = out_dir / "cornell.mtl"
    mtl.write_text("".join(
        f"newmtl m{i}\nKd {' '.join(map(str, m.material.diffuse))}\n"
        f"Ke {' '.join(map(str, m.material.emissive))}\n"
        for i, m in enumerate(meshes)))
    paths = []
    for k, dx in enumerate(shifts):
        lines, base = ["mtllib cornell.mtl\n"], 1
        for i, m in enumerate(meshes):
            v = m.vertices[0] + (np.float32([dx, 0, 0])
                                 if i == len(meshes) - 1 else 0)
            lines += [f"v {x} {y} {z}\n" for x, y, z in v]
            lines.append(f"usemtl m{i}\n")
            lines += [f"f {a + base} {b + base} {c + base}\n"
                      for a, b, c in m.indices]
            base += len(v)
        p = out_dir / f"key{k}.obj"
        p.write_text("".join(lines))
        paths.append(str(p))
    return paths


def test_cli_renders_obj_keyframes_through_motion_refill(dev, tmp_path):
    """Two small untextured keyframe .obj files render through the refill
    megakernel's motion variant."""
    from rendertoy3c_tpu_torch.app import cli

    paths = _write_cornell_keys(tmp_path, (0.0, 0.1))
    out = tmp_path / "k.png"
    shade.trace_shade_refill.launches = 0
    assert cli.main(["--scene", *paths, "--size", "64x64", "--spp", "2",
                     "--subframes", "2", "--eye", "0,1,3.4", "--lookat",
                     "0,1,0", "--fov", "45", "--device", "cuda", "-o",
                     str(out)]) == 0
    assert shade.trace_shade_refill.launches > 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _textured_quad(variant="repeat", motion=False):
    """(scene, camera) of the textured quad's `variant` (scene/builtin.py
    textured_quad_variant)."""
    from rendertoy3c_tpu_torch.scene.builtin import textured_quad_variant

    meshes, textures, cam = textured_quad_variant(variant, motion)
    return build_scene(meshes, textures=textures), cam


@pytest.mark.parametrize("variant, motion", [
    ("repeat", False), ("clamp_mirror", False), ("uv_transform", False),
    ("normal_map", False), ("repeat", True)])
def test_textured_refill_kernel_matches_plain_version_on_one_block(
        dev, variant, motion):
    """Textured K4 (static and motion) teacher-forced for 8 launches on one
    block of the textured quad: stats exact, seeds exact, lanes within 1e-5
    on at least 99%, and the time buffer exact for motion."""
    scene, cam = _textured_quad(variant, motion)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=4,
                       max_depth=8, ray_block=256, integrator="pool",
                       pool_pixel_major=True)
    kern = shade.FusedPipeline(scene, cfg, dev)
    assert kern.tables.tex is not None and kern.motion == motion
    kern = kern.refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)
    state = [torch.zeros((256, w), dtype=torch.float32, device=dev)
             for w in (8, 16, 16)]
    state[1][:, 13] = -1.0
    state[2][:, 0] = -1.0
    time = [torch.zeros(256, dtype=torch.float32, device=dev)] if motion \
        else []
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(8):
        outs = []
        for fn in (kern, ref):
            out = [x.clone() for x in state + time]
            st = torch.zeros(4, dtype=torch.int32, device=dev)
            fn(*out[:3], stats, st, 0, 2, _scf(cam), *out[3:])
            outs.append((out, st))
        (got, st_k), (want, st_r) = outs
        assert torch.equal(st_k, st_r)
        for g, w in zip(got[:3], want[:3]):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            same = np.isclose(g, w, rtol=1e-5, atol=1e-5).all(axis=1)
            assert same.mean() >= 0.99
        assert torch.equal(got[1][:, 0].view(torch.int32),
                           want[1][:, 0].view(torch.int32))
        if motion:
            assert torch.equal(got[3].view(torch.int32),
                               want[3].view(torch.int32))
        state, time, stats = want[:3], want[3:], st_r


@pytest.mark.parametrize("variant, motion", [
    ("repeat", False), ("normal_map", False), ("uv_transform", True)])
def test_textured_trace_shade_kernel_matches_plain_version(dev, variant,
                                                           motion):
    """Textured K5 teacher-forced for 8 iterations from the plain version's
    states: every output bit for bit."""
    scene, cam = _textured_quad(variant, motion)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    rays, misc = _lane_state(scene, cam, 4096, 13, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for it in range(8):
        count = torch.tensor([4096 if it % 2 == 0 else 3000],
                             dtype=torch.int32, device=dev)
        time = torch.rand(4096, device=dev, generator=gen) if motion else None
        got = shade.trace_shade(rays, misc, count, pipe.tables, pipe.config,
                                time)
        want = shade.trace_shade_ref(rays, misc, count, pipe.tables,
                                     pipe.config, time)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = want
        fr, fm = _lane_state(scene, cam, 4096, 30 + it, dev)
        dead = misc[:, 9] <= 0
        rays = torch.where(dead[:, None], fr, rays)
        misc = torch.where(dead[:, None], fm, misc)


@pytest.fixture(scope="module")
def textured_towns():
    """(static, 2-key) textured town scenes of 4294 faces."""
    from rendertoy3c_tpu_torch.scene.town import town_scene

    return (town_scene(4000, False, textured=True),
            town_scene(4000, True, textured=True))


@pytest.mark.parametrize("motion", [False, True])
def test_textured_external_shade_matches_plain_version(dev, textured_towns,
                                                       motion):
    """Textured K6 on the textured town, teacher-forced for 8 iterations
    from the plain pipeline's states: every output bit for bit."""
    scene, cam = textured_towns[int(motion)]
    assert shade.texture_state(scene) == "diffuse"
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=True)
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    scene, _ = choose_tracer(scene, cfg, dev)
    pipe = shade.ExternalPipeline(scene, cfg,
                                  mt.make_mt_tracer(scene, dev, plain=True),
                                  dev, shade_fn=shade.external_shade_ref)
    assert pipe.tables.tex is not None
    rays, misc = _lane_state(scene, cam, 4096, 7 + int(motion), dev)
    gen = torch.Generator(device=dev).manual_seed(6)
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
    assert (misc[:, 8] > 2).any()


@pytest.mark.parametrize("variant", ["repeat", "normal_map"])
def test_textured_fused_pipeline_passes_gate(dev, variant):
    """bench.py:115-116 at 96^2 on the textured quad through textured K4;
    the run must launch the kernel."""
    scene, cam = _textured_quad(variant)
    cfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=True)
    images = []
    for plain in (False, True):
        pipe = shade.FusedPipeline(
            scene, cfg, dev, **(dict(refill_fn=shade.trace_shade_refill_ref)
                                if plain else {}))
        shade.trace_shade_refill.launches = 0
        f, _ = render_frame(scene, cam.params(), cfg, tracer=pipe,
                            device=dev)
        assert (shade.trace_shade_refill.launches > 0) != plain
        images.append(f.accum.cpu().numpy())
    diff = np.abs(images[0] - images[1])
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0


def test_cli_renders_textured_town(dev, tmp_path):
    """A textured .obj (the town's checker and brick maps) renders through
    the external pipeline's textured K6."""
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.io.genassets import generate_town

    paths, _ = generate_town(str(tmp_path), faces_target=4000)
    out = tmp_path / "town.png"
    shade.external_shade.launches = 0
    assert cli.main(["--scene", paths[0], "--size", "64x64", "--spp", "2",
                     "--subframes", "1", "--eye", "38,26,46", "--lookat",
                     "0,1.5,0", "--fov", "42", "--device", "cuda", "-o",
                     str(out)]) == 0
    assert shade.external_shade.launches > 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _dispatch_scene(name, motion=False):
    """(scene, camera): the Cornell box with all four material types
    ("material", 2-key with motion) or the principled, normal-mapped quad
    ("principled_quad")."""
    from rendertoy3c_tpu_torch.scene.builtin import (material_cornell_box,
                                                     textured_quad_variant)

    if name == "material":
        meshes, cam = material_cornell_box(motion)
        return build_scene(meshes), cam
    meshes, textures, cam = textured_quad_variant("principled", motion)
    return build_scene(meshes, textures=textures), cam


@pytest.mark.parametrize("name, motion, sampler", [
    ("material", False, "uniform"), ("material", True, "power"),
    ("principled_quad", False, "power"), ("principled_quad", True, "uniform")])
def test_dispatch_refill_kernel_matches_plain_version_on_one_block(
        dev, name, motion, sampler):
    """K4 dispatch (static, motion, textured, both) teacher-forced for 8
    launches on one block: stats, seeds (and the time buffer) exact, lanes
    within 1e-5 on at least 99%."""
    scene, cam = _dispatch_scene(name, motion)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=4,
                       max_depth=8, ray_block=256, integrator="pool",
                       pool_pixel_major=True, light_sampler=sampler)
    kern = shade.FusedPipeline(scene, cfg, dev)
    assert kern.tables.params_base > 0 and kern.motion == motion
    kern = kern.refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)
    state = [torch.zeros((256, w), dtype=torch.float32, device=dev)
             for w in (8, 16, 16)]
    state[1][:, 13] = -1.0
    state[2][:, 0] = -1.0
    time = [torch.zeros(256, dtype=torch.float32, device=dev)] if motion \
        else []
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(8):
        outs = []
        for fn in (kern, ref):
            out = [x.clone() for x in state + time]
            st = torch.zeros(4, dtype=torch.int32, device=dev)
            fn(*out[:3], stats, st, 0, 2, _scf(cam), *out[3:])
            outs.append((out, st))
        (got, st_k), (want, st_r) = outs
        assert torch.equal(st_k, st_r)
        for g, w in zip(got[:3], want[:3]):
            # equal_nan: a seed's bits may read as a NaN float
            same = torch.isclose(g, w, rtol=1e-5, atol=1e-5,
                                 equal_nan=True).all(dim=1)
            assert float(same.float().mean()) >= 0.99
        assert torch.equal(got[1][:, 0].view(torch.int32),
                           want[1][:, 0].view(torch.int32))
        if motion:
            assert torch.equal(got[3].view(torch.int32),
                               want[3].view(torch.int32))
        state, time, stats = want[:3], want[3:], st_r


@pytest.mark.parametrize("name, motion, sampler", [
    ("material", False, "power"), ("material", True, "uniform"),
    ("principled_quad", False, "power"), ("principled_quad", True, "power")])
def test_dispatch_trace_shade_kernel_matches_plain_version(dev, name, motion,
                                                           sampler):
    """K5 dispatch teacher-forced for 8 iterations from the plain version's
    states: every output bit for bit."""
    scene, cam = _dispatch_scene(name, motion)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False, light_sampler=sampler)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    assert pipe.tables.params_base > 0
    rays, misc = _lane_state(scene, cam, 4096, 17, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for it in range(8):
        count = torch.tensor([4096 if it % 2 == 0 else 3000],
                             dtype=torch.int32, device=dev)
        time = torch.rand(4096, device=dev, generator=gen) if motion else None
        got = shade.trace_shade(rays, misc, count, pipe.tables, pipe.config,
                                time)
        want = shade.trace_shade_ref(rays, misc, count, pipe.tables,
                                     pipe.config, time)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = want
        fr, fm = _lane_state(scene, cam, 4096, 40 + it, dev)
        dead = misc[:, 9] <= 0
        rays = torch.where(dead[:, None], fr, rays)
        misc = torch.where(dead[:, None], fm, misc)


@pytest.mark.parametrize("textured", [False, True])
def test_dispatch_external_shade_matches_plain_version(dev, textured):
    """K6 dispatch with the power pick on the principled town (4294
    faces), teacher-forced for 8 iterations: every output bit for bit."""
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    scene, cam = town_scene(4000, textured=textured, principled=True)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=True, light_sampler="power")
    scene, _ = choose_tracer(scene, cfg, dev)
    pipe = shade.ExternalPipeline(scene, cfg,
                                  mt.make_mt_tracer(scene, dev, plain=True),
                                  dev, shade_fn=shade.external_shade_ref)
    assert pipe.tables.params_base > 0 and pipe.config.power
    assert (pipe.tables.tex is not None) == textured
    rays, misc = _lane_state(scene, cam, 4096, 9, dev)
    count = torch.tensor([4096], dtype=torch.int32, device=dev)
    for _ in range(8):
        hit = pipe._closest(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                            rays[:, 7], None, count)
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        got = shade.external_shade(rays, hit4, misc, pipe.tables,
                                   pipe.config)
        want = shade.external_shade_ref(rays, hit4, misc, pipe.tables,
                                        pipe.config)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = pipe.trace_shade(rays, misc, count)
    assert (misc[:, 8] > 2).any()


@pytest.mark.parametrize("case", ["material_power", "principled_town"])
def test_dispatch_pipelines_pass_gate(dev, case):
    """bench.py:115-116 at 96^2, kernels against plain versions: the
    material Cornell box with the power pick (K4 dispatch) and the
    principled town, power, sorted (K1/K2 + K6 dispatch)."""
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    if case == "material_power":
        scene, cam = _dispatch_scene("material")
        change = {}
    else:
        scene, cam = town_scene(4000, textured=True, principled=True)
        change = dict(sort_rays=True)
    cfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=True, light_sampler="power", **change)
    scene, pipe = choose_tracer(scene, cfg, dev)
    plain = (shade.FusedPipeline(
        scene, cfg, dev, refill_fn=shade.trace_shade_refill_ref,
        shade_fn=shade.trace_shade_ref)
        if isinstance(pipe, shade.FusedPipeline) else shade.ExternalPipeline(
            scene, cfg, mt.make_mt_tracer(scene, dev, plain=True), dev,
            shade_fn=shade.external_shade_ref))
    images = [render_frame(scene, cam.params(), cfg, tracer=p,
                           device=dev)[0].accum.cpu().numpy()
              for p in (pipe, plain)]
    diff = np.abs(images[0] - images[1])
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0


# ---------------------------------------------------------------- AOV
def _aov_scene(motion, textured, dispatch):
    """(scene, camera) of one AOV variant: the Cornell box (2-key with
    motion), the normal-mapped textured quad, the material Cornell box, or
    the principled quad."""
    if dispatch:
        return _dispatch_scene("principled_quad" if textured else "material",
                               motion)
    if textured:
        return _textured_quad("normal_map", motion)
    return _moving_cornell() if motion else (build_scene(cornell_box()[0]),
                                             cornell_box()[1])


AOV_VARIANTS = [(m, t, d) for m in (False, True) for t in (False, True)
                for d in (False, True)]
AOV_IDS = ["-".join(n for n, on in zip(("motion", "textured", "dispatch"), v)
                    if on) or "plain" for v in AOV_VARIANTS]


def _bits_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _widen_aov(misc, seed):
    """misc [R, 16] -> [R, 24], the AOV accs random."""
    gen = torch.Generator(device=misc.device).manual_seed(seed)
    aov = torch.rand((misc.shape[0], 6), device=misc.device, generator=gen)
    return torch.cat([misc, aov * 2 - 1, torch.zeros_like(aov[:, :2])], 1)


@pytest.mark.parametrize("variant", AOV_VARIANTS, ids=AOV_IDS)
def test_aov_refill_kernel_matches_plain_version(dev, variant):
    """K4 with aov=True, every instantiation: teacher-forced for 8
    launches on one block (claims in lane order), then for 6 launches at
    4096 lanes over 4096 pixels from the plain version's state after its
    first launch (every pixel claimed, so block order cannot matter), with
    the stash in use: every output bit for bit, stats and the time buffer
    exact."""
    motion, textured, dispatch = variant
    scene, cam = _aov_scene(*variant)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=1,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=True, aov=True)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    assert pipe.motion == motion and pipe.config.aov
    assert (pipe.tables.tex is not None) == textured
    assert (pipe.tables.params_base > 0) == dispatch
    kern = pipe.refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)

    def launch(fn, state, stats):
        out = [x.clone() for x in state]
        st = torch.zeros(4, dtype=torch.int32, device=dev)
        fn(*out[:3], stats, st, 0, 2, _scf(cam), *out[3:])
        return out, st

    for pool, n_launch, first in ((256, 8, 0), (4096, 6, 1)):
        state = [torch.zeros((pool, w), dtype=torch.float32, device=dev)
                 for w in (8, 24, 16)]
        state[1][:, 13] = -1.0
        state[2][:, 0] = -1.0
        if motion:
            state.append(torch.zeros(pool, dtype=torch.float32, device=dev))
        stats = torch.zeros(4, dtype=torch.int32, device=dev)
        for _ in range(first):
            state, stats = launch(ref, state, stats)
        stashed = 0
        for _ in range(n_launch):
            (got, st_k), (want, st_r) = (launch(kern, state, stats),
                                         launch(ref, state, stats))
            assert torch.equal(st_k, st_r)
            _bits_equal(got, want)
            stashed += int((want[2][:, 4:10] != 0).any(dim=1).sum())
            state, stats = want, st_r
        assert stashed > 0  # retired lanes carried their guides


@pytest.mark.parametrize("variant", AOV_VARIANTS, ids=AOV_IDS)
def test_aov_trace_shade_kernel_matches_plain_version(dev, variant):
    """K5 with aov=True, every instantiation, on one block and at 4096
    lanes: 8 iterations teacher-forced from the plain version's states (the
    AOV accs random at the start), every output bit for bit."""
    motion, textured, dispatch = variant
    scene, cam = _aov_scene(*variant)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False, aov=True,
                       light_sampler="power" if dispatch else "uniform")
    pipe = shade.FusedPipeline(scene, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for pool in (256, 4096):
        rays, misc = _lane_state(scene, cam, pool, 17, dev)
        misc = _widen_aov(misc, 1)
        for it in range(8):
            count = torch.tensor([pool if it % 2 == 0 else pool - 100],
                                 dtype=torch.int32, device=dev)
            time = (torch.rand(pool, device=dev, generator=gen) if motion
                    else None)
            a = (rays, misc, count, pipe.tables, pipe.config, time)
            got, want = shade.trace_shade(*a), shade.trace_shade_ref(*a)
            _bits_equal(got, want)
            rays, misc = want
            fr, fm = _lane_state(scene, cam, pool, 40 + it, dev)
            dead = misc[:, 9] <= 0
            rays = torch.where(dead[:, None], fr, rays)
            misc = torch.where(dead[:, None], _widen_aov(fm, it), misc)


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("dispatch", [False, True])
def test_aov_external_shade_matches_plain_version(dev, textured, dispatch):
    """K6 with aov=True, every instantiation, on the 4294-face town (the
    principled town for dispatch, with the power pick): 8 iterations
    teacher-forced at 4096 lanes and on one block of 128, misc [R, 24] in
    and [R, 32] out, every output bit for bit."""
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    scene, cam = town_scene(4000, textured=textured, principled=dispatch)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=True, aov=True,
                       light_sampler="power" if dispatch else "uniform")
    scene, _ = choose_tracer(scene, cfg, dev)
    pipe = shade.ExternalPipeline(scene, cfg,
                                  mt.make_mt_tracer(scene, dev, plain=True),
                                  dev, shade_fn=shade.external_shade_ref)
    assert (pipe.tables.tex is not None) == textured
    assert (pipe.tables.params_base > 0) == dispatch
    for n in (128, 4096):
        rays, misc = _lane_state(scene, cam, n, 9, dev)
        misc = _widen_aov(misc, 2)
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        for _ in range(8):
            hit = pipe._closest(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                                rays[:, 7], None, count)
            hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], 1)
            a = (rays, hit4, misc, pipe.tables, pipe.config)
            got = shade.external_shade(*a)
            _bits_equal(got, shade.external_shade_ref(*a))
            assert got[1].shape == (n, 32)
            rays, misc = pipe.trace_shade(rays, misc, count)


@pytest.mark.parametrize("case", ["cornell", "town_sorted"])
def test_aov_pipelines_match_plain_versions(dev, case):
    """render_frame with aov=True at 96^2, 2 spp, kernels against plain
    versions: the radiance through the gate (bench.py:115-116), the albedo
    and normal buffers bit for bit."""
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    if case == "cornell":
        scene, cam = build_scene(cornell_box()[0]), cornell_box()[1]
        change = {}
    else:
        scene, cam = town_scene(4000, textured=True)
        change = dict(sort_rays=True)
    cfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                       max_depth=6, ray_block=4096, integrator="pool",
                       pool_pixel_major=True, aov=True, **change)
    scene, pipe = choose_tracer(scene, cfg, dev)
    plain = (shade.FusedPipeline(
        scene, cfg, dev, refill_fn=shade.trace_shade_refill_ref,
        shade_fn=shade.trace_shade_ref)
        if isinstance(pipe, shade.FusedPipeline) else shade.ExternalPipeline(
            scene, cfg, mt.make_mt_tracer(scene, dev, plain=True), dev,
            shade_fn=shade.external_shade_ref))
    films = [render_frame(scene, cam.params(), cfg, tracer=p, device=dev)[0]
             for p in (pipe, plain)]
    diff = np.abs(films[0].accum.cpu().numpy() - films[1].accum.cpu().numpy())
    assert diff.mean() <= 2e-3
    assert int((diff.max(axis=-1) > 0.35).sum()) <= 8 and diff.max() <= 8.0
    for name in ("albedo", "normal"):
        assert torch.equal(getattr(films[0], name), getattr(films[1], name))
    assert (films[0].albedo.sum(dim=-1) > 0).float().mean() > 0.3
