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
from k6_case_util import VARIANTS as K6_VARIANTS
from k6_case_util import k6_case
from megakernel_util import FORMS, KINDS, fused_scene
from mt_bin_util import SOUP_SIZES, TIE_HIGH, TIE_LOW
from mt_bin_util import case as mt_bin_case
from mt_bin_util import counts as mt_bin_counts

MT_BIN_CASES = ["ties"] + [name for name, _ in SOUP_SIZES]
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


def _assert_bits_equal(got, want):
    """[R, 4] kernel output against its plain version, bit for bit."""
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _assert_sweeps_bit_equal(rays, counts, table, time=None):
    """The MT kernels against their plain versions at every live count:
    every output bit for bit, the binning's list lengths equal to
    bin_ref's; ray tiles past the count miss."""
    motion = time is not None
    pairs = ((mt.mt_closest_motion, mt.closest_motion_ref, 1),
             (mt.mt_any_motion, mt.any_motion_ref, 0)) if motion else (
        (mt.mt_closest, mt.closest_ref, 1), (mt.mt_any, mt.any_ref, 0))
    tile = mt.MOTION_RAY_TILE if motion else mt.RAY_TILE
    for count in counts:
        c = torch.tensor([count], dtype=torch.int32, device=rays.device)
        args = (time,) if motion else ()
        for kern, ref, col in pairs:
            got = kern(rays, *args, c, table)
            _assert_bits_equal(got, ref(rays, *args, c, table))
            tail = -(-count // tile) * tile
            assert (got[tail:, 1] == (-1.0 if col == 1 else 0.0)).all()
        assert torch.equal(mt.mt_bin(rays, c, table),
                           mt.bin_ref(rays, c, table).sum(
                               dim=0, dtype=torch.int32))


@pytest.mark.parametrize("scene_name", ["cornell", "box_grid",
                                        *MT_BIN_CASES])
def test_mt_kernels_match_plain_versions(dev, scene_name):
    """Cornell: one 128-wide tile; box grid: two 512-wide tiles, culled;
    the synthetic soups of tests/mt_bin_util.py: a face of tile 1 copied
    into tile 20 of 21 (the lower prim wins the tie), one tile of ct 384
    or 512, 9 and 18 tiles. Every output bit for bit at live counts 0,
    R - 1000 (R - 300 too on Cornell and the box grid) and R."""
    if scene_name in MT_BIN_CASES:
        geom, n_faces, o, d, _, _ = mt_bin_case(scene_name, 1, 8192)
        soup = mt.build_tri_soup(geom, dev, num_faces=n_faces)
        tmax = 1e16
    else:
        if scene_name == "cornell":
            scene = build_scene(cornell_box()[0])
            o, d = _rays(8192, 0, (-0.9, 0.05, -0.9), (0.9, 1.9, 0.9))
        else:
            scene = _box_grid_scene()
            o, d = _rays(8192, 3, (0, 3, 0), (8, 6, 8), down=True)
        soup = mt.build_tri_soup(scene.geom, dev, num_faces=scene.num_faces)
        tmax = 2.5
    rays, r = mt.pack_rays(torch.as_tensor(o, device=dev),
                           torch.as_tensor(d, device=dev), 0.01, tmax)
    extra = () if scene_name in MT_BIN_CASES else (r - 300,)
    _assert_sweeps_bit_equal(rays, (*mt_bin_counts(r), *extra), soup)
    if scene_name == "ties":
        got = mt.mt_closest(rays, torch.tensor([r], dtype=torch.int32,
                                                device=dev), soup)
        assert (got[:, 1] == TIE_LOW).sum() > 1000
        assert not (got[:, 1] == TIE_HIGH).any()


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


@pytest.mark.parametrize("scene_name", ["town", *MT_BIN_CASES])
def test_motion_kernels_match_plain_versions_and_brute(dev, request,
                                                       scene_name):
    """K3 on the 2-key town: every output bit for bit against the plain
    versions at live counts 0, R - 1000, R - 200 and R (128- and 256-ray
    tiles end apart), prims and occlusion exact and t within 1e-6 against
    the brute tracer; and bit for bit on tests/mt_bin_util.py's 2-key
    soups (the tie across tiles 1 and 20, 1 tile of ct 384 or 512, 9 and
    18 tiles) at 0, R - 1000 and R."""
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    if scene_name != "town":
        geom, n_faces, o, d, tm, _ = mt_bin_case(scene_name, 2, 8192)
        msoup = mt.build_motion_soup(geom, dev, num_faces=n_faces)
        rays, r = mt.pack_rays(torch.as_tensor(o, device=dev),
                               torch.as_tensor(d, device=dev), 0.01, 1e16,
                               mt.MOTION_RAY_TILE)
        tm = torch.as_tensor(tm, device=dev)
        _assert_sweeps_bit_equal(rays, mt_bin_counts(r), msoup, tm)
        if scene_name == "ties":
            got = mt.mt_closest_motion(rays, tm, torch.tensor(
                [r], dtype=torch.int32, device=dev), msoup)
            assert (got[:, 1] == TIE_LOW).sum() > 1000
            assert not (got[:, 1] == TIE_HIGH).any()
        return
    scene = request.getfixturevalue("towns")[1][0]
    msoup = mt.build_motion_soup(scene.geom, dev, num_faces=scene.num_faces)
    o, d, tm = (torch.as_tensor(x, device=dev) for x in _town_rays(8192, 4))
    rays, r = mt.pack_rays(o, d, 0.01, 30.0, mt.MOTION_RAY_TILE)
    _assert_sweeps_bit_equal(rays, (*mt_bin_counts(r), r - 200), msoup, tm)
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


# ---------------------------------------------------- the hierwalk band
def _walk_pool_scene(case):
    """(split-ordered scene, camera) of a walk-pool test: the 24 x 24 box
    field (3 table levels), its 2-key variant, the principled quad
    (textured dispatch) or the Cornell box."""
    import dataclasses

    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.scene.builtin import (box_field,
                                                      textured_quad_variant)

    if case in ("field", "field_2key"):
        meshes, cam = box_field(24)
    elif case == "principled_quad":
        meshes, textures, cam = textured_quad_variant("principled")
        return split_order_scene(build_scene(meshes, textures=textures),
                                 leaf=14), cam
    else:
        meshes, cam = cornell_box()
    scene = build_scene(meshes)
    if case == "field_2key":
        g = scene.geom
        geom = g._replace(**{k: np.concatenate([getattr(g, k)] * 2)
                             for k in ("e1", "e2", "n0", "n1", "n2")},
                          v0=np.concatenate([g.v0, g.v0 + np.float32(
                              [0.2, 0.0, 0.1])]))
        scene = dataclasses.replace(scene, geom=geom, num_keys=2)
    leaf = 7 if scene.num_keys == 2 else 14
    return split_order_scene(scene, leaf=leaf), cam


@pytest.mark.parametrize("case", ["field", "field_2key", "principled_quad"])
def test_walk_kernel_matches_plain_version(dev, case):
    """K9: one launch of 16 rounds from walk-pool states recorded at
    boundaries 1, 4 and 7 of a 64^2 render (8-24 boundaries in all; the
    quad's table is a single leaf, no directory level), against its plain
    version on a clone: every state column bit for bit."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool

    scene, cam = _walk_pool_scene(case)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=2048, integrator="pool",
                       pool_pixel_major=True)
    pipe = walkpool.make_walkpool_pipeline(scene, cfg, dev)
    states = []

    def record(s, tab, motion, k):
        if len(states) < 8:
            states.append(s.clone())
        walkpool.walk_rounds(s, tab, motion, k)

    walkpool._render_pipepool(scene, cfg, cam.params(),
                              dataclasses.replace(pipe, walk_fn=record),
                              torch.arange(64 * 64), 0)
    states = states[1::3]
    assert len(states) == 3
    walked = []
    for s in states:
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, pipe.table, pipe.motion, 16)
        walkpool.walk_rounds(want, pipe.table, pipe.motion, 16, plain=True)
        for (name, a), (_, b) in zip(got.tensors(), want.tensors()):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        walked.append(int(got.rows) - int(s.rows))
    assert walked[0] > 0


@pytest.mark.parametrize("motion", [False, True])
def test_hierwalk_tracers_match_plain_versions(dev, motion):
    """trace_closest_hier / trace_any_hier on K9 against their plain versions
    (bit for bit) and the brute tracer (prims and occlusion exact)."""
    from rendertoy3c_tpu_torch.trace import hierwalk
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    scene, _ = _walk_pool_scene("field_2key" if motion else "field")
    tab = hierwalk.build_hier_table(scene.geom, scene.num_faces,
                                    num_keys=scene.num_keys, fanout=0,
                                    device=dev)
    o, d = _rays(8192, 5, (-12, 0.2, -12), (12, 4, 12))
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    rng = np.random.default_rng(6)
    tmax = torch.as_tensor(rng.uniform(0.5, 10, 8192).astype(np.float32),
                           device=dev)
    t = (torch.as_tensor(rng.uniform(0, 1, 8192).astype(np.float32),
                         device=dev) if motion else None)
    got = hierwalk.trace_closest_hier(tab, o, d, 1e-3, 1e16, time=t)
    want = hierwalk.trace_closest_hier(tab, o, d, 1e-3, 1e16, time=t,
                                       plain=True)
    for a, b in zip(got, want):  # a flat table's hits carry no instance
        assert (a is None and b is None) or torch.equal(a, b)
    brute = trace_closest_bruteforce(scene, o, d, 1e-3, 1e16, time=t)
    assert torch.equal(got.prim, brute.prim)
    assert (got.prim >= 0).float().mean() > 0.3
    occ = hierwalk.trace_any_hier(tab, o, d, 1e-3, tmax, time=t)
    assert torch.equal(occ, hierwalk.trace_any_hier(tab, o, d, 1e-3, tmax,
                                                    time=t, plain=True))
    assert torch.equal(occ, trace_any_bruteforce(scene, o, d, 1e-3, tmax,
                                                 time=t))


@pytest.mark.parametrize("variant", ["untextured", "textured",
                                     "dispatch_power", "aov"])
def test_transposed_external_shade_matches_plain_version(dev, variant):
    """K6 with C-major misc on the walk pool's boundary inputs (both
    paths' lanes, recorded at every boundary of a 64^2 render): every
    output bit for bit."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool

    scene, cam = _walk_pool_scene(
        "principled_quad" if variant == "textured" else "cornell")
    if variant == "dispatch_power":
        from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
        from rendertoy3c_tpu_torch.scene.builtin import material_cornell_box

        meshes, cam = material_cornell_box()
        scene = split_order_scene(build_scene(meshes), leaf=14)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=2048, integrator="pool",
                       pool_pixel_major=True, aov=variant == "aov",
                       light_sampler="power" if variant == "dispatch_power"
                       else "uniform")
    pipe = walkpool.make_walkpool_pipeline(scene, cfg, dev)
    inputs = []

    def record(rays, hit4, misc, tables, config, transposed):
        inputs.append((rays.clone(), hit4.clone(), misc.clone()))
        return shade.external_shade(rays, hit4, misc, tables, config,
                                    transposed=transposed)

    walkpool._render_pipepool(scene, cfg, cam.params(),
                              dataclasses.replace(pipe, shade_fn=record),
                              torch.arange(64 * 64), 0)
    assert len(inputs) >= 8  # one launch per boundary, 8 or more
    for rays, hit4, misc in inputs[::2]:
        a = (rays, hit4, misc, pipe.shade_tables, pipe.shade_config)
        got = shade.external_shade(*a, transposed=True)
        _bits_equal(got, shade.external_shade_ref(*a, transposed=True))
        assert got[1].shape == (pipe.misc_w + 8, rays.shape[0])


def _inst_scene(case):
    """(split-ordered instanced scene, camera, textures) of an instanced
    test: bench's instance field at grid 4 (static or 2-key) or the
    normal-mapped quad under a rotated, scaled instance."""
    from rendertoy3c_tpu_torch.scene.builtin import (instance_field,
                                                      instanced_bumpy_quad)
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.trace.hier_instanced import \
        split_order_instanced

    if case == "normal_map":
        meshes, inst, tex, cam = instanced_bumpy_quad()
        return split_order_instanced(
            build_instanced_scene(meshes, inst, textures=tex)), cam
    meshes, inst, cam = instance_field(case == "field_2key", 4)
    return split_order_instanced(build_instanced_scene(meshes, inst)), cam


def _inst_pipe(case, dev, cfg):
    """The instanced walk pool of a case: the space-switching table (at
    fanout 32 for `fanout32`) or the baked world table (`baked`)."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace.hier_instanced import \
        build_inst_hier_table

    scene, cam = _inst_scene("field" if case in ("fanout32", "baked")
                             else case)
    pipe = walkpool.make_inst_walkpool_pipeline(scene, cfg, dev,
                                                bake=case == "baked")
    if case == "fanout32":
        pipe = dataclasses.replace(pipe, table=build_inst_hier_table(
            scene, fanout=32, device=dev))
    return scene, cam, pipe


@pytest.mark.parametrize("case", ["field", "field_2key", "fanout32",
                                  "baked", "normal_map"])
def test_inst_walk_kernel_matches_plain_version(dev, case):
    """K9-inst (K9 on the baked table): one launch of 20 rounds from
    instanced walk-pool states recorded at boundaries 1, 4 and 7 of a
    64^2 render, against its plain version on a clone: every state column
    bit for bit."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool

    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=2048, integrator="pool",
                       pool_pixel_major=True)
    scene, cam, pipe = _inst_pipe(case, dev, cfg)
    states = []

    def record(s, tab, motion, k):
        if len(states) < 8:
            states.append(s.clone())
        walkpool.walk_rounds(s, tab, motion, k)

    walkpool._render_pipepool(scene, cfg, cam.params(),
                              dataclasses.replace(pipe, walk_fn=record),
                              torch.arange(64 * 64), 0)
    states = states[1::3]
    assert len(states) == 3
    before = walkpool.walk_rounds.inst_launches
    walked = []
    for s in states:
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, pipe.table, pipe.motion, 20)
        walkpool.walk_rounds(want, pipe.table, pipe.motion, 20, plain=True)
        for (name, a), (_, b) in zip(got.tensors(), want.tensors()):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        walked.append(int(got.rows) - int(s.rows))
    assert walked[0] > 0
    assert (walkpool.walk_rounds.inst_launches > before) == (case != "baked")


def _deepen(tab, levels):
    """A flat table walked as before under `levels` - n_levels more
    directory levels of one child each: the same hits at up to 8 levels,
    where K9 holds its entries for 8."""
    from rendertoy3c_tpu_torch.trace.hierwalk import HierTable

    extra, f = levels - tab.n_levels, tab.fanout
    t = tab.table.cpu().numpy().copy()
    lo = t[0, :3 * f].reshape(3, f)
    hi = t[0, 3 * f:6 * f].reshape(3, f)
    real = lo[0] < 1e29
    top = np.zeros((extra, 128), np.float32)
    top[:, :6 * f] = 1e30
    top[:, 0:3 * f:f] = lo[:, real].min(axis=1)
    top[:, 3 * f:6 * f:f] = hi[:, real].max(axis=1)
    top[:, 126] = np.arange(1, extra + 1)
    dirs = t[:, 127] < 0.5
    t[dirs, 126] += extra
    return HierTable(
        table=torch.as_tensor(np.concatenate([top, t]),
                              device=tab.table.device),
        level_starts=tuple(range(extra)) + tuple(
            s + extra for s in tab.level_starts),
        leaf_start=tab.leaf_start + extra, num_faces=tab.num_faces,
        fanout=f)


def _corner_table(case, dev):
    """(table, motion) of a corner case: tests/walk_tie_util.py's flat
    table (duplicated faces in a leaf, duplicated leaves in a directory)
    at fanout 16 or 20, static or with 2-key leaves, and at 8 levels
    (`deep`), or its instanced table (duplicated instances) at fanout 16,
    20 or 32 with static or 2-key instance rows, or bench's 2-key
    578-instance field at fanout 20 (5 levels: `field`)."""
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.mesh import Mesh
    from rendertoy3c_tpu_torch.scene.scene import Instance
    from rendertoy3c_tpu_torch.trace import hier_instanced, hierwalk
    from walk_tie_util import flat_geom, inst_parts

    kind, motion, fanout = case.split("_")
    motion, fanout = motion == "2key", int(fanout[1:])
    if kind in ("flat", "deep"):
        g = flat_geom(motion)
        tab = hierwalk.build_hier_table(g, g.v0.shape[1],
                                        num_keys=1 + motion, fanout=fanout,
                                        device=dev)
        return (_deepen(tab, 8) if kind == "deep" else tab), motion
    if kind == "field":
        meshes, inst, _ = instance_field(motion)
        scene = hier_instanced.split_order_instanced(
            build_instanced_scene(meshes, inst))
        return hier_instanced.build_inst_hier_table(scene, fanout=fanout,
                                                    device=dev), motion
    verts, idx, xforms = inst_parts(motion)
    scene = build_instanced_scene(
        [Mesh(vertices=verts[None], indices=idx)],
        [Instance(mesh_index=0, transforms=t) for t in xforms])
    return hier_instanced.build_inst_hier_table(scene, fanout=fanout,
                                                device=dev), motion


def _corner_state(tab, w, seed, dev, inst):
    """A pool of w lanes and 2 paths over walk_tie_util's dyadic rays: 40%
    shadow walks (tmax 0.5-8, so some find an occluder within a launch),
    the first path pending on 90% of the lanes and the second on 50%,
    bounce rays and NEE terms for the gate, and on the lanes with nothing
    pending stale entries (quarters in [0, 8]) against a best t of 4,
    occluded on a third of them; those stay idle (their entries would
    send a new walk to rows that do not exist). Returns (state, the idle
    lanes)."""
    from rendertoy3c_tpu_torch.integrate import walkpool
    from walk_tie_util import rays

    rng = np.random.default_rng(seed)
    lo, hi = (-5, 11) if inst else (-1, 13)
    s = walkpool.new_walk_state(w, tab.n_levels, tab.fanout, 2, 16, "cpu")

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    for p in range(2):
        o, d, tmin, tmax, time = rays(w, seed + 10 + p, False, lo, hi)
        s.nrays[p] = t(np.concatenate([o, d, tmin[:, None], tmax[:, None]],
                                      1))
        s.btime[p] = t(time)
        s.mc[p, 9] = t(rng.choice([-1.0, 1.0], w))
        s.mc[p, 10:13] = t(rng.uniform(0, 1, (3, w)))
        s.nee[p] = t(rng.uniform(0, 1, (3, w)))
    _pend(s, rng, seed, lo, hi, torch.ones(w, dtype=torch.bool))
    idle = ~s.pvalid.any(dim=0)
    stale = t(rng.integers(0, 33, s.ents.shape) / 4)
    keep = torch.as_tensor(rng.uniform(size=s.ents.shape) < 0.5)
    s.ents.copy_(torch.where(idle & keep, stale, s.ents))
    s.wb_t.copy_(torch.where(idle, 4.0, s.wb_t))
    s.wfound.copy_(idle & torch.as_tensor(rng.uniform(size=w) < 1 / 3))
    return (walkpool.WalkState(**{n: x.to(dev) for n, x in s.tensors()}),
            idle.to(dev))


def _pend(s, rng, seed, lo, hi, lanes, share=(0.9, 0.5)):
    """Pend new walks as a boundary does: path p on a share of `lanes`
    where it has none pending, 40% of them shadow walks."""
    from walk_tie_util import rays

    w, dev = s.cur.shape[0], s.cur.device
    for p in range(2):
        o, d, tmin, tmax, time = rays(w, seed + p, True, lo, hi)
        shadow = rng.uniform(size=w) < 0.4
        tmax = np.where(shadow, tmax, np.float32(1e16))
        new = torch.as_tensor(rng.uniform(size=w) < share[p],
                              device=dev) & lanes & ~s.pvalid[p]
        ray8 = torch.as_tensor(np.concatenate(
            [o, d, tmin[:, None], tmax[:, None]], 1), device=dev)
        s.pray[p] = torch.where(new[:, None], ray8, s.pray[p])
        s.ptime[p] = torch.where(new, torch.as_tensor(time, device=dev),
                                 s.ptime[p])
        s.pmode[p] = torch.where(new, torch.as_tensor(shadow, device=dev),
                                 s.pmode[p])
        s.pvalid[p] |= new


CORNERS = [(c, 4096) for c in ("flat_static_f16", "flat_static_f20",
                               "flat_2key_f20", "deep_static_f16",
                               "inst_static_f16", "inst_static_f32",
                               "inst_2key_f20", "inst_2key_f32",
                               "field_2key_f20")]
CORNERS += [(c, w) for c in ("flat_static_f20", "inst_2key_f32")
            for w in (1, 5, 8192, 16384)]


@pytest.mark.parametrize("case, w", CORNERS,
                         ids=[f"{c}-w{w}" for c, w in CORNERS])
def test_walk_kernel_group_corners_match_plain_version(dev, case, w):
    """K9 and K9-inst's group reductions at their corners, against
    walk_rounds(plain=True): walk_tie_util's tables (equal t on two lanes
    of a leaf, equal entries in a level; rays through vertices and edges,
    from a face with a negative tmin: t, u, v of +-0), levels whose
    entries are all _BIG, idle lanes with stale entries, shadow walks
    that find an occluder within a launch, relaunches through the gate;
    fanouts 16, 20 and 32, static and 2-key leaves and instance rows, 2
    to 8 levels; W = 1, 5 (a CTA's 4 lanes and one more), 4096, 8192 and
    16384. After 3
    plain rounds, launches of 5, K, 3 and K rounds (new walks pended
    before each as at a boundary), each from the plain version's state:
    every state column bit for bit."""
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace.hier_instanced import InstHierTable

    tab, motion = _corner_table(case, dev)
    inst = isinstance(tab, InstHierTable)
    k = 20 if inst else 16
    s, idle = _corner_state(tab, w, 7 + w, dev, inst)
    walkpool.walk_rounds(s, tab, motion, 3, plain=True)
    rng = np.random.default_rng(w)
    walked = 0
    for i, rounds in enumerate((5, k, 3, k)):
        if i:  # a boundary's new walks; 5 and 3 rounds stop walks midway
            _pend(s, rng, 100 * i + w, *((-5, 11) if inst else (-1, 13)),
                  ~idle, share=(0.3, 0.3))
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, tab, motion, rounds)
        walkpool.walk_rounds(want, tab, motion, rounds, plain=True)
        for (name, a), (_, b) in zip(got.tensors(), want.tensors()):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        walked += int(want.rows) - int(s.rows)
        s = want
    assert walked > 0
    assert bool(s.hvalid.any()) or w < 17


def _nkey_grid_scene(num_keys=4):
    """_box_grid_scene with num_keys keys: each key shifts every face by
    a seeded step, so the segments lie apart."""
    import dataclasses

    scene = _box_grid_scene()
    g = scene.geom
    rng = np.random.default_rng(12)
    v0 = [np.asarray(g.v0[0])]
    for _ in range(1, num_keys):
        v0.append(v0[-1] + rng.uniform(-0.4, 0.4, 3).astype(np.float32))
    geom = g._replace(v0=np.stack(v0), **{
        k: np.concatenate([np.asarray(getattr(g, k))[:1]] * num_keys)
        for k in ("e1", "e2", "n0", "n1", "n2")})
    return dataclasses.replace(scene, geom=geom, num_keys=num_keys)


@pytest.mark.parametrize("w", [1, 100, 8192 + 37])
def test_walk_kernel_segment_offsets_match_plain_version(dev, w):
    """K9 with segment offsets (a 4-key scene's stacked segment tables):
    every launch of a closest and a shadow walk over w rays, half at
    times 0, 1/3, 2/3 and 1 and half at uniform random times, against
    walk_rounds(plain=True) from the same state, every state column bit
    for bit; the walks' hits against the brute tracer's N-key lerp."""
    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace import hierwalk
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    scene = split_order_scene(_nkey_grid_scene(),
                              leaf=hierwalk.HIER_LEAF_MOTION)
    tab = hierwalk.build_hier_table_nkey(scene.geom, scene.num_faces,
                                         scene.num_keys, device=dev)
    o, d = _rays(w, 21 + w, (-1, 0.2, -1), (9, 4, 9))
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    rng = np.random.default_rng(w)
    t = rng.uniform(0, 1, w).astype(np.float32)
    t[np.arange(w) % 8 < 4] = np.float32([0, 1 / 3, 2 / 3, 1])[
        np.arange(w)[np.arange(w) % 8 < 4] % 8]
    t = torch.as_tensor(t, device=dev)
    tmax = torch.as_tensor(rng.uniform(0.5, 10, w).astype(np.float32),
                           device=dev)
    launches = []

    def both(s, tab, motion, k, plain=False):
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, tab, motion, k)
        walkpool.walk_rounds(want, tab, motion, k, plain=True)
        for (name, a), (_, b) in zip(got.tensors(), want.tensors()):
            assert torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8)), name
        launches.append(k)
        for (_, a), (_, b) in zip(s.tensors(), want.tensors()):
            a.copy_(b)

    walkpool.walk_rounds.seg_launches = 0
    s = hierwalk._walk(tab, o, d, 1e-3, 1e16, None, False, t, walk_fn=both)
    sa = hierwalk._walk(tab, o, d, 1e-3, tmax, None, True, t, walk_fn=both)
    assert walkpool.walk_rounds.seg_launches == len(launches) >= 2
    brute = trace_closest_bruteforce(scene, o, d, 1e-3, 1e16, time=t)
    prim = torch.where(s.wb_prim < tab.num_faces, s.wb_prim, -1)
    assert torch.equal(prim, brute.prim)
    assert torch.equal(sa.wfound, trace_any_bruteforce(scene, o, d, 1e-3,
                                                       tmax, time=t))
    assert w < 100 or (prim >= 0).float().mean() > 0.2


def test_walk_kernel_null_offset_ignores_the_segment_column(dev):
    """On a single-segment table walk_rounds hands K9 a null offset: a
    state whose wseg column holds garbage walks bit for bit as with wseg
    zero, and as the plain version."""
    from rendertoy3c_tpu_torch.integrate import walkpool

    tab, motion = _corner_table("flat_2key_f20", dev)
    s, _ = _corner_state(tab, 4096, 5, dev, False)
    junk = s.clone()
    junk.wseg.copy_(torch.randint(1, 1 << 20, junk.wseg.shape,
                                  dtype=torch.int32, device=dev))
    walkpool.walk_rounds(s, tab, motion, 16)
    want = junk.clone()
    walkpool.walk_rounds(junk, tab, motion, 16)
    walkpool.walk_rounds(want, tab, motion, 16, plain=True)
    for (name, a), (_, b), (_, c) in zip(s.tensors(), junk.tensors(),
                                         want.tensors()):
        if name != "wseg":
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        assert torch.equal(b.view(torch.uint8), c.view(torch.uint8)), name


@pytest.mark.parametrize("motion", [False, True])
def test_inst_hier_tracers_match_plain_versions(dev, motion):
    """trace_closest_inst_hier / trace_any_inst_hier on K9-inst against
    their plain versions (bit for bit) and the brute instanced tracer
    (prim, instance and occlusion exact)."""
    from rendertoy3c_tpu_torch.trace import hier_instanced as hi
    from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer

    scene, _ = _inst_scene("field_2key" if motion else "field")
    tab = hi.build_inst_hier_table(scene, device=dev)
    o, d = _rays(8192, 5, (-3, 0.2, -3), (3, 4, 3))
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    rng = np.random.default_rng(6)
    tmax = torch.as_tensor(rng.uniform(0.5, 10, 8192).astype(np.float32),
                           device=dev)
    t = (torch.as_tensor(rng.uniform(0, 1, 8192).astype(np.float32),
                         device=dev) if motion else None)
    got = hi.trace_closest_inst_hier(tab, o, d, 1e-3, 1e16, time=t)
    want = hi.trace_closest_inst_hier(tab, o, d, 1e-3, 1e16, time=t,
                                      plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bc, ba = make_instanced_tracer(scene, dev)
    brute = bc(o, d, 1e-3, 1e16, t)
    assert (got.prim != brute.prim).sum() <= (2 if motion else 0)
    assert (got.inst != brute.inst).sum() <= (2 if motion else 0)
    assert (got.prim >= 0).float().mean() > 0.3
    occ = hi.trace_any_inst_hier(tab, o, d, 1e-3, tmax, time=t)
    assert torch.equal(occ, hi.trace_any_inst_hier(tab, o, d, 1e-3, tmax,
                                                   time=t, plain=True))
    assert (occ != ba(o, d, 1e-3, tmax, t)).sum() <= (2 if motion else 0)


@pytest.mark.parametrize("case", ["field", "field_2key", "normal_map",
                                  "aov", "row_major"])
def test_inst_external_shade_matches_plain_version(dev, case):
    """K6 with instance rows on the instanced walk pool's boundary inputs
    (C-major misc), and row-major on the trace-time external pipeline's:
    every output bit for bit, with lanes of every instance and misses."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.path import render_pixels
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=2048, integrator="pool",
                       pool_pixel_major=True, aov=case == "aov")
    inputs = []

    def record(rays, hit4, misc, tables, config, transposed=False,
               inst=None):
        inputs.append((rays.clone(), hit4.clone(), misc.clone(),
                       inst.clone(), transposed))
        return shade.external_shade(rays, hit4, misc, tables, config,
                                    transposed=transposed, inst=inst)

    if case == "row_major":
        from rendertoy3c_tpu_torch.scene.builtin import \
            multi_instance_cornell
        from rendertoy3c_tpu_torch.scene.instanced import \
            build_instanced_scene

        meshes, inst, cam = multi_instance_cornell()
        scene, pipe = choose_tracer(build_instanced_scene(meshes, inst), cfg,
                                    dev)
        assert isinstance(pipe, shade.ExternalPipeline)
        pipe.shade_fn = record
        render_pixels(scene, cfg, cam.params(), pipe, torch.arange(64 * 64),
                      0)
        tables, config = pipe.tables, pipe.config
    else:
        scene, cam, pipe = _inst_pipe("field" if case == "aov" else case,
                                      dev, cfg)
        walkpool._render_pipepool(scene, cfg, cam.params(),
                                  dataclasses.replace(pipe, shade_fn=record),
                                  torch.arange(64 * 64), 0)
        tables, config = pipe.shade_tables, pipe.shade_config
    assert len(inputs) >= 8
    before = shade.external_shade.inst_launches
    seen = set()
    for rays, hit4, misc, inst, transposed in inputs[::2]:
        a = (rays, hit4, misc, tables, config)
        got = shade.external_shade(*a, transposed=transposed, inst=inst)
        _bits_equal(got, shade.external_shade_ref(*a, transposed=transposed,
                                                  inst=inst))
        seen |= set(inst.unique().tolist())
    assert shade.external_shade.inst_launches > before
    assert -1 in seen and len(seen) > 2


def _bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("case", ["random", "forced_passes", "pool_state"])
def test_resident_walk_kernels_match_plain_versions(dev, case):
    """K8 closest and any (walk_closest, walk_any) against walk_closest_ref
    and walk_any_ref: every launch's output rows and cursor rows bit for
    bit, from the first pass's cursor and from a mid-walk one, with a
    live count inside a block; then the pass loops' hits and occlusion
    bit-equal, and the brute tracer's prims and occlusion. pool_state:
    the rays of a sorted general-pool iteration (stale lanes past the
    live count inside live blocks)."""
    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.trace import residentwalk as rw
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    scene = split_order_scene(_box_grid_scene(16))
    t_rounds = 2 if case == "forced_passes" else rw.T_ROUNDS
    o, d = _rays(4000, 3, [-1, 0.1, -1], [17, 2.5, 17])
    if case == "pool_state":
        # a sorted pool: direction octant, then origin; the stale tail
        # lanes keep their rays
        key = (d[:, 0] >= 0) + 2 * (d[:, 1] >= 0) + 4 * (d[:, 2] >= 0)
        order = np.lexsort((o[:, 0], key))
        o, d = o[order], d[order]
    ot = torch.as_tensor(o, device=dev)
    dt = torch.as_tensor(d, device=dev)
    tab = rw.build_walk_table(scene.geom, scene.num_faces, device=dev)
    rays, r = rw._pack(ot, dt, 0.01, 1e16, rw.RT)
    count = torch.tensor([3001], dtype=torch.int32, device=dev)
    er, ir = rw._start(rays, rw.RT)
    for kern, ref in ((rw.walk_closest, rw.walk_closest_ref),
                      (rw.walk_any, rw.walk_any_ref)):
        c_er, c_ir = er, ir
        for _ in range(3):
            out_k, cur_k, _ = kern(count, c_er, c_ir, rays, tab, rw.RT,
                                   t_rounds)
            out_p, cur_p = ref(count, c_er, c_ir, rays, tab, rw.RT, t_rounds)
            assert _bits(out_k, out_p) and _bits(cur_k, cur_p)
            c_er = cur_k[:, 1].contiguous()
            c_ir = cur_k[:, 2].to(torch.int32)
    for count in (None, torch.tensor(3001, device=dev)):
        got = rw.trace_closest_walk(tab, ot, dt, 0.01, 1e16, count=count,
                                    t_rounds=t_rounds)
        want = rw.trace_closest_walk(tab, ot, dt, 0.01, 1e16, count=count,
                                     t_rounds=t_rounds, plain=True)
        for a, b in zip(got, want):
            if a is not None:
                assert _bits(a.float(), b.float())
        tmax = torch.linspace(0.5, 30.0, ot.shape[0], device=dev)
        occ = rw.trace_any_walk(tab, ot, dt, 1e-3, tmax, count=count,
                                t_rounds=t_rounds)
        assert torch.equal(occ, rw.trace_any_walk(
            tab, ot, dt, 1e-3, tmax, count=count, t_rounds=t_rounds,
            plain=True))
    brute = trace_closest_bruteforce(scene, ot, dt, 0.01, 1e16)
    full = rw.trace_closest_walk(tab, ot, dt, 0.01, 1e16, t_rounds=t_rounds)
    assert torch.equal(full.prim, brute.prim)
    assert torch.equal(rw.trace_any_walk(tab, ot, dt, 1e-3, tmax,
                                         t_rounds=t_rounds),
                       trace_any_bruteforce(scene, ot, dt, 1e-3, tmax))


@pytest.mark.parametrize("t_rounds", [24, 2])
def test_resident_walk_one_launch_matches_plain_loop_and_twin(dev,
                                                              t_rounds):
    """The one-launch walk (walk_closest / walk_any with the pass cap):
    one launch per walk; its hits and occlusion bit-equal to the
    reference's pass loop (plain=True); its output rows, cursor rows and
    per-block (passes, rounds) equal to the plain twin's
    (walk_*_blocks_ref); the single-pass form (max_passes = 1) equal to
    walk_*_ref from the first cursor and from the cursor a pass leaves;
    the live count inside a block (3001 of 4000 rays); closest rays with
    tmax = inf too (the rounds past the ranked leaves, at BIG)."""
    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    scene = split_order_scene(_box_grid_scene(16))
    o, d = _rays(4000, 5, [-1, 0.1, -1], [17, 2.5, 17])
    ot = torch.as_tensor(o, device=dev)
    dt = torch.as_tensor(d, device=dev)
    tab = rw.build_walk_table(scene.geom, scene.num_faces, device=dev)
    tmax = torch.linspace(0.5, 30.0, ot.shape[0], device=dev)
    count = torch.tensor([3001], dtype=torch.int32, device=dev)
    cap = rw.pass_cap(tab, t_rounds)
    closest = (rw.walk_closest, rw.walk_closest_blocks_ref,
               rw.walk_closest_ref, rw.trace_closest_walk)
    for kern, twin, ref, trace, t_hi in (
            closest + (1e16,), closest + (float("inf"),),
            (rw.walk_any, rw.walk_any_blocks_ref, rw.walk_any_ref,
             rw.trace_any_walk, tmax)):
        t_lo = 0.01 if kern is rw.walk_closest else 1e-3
        before = kern.launches
        counts = []
        got = trace(tab, ot, dt, t_lo, t_hi, count=count, t_rounds=t_rounds,
                    passes=counts)
        assert kern.launches == before + 1
        want = trace(tab, ot, dt, t_lo, t_hi, count=count, t_rounds=t_rounds,
                     plain=True)
        pairs = (zip(got[:4], want[:4]) if isinstance(got, tuple)
                 else [(got, want)])
        for a, b in pairs:
            assert _bits(a.float(), b.float())
        rays, _ = rw._pack(ot, dt, t_lo, t_hi, rw.RT)
        er, ir = rw._start(rays, rw.RT)
        out_k, cur_k, cnt_k = kern(count, er, ir, rays, tab, rw.RT, t_rounds,
                                   cap)
        out_p, cur_p, cnt_p = twin(count, er, ir, rays, tab, rw.RT, t_rounds,
                                   cap)
        assert _bits(out_k, out_p) and _bits(cur_k, cur_p)
        assert torch.equal(cnt_k, cnt_p) and torch.equal(counts[0], cnt_p)
        assert int(cnt_k[:, 0].max()) > 1 or t_rounds == 24
        c_er, c_ir = er, ir
        for _ in range(2):  # the first cursor, then the one a pass leaves
            out_k, cur_k, cnt_k = kern(count, c_er, c_ir, rays, tab, rw.RT,
                                       t_rounds)
            out_p, cur_p = ref(count, c_er, c_ir, rays, tab, rw.RT, t_rounds)
            assert _bits(out_k, out_p) and _bits(cur_k, cur_p)
            assert (cnt_k[:, 0] == 1).all()
            c_er = cur_k[:, 1].contiguous()
            c_ir = cur_k[:, 2].to(torch.int32)


def _wide_lanes(scene, cam, seed, dev, aov):
    """_lane_state of 4096 lanes, misc widened to 24 columns with AOV."""
    rays, misc = _lane_state(scene, cam, 4096, seed, dev)
    if aov:
        misc = torch.cat([misc, torch.zeros((4096, 8), device=dev)], dim=1)
    return rays, misc


@pytest.mark.parametrize("case", ["cornell", "motion", "dispatch_power",
                                  "aov"])
def test_non_merged_trace_shade_kernel_matches_plain_version(dev, case):
    """The non-merged K5 (trace_shade_hit: hit4 from closest_raw, K1 or
    K3) teacher-forced for 8 iterations from the plain version's states:
    every output bit for bit; at the full count also bit-equal to the
    merged K5 on the same inputs; and a sorted 96^2 render through
    SplitPipeline bit-equal to the merged pipeline's."""
    from split_util import SplitPipeline

    motion = case == "motion"
    if case == "dispatch_power":
        scene, cam = _dispatch_scene("material", False)
    else:
        scene, cam = (_moving_cornell() if motion
                      else (build_scene(cornell_box()[0]), cornell_box()[1]))
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False, aov=case == "aov",
                       light_sampler=("power" if case == "dispatch_power"
                                      else "uniform"))
    pipe = shade.FusedPipeline(scene, cfg, dev)
    rays, misc = _wide_lanes(scene, cam, 61, dev, cfg.aov)
    gen = torch.Generator(device=dev).manual_seed(6)
    before = shade.trace_shade_hit.launches
    for it in range(8):
        n = 4096 if it % 2 == 0 else 3000
        count = torch.tensor([n], dtype=torch.int32, device=dev)
        time = torch.rand(4096, device=dev, generator=gen) if motion else None
        hit4 = pipe.closest_raw(rays, count, time)
        got = shade.trace_shade_hit(rays, hit4, misc, count, pipe.tables,
                                    pipe.config)
        want = shade.trace_shade_hit_ref(rays, hit4, misc, count,
                                         pipe.tables, pipe.config)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        if n == 4096:
            merged = shade.trace_shade(rays, misc, count, pipe.tables,
                                       pipe.config, time)
            for g, w in zip(got, merged):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        rays, misc = want
        fr, fm = _wide_lanes(scene, cam, 70 + it, dev, cfg.aov)
        dead = misc[:, 9] <= 0
        rays = torch.where(dead[:, None], fr, rays)
        misc = torch.where(dead[:, None], fm, misc)
    assert shade.trace_shade_hit.launches == before + 8
    gcfg = RenderConfig(width=96, height=96, samples_per_launch=2,
                        max_depth=6, ray_block=4096, integrator="pool",
                        sort_rays=True, aov=cfg.aov,
                        light_sampler=cfg.light_sampler)
    images = [render_frame(scene, cam.params(), gcfg, device=dev,
                           tracer=make(scene, gcfg, dev))[0].accum
              for make in (shade.FusedPipeline, SplitPipeline)]
    assert torch.equal(images[0].view(torch.int32),
                       images[1].view(torch.int32))


def _inst_field_scene(grid=4):
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene

    meshes, inst, cam = instance_field(False, grid)
    return build_instanced_scene(meshes, inst), cam


@pytest.mark.parametrize("case", ["field", "tracetime_cornell"])
def test_instanced_mt_kernel_matches_plain_version(dev, case):
    """K7 closest and any (trace_instanced) against trace_instanced_ref on
    seeded rays with a live count inside a tile: every output bit for bit;
    the tracer pair's prims, instances and occlusion against the brute
    instanced tracer."""
    from rendertoy3c_tpu_torch.scene.builtin import multi_instance_cornell
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.trace import instanced_mt as im
    from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer

    if case == "field":
        scene, _ = _inst_field_scene()
        o, d = _rays(5000, 12, [-1, 0.5, -1], [5, 6, 5], down=True)
    else:
        meshes, inst, _ = multi_instance_cornell()
        scene = build_instanced_scene(meshes, inst)
        o, d = _rays(5000, 13, [-0.9, 0.05, -0.9], [0.9, 1.9, 0.9])
    soup = im.build_instanced_soup(scene, dev)
    ot = torch.as_tensor(o, device=dev)
    dt = torch.as_tensor(d, device=dev)
    tmax = torch.linspace(0.2, 8.0, 5000, device=dev)
    for any_hit in (False, True):
        rays, r = mt.pack_rays(ot, dt, 1e-3, tmax if any_hit else 1e16)
        for n in (r, 3001):
            count = torch.tensor([n], dtype=torch.int32, device=dev)
            before = (im.trace_instanced.any_launches if any_hit
                      else im.trace_instanced.launches)
            got = im.trace_instanced(rays, count, soup, any_hit)
            want = im.trace_instanced_ref(rays, count, soup, any_hit)
            assert _bits(got, want)
            after = (im.trace_instanced.any_launches if any_hit
                     else im.trace_instanced.launches)
            assert after == before + 1
    closest, any_hit = im.make_instanced_mt_tracer(scene, dev)
    b_closest, b_any = make_instanced_tracer(scene, dev)
    h, bh = closest(ot, dt, 1e-2, 1e16), b_closest(ot, dt, 1e-2, 1e16)
    assert torch.equal(h.prim, bh.prim) and torch.equal(h.inst, bh.inst)
    assert 0.2 < float((h.prim >= 0).float().mean())
    assert torch.equal(any_hit(ot, dt, 1e-3, tmax),
                       b_any(ot, dt, 1e-3, tmax))


def _cull_case(case):
    """(scene, rays) of tests/test_torch_instanced_cull.py's inputs, built
    with this package (inst_cull_util)."""
    import inst_cull_util as icu
    from rendertoy3c_tpu_torch.scene import builtin
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.scene import Instance

    if case == "three_instances":
        parts = icu.three_instances_parts(builtin, Material, Mesh, Instance)
        return build_instanced_scene(*parts), icu.three_rays(
            np.random.default_rng(41))
    if case == "ties":
        parts = icu.ties_parts(Material, Mesh, Instance)
        return build_instanced_scene(*parts), icu.ties_rays(
            np.random.default_rng(41))
    meshes, inst, _ = builtin.multi_instance_cornell()
    rays = (icu.cornell_rays(np.random.default_rng(41))
            if case == "cornell_edges"
            else icu.wall_rays(np.random.default_rng(47)))
    return build_instanced_scene(meshes, inst), rays


@pytest.mark.parametrize("case", ["three_instances", "cornell_edges",
                                  "cornell_walls", "ties"])
def test_instanced_mt_kernel_on_the_cull_cases(dev, case):
    """K7 closest and any against trace_instanced_ref on
    the scenes and rays of tests/test_torch_instanced_cull.py (rays in
    the planes of zero-thickness boxes and along their edges, zero
    direction components, tmax <= tmin, two identical instances, a face
    repeated across tiles, degenerate faces), and on shadow rays from
    1e16 away toward the scene (the pool's unread shadow rays of lanes
    that missed): every output bit for bit at the full count and at a
    count inside a ray tile."""
    from rendertoy3c_tpu_torch.trace import instanced_mt as im

    scene, (o, d, tmax) = _cull_case(case)
    soup = im.build_instanced_soup(scene, dev)
    far = torch.as_tensor(o, device=dev) + 1e16 * torch.as_tensor(
        d, device=dev)
    to = torch.as_tensor(o, device=dev) - far
    dist = to.norm(dim=1)
    for near, ro, rd, rt in ((True, torch.as_tensor(o, device=dev),
                              torch.as_tensor(d, device=dev),
                              torch.as_tensor(tmax, device=dev)),
                             (False, far, to / dist[:, None], dist - 1e-3)):
        rays, r = mt.pack_rays(ro, rd, 1e-3, rt)
        for any_hit in (False, True):
            for n in (r, r - 150):
                count = torch.tensor([n], dtype=torch.int32, device=dev)
                got = im.trace_instanced(rays, count, soup, any_hit)
                want = im.trace_instanced_ref(rays, count, soup, any_hit)
                assert _bits(got, want)
            hits = got[:r, 0] > 0 if any_hit else got[:r, 1] >= 0
            assert bool(hits.any()) or not near


# ------------------------------------------------- K4 / K5 sweeps (mt.cuh)
MK_CASES = [(kind, form) for kind in KINDS for form in FORMS]
MK_IDS = [f"{kind}-{form}" for kind, form in MK_CASES]


@pytest.mark.parametrize("kind, form", MK_CASES, ids=MK_IDS)
def test_refill_kernel_on_ties_and_tiles(dev, kind, form):
    """K4 on tests/megakernel_util.py's scenes (a face and its copy in
    different threads of a lane's group; three 512-face tiles, culled and
    merged tile by tile) in each form: one 256-lane block teacher-forced
    for 8 launches, every output bit for bit, stats and the time buffer
    exact."""
    scene, cam, aov = fused_scene(kind, form)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=4,
                       max_depth=8, ray_block=256, integrator="pool",
                       pool_pixel_major=True, aov=aov)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    assert pipe.motion == (form == "motion")
    assert pipe.tables.soup.tris.shape[0] == (3 if kind == "multitile" else 1)
    kern = pipe.refill_shader(4096)
    ref = shade.FusedPipeline(scene, cfg, dev, refill_fn=shade
                              .trace_shade_refill_ref).refill_shader(4096)
    state = [torch.zeros((256, w), dtype=torch.float32, device=dev)
             for w in (8, shade.misc_width(aov), 16)]
    state[1][:, 13] = -1.0
    state[2][:, 0] = -1.0
    if pipe.motion:
        state.append(torch.zeros(256, dtype=torch.float32, device=dev))
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(8):
        outs = []
        for fn in (kern, ref):
            out = [x.clone() for x in state]
            st = torch.zeros(4, dtype=torch.int32, device=dev)
            fn(*out[:3], stats, st, 0, 2, _scf(cam), *out[3:])
            outs.append((out, st))
        (got, st_k), (want, st_r) = outs
        assert torch.equal(st_k, st_r)
        _bits_equal(got, want)
        state, stats = want, st_r
    assert int(stats[2]) > 0


@pytest.mark.parametrize("kind, form", MK_CASES, ids=MK_IDS)
def test_trace_shade_kernel_on_ties_and_tiles(dev, kind, form):
    """K5 on the same scenes and forms at 4096 lanes, 8 iterations
    teacher-forced from the plain version's states, the live count
    alternating between 4096 and 3000: every output bit for bit."""
    scene, cam, aov = fused_scene(kind, form)
    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=8, ray_block=4096, integrator="pool",
                       pool_pixel_major=False, aov=aov)
    pipe = shade.FusedPipeline(scene, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    rays, misc = _lane_state(scene, cam, 4096, 23, dev)
    if aov:
        misc = _widen_aov(misc, 2)
    for it in range(8):
        count = torch.tensor([4096 if it % 2 == 0 else 3000],
                             dtype=torch.int32, device=dev)
        time = (torch.rand(4096, device=dev, generator=gen) if pipe.motion
                else None)
        a = (rays, misc, count, pipe.tables, pipe.config, time)
        got, want = shade.trace_shade(*a), shade.trace_shade_ref(*a)
        _bits_equal(got, want)
        rays, misc = want
        fr, fm = _lane_state(scene, cam, 4096, 60 + it, dev)
        dead = misc[:, 9] <= 0
        rays = torch.where(dead[:, None], fr, rays)
        misc = torch.where(dead[:, None], _widen_aov(fm, it) if aov else fm,
                           misc)
    assert (misc[:, 8] > 2).any()


@pytest.mark.parametrize("n", [1, 100, 8192, 8192 + 37, 16384, 32768])
@pytest.mark.parametrize("layout", ["row_major", "c_major"])
@pytest.mark.parametrize("variant", K6_VARIANTS)
def test_external_shade_kernel_at_pool_sizes(dev, variant, layout, n):
    """K6 (two warps a 32-lane block) against its plain version on the
    card, bit for bit, at the walk and instanced pools' lane counts, a
    count past a multiple of the block and counts below one block, in
    both misc layouts and every variant (tests/k6_case_util.py)."""
    rays, hit4, misc, tables, config, inst = k6_case(variant, n, seed=n,
                                                     device=dev)
    transposed = layout == "c_major"
    if transposed:
        misc = misc.T.contiguous()
    a = (rays, hit4, misc, tables, config)
    counter = "inst_launches" if inst is not None else "launches"
    before = getattr(shade.external_shade, counter)
    got = shade.external_shade(*a, transposed=transposed, inst=inst)
    torch.cuda.synchronize()
    assert getattr(shade.external_shade, counter) == before + 1
    _bits_equal(got, shade.external_shade_ref(*a, transposed=transposed,
                                              inst=inst))


# ------------------------------------ environment maps, the general stage
def _sky(h=64, w=128, seed=0):
    """A seeded lat-long HDR sky: a gradient, noise and a sun of ~1e3."""
    r = np.random.default_rng(seed)
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (np.float32([0.3, 0.5, 0.9]) * (1.2 - v)
           + r.uniform(0, 0.2, (h, w, 3)).astype(np.float32))
    img[h // 4, w // 3] = (1000.0, 950.0, 800.0)
    return img


def test_env_map_sampling_on_the_card_matches_the_cpu(dev):
    """sample_env_map on the card against the CPU on 65536 seeded
    directions, the poles and both sides of the atan2 seam: within
    rtol = atol = 1e-5 of the map's largest value (the two devices' atan2
    and acos may differ in the last ulps)."""
    from rendertoy3c_tpu_torch.scene.envmap import (build_env_map,
                                                    env_map_to,
                                                    sample_env_map)

    img = _sky()
    env = build_env_map(img, 1.5, device="cpu")
    r = np.random.default_rng(3)
    d = r.normal(size=(65536, 3))
    d[:6] = [[0, 1, 0], [0, -1, 0], [0, 0, 1], [-0.0, 0, 1], [1e-7, 0, 1],
             [-1e-7, 0, 1]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    want = sample_env_map(env, torch.as_tensor(d))
    got = sample_env_map(env_map_to(env, dev),
                         torch.as_tensor(d, device=dev)).cpu()
    scale = float(env.data.abs().max())
    np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                               rtol=1e-5, atol=1e-5)


def _general_stage_pipe(case, dev, cfg):
    """(scene, camera, walk pool) of a general-stage case: the 24 x 24 box
    field (K9) and its 2-key form (K9 motion) under an env map, and the
    instance field at grid 4 (K9-inst) and its baked table (K9) under the
    physical throughput model."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.scene.envmap import build_env_map

    if case in ("env_field", "env_field_2key"):
        scene, cam = _walk_pool_scene(case[4:])
        scene = dataclasses.replace(scene, env=build_env_map(
            _sky(), device=dev))
        return scene, cam, walkpool.make_walkpool_pipeline(scene, cfg, dev)
    cfg = dataclasses.replace(cfg, throughput_model="physical")
    scene, cam, pipe = _inst_pipe("baked" if case == "physical_baked"
                                  else "field", dev, cfg)
    return scene, cam, pipe


@pytest.mark.parametrize("case", ["env_field", "env_field_2key",
                                  "physical_inst_field", "physical_baked"])
def test_walk_kernels_under_the_general_stage_match_plain_versions(dev, case):
    """K9 and K9-inst on walk-pool states recorded at boundaries 1, 4 and
    7 of a 64^2 render whose shade stage is the general one (kernel
    False): one launch against its plain version on a clone, every state
    column bit for bit; and the general stage on the card against the
    same stage on CPU copies of those boundaries' inputs: the seed, depth,
    pixel and sample columns bit-equal; the decisions (prev_delta, alive,
    want_shadow) equal on all but 0.05% of the live lanes and every other
    float within rtol = 1e-4, atol = 1e-5 (the CPU test's tolerance
    against the reference) on all but 0.1% of the lanes: the card's sin,
    cos, acos, atan2 and scalar divisions differ from the CPU's in the
    last ulps, which an ill-conditioned lane amplifies (chip_smoke.py
    STAGE_FLIPS, STAGE_OFF)."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.path import general_tables

    cfg = RenderConfig(width=64, height=64, samples_per_launch=2,
                       max_depth=6, ray_block=2048, integrator="pool",
                       pool_pixel_major=True)
    scene, cam, pipe = _general_stage_pipe(case, dev, cfg)
    assert not pipe.kernel and pipe.shade_fn is walkpool.general_shade
    states, inputs = [], []

    def record(s, tab, motion, k):
        if len(states) < 8:
            states.append(s.clone())
        walkpool.walk_rounds(s, tab, motion, k)

    def record_shade(rays, hit4, misc, tables, config, transposed,
                     inst=None):
        if len(inputs) < 8:
            inputs.append((rays.clone(), hit4.clone(), misc.clone(),
                           None if inst is None else inst.clone()))
        return walkpool.general_shade(rays, hit4, misc, tables, config,
                                      transposed, inst)

    launches = (walkpool.walk_rounds.launches,
                walkpool.walk_rounds.inst_launches)
    walkpool._render_pipepool(scene, cfg, cam.params(), dataclasses.replace(
        pipe, walk_fn=record, shade_fn=record_shade), torch.arange(64 * 64),
        0)
    inst_walk = case == "physical_inst_field"
    assert (walkpool.walk_rounds.inst_launches > launches[1]) == inst_walk
    assert (walkpool.walk_rounds.launches > launches[0]) != inst_walk
    k = 20 if inst_walk else 16
    for s in states[1::3]:
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, pipe.table, pipe.motion, k)
        walkpool.walk_rounds(want, pipe.table, pipe.motion, k, plain=True)
        for (name, a), (_, b) in zip(got.tensors(), want.tensors()):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    cpu_tables = general_tables(scene, "cpu")
    flips = off = live_n = lanes = 0
    for rays, hit4, misc, inst in inputs[1::3]:
        got = walkpool.general_shade(rays, hit4, misc, pipe.shade_tables,
                                     pipe.shade_config, True, inst)
        want = walkpool.general_shade(
            rays.cpu(), hit4.cpu(), misc.cpu(), cpu_tables,
            pipe.shade_config, True, None if inst is None else inst.cpu())
        got = [g.cpu().numpy() for g in got]
        want = [w.numpy() for w in want]
        for c in (0, 8, 13, 14):
            np.testing.assert_array_equal(got[1][c].view(np.uint32),
                                          want[1][c].view(np.uint32))
        live = misc[9].cpu().numpy() > 0
        flip = np.zeros_like(live)
        for c in (7, 9, 15):
            flip |= got[1][c] != want[1][c]
        close = np.ones_like(live)
        for g, w in ((got[0], want[0]), (got[1].T, want[1].T),
                     (got[2], want[2])):
            close &= (np.isclose(g, w, rtol=1e-4, atol=1e-5)
                      | (np.isnan(g) & np.isnan(w))).all(axis=1)
        flips += int((flip & live).sum())
        off += int((~close & ~flip).sum())
        live_n += int(live.sum())
        lanes += live.size
    assert flips <= 5e-4 * live_n and off <= 1e-3 * lanes, (flips, off)
