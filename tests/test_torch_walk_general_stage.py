"""The walk pool's general shade stage (integrate/walkpool.py
general_shade, the port of the reference's `_make_xla_shade_stage`,
walkpool.py:255-360) and the routes that reach it.

- The stage against the reference's, teacher-forced for 3 iterations at
  384 lanes, each package's stage as its walk-pool pipeline picks it for
  the same split-ordered scene (both with `kernel` False): the env-lit
  Cornell box static, 2-key and with AOV, the trace-time instanced
  Cornell box and the baked instance field (physical throughput). The
  same rays, closest hits (the port's brute tracer) and C-major misc go
  through both. The seed, prev_delta, depth, alive, pixel, sample and
  want_shadow columns bit-equal on every lane, the zero columns zero, and
  every other float by tests/test_torch_general_shade.py's `_close` rule
  for the reference's shading: within rtol = 1e-4, atol = 1e-5 on at
  least 99% of each output's elements and within rtol = 1e-2 on at least
  99.9% (all of them on the hosts where this was written; XLA's FMAs and
  its own sin, cos and sqrt differ from torch's in the last ulps from
  host to host, and a lane whose sampled cosine is near 0 amplifies that,
  tests/k6_agree_util.py).
- The stage against K6's plain version on the scenes K6 shades, by the
  rule of tests/k6_agree_util.py. The reference's own two stages meet
  that rule on these inputs on the CPU (XLA stage against its K6 in
  interpret mode, every iteration of the four variants), so the port's
  are held to it.
- Whole renders at 24^2, 2 spp, depth 2 (tests/test_walkpool.py:180-195,
  test_walkpool_xla_stage_env_map): the env-lit Cornell box through the
  port's walk pool against the reference's walk pool and against the
  port's hierwalk tracer under the general pool, rtol = atol = 2e-4, the
  radiance rays equal and the shadow rays within 2; the same against the
  hierwalk for a roughness- and emissive-textured scene, a light-less
  env-lit Cornell box and the physical throughput model.
- choose_tracer's routes: an env-lit scene of at most 16384 faces takes
  the bare MT tracer (K1/K2, K3 at 2 keys); an env-lit or ineligible
  scene past 16384 faces (static, 2-key, trace-time instanced or baked)
  the walk pool with kernel False; an eligible one keeps K6.
- The CLI's --env, --env-scale and --throughput."""
import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inst_util import (forced_bake, j_field, j_multi_instance_cornell,
                       to_port_iscene)
from k6_agree_util import check_iteration
from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.walkpool import \
    make_inst_walkpool_pipeline as j_inst_walkpool
from rendertoy3c_tpu.integrate.walkpool import \
    make_walkpool_pipeline as j_make_walkpool
from rendertoy3c_tpu.scene.envmap import EnvMap as JEnvMap
from rendertoy3c_tpu.trace.hier_instanced import \
    split_order_instanced as j_split_inst
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate import walkpool
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import (general_tables,
                                                  render_frame,
                                                  render_pixels)
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.scene.envmap import build_env_map
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from rendertoy3c_tpu_torch.trace.hier_instanced import InstHierTable
from rendertoy3c_tpu_torch.trace.hierwalk import (HIER_LEAF,
                                                  HIER_LEAF_MOTION, HierTable,
                                                  make_hierwalk_tracer)
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
from rendertoy3c_tpu_torch.trace.intersect import trace_closest_bruteforce
from torch_port_util import (cornell_pair, hdr_sky, lit_grid_scene,
                             material_cornell_pair, moving_cornell_pair,
                             textured_quad_meshes, textured_quad_pair)
from walk_render_util import render_pair

LANES = 384
TOL = dict(rtol=1e-4, atol=1e-5)
LOOSE = dict(rtol=1e-2, atol=1e-5)
# misc columns decided by integers or by exact decisions
EXACT_COLS = (0, 7, 8, 9, 13, 14, 15)


def with_env(js, ts, img):
    """Both packages' scenes lit by the lat-long image img."""
    return (dataclasses.replace(js, env=JEnvMap(data=jnp.asarray(img))),
            dataclasses.replace(ts, env=build_env_map(img, device="cpu")))


def _port_cam(jcam):
    return Camera(eye=jcam.eye, lookat=jcam.lookat, up=jcam.up,
                  fov_y=jcam.fov_y, aspect_ratio=1.0)


def _stages(form):
    """(reference pipeline, port pipeline, port scene, port camera) of
    one form, each built by its package's walk-pool factory."""
    if form in ("tracetime", "baked"):
        kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
                  ray_block=LANES, integrator="pool", pool_pixel_major=True,
                  throughput_model="physical")
        if form == "tracetime":
            js, _, _, jcam = j_multi_instance_cornell()
        else:
            js, jcam = j_field(False, 4)
            jcam.eye, jcam.lookat = (0.0, 6.0, 9.0), (0.0, 0.5, 0.0)
        js = j_split_inst(js)
        ts = to_port_iscene(js)
        with forced_bake() if form == "baked" else contextlib.nullcontext():
            jpipe = j_inst_walkpool(js, JConfig(**kw))
        pipe = walkpool.make_inst_walkpool_pipeline(
            ts, RenderConfig(**kw), "cpu", bake=form == "baked")
        assert (pipe.inst_stride > 0) == (form == "baked")
        assert pipe.inst_stride == jpipe.inst_stride
        return jpipe, pipe, ts, _port_cam(jcam)
    js, ts, _, cam = (moving_cornell_pair if form == "two_key"
                      else cornell_pair)()
    js, ts = with_env(js, ts, hdr_sky())
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=LANES, integrator="pool", pool_pixel_major=True,
              aov=form == "aov")
    leaf = HIER_LEAF_MOTION if form == "two_key" else HIER_LEAF
    js, ts = j_split_order(js, leaf=leaf), split_order_scene(ts, leaf=leaf)
    return (j_make_walkpool(js, JConfig(**kw)),
            walkpool.make_walkpool_pipeline(ts, RenderConfig(**kw), "cpu"),
            ts, cam)


def _fresh(cam, n, rng, mw):
    """Camera rays and fresh paths (random seeds), 90% of the lanes alive,
    misc C-major [mw, n] with random AOV accs."""
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


def _closest(scene, rays, time):
    """The closest hits of the port's brute tracers: (hit4 [R, 4], inst
    [R] int32 or None)."""
    rt = torch.as_tensor(rays)
    if hasattr(scene, "instance_mesh"):
        hit = make_instanced_tracer(scene, "cpu")[0](
            rt[:, 0:3], rt[:, 3:6], rt[:, 6], rt[:, 7], torch.as_tensor(time))
    else:
        hit = trace_closest_bruteforce(scene, rt[:, 0:3], rt[:, 3:6],
                                       rt[:, 6], rt[:, 7],
                                       torch.as_tensor(time))
    hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
    return hit4, hit.inst


def _close(got, want, name):
    """Within TOL on at least 99% of the elements, LOOSE on 99.9%."""
    nan = np.isnan(got) & np.isnan(want)
    tol = (np.isclose(got, want, **TOL) | nan).mean()
    loose = (np.isclose(got, want, **LOOSE) | nan).mean()
    assert tol >= 0.99 and loose >= 0.999, (name, tol, loose)


def _next(want, mw, cam, rng):
    """The reference's outputs as the next input, its NEE added on every
    lane that wanted a shadow ray; dead lanes restart fresh."""
    rays = want[0].copy()
    misc = want[1][:mw].copy()
    misc[10:13] += want[1][mw:mw + 3]
    dead = misc[9] <= 0
    fresh = _fresh(cam, rays.shape[0], rng, mw)
    rays[dead], misc[:, dead] = fresh[0][dead], fresh[1][:, dead]
    return rays, misc


@pytest.mark.parametrize("form", ["static", "two_key", "aov", "tracetime",
                                  "baked"])
def test_general_stage_matches_reference(form):
    jpipe, pipe, ts, cam = _stages(form)
    assert not jpipe.kernel and not pipe.kernel
    assert pipe.shade_fn is walkpool.general_shade
    mw, sw = pipe.misc_w, pipe.shadow_w
    assert (mw, sw) == (24 if form == "aov" else 16,
                        16 if form == "two_key" else 8)
    rng = np.random.default_rng(29)
    rays, misc = _fresh(cam, LANES, rng, mw)
    for _ in range(3):
        time = rng.uniform(0, 1, LANES).astype(np.float32)
        hit4, inst = _closest(ts, rays, time)
        assert int((hit4[:, 1] >= 0).sum()) > LANES // 3
        hit8 = np.zeros((LANES, 8), np.float32)
        hit8[:, :4] = hit4.numpy()
        if inst is not None:
            hit8[:, 4] = inst.numpy()
        want = [np.array(x) for x in jpipe.shade(
            jnp.asarray(rays), jnp.asarray(hit8), jnp.asarray(misc), None,
            LANES)]
        got = [x.numpy() for x in pipe.shade(
            torch.as_tensor(rays), hit4, torch.as_tensor(misc), inst)]
        assert [g.shape for g in got] == [w.shape for w in want] == [
            (LANES, 8), (mw + 8, LANES), (LANES, sw)]
        bits_g, bits_w = got[1].view(np.uint32), want[1].view(np.uint32)
        for k in EXACT_COLS:
            np.testing.assert_array_equal(bits_g[k], bits_w[k],
                                          err_msg=f"misc column {k}")
        # the zero columns: after the NEE term, the AOV pad, the shadow
        # ray's tail
        assert not got[1][mw + 3:].any()
        if form == "aov":
            assert not got[1][22:24].any()
        if sw == 16:
            assert not got[2][:, 9:].any()
        for name, g, w in zip(("rays", "misc", "shadow"), got, want):
            _close(g, w, name)
        # a lane that wants no shadow ray has tmax 0
        assert not got[2][got[1][15] == 0, 7].any()
        rays, misc = _next(want, mw, cam, rng)


@pytest.mark.parametrize("variant", ["untextured", "textured",
                                     "dispatch_power", "aov"])
def test_general_stage_agrees_with_k6_plain_version(variant):
    """On scenes K6 shades, the general stage (over the scene's
    GeneralTables) against external_shade_ref, by K6's agreement rule."""
    pairs = {"textured": textured_quad_pair,
             "dispatch_power": material_cornell_pair}
    _, ts, _, cam = pairs.get(variant, cornell_pair)()
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=512, integrator="pool", pool_pixel_major=True,
              aov=variant == "aov",
              light_sampler="power" if variant == "dispatch_power"
              else "uniform")
    ts = split_order_scene(ts, leaf=HIER_LEAF)
    cfg = RenderConfig(**kw)
    pipe = walkpool.make_walkpool_pipeline(ts, cfg, "cpu")
    assert pipe.kernel
    tables = general_tables(ts, "cpu")
    config = walkpool.GeneralStageConfig(cfg=cfg, motion=False)
    mw = pipe.misc_w
    rng = np.random.default_rng(23)
    rays, misc = _fresh(cam, 512, rng, mw)
    for _ in range(3):
        hit4, _ = _closest(ts, rays, np.zeros(512, np.float32))
        rt, mt = torch.as_tensor(rays), torch.as_tensor(misc)
        want = [x.numpy() for x in shade.external_shade_ref(
            rt, hit4, mt, pipe.shade_tables, pipe.shade_config,
            transposed=True)]
        got = [x.numpy() for x in walkpool.general_shade(
            rt, hit4, mt, tables, config)]
        check_iteration(rays, hit4.numpy(), misc, got, want,
                        pipe.shade_tables, pipe.shade_config,
                        transposed=True)
        rays, misc = _next(want, mw, cam, rng)


def _rgb(res):
    return (res[0].numpy(), int(res[2]), int(res[3]))


def _hierwalk_pair(ts, cam, **change):
    """(walk pool, hierwalk under the general pool) render_pixels results
    over the split-ordered ts, 24^2, 2 spp, depth 2."""
    cfg = RenderConfig(width=24, height=24, integrator="pool",
                       pool_pixel_major=True, samples_per_launch=2,
                       ray_block=1024, max_depth=2, **change)
    cam.aspect_ratio = 1.0
    pipe = walkpool.make_walkpool_pipeline(ts, cfg, "cpu")
    assert not pipe.kernel
    n = cfg.width * cfg.height
    walk = render_pixels(ts, cfg, cam.params(), pipe, torch.arange(n), 0)
    hier = render_pixels(ts, cfg, cam.params(),
                         make_hierwalk_tracer(ts, "cpu"), torch.arange(n), 0)
    return _rgb(walk), _rgb(hier)


def _assert_renders_agree(got, want):
    """test_walkpool_xla_stage_env_map's rule."""
    assert got[1] == want[1] and abs(got[2] - want[2]) <= 2
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-4)
    assert np.isfinite(got[0]).all() and got[0].mean() > 0


def test_env_walk_pool_matches_reference_and_hierwalk():
    js, ts, jcam, tcam = cornell_pair()
    h, w = 8, 16
    img = np.linspace(0.0, 1.0, h * w * 3, dtype=np.float32).reshape(h, w, 3)
    js, ts = with_env(js, ts, img)
    js = j_split_order(js, leaf=HIER_LEAF)
    ts = split_order_scene(ts, leaf=HIER_LEAF)
    got, want = render_pair(js, ts, jcam, tcam, order=False, max_depth=2)
    _assert_renders_agree((got[0], got[2], got[3]), (want[0], want[2],
                                                     want[3]))
    walk, hier = _hierwalk_pair(ts, tcam)
    _assert_renders_agree(walk, hier)
    np.testing.assert_array_equal(walk[0], got[0])


def _emissive_rough_scene():
    """The textured quad's floor PRINCIPLED, emissive (2, 2, 2), with its
    texture as the emissive and roughness maps."""
    from rendertoy3c_tpu_torch.scene.material import MaterialType
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, textures, cam = textured_quad_meshes("torch")
    meshes[0].material = dataclasses.replace(
        meshes[0].material, material_type=MaterialType.PRINCIPLED,
        roughness=0.5, emissive=(2.0, 2.0, 2.0), emissive_texture_id=0,
        roughness_texture_id=0)
    return build_scene(meshes, textures=textures), cam


@pytest.mark.parametrize("case", ["emissive_roughness_textures",
                                  "no_lights_env", "physical"])
def test_ineligible_walk_pool_matches_hierwalk(case):
    change = {}
    if case == "emissive_roughness_textures":
        ts, cam = _emissive_rough_scene()
        assert shade.texture_state(ts) == "unsupported"
    else:
        _, ts, _, cam = cornell_pair()
        if case == "physical":
            change = dict(throughput_model="physical")
        else:
            ts = dataclasses.replace(ts, num_lights=0, env=build_env_map(
                hdr_sky(8, 16), device="cpu"))
    ts = split_order_scene(ts, leaf=HIER_LEAF)
    walk, hier = _hierwalk_pair(ts, cam, **change)
    _assert_renders_agree(walk, hier)


@pytest.fixture(scope="module")
def grid():
    return lit_grid_scene("torch")


def _two_key(scene):
    g = scene.geom
    shift = np.float32([0.2, 0.0, 0.1])
    geom = g._replace(**{k: np.concatenate([getattr(g, k)] * 2)
                         for k in ("e1", "e2", "n0", "n1", "n2")},
                      v0=np.concatenate([g.v0, g.v0 + shift]))
    return dataclasses.replace(scene, geom=geom, num_keys=2)


POOL = dict(integrator="pool", pool_pixel_major=True, width=16, height=16,
            samples_per_launch=1, max_depth=3, ray_block=1024)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_env_scene_of_the_mt_band_takes_the_bare_mt_tracer(motion):
    _, ts, _, _ = (moving_cornell_pair if motion else cornell_pair)()
    ts = dataclasses.replace(ts, env=build_env_map(hdr_sky(), device="cpu"))
    _, tracer = choose_tracer(ts, RenderConfig(**POOL), "cpu")
    assert isinstance(tracer, tuple) and len(tracer) == 2
    assert tracer[0].__qualname__.startswith("make_mt_tracer")
    # the kernels refuse it, naming the environment map
    assert "environment maps" in shade.fused_unsupported(
        ts, RenderConfig(**POOL))
    assert "environment maps" in shade.external_unsupported(
        ts, RenderConfig(**POOL))


@pytest.mark.parametrize("case", ["env", "env_2key", "physical",
                                  "eligible"])
def test_walk_band_routes(grid, case):
    scene = _two_key(grid) if case == "env_2key" else grid
    cfg = RenderConfig(**POOL)
    if case.startswith("env"):
        scene = dataclasses.replace(scene, env=build_env_map(
            hdr_sky(), device="cpu"))
    elif case == "physical":
        cfg = dataclasses.replace(cfg, throughput_model="physical")
    ordered, pipe = choose_tracer(scene, cfg, "cpu")
    assert isinstance(pipe, walkpool.WalkPoolPipeline)
    assert pipe.kernel == (case == "eligible")
    assert isinstance(pipe.shade_tables, shade.ExternalTables) == pipe.kernel
    assert pipe.shadow_w == (16 if case == "env_2key" else 8)
    assert isinstance(pipe.table, HierTable)
    assert ordered.env is scene.env and ordered.num_faces >= grid.num_faces


@pytest.mark.parametrize("case", ["tracetime", "baked", "tracetime_eligible",
                                  "baked_eligible"])
def test_instanced_walk_band_routes(case):
    """Past 16384 effective faces: the 2-key field (trace-time, K9-inst)
    and the static field (baked, K9) at grid 5 (24300 effective faces)
    take the general stage under physical throughput, K6 otherwise."""
    ts = to_port_iscene(j_field(case.startswith("tracetime"), 5)[0])
    cfg = RenderConfig(**POOL)
    if not case.endswith("eligible"):
        cfg = dataclasses.replace(cfg, throughput_model="physical")
    _, pipe = choose_tracer(ts, cfg, "cpu")
    assert isinstance(pipe, walkpool.WalkPoolPipeline) and pipe.instanced
    assert pipe.kernel == case.endswith("eligible")
    baked = case.startswith("baked")
    assert (pipe.inst_stride > 0) == baked
    assert isinstance(pipe.table, HierTable if baked else InstHierTable)


def test_cli_env_and_throughput(tmp_path):
    """--env (an EXR sky) with --env-scale and --throughput physical give
    the EXR of render_frame over the same scene and config."""
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.film.image import read_exr, write_exr
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    sky = hdr_sky(8, 16)
    write_exr(str(tmp_path / "sky.exr"), sky)
    out = str(tmp_path / "o.exr")
    assert cli.main(["--scene", "cornell", "--env", str(tmp_path / "sky.exr"),
                     "--env-scale", "2.5", "--throughput", "physical",
                     "--size", "16x16", "--spp", "1", "--subframes", "1",
                     "--max-depth", "2", "--device", "cpu", "-o", out]) == 0
    meshes, camera = cornell_box()
    camera.aspect_ratio = 1.0
    scene = build_scene(meshes, env_map=build_env_map(sky, 2.5,
                                                      device="cpu"))
    cfg = RenderConfig(width=16, height=16, samples_per_launch=1,
                       max_depth=2, integrator="pool", pool_pixel_major=True,
                       throughput_model="physical")
    film, _ = render_frame(scene, camera.params(), cfg, device="cpu")
    np.testing.assert_array_equal(read_exr(out),
                                  np.flip(film.accum.numpy(), axis=0))


@pytest.mark.parametrize("case", ["env_cornell", "env_grid", "physical_field"])
def test_dist_factory_routes_as_choose_tracer(grid, case):
    """parallel/dist.py prepare_tracer_factory (kind "auto") sends env-lit
    and ineligible scenes where choose_tracer does: the bare MT pair at or
    below 16384 faces, the walk pool with the general stage past them."""
    from rendertoy3c_tpu_torch.parallel import dist

    cfg = RenderConfig(**POOL)
    env = build_env_map(hdr_sky(), device="cpu")
    if case == "env_cornell":
        scene = dataclasses.replace(cornell_pair()[1], env=env)
    elif case == "env_grid":
        scene = dataclasses.replace(grid, env=env)
    else:
        scene = to_port_iscene(j_field(False, 5)[0])
        cfg = dataclasses.replace(cfg, throughput_model="physical")
    ordered, fac = dist.prepare_tracer_factory(scene, cfg, device="cpu")
    got = fac(ordered, None, cfg)
    _, want = choose_tracer(scene, cfg, "cpu")
    if case == "env_cornell":
        assert isinstance(got, tuple) and isinstance(want, tuple)
        assert got[0].__qualname__ == want[0].__qualname__
        return
    assert isinstance(got, walkpool.WalkPoolPipeline)
    assert not got.kernel and not want.kernel
    assert got.inst_stride == want.inst_stride


def test_card_rule_tolerates_last_ulp_noise():
    """The rule chip_smoke.py (STAGE_FLIPS, STAGE_OFF) and the CUDA test
    hold the card's general stage to the CPU's by, on the CPU: the stage
    on 131072 lanes of the env-lit Cornell box for 3 iterations against
    the same stage with sin, cos, acos and atan2 nudged one ulp up in a
    seeded 30% of their results, as the card's torch may round them. The
    integer columns stay bit-equal; a decision flips at its edge (1 of
    117958 live lanes in iteration 0 here) and a few lanes whose sampled
    cosine is near 0 leave rtol 1e-4, atol 1e-5 (15-29 a boundary here),
    within the rule's 0.05% and 0.1%."""
    _, ts, _, cam = cornell_pair()
    ts = split_order_scene(dataclasses.replace(
        ts, env=build_env_map(hdr_sky(), device="cpu")), leaf=HIER_LEAF)
    cfg = RenderConfig(integrator="pool", ray_block=1024, max_depth=16)
    pipe = walkpool.make_walkpool_pipeline(ts, cfg, "cpu")
    n = 131072
    rng = np.random.default_rng(5)
    rays, misc = _fresh(cam, n, rng, 16)
    names = ("sin", "cos", "acos", "atan2")
    for it in range(3):
        hit4, _ = _closest(ts, rays, np.zeros(n, np.float32))
        rt, mt = torch.as_tensor(rays), torch.as_tensor(misc)
        want = [x.numpy() for x in pipe.shade(rt, hit4, mt)]
        gen = torch.Generator().manual_seed(it)
        orig = {k: getattr(torch, k) for k in names}

        def nudged(f):
            def g(*args, **kw):
                y = f(*args, **kw)
                up = torch.nextafter(y, torch.full_like(y, float("inf")))
                return torch.where(torch.rand(y.shape, generator=gen) < 0.3,
                                   up, y)
            return g

        try:
            for k in names:
                setattr(torch, k, nudged(orig[k]))
            got = [x.numpy() for x in pipe.shade(rt, hit4, mt)]
        finally:
            for k, f in orig.items():
                setattr(torch, k, f)
        for c in (0, 8, 13, 14):
            np.testing.assert_array_equal(got[1][c].view(np.uint32),
                                          want[1][c].view(np.uint32))
        live = misc[9] > 0
        flip = np.zeros(n, bool)
        for c in (7, 9, 15):
            flip |= got[1][c] != want[1][c]
        close = np.ones(n, bool)
        for g, w in ((got[0], want[0]), (got[1].T, want[1].T),
                     (got[2], want[2])):
            close &= (np.isclose(g, w, **TOL)
                      | (np.isnan(g) & np.isnan(w))).all(axis=1)
        off = ~close & ~flip
        assert (flip & live).sum() <= 5e-4 * live.sum()
        assert off.sum() <= 1e-3 * n
        assert off.sum() > 0  # the nudges do reach ill-conditioned lanes
        rays, misc = _next(want, 16, cam, rng)
