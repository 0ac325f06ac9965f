"""The first-hit AOV rows (albedo and shading normal, misc columns 16-21)
and the film's guide buffers against the reference (Pallas in interpret
mode).

Teacher-forced, as tests/test_torch_megakernel.py, test_torch_trace_shade.py
and test_torch_external.py do without AOV: K4 with aov=True on the Cornell
box, its 2-key variant, the textured quad with a uv transform and a normal
map, the 2-key material Cornell box and the principled quad (8 launches at
pool 512; the stash's AOV columns are in use from launch 4 on); K5 with
aov=True on the Cornell box, the 2-key normal-mapped quad and the material
Cornell box with the power pick (AOV input columns random, 8 iterations);
K6 with aov=True on the textured 4294-face town and the principled town
(BASELINE config 5's scene). The integer columns exact; every float
column, the 8 AOV columns and K6's 32 included, within rtol = atol = 3e-5
on at least 98% of the (live) lanes, the tolerance of those tests; stats
and the time buffer exact.

Whole renders through render_frame (2 subframes of 16^2, 2 spp, depth 4)
against the reference's render over its own pipeline: the Cornell box
pixel-major (K4), stashless (pool_stash=0), sorted and sample-major (K5),
the 2-key Cornell box, the normal-mapped textured quad, the material
Cornell box, and the 4294-face textured town (K6; without and with the
XLA-refill loop's stash). film.accum by the
`_match` rule of tests/test_fused.py (>98% of pixels within 3e-5, means
within 2e-3, 5e-3 on the town); film.albedo and film.normal at rtol 1e-4,
atol 1e-5, the reference's own tolerance (tests/test_aov.py:130-139): they
do not depend on Russian-roulette draws, so a lost stash row would show as
an O(1) difference. The largest |d| that held: on the albedo buffers 0
(untextured), 3.8e-6 (the quad) and 2.2e-5 (the town, whose hit u/v differ
by up to 3e-6 where XLA contracts to FMAs); on the normal buffers
5.4e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.film.film import film_create as j_film_create
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import make_render_fn as j_render_fn
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_shade import (make_external_shader,
                                                make_fused_pipeline,
                                                make_fused_shader)
from rendertoy3c_tpu_torch.film.film import film_create
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import make_render_fn, render_frame
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from test_torch_external import _lane_state as town_lanes
from test_torch_external import j_morton_order
from test_torch_trace_shade import _fresh_lanes
from torch_port_util import (cornell_pair, j_town_scene,
                             material_cornell_pair, moving_cornell_pair,
                             textured_quad_pair)

CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=512, integrator="pool", pool_pixel_major=True,
           aov=True)
POOL, N_PIX, SUB = 512, 256, 1
INT_COLS = [0, 8, 9, 13, 14, 15]  # seed bits, depth, alive, pixel, samp, shadow
FLOAT_COLS = [c for c in range(24) if c not in INT_COLS]
AOV = slice(16, 22)


def _agree(got, want, cols, exact):
    """[R] bool: lanes whose given columns agree."""
    if exact:
        ok = got[:, cols].view(np.uint32) == want[:, cols].view(np.uint32)
    else:
        ok = np.isclose(got[:, cols], want[:, cols], rtol=3e-5, atol=3e-5)
    return ok.all(axis=1)


def _widen(misc, rng):
    """A [R, 16] lane state widened to AOV's 24 columns, its accs random."""
    out = np.zeros((misc.shape[0], 24), np.float32)
    out[:, :16] = misc
    out[:, AOV] = rng.uniform(-1, 1, (misc.shape[0], 6)).astype(np.float32)
    return out


def _scf(cam):
    p = cam.params()
    return np.concatenate([p.eye, p.u, p.v, p.w]).astype(np.float32)


# ---------------------------------------------------------------- K4
def _k4_steps(scenes, motion):
    """8 launches of the reference's AOV refill megakernel from an empty
    pool: (port scene, port camera, [(inputs, outputs)])."""
    js, ts, jcam, tcam = scenes
    soup = j_soup(js.geom, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces)
    soup1 = (j_soup(js.geom, key=1, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces) if motion else None)
    kern = make_fused_shader(js, JConfig(**CFG), soup, soup1, interpret=True,
                             merged=True,
                             refill=dict(n_pix=N_PIX, use_stash=True))
    rays = np.zeros((POOL, 8), np.float32)
    misc = np.zeros((POOL, 24), np.float32)
    misc[:, 13] = -1.0
    stash = np.zeros((POOL, 16), np.float32)
    stash[:, 0] = -1.0
    time = np.zeros(POOL, np.float32)
    next_work, count = 0, 0
    steps = []
    for _ in range(8):
        sci = np.array([next_work, 0, SUB, 0], np.int32)
        time8 = ((jnp.asarray(np.repeat(time[:, None], 8, axis=1)),)
                 if motion else ())
        outs = [np.asarray(x) for x in kern(
            jnp.asarray(rays), jnp.asarray(misc), jnp.asarray(stash), count,
            sci, _scf(jcam), *time8)]
        if motion:
            outs[3] = outs[3][:, 0]
        else:
            outs.insert(3, None)
        steps.append(((rays, misc, stash, next_work, count, time), outs))
        rays, misc, stash = outs[0].copy(), outs[1].copy(), outs[2].copy()
        if motion:
            time = outs[3].copy()
        next_work, count = int(outs[4][0]), int(outs[4][1])
    return ts, tcam, steps


def _k4_port(ts, tcam, inputs):
    """[rays, misc, stash, stats, time] after one launch of the port's K4
    (its plain version, on the CPU)."""
    rays, misc, stash, next_work, count, time = inputs
    pipe = shade.FusedPipeline(ts, RenderConfig(**CFG), "cpu")
    assert pipe.config.aov
    t = [torch.as_tensor(a.copy()) for a in (rays, misc, stash)]
    tm = torch.as_tensor(time.copy()) if pipe.motion else None
    stats_in = torch.tensor([next_work, count, 0, 0], dtype=torch.int32)
    stats_out = torch.zeros(4, dtype=torch.int32)
    pipe.refill_shader(N_PIX)(*t, stats_in, stats_out, 0, SUB,
                              tuple(map(float, _scf(tcam))), tm)
    return [x.numpy() for x in t] + [stats_out.numpy(),
                                     None if tm is None else tm.numpy()]


K4_CASES = {
    "cornell": lambda: cornell_pair(),
    "2key-cornell": lambda: moving_cornell_pair(),
    "textured-features": lambda: textured_quad_pair("features"),
    "2key-material": lambda: material_cornell_pair(True),
    "principled-quad": lambda: textured_quad_pair("principled"),
}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_aov_refill_ref_matches_reference_kernel(case):
    """K4 with aov=True: 8 launches teacher-forced, the stash's AOV
    columns 4-9 included."""
    motion = case.startswith("2key")
    ts, tcam, steps = _k4_steps(K4_CASES[case](), motion)
    retired = 0
    for inputs, want in steps:
        got = _k4_port(ts, tcam, inputs)
        assert got[1].shape == (POOL, 24)
        np.testing.assert_array_equal(got[3], want[4])  # stats
        if motion:
            np.testing.assert_array_equal(got[4].view(np.uint32),
                                          want[3].view(np.uint32))
        assert _agree(got[1], want[1], INT_COLS, exact=True).mean() >= 0.98
        assert _agree(got[1], want[1], FLOAT_COLS, exact=False).mean() >= 0.98
        assert _agree(got[0], want[0], list(range(8)), False).mean() >= 0.98
        assert _agree(got[2], want[2], list(range(16)), False).mean() >= 0.98
        assert not got[1][:, 22:].any() and not got[2][:, 10:].any()
        # lanes retired into free stash slots with guides that hit
        taken = (want[2][:, 0] >= 0) & (inputs[2][:, 0] < 0)
        retired += int((np.abs(want[2][taken, 4:10]).sum(axis=1) > 0).sum())
    assert retired > 0


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("case", ["cornell", "2key-normal_map",
                                  "material-power"])
def test_aov_trace_shade_ref_matches_reference_kernel(case):
    """K5 with aov=True: 8 iterations teacher-forced, the live count
    alternating between the whole pool and 300 lanes."""
    motion = case.startswith("2key")
    scenes = {"cornell": cornell_pair,
              "2key-normal_map": lambda: textured_quad_pair("normal_map",
                                                            True),
              "material-power": material_cornell_pair}[case]()
    cfg = dict(CFG, light_sampler="power" if case.endswith("power")
               else "uniform")
    js, ts, jcam, tcam = scenes
    j_pipe = make_fused_pipeline(js, JConfig(**cfg), interpret=True)
    j_shade = make_fused_shader(js, JConfig(**cfg), j_pipe.soup,
                                j_pipe.soup1 if motion else None,
                                interpret=True, merged=True)
    pipe = shade.FusedPipeline(ts, RenderConfig(**cfg), "cpu")
    assert pipe.motion == motion and pipe.config.aov
    rng = np.random.default_rng(41)
    rays, misc = _fresh_lanes(tcam, POOL, rng)
    misc = _widen(misc, rng)
    for step in range(8):
        count = POOL if step % 2 == 0 else 300
        tm = rng.uniform(0, 1, POOL).astype(np.float32)
        time8 = jnp.asarray(np.repeat(tm[:, None], 8, axis=1)) if motion \
            else None
        want = [np.asarray(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(misc), count, time8)]
        got = [x.numpy() for x in pipe.trace_shade(
            torch.as_tensor(rays), torch.as_tensor(misc),
            torch.tensor([count], dtype=torch.int32), torch.as_tensor(tm))]
        assert got[1].shape == want[1].shape == (POOL, 24)
        alive = misc[:, 9] > 0
        ok = (_agree(got[1], want[1], INT_COLS, exact=True)
              & _agree(got[1], want[1], FLOAT_COLS, exact=False)
              & _agree(got[0], want[0], list(range(8)), False))
        assert ok[alive].mean() >= 0.98, step
        # dead lanes pass their AOV accs on unchanged
        np.testing.assert_array_equal(got[1][~alive, AOV], misc[~alive, AOV])
        rays, misc = want[0].copy(), want[1].copy()
        dead = misc[:, 9] <= 0
        fresh = _fresh_lanes(tcam, POOL, rng)
        rays[dead] = fresh[0][dead]
        misc[dead] = _widen(fresh[1], rng)[dead]


# ---------------------------------------------------------------- K6
@pytest.fixture(scope="module")
def aov_towns(tmp_path_factory):
    """{name: (reference scene, port scene, port camera)}: the textured
    and the principled (BASELINE config 5's scene) 4294-face towns."""
    out = {}
    for name, kw in (("textured", dict(textured=True)),
                     ("principled", dict(textured=True, principled=True))):
        js, _ = j_town_scene(4000, False, tmp_path_factory.mktemp(name), **kw)
        ts, cam = town_scene(4000, **kw)
        out[name] = (js, ts, cam)
    return out


@pytest.mark.parametrize("name", ["textured", "principled"])
def test_aov_external_shade_ref_matches_reference_kernel(aov_towns, name):
    """K6 with aov=True: misc [R, 24] in, [R, 32] out (the pending NEE in
    columns 24-26), 8 iterations teacher-forced."""
    js, ts, cam = aov_towns[name]
    kw = dict(CFG, ray_block=256,
              light_sampler="power" if name == "principled" else "uniform")
    ts, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    js = j_morton_order(js)
    assert isinstance(pipe, shade.ExternalPipeline) and pipe.config.aov
    j_shade, attr_rows, presample = make_external_shader(
        js, JConfig(**kw), motion=False, interpret=True)
    attr_rows = np.asarray(attr_rows)
    rng = np.random.default_rng(43)
    rays, misc = town_lanes(cam, POOL, rng)
    misc = _widen(misc, rng)
    count = torch.tensor([POOL], dtype=torch.int32)
    for _ in range(8):
        rt = torch.as_tensor(rays)
        hit = pipe._closest(rt[:, 0:3], rt[:, 3:6], rt[:, 6], rt[:, 7], None,
                            count)
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        attr_t = attr_rows[np.maximum(hit.prim.numpy(), 0)]
        if presample is not None:
            attr_t = np.concatenate([attr_t, np.asarray(presample(
                jnp.asarray(attr_t), jnp.asarray(hit.u.numpy()),
                jnp.asarray(hit.v.numpy())))], axis=1)
        hit8 = np.concatenate([hit4.numpy(), np.zeros((POOL, 4), np.float32)],
                              axis=1)
        want = [np.array(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(hit8), jnp.asarray(misc),
            jnp.asarray(attr_t.T), POOL)]
        got = [x.numpy() for x in shade.external_shade_ref(
            rt, hit4, torch.as_tensor(misc), pipe.tables, pipe.config)]
        assert [g.shape for g in got] == [w.shape for w in want]
        assert got[1].shape == (POOL, 32)
        alive = misc[:, 9] > 0
        ok = (_agree(got[1], want[1], INT_COLS, exact=True)
              & _agree(got[1], want[1],
                       [c for c in range(32) if c not in INT_COLS], False)
              & _agree(got[0], want[0], list(range(8)), False)
              & _agree(got[2], want[2], list(range(8)), False))
        assert ok[alive].mean() >= 0.98
        sh = torch.as_tensor(want[2])
        occ = pipe._any(sh[:, 0:3], sh[:, 3:6], sh[:, 6], sh[:, 7], None,
                        count).numpy()
        rays = want[0]
        misc = want[1][:, :24].copy()
        misc[:, 10:13] += np.where(occ[:, None], 0.0, want[1][:, 24:27])
        dead = misc[:, 9] <= 0
        fresh = town_lanes(cam, POOL, rng)
        rays[dead] = fresh[0][dead]
        misc[dead] = _widen(fresh[1], rng)[dead]


# ---------------------------------------------------------------- renders
KW = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
          ray_block=256, integrator="pool", pool_pixel_major=True, aov=True)


def _render_pair(js, j_tracer, ts, cam, kw):
    """2 subframes on each side through make_render_fn: (port film, its
    stats per subframe, reference film, its stats per subframe)."""
    jstep = j_render_fn(js, JConfig(**kw), tracer=j_tracer)
    jf = j_film_create(kw["height"], kw["width"], aov=True)
    cfg = RenderConfig(**kw)
    step = make_render_fn(ts, cfg, device="cpu")
    f = film_create(cfg.height, cfg.width, device="cpu", aov=True)
    stats, j_stats = [], []
    for _ in range(2):
        jf, js_ = jstep(cam.params(), jf)
        f, s = step(cam.params(), f)
        j_stats.append((int(js_.radiance_rays), int(js_.shadow_rays),
                        int(js_.pool_iters)))
        stats.append((int(s.radiance_rays), int(s.shadow_rays),
                      int(s.pool_iters)))
    return f, stats, jf, j_stats


def _assert_aov_match(f, stats, jf, j_stats, mean_rtol, count_rel,
                      count_abs, hit_share=0.5):
    a, b = f.accum.numpy(), np.asarray(jf.accum)
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=mean_rtol)
    for got, want in zip(stats, j_stats):
        for g, w in zip(got[:2], want[:2]):
            assert abs(g - w) <= count_rel * w + count_abs, (g, w)
        assert got[2] == want[2], ("pool iterations", got, want)
    for name in ("albedo", "normal"):
        got, want = getattr(f, name).numpy(), np.asarray(getattr(jf, name))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    alb = f.albedo.numpy()
    # pixels whose camera rays hit carry an albedo
    assert np.isfinite(alb).all() and (alb.sum(axis=-1) > 0).mean() > hit_share
    assert np.linalg.norm(f.normal.numpy(), axis=-1).max() <= 1.0 + 1e-4


FUSED_CASES = {
    "cornell-pixel_major": (cornell_pair, {}),
    "cornell-stashless": (cornell_pair, dict(pool_stash=0)),
    "cornell-sorted": (cornell_pair, dict(sort_rays=True)),
    "cornell-sample_major": (cornell_pair, dict(pool_pixel_major=False)),
    "2key-cornell": (moving_cornell_pair, {}),
    "textured-normal_map": (lambda: textured_quad_pair("normal_map"), {}),
    "material-cornell": (material_cornell_pair, {}),
}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_aov_render_matches_reference_fused(case):
    scenes, change = FUSED_CASES[case]
    js, ts, _, tcam = scenes()
    kw = dict(KW, **change)
    _, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, shade.FusedPipeline)
    j_pipe = make_fused_pipeline(js, JConfig(**kw), interpret=True)
    _assert_aov_match(*_render_pair(js, j_pipe, ts, tcam, kw), 2e-3, 0.01, 8)


@pytest.mark.parametrize("pool_stash", [-1, 1])
def test_aov_render_matches_reference_textured_town(aov_towns, pool_stash):
    """The 4294-face textured town on the external pipeline (K6 with
    aov=True), pixel-major; pool_stash 1 takes the XLA-refill loop's stash
    branch, whose stash carries the AOV accs in columns 4-9."""
    js, ts, cam = aov_towns["textured"]
    kw = dict(KW, pool_stash=pool_stash)
    js, j_pipe = j_choose_tracer(js, JConfig(**kw), on_tpu=True)
    assert type(j_pipe).__name__ == "ExternalPipeline"
    _, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    assert isinstance(pipe, shade.ExternalPipeline)
    _assert_aov_match(*_render_pair(js, j_pipe, ts, cam, kw), 5e-3, 0.02,
                      16, hit_share=0.3)


def test_aov_wave_integrator_raises_naming_a6():
    """The wave integrator stays outside the slice, with or without AOV."""
    _, ts, _, _ = cornell_pair()
    for aov in (False, True):
        cfg = RenderConfig(**dict(KW, integrator="wave", aov=aov))
        with pytest.raises(NotImplementedError, match="A6"):
            choose_tracer(ts, cfg, "cpu")


def test_aov_off_leaves_film_plain():
    """tests/test_aov.py: without cfg.aov the film has no guide buffers,
    and the radiance does not depend on the AOV rows."""
    _, ts, _, tcam = cornell_pair()
    kw = dict(KW, samples_per_launch=1, max_depth=2)
    film, _ = render_frame(ts, tcam.params(), RenderConfig(**dict(
        kw, aov=False)), device="cpu")
    assert film.albedo is None and film.normal is None
    film_aov, _ = render_frame(ts, tcam.params(), RenderConfig(**kw),
                               device="cpu")
    np.testing.assert_array_equal(film.accum.numpy(), film_aov.accum.numpy())
