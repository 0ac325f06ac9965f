"""N-key vertex motion (more than 2 keys) in the port against the
reference: the stacked segment tables of `build_hier_table_nkey`, the
walk over them (K9's plain version with each lane's segment row offset)
against the reference's stacked tracer and the port's brute tracer, the
segment pick at the key boundaries, and whole renders through
`choose_tracer`: past 16384 faces the bare stacked hierwalk under the
general pool, at or below it the brute tracer, each against the
reference's `render_frame` by the pool `_match` rule of
tests/walk_render_util.py (the 3-key field at 12 x 12, 1 spp, depth 3 to
keep the plain walk inside ~30 s)."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace import hierwalk as jh
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate import walkpool
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.trace import hierwalk as th
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from torch_port_util import box_field_pair, lit_grid_scene
from walk_render_util import assert_match

N = 2048
TIMES = (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0, None)  # None: uniform random


def nkey(scene, num_keys, seed, jax_side: bool):
    """`scene` with num_keys keys: every face drifts by one seeded shift
    per key (tests/test_hierwalk.py:311-335 `_nkey_field`), the keys' v0
    stacked, e1, e2 and the normals repeated."""
    g = scene.geom
    rng = np.random.default_rng(seed + 50)
    v0 = [np.asarray(g.v0[0])]
    for _ in range(1, num_keys):
        v0.append(v0[-1] + rng.uniform(-0.4, 0.4, 3).astype(np.float32))
    put = jnp.asarray if jax_side else np.asarray
    geom = g._replace(v0=put(np.stack(v0)), **{
        k: put(np.concatenate([np.asarray(getattr(g, k))[:1]] * num_keys))
        for k in ("e1", "e2", "n0", "n1", "n2")})
    return dataclasses.replace(scene, geom=geom, num_keys=num_keys)


@pytest.fixture(scope="module")
def field():
    """(reference scene, port scene) of the 16 x 16 box field (3074 faces)
    with 4 keys, split-ordered at the 2-key leaf."""
    js, ts, _ = box_field_pair(16)
    js, ts = nkey(js, 4, 0, True), nkey(ts, 4, 0, False)
    return (j_split_order(js, leaf=jh.HIER_LEAF_MOTION),
            split_order_scene(ts, leaf=th.HIER_LEAF_MOTION))


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((-9, 0.2, -9), (9, 4, 9), (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _times(value, seed):
    if value is None:
        return np.random.default_rng(seed).random(N).astype(np.float32)
    return np.full(N, value, np.float32)


def test_stacked_tables_equal_reference(field):
    js, ts = field
    want = jh.build_hier_table_nkey(js.geom, js.num_faces, js.num_keys)
    got = th.build_hier_table_nkey(ts.geom, ts.num_faces, ts.num_keys)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    assert got.level_starts == tuple(want.level_starts)
    assert (got.leaf_start, got.seg_rows, got.n_seg, got.num_faces,
            got.fanout) == (want.leaf_start, want.seg_rows, want.n_seg,
                            want.num_faces, want.fanout)
    assert got.n_seg == 3 and got.table.shape[0] == 3 * got.seg_rows


@pytest.mark.parametrize("case", ["two_keys", "auto_fanout"])
def test_stacked_tables_refuse_as_reference(field, case):
    ts = field[1]
    keys, fanout = (2, th.FANOUT) if case == "two_keys" else (4, 0)
    with pytest.raises(ValueError):
        th.build_hier_table_nkey(ts.geom, ts.num_faces, keys, fanout=fanout)


@pytest.mark.parametrize("value", TIMES, ids=["t0", "t1_3", "t2_3", "t1",
                                              "random"])
def test_seg_select_matches_reference(field, value):
    """Segment offsets equal; local times within 1 ulp (XLA may contract
    t * n - floor(t * n) into an FMA)."""
    js, ts = field
    jt = jh.build_hier_table_nkey(js.geom, js.num_faces, js.num_keys)
    tt = th.build_hier_table_nkey(ts.geom, ts.num_faces, ts.num_keys)
    t = _times(value, 5)
    j_off, j_loc = jh._seg_select(jt, jnp.asarray(t), N)
    off, loc = th._seg_select(tt, torch.as_tensor(t), N, "cpu")
    np.testing.assert_array_equal(off.numpy(), np.asarray(j_off))
    j_loc = np.asarray(j_loc)
    np.testing.assert_array_less(
        np.abs(loc.numpy() - j_loc),
        np.spacing(np.maximum(np.abs(j_loc), np.float32(1e-30))) * 1.0001
        + 1e-30)
    # the port's own float32 arithmetic, exactly: at t = k / 3 segment k
    # (the last at t = 1) starts at local time 0 (1)
    ts32 = t * np.float32(3)
    k = np.clip(np.floor(ts32), 0, 2).astype(np.int32)
    np.testing.assert_array_equal(off.numpy(), k * tt.seg_rows)
    np.testing.assert_array_equal(loc.numpy(), ts32 - k.astype(np.float32))


@pytest.mark.parametrize("value", TIMES, ids=["t0", "t1_3", "t2_3", "t1",
                                              "random"])
def test_stacked_walk_matches_reference_and_brute(field, value):
    """Prims and occlusion exact against the reference's stacked tracer
    and the port's brute tracer (whose N-key lerp picks the segment at
    ts = time * (num_keys - 1)), t within 2e-4."""
    js, ts = field
    o, d = _rays(41)
    t = _times(value, 43)
    hc, ha = th.make_hierwalk_tracer(ts, "cpu")
    bc, ba = make_bruteforce_tracer(ts)
    jc, ja = jh.make_hierwalk_tracer(js)
    to = torch.as_tensor
    h = hc(to(o), to(d), 1e-3, 1e16, to(t))
    b = bc(to(o), to(d), 1e-3, 1e16, to(t))
    j = jc(jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16, jnp.asarray(t), None)
    np.testing.assert_array_equal(h.prim.numpy(), b.prim.numpy())
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(j.prim))
    np.testing.assert_allclose(h.t.numpy(), b.t.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.t.numpy(), np.asarray(j.t), rtol=2e-4,
                               atol=2e-4)
    assert 0.05 < float((h.prim >= 0).float().mean()) < 0.95
    occ = ha(to(o), to(d), 1e-3, 5.0, to(t)).numpy()
    np.testing.assert_array_equal(occ, ba(to(o), to(d), 1e-3, 5.0,
                                          to(t)).numpy())
    np.testing.assert_array_equal(occ, np.asarray(
        ja(jnp.asarray(o), jnp.asarray(d), 1e-3, 5.0, jnp.asarray(t), None)))


@pytest.mark.parametrize("value", TIMES, ids=["t0", "t1_3", "t2_3", "t1",
                                              "random"])
def test_brute_nkey_lerp_matches_reference(field, value):
    """The brute tracer's N-key lerp (trace/intersect.py `_tri_chunk`)
    against the reference's at the key boundaries t = k / (N - 1) and at
    random times: prims and occlusion exact, t within 1e-5."""
    from rendertoy3c_tpu.trace.intersect import \
        make_bruteforce_tracer as j_brute

    js, ts = field
    o, d = _rays(17)
    t = _times(value, 19)
    to = torch.as_tensor
    bc, ba = make_bruteforce_tracer(ts)
    jc, ja = j_brute(js)
    got = bc(to(o), to(d), 1e-3, 1e16, to(t))
    want = jc(jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16, jnp.asarray(t),
              None)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        ba(to(o), to(d), 1e-3, 5.0, to(t)).numpy(),
        np.asarray(ja(jnp.asarray(o), jnp.asarray(d), 1e-3, 5.0,
                      jnp.asarray(t), None)))


def test_segments_apart_catch_a_misplaced_offset(field):
    """The segments move apart (a shift a key), so a walk that put the
    segment offset on anything but the gather would miss: the same rays at
    t = 1 on the last segment alone, re-tabled as a 2-key scene, give the
    same prims as the stacked walk."""
    _, ts = field
    o, d = _rays(7)
    t = np.ones(N, np.float32)
    last = dataclasses.replace(ts, num_keys=2, geom=ts.geom._replace(**{
        k: getattr(ts.geom, k)[2:4] for k in ("v0", "e1", "e2", "n0", "n1",
                                               "n2")}))
    to = torch.as_tensor
    got = th.make_hierwalk_tracer(ts, "cpu")[0](to(o), to(d), 1e-3, 1e16,
                                                to(t))
    want = th.make_hierwalk_tracer(last, "cpu")[0](to(o), to(d), 1e-3, 1e16,
                                                   to(t))
    np.testing.assert_array_equal(got.prim.numpy(), want.prim.numpy())
    first = th.make_hierwalk_tracer(ts, "cpu")[0](to(o), to(d), 1e-3, 1e16,
                                                  to(np.zeros(N, np.float32)))
    assert (first.prim != got.prim).float().mean() > 0.05


def test_walk_pool_refuses_stacked_tables(field):
    """The walk pool, as the reference's, takes at most 2 keys: a stacked
    table in a pool state with paths raises ValueError."""
    ts = field[1]
    tab = th.build_hier_table_nkey(ts.geom, ts.num_faces, ts.num_keys)
    s = walkpool.new_walk_state(64, tab.n_levels, tab.fanout, 2, 16, "cpu")
    with pytest.raises(ValueError, match="2 keys"):
        walkpool.walk_rounds(s, tab, True, 4)


KW = dict(width=12, height=12, samples_per_launch=1, max_depth=3,
          integrator="pool", pool_pixel_major=True, ray_block=256)
TOWN_KW = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
               integrator="pool", pool_pixel_major=True, ray_block=256)


def _render_pair(js, ts, cam, kw, j_tracer=None, t_tracer=None):
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jf, jst = j_render_frame(js, cam.params(), jcfg, tracer=j_tracer)
    tf, tst = render_frame(ts, cam.params(), cfg, tracer=t_tracer,
                           device="cpu")
    return ((tf.accum.numpy().reshape(-1, 3), None, int(tst.radiance_rays),
             int(tst.shadow_rays)),
            (np.asarray(jf.accum).reshape(-1, 3), None,
             int(jst.radiance_rays), int(jst.shadow_rays)))


def test_three_key_field_past_16384_faces_renders_as_reference():
    """Past 16384 faces, 3 keys: choose_tracer gives the bare stacked
    hierwalk (split order at the 2-key leaf), as the reference's ladder;
    the render matches the reference's over its own stacked tracer."""
    js = nkey(lit_grid_scene("jax", n=38), 3, 1, True)
    ts = nkey(lit_grid_scene("torch", n=38), 3, 1, False)
    assert ts.num_faces > 16384
    cfg = RenderConfig(**KW)
    ordered, tracer = choose_tracer(ts, cfg, "cpu")
    assert isinstance(tracer, tuple) and ordered.num_faces >= ts.num_faces
    j_ordered, j_tracer = j_choose_tracer(js, JConfig(**KW), on_tpu=True)
    assert isinstance(j_tracer, tuple)
    np.testing.assert_array_equal(np.asarray(ordered.geom.v0),
                                  np.asarray(j_ordered.geom.v0))
    cam = Camera(eye=(19.0, 14.0, 50.0), lookat=(19.0, 0.0, 19.0),
                 fov_y=45.0)
    got, want = _render_pair(j_ordered, ordered, cam, KW, j_tracer, tracer)
    assert_match(got, want)


def test_three_key_town_at_most_16384_faces_takes_the_brute_tracer(
        tmp_path):
    """At or below 16384 faces, 3 keys: choose_tracer gives the brute
    tracer, the route of the reference's render on the CPU (its ladder
    offers none there, integrate/path.py:1472-1488)."""
    from rendertoy3c_tpu_torch.io.genassets import generate_town
    from rendertoy3c_tpu_torch.io.obj import load_obj
    from rendertoy3c_tpu_torch.scene.scene import build_scene
    from rendertoy3c_tpu.io.obj import load_obj as j_load_obj
    from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene

    paths, camkw = generate_town(str(tmp_path), faces_target=4000,
                                 two_key=True)
    keys = [paths[0], paths[1], paths[0]]
    scenes = []
    for load, build in ((j_load_obj, j_build_scene), (load_obj, build_scene)):
        meshes, _ = load(keys)
        for m in meshes:
            m.material = dataclasses.replace(
                m.material, diffuse_texture_id=-1, emissive_texture_id=-1,
                roughness_texture_id=-1, normal_texture_id=-1)
        scenes.append(build(meshes))
    js, ts = scenes
    assert ts.num_keys == 3 and ts.num_faces <= 16384
    ordered, tracer = choose_tracer(ts, RenderConfig(**TOWN_KW), "cpu")
    assert ordered is ts and isinstance(tracer, tuple)
    assert tracer[0].__qualname__.startswith("make_bruteforce_tracer")
    got, want = _render_pair(js, ts, Camera(**camkw), TOWN_KW)
    assert_match(got, want)


def test_cli_renders_three_obj_keyframes(tmp_path):
    """--scene k0.obj k1.obj k0.obj: three files are three motion keys,
    rendered through the ladder (the brute tracer at 4294 faces)."""
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.io.genassets import generate_town

    paths, _ = generate_town(str(tmp_path), faces_target=4000, two_key=True)
    keys = [paths[0], paths[1], paths[0]]
    meshes, _, _ = cli.load_scene(keys)
    assert {m.num_keys for m in meshes} == {3}
    out = tmp_path / "k3.png"
    assert cli.main(["--scene", *keys, "--size", "12x12", "--spp", "1",
                     "--subframes", "1", "--max-depth", "3", "--eye",
                     "38,26,46", "--lookat", "0,1.5,0", "--fov", "42",
                     "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
