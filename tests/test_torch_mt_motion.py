"""K3's plain versions (closest_motion_ref / any_motion_ref, through
trace_closest_mt_motion / trace_any_mt_motion) and the 2-key motion brute
tracers against the reference: the Pallas motion kernels in interpret mode
and the reference brute tracers, on the 2-key 4294-face town at uniform
random ray times. Prim ids and occlusion flags exact; t at rtol = atol =
1e-6; u, v at rtol = atol = 1e-6 against the port's own brute tracer and
at atol = 1e-5 against the reference, whose CPU backend contracts a*b + c
into fused multiply-adds: at the town's coordinates (up to 40) that moves
u, v by up to 3e-6, and both packages stay within 4.5e-6 of a float64
evaluation (the static K1 path differs from its Pallas kernel alike). The
live-count skip acts on 128-ray tiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.trace.intersect import trace_any_bruteforce as j_any_b
from rendertoy3c_tpu.trace.intersect import \
    trace_closest_bruteforce as j_closest_b
from rendertoy3c_tpu.trace.pallas_mt import _motion_cull_tables
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_mt import trace_any_mt_motion as j_any
from rendertoy3c_tpu.trace.pallas_mt import \
    trace_closest_mt_motion as j_closest
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import mt
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)
from torch_port_util import j_town_scene

TOL = dict(rtol=1e-6, atol=1e-6)
UV_TOL_REF = dict(rtol=1e-6, atol=1e-5)  # against the reference: see above
COUNT = 301  # live rays: 128-ray tiles end at 384, 256-ray tiles at 512
T_ANY = 6.0  # the any-hit probes' tmax


def _town_rays(scene, cam, rng, n_cam=256, n_rand=256):
    """Camera rays, one cosine bounce from their hits, random rays; all at
    uniform random times."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n_cam, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(p.eye, d.shape).astype(np.float32)
    tm = rng.uniform(0, 1, n_cam).astype(np.float32)
    hit = trace_closest_bruteforce(scene, torch.as_tensor(o),
                                   torch.as_tensor(d), 0.01, 1e16,
                                   torch.as_tensor(tm))
    prim = hit.prim.numpy()
    ok = prim >= 0
    g = scene.geom
    n = np.cross(g.e1[0][prim[ok]], g.e2[0][prim[ok]])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n *= -np.sign(np.sum(n * d[ok], axis=1, keepdims=True))  # face the ray
    w = rng.normal(size=(int(ok.sum()), 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    bd = n + w
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    bo = (o + hit.t.numpy()[:, None] * d).astype(np.float32)[ok]
    ro = rng.uniform((-20, 0.2, -20), (20, 8, 20), (n_rand, 3))
    rd = rng.normal(size=(n_rand, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o_all = np.concatenate([o, bo, ro]).astype(np.float32)
    d_all = np.concatenate([d, bd, rd]).astype(np.float32)
    return o_all, d_all, rng.uniform(0, 1, len(o_all)).astype(np.float32)


@pytest.fixture(scope="module")
def town2(tmp_path_factory):
    js, _ = j_town_scene(4000, True, tmp_path_factory.mktemp("town2"))
    ts, cam = town_scene(4000, True)
    assert ts.num_keys == 2 and ts.num_faces == 4294
    o, d, tm = _town_rays(ts, cam, np.random.default_rng(21))
    j0, j1 = (j_soup(js.geom, key=k, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces) for k in (0, 1))
    msoup = mt.build_motion_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    return js, ts, (j0, j1), msoup, o, d, tm


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _assert_hits_equal(got, want, uv_tol=TOL):
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)),
                                   **(TOL if k == "t" else uv_tol),
                                   err_msg=k)


def test_motion_soup_matches_reference(town2):
    js, ts, (j0, j1), msoup, *_ = town2
    np.testing.assert_array_equal(msoup.tris0.numpy(), np.asarray(j0.tris))
    np.testing.assert_array_equal(msoup.tris1.numpy(), np.asarray(j1.tris))
    aabb, super_aabb = _motion_cull_tables(j0, j1)
    np.testing.assert_array_equal(msoup.aabb.numpy(), np.asarray(aabb))
    np.testing.assert_array_equal(msoup.super_aabb.numpy(),
                                  np.asarray(super_aabb))
    assert msoup.tris0.shape[0] == 9 and msoup.num_faces == 4294
    # key 1 moves some buildings: the union boxes grow somewhere
    assert not np.array_equal(np.asarray(j0.aabb), np.asarray(aabb))


def test_motion_brute_matches_reference(town2):
    js, ts, _, _, o, d, tm = town2
    kw = dict(num_keys=2, num_faces=js.num_faces, chunk=512)
    want = j_closest_b(js.geom, jnp.asarray(o), jnp.asarray(d), 0.01, 1e16,
                       jnp.asarray(tm), **kw)
    got = trace_closest_bruteforce(ts, *_torch(o, d), 0.01, 1e16,
                                   torch.as_tensor(tm))
    _assert_hits_equal(got, want, UV_TOL_REF)
    assert (got.prim.numpy() >= 0).mean() > 0.5
    occ = j_any_b(js.geom, jnp.asarray(o), jnp.asarray(d), 0.01, T_ANY,
                  jnp.asarray(tm), **kw)
    got_occ = trace_any_bruteforce(ts, *_torch(o, d), 0.01, T_ANY,
                                   torch.as_tensor(tm))
    np.testing.assert_array_equal(got_occ.numpy(), np.asarray(occ))
    assert 0.05 < got_occ.numpy().mean() < 0.95


@pytest.mark.parametrize("count", [None, COUNT])
def test_closest_motion_matches_pallas_kernel(town2, count):
    _, _, (j0, j1), msoup, o, d, tm = town2
    want = j_closest(j0, j1, jnp.asarray(o), jnp.asarray(d), 0.01, 1e16,
                     jnp.asarray(tm), count=count, interpret=True)
    got = mt.trace_closest_mt_motion(msoup, *_torch(o, d), 0.01, 1e16,
                                     torch.as_tensor(tm), count=count)
    _assert_hits_equal(got, want, UV_TOL_REF)
    if count is not None:
        full = mt.trace_closest_mt_motion(msoup, *_torch(o, d), 0.01, 1e16,
                                          torch.as_tensor(tm))
        tail = -(-count // mt.MOTION_RAY_TILE) * mt.MOTION_RAY_TILE
        # the tile holding ray `count` is still traced; later tiles miss
        np.testing.assert_array_equal(got.prim.numpy()[:tail],
                                      full.prim.numpy()[:tail])
        assert (got.prim.numpy()[tail:] == -1).all()
        assert (full.prim.numpy()[count:tail] >= 0).any()
        assert (full.prim.numpy()[tail:512] >= 0).any()


@pytest.mark.parametrize("count", [None, COUNT])
def test_any_motion_matches_pallas_kernel(town2, count):
    _, _, (j0, j1), msoup, o, d, tm = town2
    want = j_any(j0, j1, jnp.asarray(o), jnp.asarray(d), 0.01, T_ANY,
                 jnp.asarray(tm), count=count, interpret=True)
    got = mt.trace_any_mt_motion(msoup, *_torch(o, d), 0.01, T_ANY,
                                 torch.as_tensor(tm), count=count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if count is not None:
        tail = -(-count // mt.MOTION_RAY_TILE) * mt.MOTION_RAY_TILE
        assert not got.numpy()[tail:].any()
        assert got.numpy()[count:tail].any()


def test_motion_refs_match_brute(town2):
    _, ts, _, msoup, o, d, tm = town2
    ot, dt, tt = _torch(o, d, tm)
    brute = trace_closest_bruteforce(ts, ot, dt, 0.01, 1e16, tt)
    _assert_hits_equal(mt.trace_closest_mt_motion(msoup, ot, dt, 0.01, 1e16,
                                                  tt), brute)
    np.testing.assert_array_equal(
        mt.trace_any_mt_motion(msoup, ot, dt, 0.01, T_ANY, tt).numpy(),
        trace_any_bruteforce(ts, ot, dt, 0.01, T_ANY, tt).numpy())
    # a time the rays do not see: the scene at key 0 differs
    key0 = trace_closest_bruteforce(ts, ot, dt, 0.01, 1e16, 0.0)
    assert not np.array_equal(key0.t.numpy(), brute.t.numpy())


def test_mt_tracer_dispatches_by_keys(town2):
    """make_mt_tracer: K3 for the 2-key town, (o, d, tmin, tmax, time,
    count) signature; a static scene ignores the time."""
    _, ts, _, msoup, o, d, tm = town2
    ot, dt, tt = _torch(o, d, tm)
    closest, any_hit = mt.make_mt_tracer(ts, "cpu")
    _assert_hits_equal(closest(ot, dt, 0.01, 1e16, tt),
                       mt.trace_closest_mt_motion(msoup, ot, dt, 0.01, 1e16,
                                                  tt))
    c = torch.tensor([COUNT], dtype=torch.int32)
    np.testing.assert_array_equal(
        any_hit(ot, dt, 0.01, T_ANY, tt, c).numpy(),
        mt.trace_any_mt_motion(msoup, ot, dt, 0.01, T_ANY, tt,
                               count=COUNT).numpy())
