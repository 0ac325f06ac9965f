"""K1/K2 plain versions (closest_ref / any_ref, through trace_closest_mt /
trace_any_mt) against the reference Pallas kernels in interpret mode and
against the brute tracers. Prim ids and occlusion flags exact; t, u, v at
rtol = atol = 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.scene.builtin import box_mesh as j_box_mesh
from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.intersect import trace_closest_bruteforce as j_brute
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_mt import trace_any_mt as j_any
from rendertoy3c_tpu.trace.pallas_mt import trace_closest_mt as j_closest
from rendertoy3c_tpu_torch.scene.builtin import box_mesh
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import mt
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)
from torch_port_util import (box_grid_meshes, cornell_pair,
                             random_rays)

TOL = dict(rtol=1e-6, atol=1e-6)


def _cornell_rays(scene, cam, n_cam=256, n_rand=256, seed=0):
    """Camera rays, one cosine bounce from their hits, random rays."""
    rng = np.random.default_rng(seed)
    p = cam.params()
    xy = rng.uniform(-1, 1, (n_cam, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(p.eye, d.shape).astype(np.float32)
    hit = trace_closest_bruteforce(scene, torch.as_tensor(o),
                                   torch.as_tensor(d), 0.01, 1e16)
    prim = hit.prim.numpy()
    ok = prim >= 0
    g = scene.geom
    n = np.cross(g.e1[0][prim], g.e2[0][prim])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n *= -np.sign(np.sum(n * d, axis=1, keepdims=True))  # face the ray
    w = rng.normal(size=(n_cam, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    bd = n + w
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    bo = (o + hit.t.numpy()[:, None] * d).astype(np.float32)
    ro, rd = random_rays(n_rand, seed=seed + 1)
    return (np.concatenate([o, bo[ok], ro]),
            np.concatenate([d, bd[ok], rd]))


@pytest.fixture(scope="module")
def cornell():
    js, ts, _, tcam = cornell_pair()
    o, d = _cornell_rays(ts, tcam)
    return js, ts, o, d


def _jax_soup(js):
    return j_soup(js.geom, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces)


def _assert_hits_equal(got, want_prim, want_t, want_u, want_v):
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want_prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want_t), **TOL)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want_u), **TOL)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want_v), **TOL)


@pytest.mark.parametrize("count", [None, 301])
def test_closest_matches_pallas_kernel(cornell, count):
    js, ts, o, d = cornell
    want = j_closest(_jax_soup(js), jnp.asarray(o), jnp.asarray(d), 0.01,
                     1e16, count=count, interpret=True)
    soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    got = mt.trace_closest_mt(soup, torch.as_tensor(o), torch.as_tensor(d),
                              0.01, 1e16, count=count)
    _assert_hits_equal(got, want.prim, want.t, want.u, want.v)
    if count is not None:  # tiles past the count: all misses
        assert (got.prim.numpy()[512:] == -1).all()


@pytest.mark.parametrize("count", [None, 301])
def test_any_matches_pallas_kernel(cornell, count):
    js, ts, o, d = cornell
    want = j_any(_jax_soup(js), jnp.asarray(o), jnp.asarray(d), 0.001, 1.5,
                 count=count, interpret=True)
    soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    got = mt.trace_any_mt(soup, torch.as_tensor(o), torch.as_tensor(d),
                          0.001, 1.5, count=count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_closest_and_any_match_brute(cornell):
    js, ts, o, d = cornell
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    want = j_brute(js.geom, jnp.asarray(o), jnp.asarray(d), 0.01, 1e16,
                   jnp.zeros(len(o)), num_keys=1, num_faces=js.num_faces,
                   chunk=512)
    brute = trace_closest_bruteforce(ts, ot, dt, 0.01, 1e16)
    _assert_hits_equal(brute, want.prim, want.t, want.u, want.v)
    soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    got = mt.trace_closest_mt(soup, ot, dt, 0.01, 1e16)
    _assert_hits_equal(got, brute.prim, brute.t, brute.u, brute.v)
    np.testing.assert_array_equal(
        mt.trace_any_mt(soup, ot, dt, 0.001, 1.5).numpy(),
        trace_any_bruteforce(ts, ot, dt, 0.001, 1.5).numpy())


def test_multi_tile_soup_matches_culled_pallas_kernel():
    """A 768-face scene: two 512-wide tiles, so the reference kernel culls
    by tile boxes while the plain version sweeps densely."""
    js = j_build_scene(box_grid_meshes(JMaterial, JMesh, j_box_mesh))
    ts = build_scene(box_grid_meshes(Material, Mesh, box_mesh))
    o, d = random_rays(512, seed=3, lo=(0, 3, 0), hi=(8, 6, 8))
    d[:, 1] = -np.abs(d[:, 1])  # toward the boxes
    want = j_closest(_jax_soup(js), jnp.asarray(o), jnp.asarray(d), 0.01,
                     1e16, interpret=True)
    soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    assert soup.tris.shape[0] == 2
    got = mt.trace_closest_mt(soup, torch.as_tensor(o), torch.as_tensor(d),
                              0.01, 1e16)
    _assert_hits_equal(got, want.prim, want.t, want.u, want.v)
    assert (got.prim.numpy() >= 0).mean() > 0.2  # no floor: gaps miss
