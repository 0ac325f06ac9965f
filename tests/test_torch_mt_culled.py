"""The plain MT sweeps (mt.closest_ref / any_ref and their motion forms),
culled ray by ray, against the dense sweep of every tile they replaced and
the brute tracer, on the 4294-face town's camera rays and one cosine
bounce from their hits, static and 2-key (at uniform random times), with a
live count that ends inside a ray tile: every output bit-equal to the
dense sweep; prims and occlusion exact, t/u/v within 1e-6, against the
brute tracer."""
import numpy as np
import pytest
import torch

from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import mt
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)

N_CAM = 512
# one intra-op thread per test worker, as tests/torch_port_util.py sets it
torch.set_num_threads(1)


def _closest_dense(rays, n_tiles, test):
    """The dense closest sweep the culled one replaced: every ray against
    every tile, min t, lowest prim at equal t."""
    cols = tuple(rays[:, c:c + 1] for c in range(8))
    r = rays.shape[0]
    best_t = rays[:, 7].clone()
    best = torch.zeros((r, 3))
    best[:, 0] = -1.0
    for k in range(n_tiles):
        t, u, v, hit, prim_f = test(cols, k)
        t = torch.where(hit, t, torch.full_like(t, 1e30))
        t_c, idx = torch.min(t, dim=1)
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        got = torch.stack([prim_f[0, idx], torch.gather(u, 1, idx[:, None])[
            :, 0], torch.gather(v, 1, idx[:, None])[:, 0]], dim=1)
        best = torch.where(better[:, None], got, best)
    return torch.cat([best_t[:, None], best], dim=1)


def _any_dense(rays, n_tiles, test):
    cols = tuple(rays[:, c:c + 1] for c in range(8))
    occ = torch.zeros(rays.shape[0], dtype=torch.bool)
    for k in range(n_tiles):
        occ |= test(cols, k)[3].any(dim=1)
    return occ


@pytest.fixture(scope="module")
def town_rays():
    """{two_key: (scene, o, d, time)}: camera rays and a cosine bounce."""
    out = {}
    for two_key in (False, True):
        scene, cam = town_scene(4000, two_key)
        rng = np.random.default_rng(21 + int(two_key))
        p = cam.params()
        xy = rng.uniform(-1, 1, (N_CAM, 2)).astype(np.float32)
        d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o = np.broadcast_to(p.eye, d.shape).astype(np.float32)
        tm = (torch.as_tensor(rng.uniform(0, 1, N_CAM).astype(np.float32))
              if two_key else None)
        hit = trace_closest_bruteforce(scene, torch.as_tensor(o),
                                       torch.as_tensor(d), 0.01, 1e16, tm)
        prim = hit.prim.numpy()
        ok = prim >= 0
        g = scene.geom
        n = np.cross(g.e1[0][np.maximum(prim, 0)], g.e2[0][np.maximum(
            prim, 0)])
        n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-30
        n *= -np.sign(np.sum(n * d, axis=1, keepdims=True))
        w = rng.normal(size=(N_CAM, 3))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        bd = (n + w) / np.linalg.norm(n + w, axis=1, keepdims=True)
        bo = np.where(ok[:, None], o + hit.t.numpy()[:, None] * d, o)
        out[two_key] = (scene, torch.as_tensor(np.concatenate([o, bo]).astype(
            np.float32)), torch.as_tensor(np.concatenate([d, bd]).astype(
                np.float32)), None if tm is None else torch.cat([tm, tm]))
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("two_key", [False, True], ids=["static", "2key"])
def test_culled_plain_sweep_matches_dense_and_brute(town_rays, two_key,
                                                    any_hit):
    scene, o, d, tm = town_rays[two_key]
    r = o.shape[0]
    tmin = 0.001 if any_hit else 0.01
    tmax = (torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 20, r).astype(np.float32)) if any_hit else 1e16)
    tile = mt.MOTION_RAY_TILE if two_key else mt.RAY_TILE
    rays, _ = mt.pack_rays(o, d, tmin, tmax, tile)
    count = torch.tensor([r - 100], dtype=torch.int32)  # inside a tile
    if two_key:
        table = mt.build_motion_soup(scene.geom, "cpu",
                                     num_faces=scene.num_faces)
        ct = table.tris0.shape[2]
        time = torch.zeros(rays.shape[0])
        time[:r] = tm

        def test(cols, k):
            return mt.mt_test(cols, table.tris0[k], k * ct, table.tris1[k],
                              time[:, None])

        n_tiles = table.tris0.shape[0]
        fn = mt.any_motion_ref if any_hit else mt.closest_motion_ref
        got = fn(rays, time, count, table)
    else:
        table = mt.build_tri_soup(scene.geom, "cpu",
                                  num_faces=scene.num_faces)
        ct = table.tris.shape[2]

        def test(cols, k):
            return mt.mt_test(cols, table.tris[k], k * ct)

        n_tiles = table.tris.shape[0]
        got = (mt.any_ref if any_hit else mt.closest_ref)(rays, count, table)
    assert n_tiles == 9
    live = mt.live_rows(rays.shape[0], count, tile)
    if any_hit:
        want = mt._any_out(_any_dense(rays, n_tiles, test), live)
    else:
        want = mt._closest_out(rays, _closest_dense(rays, n_tiles, test),
                               live)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    # the brute tracer, on the live rays
    n = int(count)
    time_b = None if tm is None else tm[:n]
    tmax_b = tmax[:n] if any_hit else tmax
    if any_hit:
        occ = trace_any_bruteforce(scene, o[:n], d[:n], tmin, tmax_b, time_b)
        assert torch.equal(got[:n, 0] > 0, occ)
        assert 0.05 < float(occ.float().mean()) < 0.95
    else:
        b = trace_closest_bruteforce(scene, o[:n], d[:n], tmin, tmax_b,
                                     time_b)
        np.testing.assert_array_equal(got[:n, 1].numpy(),
                                      b.prim.numpy().astype(np.float32))
        hit = b.prim.numpy() >= 0
        assert hit.mean() > 0.2
        for col, x in ((0, b.t), (2, b.u), (3, b.v)):
            np.testing.assert_allclose(got[:n, col].numpy()[hit],
                                       x.numpy()[hit], rtol=1e-6, atol=1e-6)
