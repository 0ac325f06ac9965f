"""The cases the binned MT kernels (K1/K2, K3) must keep, on the CPU: the
port's plain versions (`closest_ref` / `any_ref` and their motion forms,
through `trace_closest_mt` and its kin) against the reference's Pallas
kernels in interpret mode, static and 2-key, closest and any-hit, on
synthetic soups of 1 tile (ct 384 and 512), 9 tiles (one cull level in the
reference), 18 tiles (two levels) and 21 tiles with a face of tile 1
copied into tile 20; at live counts 0, R - 1000 and R, so that 256- and
128-ray tiles past the count miss and rays past it inside a live tile are
traced. Prims and occlusion exact; t, u and v within 5e-4 + 1e-4 of their
size: the reference's CPU backend contracts a*b + c into fused
multiply-adds (see test_torch_mt_motion.py), and the random soups' sliver
triangles and grazing rays amplify that to 3e-4 on a few rays of a case
(the kernels are held bit for bit to the plain versions on the card, in
tests/test_torch_cuda.py). Then the binning's plain
version `bin_ref` (every hit's tile is admitted, nothing past the count)
and the workspace size."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_bin_util import (SOUP_SIZES, TIE_HIGH, TIE_LOW, TRI_TILE, case,
                         counts)
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_mt import trace_any_mt as j_any
from rendertoy3c_tpu.trace.pallas_mt import trace_any_mt_motion as j_any_m
from rendertoy3c_tpu.trace.pallas_mt import trace_closest_mt as j_closest
from rendertoy3c_tpu.trace.pallas_mt import \
    trace_closest_mt_motion as j_closest_m
from rendertoy3c_tpu_torch.trace import mt

# one intra-op thread per test worker, as tests/torch_port_util.py sets it
torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=5e-4)
T_ANY = 5.0  # the any-hit probes' tmax
NAMES = ["ties"] + [name for name, _ in SOUP_SIZES]
R = 1280


@functools.cache
def _setup(name, keys):
    """(reference soups, port table, o, d, time) of a case."""
    geom, n_faces, o, d, tm, _ = case(name, keys, R)
    jsoups = tuple(j_soup(geom, key=k, num_faces=n_faces)._replace(
        num_faces=n_faces) for k in range(keys))
    table = (mt.build_motion_soup(geom, "cpu", num_faces=n_faces)
             if keys == 2 else mt.build_tri_soup(geom, "cpu",
                                                 num_faces=n_faces))
    return jsoups, table, o, d, tm


@functools.cache
def _traced(name, keys, count, any_hit):
    """(reference result, port result) of one sweep, as numpy: a Hit's
    (prim, t, u, v), or the occlusion flags."""
    jsoups, table, o, d, tm = _setup(name, keys)
    tmin, tmax = (0.001, T_ANY) if any_hit else (0.01, 1e16)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    if keys == 2:
        fn_j = j_any_m if any_hit else j_closest_m
        fn_t = mt.trace_any_mt_motion if any_hit else mt.trace_closest_mt_motion
        want = fn_j(*jsoups, jo, jd, tmin, tmax, jnp.asarray(tm), count=count,
                    interpret=True)
        got = fn_t(table, to, td, tmin, tmax, torch.as_tensor(tm),
                   count=count)
    else:
        fn_j = j_any if any_hit else j_closest
        fn_t = mt.trace_any_mt if any_hit else mt.trace_closest_mt
        want = fn_j(jsoups[0], jo, jd, tmin, tmax, count=count,
                    interpret=True)
        got = fn_t(table, to, td, tmin, tmax, count=count)
    if any_hit:
        return np.asarray(want), got.numpy()
    return (tuple(np.asarray(getattr(want, k)) for k in ("prim", "t", "u",
                                                          "v")),
            tuple(getattr(got, k).numpy() for k in ("prim", "t", "u", "v")))


@pytest.mark.parametrize("keys", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_sweeps_match_reference(name, keys):
    """Every count: closest prims and occlusion exact, t/u/v close; ray
    tiles past the count miss; rays past it inside a live tile traced."""
    tile = mt.MOTION_RAY_TILE if keys == 2 else mt.RAY_TILE
    for any_hit in (False, True):
        full = _traced(name, keys, R, any_hit)[1]
        for count in counts(R):
            want, got = _traced(name, keys, count, any_hit)
            tail = -(-count // tile) * tile
            if any_hit:
                np.testing.assert_array_equal(got, want)
                assert not got[tail:].any()
                np.testing.assert_array_equal(got[count:tail],
                                              full[count:tail])
                continue
            np.testing.assert_array_equal(got[0], want[0])
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, **TOL)
            assert (got[0][tail:] == -1).all()
            np.testing.assert_array_equal(got[0][count:tail],
                                          full[0][count:tail])
        assert (full if any_hit else full[0] >= 0).mean() > 0.2


@pytest.mark.parametrize("keys", [1, 2])
def test_tie_across_tiles_lowest_prim_wins(keys):
    """A face of tile 1 and its copy in tile 20: every ray that hits them
    gets the lower prim, with t, u and v bit-equal to that face's own test,
    as in the reference."""
    want, got = _traced("ties", keys, R, False)
    _, table, o, d, tm = _setup("ties", keys)
    hit = got[0] == TIE_LOW
    assert hit.sum() > 100
    assert not (got[0] == TIE_HIGH).any()
    np.testing.assert_array_equal(want[0] == TIE_LOW, hit)
    rays, _ = mt.pack_rays(torch.as_tensor(o), torch.as_tensor(d), 0.01,
                           1e16)
    cols = tuple(rays[:R, c:c + 1] for c in range(8))
    k, j = divmod(TIE_LOW, TRI_TILE)
    if keys == 2:
        t, u, v, ok, _ = mt.mt_test(cols, table.tris0[k][:, j:j + 1], 0,
                                    table.tris1[k][:, j:j + 1],
                                    torch.as_tensor(tm)[:, None])
    else:
        t, u, v, ok, _ = mt.mt_test(cols, table.tris[k][:, j:j + 1], 0)
    rows = torch.as_tensor(hit)
    assert ok[rows, 0].all()
    for g, w in zip(got[1:], (t, u, v)):
        np.testing.assert_array_equal(g[hit].view(np.int32),
                                      w[rows, 0].numpy().view(np.int32))
    # both copies' tiles admit those rays: the tie reaches the merge
    admitted = mt.bin_ref(rays, torch.tensor([R], dtype=torch.int32),
                          table)[:R]
    assert admitted[rows][:, [1, 20]].all()


@pytest.mark.parametrize("keys", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_bin_ref_admits_every_hit_tile(name, keys):
    """bin_ref (the kernels' binning, plain): each ray's closest hit lies in
    a tile it is binned to, each occluded ray is binned somewhere, rays past
    the live tiles nowhere; mt_bin on the CPU counts its lists."""
    _, table, o, d, tm = _setup(name, keys)
    tile = mt.MOTION_RAY_TILE if keys == 2 else mt.RAY_TILE
    ct = mt._tiles(table).shape[2]
    for any_hit in (False, True):
        tmin, tmax = (0.001, T_ANY) if any_hit else (0.01, 1e16)
        rays, _ = mt.pack_rays(torch.as_tensor(o), torch.as_tensor(d), tmin,
                               tmax, tile)
        for count in counts(R):
            c = torch.tensor([count], dtype=torch.int32)
            admitted = mt.bin_ref(rays, c, table)
            tail = -(-count // tile) * tile
            assert not admitted[tail:].any()
            got = _traced(name, keys, count, any_hit)[1]
            if any_hit:
                assert admitted[:R][torch.as_tensor(got)].any(dim=1).all()
            else:
                prim = torch.as_tensor(got[0]).long()
                rows = (prim >= 0).nonzero()[:, 0]
                assert admitted[rows, prim[rows] // ct].all()
            assert torch.equal(mt.mt_bin(rays, c, table),
                               admitted.sum(dim=0, dtype=torch.int32))


def test_workspace_holds_every_ray_in_every_tile():
    """R keys of two words, the counters, and n_tiles lists of R indices:
    4 MiB of lists at the towns' pool (32 tiles x 32768 rays)."""
    for r, n_tiles in ((32768, 32), (131072, 32), (256, 1), (1280, 21)):
        assert mt.workspace_words(r, n_tiles) == 2 * r + n_tiles * (r + 1)
    assert mt.workspace_words(32768, 32) * 4 - 4 * 2**20 == 4 * (2 * 32768
                                                                 + 32)
