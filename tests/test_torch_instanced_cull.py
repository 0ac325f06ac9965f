"""K7's per-ray instance cull and trimmed mesh tiles (trace/instanced_mt.py
`trace_instanced_ref`) against the reference's Pallas kernel
(rendertoy3c_tpu/trace/pallas_instanced.py `_trace_instanced`, whose
256-ray tile votes an instance in and tests every stored face) in
interpret mode, on the rays where a cull could go wrong.

Three scenes: the reference test's 3-instance scene; bench's trace-time
Cornell (`multi_instance_cornell`), with rays in the planes of the
zero-thickness boxes of its light and small floors and along their edges,
rays with one or two zero direction components and rays with tmax <= tmin
mixed into seeded rays; and a "ties" scene: two identical instances of
one mesh at the same place (the earlier wins at equal t) and a third
behind them, the mesh repeating its first face in its second tile (the
lower prim wins), with a degenerate face inside it and as its last real
face. Each at the full count and at a count inside a ray tile: prims,
instances and occlusion exact, t within T_TOL and u, v within UV_TOL
(tests/test_torch_instanced_mt.py: XLA's CPU backend contracts the MT
test's a + b * c). Rays in the planes of the Cornell's big walls and
along their edges are held to the reference's kernel the same way but
for a few rays whose hit lies on a triangle's edge, which the
contraction decides the other way (`test_wall_planes_match_reference_
kernel_off_edges` names them), and bit for bit to the vote's algorithm
in this package's arithmetic. On these inputs the reference's vote
admits (ray, instance) pairs the per-ray cull rejects, the trimmed tiles
hold the real faces only and the padded boxes are trace/mt.py's padding;
a ray with tmax above 1e30 decodes as the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inst_cull_util as icu
from inst_cull_util import COUNT_IN_TILE, N
from inst_util import j_multi_instance_cornell, to_port_iscene
from rendertoy3c_tpu.trace import pallas_instanced as jpi
from rendertoy3c_tpu_torch.trace import instanced_mt as im
from rendertoy3c_tpu_torch.trace.mt import pack_rays
from test_torch_instanced_mt import T_TOL, UV_TOL, j_three_instances


def j_ties():
    """The reference's InstancedScene of inst_cull_util.ties_parts."""
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu.scene.material import Material
    from rendertoy3c_tpu.scene.mesh import Mesh
    from rendertoy3c_tpu.scene.scene import Instance

    return build_instanced_scene(*icu.ties_parts(Material, Mesh, Instance))



SCENES = {"three_instances": (j_three_instances, icu.three_rays),
          "cornell_edges": (lambda: j_multi_instance_cornell()[0],
                            icu.cornell_rays),
          "ties": (j_ties, icu.ties_rays)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make, rays = SCENES[request.param]
    js = make()
    o, d, tmax = rays(np.random.default_rng(41))
    return request.param, js, to_port_iscene(js), o, d, tmax


def _ref(js, o, d, tmax, any_hit, count):
    tris, table, ranges = jpi.build_instanced_soup(js)
    return np.asarray(jpi._trace_instanced(
        tris, table, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tmax),
        instance_mesh=js.instance_mesh, tile_ranges=ranges, any_hit=any_hit,
        count=count, interpret=True))


def _plain(ts, o, d, tmax, any_hit, count, stats=None):
    rays, r = pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                        torch.from_numpy(tmax))
    return im.trace_instanced_ref(
        rays, torch.tensor([count], dtype=torch.int32),
        im.build_instanced_soup(ts, "cpu"), any_hit, stats)[:r].numpy()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_cull_matches_reference_kernel(case, any_hit):
    """At the full count and at a count inside a ray tile; closest rays
    keep their finite tmax, so the tmax <= tmin rays take part."""
    name, js, ts, o, d, tmax = case
    for count in (N, COUNT_IN_TILE):
        want = _ref(js, o, d, tmax, any_hit, count)
        got = _plain(ts, o, d, tmax, any_hit, count)
        if any_hit:
            np.testing.assert_array_equal(got, want)
            assert 0 < got[:, 0].sum() < N
            continue
        np.testing.assert_array_equal(got[:, 1], want[:, 1])  # prim
        np.testing.assert_array_equal(got[:, 4], want[:, 4])  # instance
        np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=T_TOL,
                                   atol=T_TOL)
        np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=UV_TOL,
                                   atol=UV_TOL)
        assert (got[:, 1] >= 0).mean() > 0.03
        if count < N:
            tail = got[768:]
            assert (tail[:, 1] == -1).all() and (tail[:, 4] == -1).all()
    if name == "ties" and not any_hit:
        # the straight rays inside face 0: the first instance, prim 0
        x, y = o[: N // 4, 0], o[: N // 4, 1]
        on0 = (x > 1e-3) & (y > 1e-3) & (x + y < 1.0 - 1e-3)
        assert on0.mean() > 0.3
        assert (got[: N // 4][on0][:, [1, 4]] == [0.0, 0.0]).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_vote_admits_pairs_the_cull_rejects(case, any_hit):
    """The reference's 256-ray vote lets whole ray tiles into instances
    that a ray's own padded test keeps it out of: more (ray, instance)
    pairs than the cull admits, so at least that many pairs the cull
    rejects, while the outputs above agree."""
    _, _, ts, o, d, tmax = case
    stats = {}
    _plain(ts, o, d, tmax, any_hit, N, stats)
    assert stats["vote_pairs"] > stats["pairs"] > 0
    assert stats["live"] <= N
    assert stats["tests"] <= stats["real_faces"] < im.ITILE * stats["visits"]


def _vote_ref(rays, count, soup, any_hit):
    """The reference's algorithm in this package's arithmetic (the plain
    K7 before the per-ray cull): per instance in table order, every row
    of a live 256-ray tile tests every stored face of the instance's mesh
    when any row's unpadded slab test admits it, bounded by its best t
    (closest) or tmax."""
    from rendertoy3c_tpu_torch.trace.mt import RAY_TILE, live_rows, mt_test

    r = rays.shape[0]
    o, d, tmin, tmax = rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]
    ok, tn = im._vote_slabs(rays, soup.table)
    live = live_rows(r, count).view(-1, RAY_TILE)[:, 0]
    best_t = tmax.clone()
    best = torch.tensor([-1.0, 0.0, 0.0, -1.0]).repeat(r, 1)
    occ = torch.zeros(r, dtype=torch.bool)
    rows = torch.arange(r).view(-1, RAY_TILE)
    for i, (start, n_tiles) in enumerate(soup.inst_tiles.tolist()):
        tcur = tmax if any_hit else best_t
        vote = (ok[:, i] & (tn[:, i] <= tcur)).view(-1, RAY_TILE).any(1)
        idx = rows[vote & live].reshape(-1)
        m = soup.table[i, 0:12]
        ob, db = o[idx], d[idx]
        obj = tuple(m[4 * a] * ob[:, 0:1] + m[4 * a + 1] * ob[:, 1:2]
                    + m[4 * a + 2] * ob[:, 2:3] + m[4 * a + 3]
                    for a in range(3)) + tuple(
            m[4 * a] * db[:, 0:1] + m[4 * a + 1] * db[:, 1:2]
            + m[4 * a + 2] * db[:, 2:3] for a in range(3))
        for k in range(start, start + n_tiles):
            bound = (tmax if any_hit else best_t)[idx, None]
            t, u, v, hit, prim_f = mt_test(obj + (tmin[idx, None], bound),
                                           soup.tris[k], k * im.ITILE)
            if any_hit:
                occ[idx] |= hit.any(dim=1)
                continue
            t = torch.where(hit, t, 1e30)
            t_c = t.amin(dim=1, keepdim=True)
            at_min = t <= t_c
            prim_c = torch.where(at_min, prim_f, 1e30).amin(dim=1,
                                                            keepdim=True)
            one = at_min & (prim_f == prim_c)
            got = torch.stack([prim_c[:, 0],
                               torch.where(one, u, 0.0).sum(dim=1),
                               torch.where(one, v, 0.0).sum(dim=1),
                               torch.full_like(t_c[:, 0], float(i))], 1)
            better = t_c[:, 0] < best_t[idx]
            best_t[idx] = torch.where(better, t_c[:, 0], best_t[idx])
            best[idx] = torch.where(better[:, None], got, best[idx])
    out = torch.zeros((r, 8))
    if any_hit:
        out[:, 0] = occ.float()
    else:
        out[:, 0], out[:, 1:5] = best_t, best
    return out


@pytest.fixture(scope="module")
def walls():
    """The trace-time Cornell (reference and port) and wall_rays."""
    js = j_multi_instance_cornell()[0]
    o, d, tmax = icu.wall_rays(np.random.default_rng(47))
    return js, to_port_iscene(js), o, d, tmax


def _on_edge(out):
    """Rows whose closest hit lies on an edge of its triangle: u, v or
    1 - u - v within UV_TOL of 0."""
    u, v = out[:, 2].astype(np.float64), out[:, 3].astype(np.float64)
    return (out[:, 1] >= 0) & (np.minimum(np.minimum(u, v), 1 - u - v)
                               <= UV_TOL)


# the wall rays (seed 47) whose hit the reference's CPU kernel and the
# plain K7 decide differently, each a hit on a triangle's edge
WALL_EDGE_RAYS = [149, 161, 173, 174, 178, 188, 379]


def test_wall_planes_match_reference_kernel_off_edges(walls):
    """Rays in the planes of the Cornell's big walls and along their edges
    through the reference's interpret-mode kernel, closest and any-hit, at
    the full count and at a count inside a ray tile: prims, instances and
    occlusion exact, t within T_TOL and u, v within UV_TOL, on every ray
    but WALL_EDGE_RAYS (7 of 900). On each of those, one side hits and the
    other misses, and the hit lies on the edge between a wall the ray runs
    in and its neighbour (u + v = 1 up to UV_TOL): where the reference's
    MT test, its a + b * c contracted into FMAs on the CPU, rounds u + v
    to the other side of 1 than this package's arithmetic. Any other
    disagreement fails the test, whatever its cause; on these rays the
    per-ray cull gives the vote's answer in this package's arithmetic
    (`test_cull_bit_equal_to_the_vote_on_wall_planes`)."""
    js, ts, o, d, tmax = walls
    n = len(o)
    for count in (n, n - 150):
        want = _ref(js, o, d, tmax, False, count)[:n]
        got = _plain(ts, o, d, tmax, False, count)
        differ = (got[:, 1] != want[:, 1]) | (got[:, 4] != want[:, 4])
        assert np.flatnonzero(differ).tolist() == WALL_EDGE_RAYS
        hit_g, hit_w = got[:, 1] >= 0, want[:, 1] >= 0
        assert (hit_g[differ] != hit_w[differ]).all()
        assert (_on_edge(got) | _on_edge(want))[differ].all()
        same = ~differ
        np.testing.assert_array_equal(got[same][:, 5:], want[same][:, 5:])
        np.testing.assert_allclose(got[same][:, 0], want[same][:, 0],
                                   rtol=T_TOL, atol=T_TOL)
        np.testing.assert_allclose(got[same][:, 2:4], want[same][:, 2:4],
                                   rtol=UV_TOL, atol=UV_TOL)
        assert 0.2 < hit_g.mean() < 1.0
        occ_w = _ref(js, o, d, tmax, True, count)[:n, 0] > 0
        occ_g = _plain(ts, o, d, tmax, True, count)[:, 0] > 0
        # the same tmax: occluded exactly where the closest ray hits
        assert (occ_g == hit_g).all() and (occ_w == hit_w).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_cull_bit_equal_to_the_vote_on_wall_planes(any_hit):
    """Rays in the planes of the Cornell's big walls and along their edges
    meet the other walls exactly on their edges, where the reference's
    MT test, its a + b * c contracted on the CPU, decides some of these
    rays the other way (`test_wall_planes_match_reference_kernel_off_
    edges`). So the cull is also held bit for bit to the vote's algorithm
    in this package's arithmetic (`_vote_ref`), at the full count and at
    a count inside a ray tile, and the vote admits pairs the cull
    rejects."""
    ts = to_port_iscene(j_multi_instance_cornell()[0])
    soup = im.build_instanced_soup(ts, "cpu")
    o, d, tmax = icu.wall_rays(np.random.default_rng(47))
    rays, r = pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                        torch.from_numpy(tmax))
    for count in (r, r - 150):
        c = torch.tensor([count], dtype=torch.int32)
        stats = {}
        got = im.trace_instanced_ref(rays, c, soup, any_hit, stats)
        want = _vote_ref(rays, c, soup, any_hit)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert stats["vote_pairs"] > stats["pairs"]
    hits = got[:, 0] > 0 if any_hit else got[:, 1] >= 0
    assert 0.2 < float(hits[:r].float().mean()) < 1.0


def test_tiles_hold_their_real_faces():
    """tile_faces: 2 in each Cornell tile; the ties mesh's 131 faces in
    two tiles, its degenerate last face counted."""
    js = j_multi_instance_cornell()[0]
    assert im.build_instanced_soup(to_port_iscene(js), "cpu") \
        .tile_faces.tolist() == [2] * 6
    soup = im.build_instanced_soup(to_port_iscene(j_ties()), "cpu")
    assert soup.tile_faces.tolist() == [128, 3]
    tiles = soup.tris.numpy()
    assert (tiles[1, :, 3:] == 0).all() and (tiles[1, :, 2] != 0).any()
    assert im.real_faces(np.zeros((1, 9, im.ITILE), np.float32)).tolist() \
        == [0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_padded_boxes_are_the_sweeps_padding(name):
    """The soup's padded instance boxes are the instance boxes padded as
    trace/mt.py `_slabs` pads a tile's box, bit for bit."""
    from rendertoy3c_tpu_torch.trace.mt import BOX_PAD

    soup = im.build_instanced_soup(to_port_iscene(SCENES[name][0]()), "cpu")
    lo, hi = soup.table[:, 12:15], soup.table[:, 15:18]
    pad = BOX_PAD * (1.0 + torch.maximum(hi - lo, torch.maximum(
        lo.abs(), hi.abs())).amax(dim=1, keepdim=True))
    want = torch.cat([lo - pad, pad, hi + pad, torch.ones_like(pad)], 1)
    assert torch.equal(soup.cull, want)


def test_tmax_above_1e30_decodes_as_the_reference():
    """A closest ray with tmax above 1e30 that hits nothing in a tile the
    reference tests gets its tile minimum's seed row (t = 1e30, the
    tile's first prim) there and the miss row here: the tracers' hits
    agree."""
    js = j_multi_instance_cornell()[0]
    ts = to_port_iscene(js)
    o, d, _ = icu.cornell_rays(np.random.default_rng(43))
    closest = im.make_instanced_mt_tracer(ts, "cpu")[0]
    j_closest = jpi.make_pallas_instanced_tracer(js, interpret=True)[0]
    h = closest(torch.from_numpy(o), torch.from_numpy(d), 1e-2, 3e30)
    jh = j_closest(jnp.asarray(o), jnp.asarray(d), 1e-2, 3e30, None)
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(h.inst.numpy(), np.asarray(jh.inst))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(jh.t), rtol=T_TOL)
    assert 0 < float((h.prim >= 0).float().mean()) < 1
