"""K9's plain version, the walk round, against the reference.

The port's `_walk_round` (integrate/walkpool.py) is driven to completion
over a ray batch as tests/test_walkpool.py `_drive_walk` drives the
reference's, round for round on the same seeded rays and the same table:
the current rows equal after every round, and at the end prims and
occlusion exact, t within 1e-6 (1e-5 for 2 keys) and u, v within 1e-5:
XLA on the CPU contracts a * b + c into an FMA where torch rounds twice,
which moved one lane's u by 1.8e-6 and, through the 2-key row lerp, two
lanes' t by up to 3.9e-6 (tests/test_torch_mt_motion.py holds u/v at
1e-5 for the same reason). Closest and any-hit walks, static and 2-key
with random times. The walk tracers (`trace_closest_hier`,
`trace_any_hier`, plain) are held against the port's brute tracer: prims
and occlusion exact, t, u, v within 1e-6.

The tie rules that K9 and K9-inst keep (the lowest leaf lane at equal t,
the lowest slot at equal entries, the pruning write-back, -0 and +0 as
equals) are pinned on tests/walk_tie_util.py's tables, whose arithmetic
is exact: there the port's plain `_walk_round` and `_walk_round_inst`
equal the reference's rounds bit for bit after every round (every lane
column; the entries after the reference's instanced round are compared
once pruned at the round's cut, which that round does not write back,
ROADMAP C9), and every closest hit is on the lower lane of its
duplicated pair."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.walkpool import _walk_round as j_walk_round
from rendertoy3c_tpu.trace import hierwalk as jh
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate import walkpool as tw
from rendertoy3c_tpu_torch.trace import hierwalk as th
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)
from torch_port_util import box_field_pair, to_port_hier_table
from walk_tie_util import flat_geom, has_equal_children, inst_parts
from walk_tie_util import rays as tie_rays

N = 2048
TIE_N = 512


@pytest.fixture(scope="module")
def fields():
    """{motion: (reference table, port table, port scene)}: the 16 x 16 box
    field split-ordered, 2 levels at fanout 16 (the fanout auto-pick's)."""
    out = {}
    for motion in (False, True):
        js, ts, _ = box_field_pair(16, motion)
        leaf = th.HIER_LEAF_MOTION if motion else th.HIER_LEAF
        js, ts = j_split_order(js, leaf=leaf), split_order_scene(ts, leaf=leaf)
        keys = 2 if motion else 1
        jt = jh.build_hier_table(js.geom, js.num_faces, num_keys=keys,
                                 fanout=0)
        out[motion] = (jt, to_port_hier_table(jt), ts)
    return out


def _rays(seed, any_hit):
    """Rays from above the field, in all directions; any-hit rays end at
    random tmax in [0.5, 12]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-9, 0.2, -9), (9, 4, 9), (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = (rng.uniform(0.5, 12.0, N) if any_hit
            else np.full(N, 1e16)).astype(np.float32)
    time = rng.uniform(0, 1, N).astype(np.float32)
    return o, d, tmax, time


def _j_state(jt, o, d, tmax, time, any_hit):
    r = o.shape[0]
    return dict(
        rays=jnp.concatenate([jnp.asarray(o), jnp.asarray(d),
                              jnp.full((r, 1), jnp.float32(1e-3)),
                              jnp.asarray(tmax)[:, None]], axis=1),
        wtime=jnp.asarray(time), cur=jnp.zeros((r,), jnp.int32),
        wmode=jnp.full((r,), any_hit), wfound=jnp.zeros((r,), bool),
        wb_t=jnp.asarray(tmax), wb_prim=jnp.full((r,), -1, jnp.int32),
        wb_u=jnp.zeros((r,)), wb_v=jnp.zeros((r,)),
        ents=[jnp.full((r, jt.fanout), jnp.float32(jh._BIG))
              for _ in range(len(jt.level_starts))],
        bases=[jnp.zeros((r,), jnp.int32) for _ in jt.level_starts])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_walk_round_matches_reference(fields, motion, any_hit):
    jt, tt, _ = fields[motion]
    o, d, tmax, time = _rays(3 + 2 * motion + any_hit, any_hit)
    js = _j_state(jt, o, d, tmax, time, any_hit)
    s = tw.new_walk_state(N, tt.n_levels, tt.fanout, 0, 16, "cpu")
    s.ray.copy_(torch.as_tensor(np.concatenate(
        [o, d, np.full((N, 1), 1e-3, np.float32), tmax[:, None]], axis=1)))
    s.wtime.copy_(torch.as_tensor(time))
    s.cur.zero_()
    s.wmode.fill_(any_hit)
    s.wb_t.copy_(torch.as_tensor(tmax))
    step = jax.jit(lambda st: j_walk_round(jt, st, motion))
    rounds = 0
    while bool(jnp.any(js["cur"] >= 0)):
        js = step(js)
        tw._walk_round(tt, s, motion)
        rounds += 1
        np.testing.assert_array_equal(s.cur.numpy(), np.asarray(js["cur"]))
        assert rounds < 256
    assert rounds > 2 * tt.n_levels
    assert int(s.rows) > N * 2  # rows gathered: the walking lane-rounds
    if any_hit:
        found = s.wfound.numpy()
        np.testing.assert_array_equal(found, np.asarray(js["wfound"]))
        assert 0.1 < found.mean() < 0.9
        return
    prim = s.wb_prim.numpy()
    np.testing.assert_array_equal(prim, np.asarray(js["wb_prim"]))
    assert 0.3 < (prim >= 0).mean() < 1.0
    t_tol = 1e-5 if motion else 1e-6
    for name, tol in (("wb_t", t_tol), ("wb_u", 1e-5), ("wb_v", 1e-5)):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(js[name]), rtol=tol,
                                   atol=tol, err_msg=name)
    assert (s.ents == th._BIG).all()  # every entry popped or pruned


@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_walk_tracers_match_brute_tracer(fields, motion):
    _, tt, ts = fields[motion]
    o, d, tmax, time = (torch.as_tensor(x) for x in _rays(11, True))
    t = time if motion else None
    h = th.trace_closest_hier(tt, o, d, 1e-3, 1e16, time=t)
    b = trace_closest_bruteforce(ts, o, d, 1e-3, 1e16, time=t)
    np.testing.assert_array_equal(h.prim.numpy(), b.prim.numpy())
    hit = b.prim.numpy() >= 0
    assert hit.mean() > 0.3
    for got, want in ((h.t, b.t), (h.u, b.u), (h.v, b.v)):
        np.testing.assert_allclose(got.numpy()[hit], want.numpy()[hit],
                                   rtol=1e-6, atol=1e-6)
    occ = th.trace_any_hier(tt, o, d, 1e-3, tmax, time=t)
    np.testing.assert_array_equal(
        occ.numpy(), trace_any_bruteforce(ts, o, d, 1e-3, tmax,
                                          time=t).numpy())
    # the live count: rays past it stay misses
    h2 = th.trace_closest_hier(tt, o, d, 1e-3, 1e16, count=N // 2, time=t)
    assert (h2.prim[N // 2:] == -1).all()
    np.testing.assert_array_equal(h2.prim[:N // 2].numpy(),
                                  h.prim[:N // 2].numpy())


# ------------------------------------------------------------ the ties
def _tie_states(o, d, tmin, tmax, time, any_hit, n_levels, fanout, inst):
    """(reference state, port state) of a bare walk from the root."""
    r = o.shape[0]
    ray8 = np.concatenate([o, d, tmin[:, None], tmax[:, None]], axis=1)
    js = dict(rays=jnp.asarray(ray8), wtime=jnp.asarray(time),
              cur=jnp.zeros((r,), jnp.int32), wmode=jnp.full((r,), any_hit),
              wfound=jnp.zeros((r,), bool), wb_t=jnp.asarray(tmax),
              wb_prim=jnp.full((r,), -1, jnp.int32),
              wb_u=jnp.zeros((r,), jnp.float32),
              wb_v=jnp.zeros((r,), jnp.float32),
              ents=[jnp.full((r, fanout), jnp.float32(jh._BIG))
                    for _ in range(n_levels)],
              bases=[jnp.zeros((r,), jnp.int32) for _ in range(n_levels)])
    s = tw.new_walk_state(r, n_levels, fanout, 0, 16, "cpu")
    s.ray.copy_(torch.as_tensor(ray8))
    s.wtime.copy_(torch.as_tensor(time))
    s.cur.zero_()
    s.wmode.fill_(any_hit)
    s.wb_t.copy_(torch.as_tensor(tmax))
    if inst:
        js.update(o_cur=jnp.asarray(o), d_cur=jnp.asarray(d),
                  inst_cur=jnp.full((r,), -1, jnp.int32),
                  wb_inst=jnp.full((r,), -1, jnp.int32))
        s.o_cur.copy_(torch.as_tensor(o))
        s.d_cur.copy_(torch.as_tensor(d))
    return js, s


def _assert_rounds_bit_equal(js, s, inst):
    """Every lane column of the port's state equal to the reference's, bit
    for bit; the reference's instanced entries compared once pruned at
    the round's cut (ROADMAP C9)."""
    names = ["cur", "wfound", "wb_t", "wb_prim", "wb_u", "wb_v"]
    if inst:
        names += ["o_cur", "d_cur", "inst_cur", "wb_inst"]
    for name in names:
        want = np.asarray(js[name])
        got = getattr(s, name).numpy()
        if want.dtype == np.float32:
            want, got = want.view(np.int32), got.view(np.int32)
        np.testing.assert_array_equal(got, want, name)
    cut = th._prune_cut(torch.where(s.wfound, 0.0, s.wb_t)).numpy()
    for lv in range(len(js["ents"])):
        want = np.asarray(js["ents"][lv]).T
        if inst:
            want = np.where(want < cut[None], want, np.float32(th._BIG))
        np.testing.assert_array_equal(s.ents[lv].numpy().view(np.int32),
                                      want.view(np.int32), f"ents {lv}")
        np.testing.assert_array_equal(s.bases[lv].numpy(),
                                      np.asarray(js["bases"][lv]))


def _drive_ties(step, port_round, js, s, inst):
    rounds = 0
    while bool(jnp.any(js["cur"] >= 0)):
        js = step(js)
        port_round(s)
        _assert_rounds_bit_equal(js, s, inst)
        rounds += 1
        assert rounds < 256
    return rounds


def _assert_lower_lane_wins(s, any_hit, cap):
    """Shadow walks find some occluders and miss others; every closest hit
    is on the lower lane of its leaf's duplicated pair."""
    if any_hit:
        assert 0.1 < s.wfound.float().mean() < 0.9
        return
    prim = s.wb_prim.numpy()
    assert (prim >= 0).mean() > 0.15
    lane = prim[prim >= 0] % cap
    assert (lane % 2 == 0).all()


@pytest.fixture(scope="module")
def tie_tables():
    """{motion: (reference table, port table)} of walk_tie_util's flat
    geometry in its own order, at the auto fanout."""
    out = {}
    for motion in (False, True):
        g = flat_geom(motion)
        jt = jh.build_hier_table(g, g.v0.shape[1], num_keys=1 + motion,
                                 fanout=0)
        out[motion] = (jt, to_port_hier_table(jt))
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_walk_round_ties_match_reference_bit_for_bit(tie_tables, motion,
                                                     any_hit):
    jt, tt = tie_tables[motion]
    assert has_equal_children(tt.table.numpy(), tt.fanout)
    o, d, tmin, tmax, time = tie_rays(TIE_N, 40 + 2 * motion + any_hit,
                                      any_hit)
    js, s = _tie_states(o, d, tmin, tmax, time, any_hit, tt.n_levels,
                        tt.fanout, inst=False)
    step = jax.jit(lambda st: j_walk_round(jt, st, motion))
    rounds = _drive_ties(step, lambda st: tw._walk_round(tt, st, motion), js,
                         s, inst=False)
    assert rounds > tt.n_levels + 1
    _assert_lower_lane_wins(s, any_hit, th.HIER_LEAF_MOTION if motion
                            else th.HIER_LEAF)


@pytest.fixture(scope="module")
def tie_inst_tables():
    """{motion: (reference table, port table)} of walk_tie_util's
    instanced form: the reference's scene and table, and the port's table
    built from the same arrays."""
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu.scene.mesh import Mesh
    from rendertoy3c_tpu.scene.scene import Instance
    from rendertoy3c_tpu.trace import hier_instanced as jhi
    from rendertoy3c_tpu_torch.trace import hier_instanced as hi
    from inst_util import to_port_iscene

    out = {}
    for motion in (False, True):
        verts, idx, xforms = inst_parts(motion)
        js = build_instanced_scene(
            [Mesh(vertices=verts[None], indices=idx)],
            [Instance(mesh_index=0, transforms=t) for t in xforms])
        jt = jhi.build_inst_hier_table(js)
        tt = hi.build_inst_hier_table(to_port_iscene(js), device="cpu")
        np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
        out[motion] = (jt, tt)
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_walk_round_inst_ties_match_reference_bit_for_bit(
        tie_inst_tables, motion, any_hit):
    from rendertoy3c_tpu.integrate.walkpool import \
        _walk_round_inst as j_walk_round_inst

    jt, tt = tie_inst_tables[motion]
    o, d, tmin, tmax, time = tie_rays(TIE_N, 50 + 2 * motion + any_hit,
                                      any_hit, lo=-5, hi=11)
    js, s = _tie_states(o, d, tmin, tmax, time, any_hit, tt.n_levels,
                        tt.fanout, inst=True)
    step = jax.jit(lambda st: j_walk_round_inst(jt, st, motion))
    rounds = _drive_ties(step,
                         lambda st: tw._walk_round_inst(tt, st, motion), js,
                         s, inst=True)
    assert rounds > tt.n_levels + 1
    _assert_lower_lane_wins(s, any_hit, th.HIER_LEAF)
