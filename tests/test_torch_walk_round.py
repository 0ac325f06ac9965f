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
and occlusion exact, t, u, v within 1e-6."""
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

N = 2048


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
