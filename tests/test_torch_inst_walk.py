"""K9-inst's plain version, the instanced walk round, against the
reference, and the instanced walk tracers against the brute tracers.

The port's `_walk_round_inst` (integrate/walkpool.py) is driven to
completion over seeded rays as the reference's is, round for round on the
same split-ordered field and table: the current row, the instance the
lane walks in and the best prim and instance equal after every round;
at the end t within 1e-6 (1e-5 for 2 keys, whose per-lane inverse moves
through XLA's FMA contractions) and u, v within 1e-5, prims, instances and
occlusion exact. The walk tracers (`trace_closest_inst_hier`,
`trace_any_inst_hier`, plain) are held to the port's and the reference's
brute instanced tracers (trace/instanced.py): prim and instance exact,
t/u/v within 1e-5 (2e-4 for 2 keys, the reference's own bound for its
walk against its brute tracer, tests/test_hier_instanced.py:156: the walk
inverts the lerped transform about the ray origin, the brute tracer
about the world origin: on 1024 such rays one lane's u moved by 1.3e-5),
at times 0 and 1 too, and the live count gates; the two brute tracers
agree within 1e-5. The reference's instanced round leaves pruned entries
behind a finished walk (ROADMAP C9); the port's does not, and a second
walk in the scratch equals a fresh one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inst_util import j_field, to_port_iscene
from rendertoy3c_tpu.integrate.walkpool import \
    _walk_round_inst as j_walk_round_inst
from rendertoy3c_tpu.trace import hier_instanced as jhi
from rendertoy3c_tpu.trace.instanced import \
    make_instanced_tracer as j_brute
from rendertoy3c_tpu_torch.integrate import walkpool as tw
from rendertoy3c_tpu_torch.trace import hier_instanced as hi
from rendertoy3c_tpu_torch.trace.hierwalk import _BIG
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer

N = 2048


@pytest.fixture(scope="module")
def fields():
    """{motion: (reference scene, table; port scene, table)}: bench's
    instance field at grid 6 (38 instances), split-ordered."""
    out = {}
    for motion in (False, True):
        js = jhi.split_order_instanced(j_field(motion, 6)[0])
        ts = to_port_iscene(js)
        out[motion] = (js, jhi.build_inst_hier_table(js), ts,
                       hi.build_inst_hier_table(ts, device="cpu"))
    return out


def _rays(seed, any_hit, n=N):
    """Rays from above and around the field, toward it; any-hit rays end
    at random tmax in [0.5, 12]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform((-5, 0.2, -5), (5, 5, 5), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = (rng.uniform(0.5, 12.0, n) if any_hit
            else np.full(n, 1e16)).astype(np.float32)
    time = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, tmax, time


def _ray8(o, d, tmax):
    return np.concatenate([o, d, np.full((o.shape[0], 1), 1e-3, np.float32),
                           tmax[:, None]], axis=1)


def _j_state(jt, o, d, tmax, time, any_hit):
    r = o.shape[0]
    return dict(
        rays=jnp.asarray(_ray8(o, d, tmax)), wtime=jnp.asarray(time),
        cur=jnp.zeros((r,), jnp.int32), wmode=jnp.full((r,), any_hit),
        wfound=jnp.zeros((r,), bool), wb_t=jnp.asarray(tmax),
        wb_prim=jnp.full((r,), -1, jnp.int32), wb_u=jnp.zeros((r,)),
        wb_v=jnp.zeros((r,)), o_cur=jnp.asarray(o), d_cur=jnp.asarray(d),
        inst_cur=jnp.full((r,), -1, jnp.int32),
        wb_inst=jnp.full((r,), -1, jnp.int32),
        ents=[jnp.full((r, jt.fanout), jnp.float32(jhi._BIG))
              for _ in range(len(jt.world_starts) + len(jt.mesh_starts))],
        bases=[jnp.zeros((r,), jnp.int32)
               for _ in range(len(jt.world_starts) + len(jt.mesh_starts))])


def _t_state(tt, o, d, tmax, time, any_hit, paths=0):
    s = tw.new_walk_state(o.shape[0], tt.n_levels, tt.fanout, paths, 16,
                          "cpu")
    s.ray.copy_(torch.as_tensor(_ray8(o, d, tmax)))
    s.o_cur.copy_(torch.as_tensor(o))
    s.d_cur.copy_(torch.as_tensor(d))
    s.wtime.copy_(torch.as_tensor(time))
    s.cur.zero_()
    s.wmode.fill_(any_hit)
    s.wb_t.copy_(torch.as_tensor(tmax))
    return s


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_walk_round_inst_matches_reference(fields, motion, any_hit):
    _, jt, _, tt = fields[motion]
    o, d, tmax, time = _rays(3 + 2 * motion + any_hit, any_hit)
    js = _j_state(jt, o, d, tmax, time, any_hit)
    s = _t_state(tt, o, d, tmax, time, any_hit)
    step = jax.jit(lambda st: j_walk_round_inst(jt, st, motion))
    rounds = 0
    while bool(jnp.any(js["cur"] >= 0)):
        js = step(js)
        tw._walk_round_inst(tt, s, motion)
        rounds += 1
        for name in ("cur", "inst_cur", "wb_prim", "wb_inst"):
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(js[name]), name)
        assert rounds < 256
    assert rounds > 2 * tt.n_levels
    if any_hit:
        found = s.wfound.numpy()
        np.testing.assert_array_equal(found, np.asarray(js["wfound"]))
        assert 0.1 < found.mean() < 0.9
        return
    assert 0.3 < (s.wb_prim.numpy() >= 0).mean()
    t_tol = 1e-5 if motion else 1e-6
    for name, tol in (("wb_t", t_tol), ("wb_u", 1e-5), ("wb_v", 1e-5)):
        np.testing.assert_allclose(getattr(s, name).numpy(),
                                   np.asarray(js[name]), rtol=tol,
                                   atol=tol, err_msg=name)
    assert (s.ents == _BIG).all()  # every entry popped or pruned


@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_inst_tracers_match_brute_tracers(fields, motion):
    js, _, ts, tt = fields[motion]
    o, d, tmax, time = _rays(11, True, N // 4)
    ot, dt_, tmt, tmt_ = (torch.as_tensor(x) for x in (o, d, tmax, time))
    t = tmt_ if motion else None
    h = hi.trace_closest_inst_hier(tt, ot, dt_, 1e-3, 1e16, time=t)
    b = make_instanced_tracer(ts, "cpu")[0](ot, dt_, 1e-3, 1e16, t)
    jb = j_brute(js)[0](jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16,
                        jnp.asarray(time) if motion else None, None)
    hit = b.prim.numpy() >= 0
    assert hit.mean() > 0.3
    for got, tol in ((h, 2e-4 if motion else 1e-5), (b, 1e-5)):
        np.testing.assert_array_equal(got.prim.numpy(), np.asarray(jb.prim))
        np.testing.assert_array_equal(got.inst.numpy(), np.asarray(jb.inst))
        for a, w in ((got.t, jb.t), (got.u, jb.u), (got.v, jb.v)):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(w)[hit],
                                       rtol=tol, atol=tol)
    occ = hi.trace_any_inst_hier(tt, ot, dt_, 1e-3, tmt, time=t)
    np.testing.assert_array_equal(
        occ.numpy(), make_instanced_tracer(ts, "cpu")[1](ot, dt_, 1e-3, tmt,
                                                  t).numpy())
    # the live count: rays past it stay misses
    h2 = hi.trace_closest_inst_hier(tt, ot, dt_, 1e-3, 1e16, count=N // 8,
                                    time=t)
    assert (h2.prim[N // 8:] == -1).all() and (h2.inst[N // 8:] == -1).all()
    np.testing.assert_array_equal(h2.prim[:N // 8].numpy(),
                                  h.prim[:N // 8].numpy())


@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_inst_tracer_routes_every_launch_through_walk_fn(fields, motion):
    """make_inst_hierwalk_tracer's walk_fn takes every launch of both
    drivers in place of walk_rounds, and the hits and occlusion stay
    those of the default tracer bit for bit."""
    _, _, ts, _ = fields[motion]
    o, d, tmax, time = (torch.as_tensor(x) for x in _rays(41, True, 256))
    t = time if motion else None
    seen = []

    def walk_fn(s, tab, motion_, rounds, plain=False):
        seen.append((s.cur.shape[0], motion_, rounds))
        tw.walk_rounds(s, tab, motion_, rounds, plain=plain)

    mine = hi.make_inst_hierwalk_tracer(ts, "cpu", walk_fn=walk_fn)
    base = hi.make_inst_hierwalk_tracer(ts, "cpu")
    hit = mine[0](o, d, 1e-3, 1e16, t)
    n_closest = len(seen)
    got = hit, mine[1](o, d, 1e-3, tmax, t)
    want = base[0](o, d, 1e-3, 1e16, t), base[1](o, d, 1e-3, tmax, t)
    assert 0 < n_closest < len(seen)
    assert set(seen) == {(256, motion, 16)}
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("tv", [0.0, 1.0])
def test_matrix_motion_time_extremes(fields, tv):
    """At t = 0 and t = 1 the walk reproduces the key transforms: prims
    exact against the reference's brute tracer, t within 1e-5."""
    js, _, _, tt = fields[True]
    o, d, _, _ = _rays(21, False, 256)
    time = np.full(256, tv, np.float32)
    h = hi.trace_closest_inst_hier(tt, torch.as_tensor(o),
                                   torch.as_tensor(d), 1e-3, 1e16,
                                   time=torch.as_tensor(time))
    jb = j_brute(js)[0](jnp.asarray(o), jnp.asarray(d), 1e-3, 1e16,
                        jnp.asarray(time), None)
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jb.prim))
    np.testing.assert_array_equal(h.inst.numpy(), np.asarray(jb.inst))
    hit = h.prim.numpy() >= 0
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(jb.t)[hit],
                               rtol=1e-5, atol=1e-5)


def test_second_walk_in_a_scratch_is_fresh(fields):
    """ROADMAP C9: after a closest walk finishes, the reference's
    instanced round leaves its pruned entries in the scratch, which the
    next walk launched there pops; the port's entries are all _BIG, and
    its second walk takes the rounds and finds the hits of a fresh one."""
    js, jt, ts, tt = fields[False]
    o, d, tmax, time = _rays(31, False)
    jstate = _j_state(jt, o, d, tmax, time, False)
    step = jax.jit(lambda st: j_walk_round_inst(jt, st, False))
    while bool(jnp.any(jstate["cur"] >= 0)):
        jstate = step(jstate)
    stale = sum(int((np.asarray(e) < 1e29).sum()) for e in jstate["ents"])
    assert stale > 0

    s = _t_state(tt, o, d, tmax, time, False, paths=1)
    o2, d2, tmax2, _ = _rays(32, False)
    s.pray[0] = torch.as_tensor(_ray8(o2, d2, tmax2))
    s.pvalid.fill_(True)
    while bool((s.cur >= 0).any()):
        tw._walk_round_inst(tt, s, False)
    assert (s.ents == _BIG).all()
    rounds = 0
    tw._launch_ref(s, inst=True)
    while bool((s.cur >= 0).any()):
        tw._walk_round_inst(tt, s, False)
        rounds += 1
    fresh = _t_state(tt, o2, d2, tmax2, time, False)
    fresh_rounds = 0
    while bool((fresh.cur >= 0).any()):
        tw._walk_round_inst(tt, fresh, False)
        fresh_rounds += 1
    assert rounds == fresh_rounds
    for name in ("wb_prim", "wb_inst", "wb_t"):
        assert torch.equal(getattr(s, name), getattr(fresh, name)), name
