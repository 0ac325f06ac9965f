"""The one-launch schedule of the resident-table walk (K8): each block
runs its own passes to its own done flag, keeping any-hit occlusion
across them (trace/residentwalk.py `walk_closest_blocks_ref` and
`walk_any_blocks_ref`, which trace_closest_walk / trace_any_walk run on
the CPU), against the reference's pass loop, which relaunches every
block while any is open and starts each any-hit pass unoccluded: the
port's (plain=True, bit for bit) and the JAX package's in interpret mode
(prims and occlusion exact, t, u and v at rtol = atol = 1e-6, as
tests/test_torch_residentwalk.py says why).

Box grids at T = 24, 4 and 2. The kernel tests WINDOW leaves at once and
resolves them in visit order, so its results and its per-block counts
are those of this schedule for any WINDOW; the twin has none. Cases: the
live count inside a block with stale lanes past it, zero padding rays in
a live block, rays with tmax = inf (each block's first round without a
hit takes face 0's u and v), a ray through the shared edge of two faces
in different leaves at equal t, and walks cut at a pass cap."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace import pallas_walk as j_walk
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import residentwalk as rw
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)
from resident_walk_util import TOL, field_pair, rays, tables

BOX = ([-1, 0.1, -1], [9, 2.5, 9])


@pytest.fixture(scope="module")
def field():
    js, ts = field_pair()
    return js, ts, *tables(js, ts, 32)


def _bits(a, b) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _closest(jt, tt, o, d, tmax, count, t_rounds):
    """(the schedule's Hit, its counts, the port's plain loop's Hit, the
    reference's Hit)."""
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    passes = []
    got = rw.trace_closest_walk(tt, ot, dt, 0.01, tmax, count=count,
                                t_rounds=t_rounds, passes=passes)
    plain = rw.trace_closest_walk(tt, ot, dt, 0.01, tmax, count=count,
                                  t_rounds=t_rounds, plain=True)
    want = j_walk.trace_closest_walk(jt, jnp.asarray(o), jnp.asarray(d),
                                     0.01, tmax, count=count,
                                     t_rounds=t_rounds, interpret=True)
    return got, passes[0], plain, want


def _check_closest(got, plain, want):
    for a, b in zip(got[:4], plain[:4]):
        assert _bits(a, b)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)


@pytest.mark.parametrize("t_rounds", [24, 4, 2])
@pytest.mark.parametrize("count", [150, 200])
def test_closest_schedule_matches_pass_loops(field, t_rounds, count):
    """200 rays (7 blocks, the last padded with 24 zero rays): count 150
    ends inside block 4, whose rays 150-159 are stale, and leaves blocks
    5 and 6 dead; count 200 keeps the padding rays of block 6 live."""
    js, ts, jt, tt = field
    o, d = rays(200, *BOX, 31)
    got, counts, plain, want = _closest(jt, tt, o, d, 1e16, count,
                                        t_rounds)
    _check_closest(got, plain, want)
    brute = trace_closest_bruteforce(ts, torch.as_tensor(o),
                                     torch.as_tensor(d), 0.01, 1e16)
    live = torch.arange(200) < count
    assert torch.equal(got.prim, torch.where(live, brute.prim, -1))
    assert counts.shape == (7, 2) and counts.dtype == torch.int32
    assert (counts[:, 0] >= 1).all()
    if count == 150:  # dead blocks run one pass without a round
        assert counts[5:].tolist() == [[1, 0], [1, 0]]
    if t_rounds == 2:
        assert int(counts[:, 0].max()) > 1


@pytest.mark.parametrize("t_rounds", [24, 4, 2])
@pytest.mark.parametrize("count", [150, 200])
def test_any_schedule_matches_pass_loops(field, t_rounds, count):
    """Per-ray tmax from 0.3 to 6, so that some rays of a block are
    occluded early and others walk every leaf their slabs enter."""
    js, ts, jt, tt = field
    o, d = rays(200, *BOX, 37)
    tmax = np.linspace(0.3, 6.0, 200).astype(np.float32)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    passes = []
    got = rw.trace_any_walk(tt, ot, dt, 1e-3, torch.as_tensor(tmax),
                            count=count, t_rounds=t_rounds, passes=passes)
    plain = rw.trace_any_walk(tt, ot, dt, 1e-3, torch.as_tensor(tmax),
                              count=count, t_rounds=t_rounds, plain=True)
    want = j_walk.trace_any_walk(jt, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                 jnp.asarray(tmax), count=count,
                                 t_rounds=t_rounds, interpret=True)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    brute = trace_any_bruteforce(ts, ot, dt, 1e-3, torch.as_tensor(tmax))
    assert torch.equal(got, brute & (torch.arange(200) < count))
    assert 0 < int(got.sum()) < count
    counts = passes[0]
    assert (counts[:, 0] >= 1).all()
    if t_rounds == 2:
        assert int(counts[:, 0].max()) > 1


@pytest.mark.parametrize("t_rounds", [24, 2])
def test_closest_tmax_inf_raw_rows(field, t_rounds):
    """tmax = inf: every block's first round takes t_c = BIG at face 0 of
    its leaf with face 0's u and v where its rays hit nothing (dead
    blocks too). The walk's raw rows against the reference's pass loop
    run by hand (chained walk_closest_ref launches of every block,
    combined as pallas_walk.py:407-411), the first pass's rows and cursor
    against the reference's kernel; the gated hits as the reference's."""
    js, ts, jt, tt = field
    o, d = rays(200, *BOX, 41)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    inf = float("inf")
    packed, _ = rw._pack(ot, dt, 0.01, inf, 32)
    count = torch.tensor([150], dtype=torch.int32)
    er, ir = rw._start(packed, 32)
    out1, cur1 = rw.walk_closest_ref(count, er, ir, packed, tt, 32,
                                     t_rounds)
    w_out, w_cur = j_walk._walk_call(
        j_walk._closest_kernel, jnp.asarray(count.numpy()),
        jnp.asarray(er.numpy()), jnp.asarray(ir.numpy()),
        jnp.asarray(packed.numpy()), jt, 32, t_rounds, True)
    np.testing.assert_array_equal(cur1.numpy(), np.asarray(w_cur))
    np.testing.assert_array_equal(out1[:, 1].numpy(), np.asarray(w_out)[:, 1])
    np.testing.assert_allclose(out1.numpy(), np.asarray(w_out), **TOL)
    no_hit = out1[:, 0] == 1e30
    assert no_hit.any() and (out1[no_hit, 1] % 32 == 0).all()
    best = torch.where((out1[:, 1] >= 0.0)[:, None], out1,
                       torch.stack([packed[:, 7], -torch.ones(224),
                                    torch.zeros(224), torch.zeros(224)], 1))
    cur = cur1
    for _ in range(rw.pass_cap(tt, t_rounds) - 1):
        if not (cur[:, 0] == 0.0).any():
            break
        rays_p = torch.cat([packed[:, :7], best[:, :1]], dim=1)
        out, cur = rw.walk_closest_ref(count, cur[:, 1].contiguous(),
                                       cur[:, 2].to(torch.int32), rays_p,
                                       tt, 32, t_rounds)
        best = torch.where((out[:, 1] >= 0.0)[:, None], out, best)
    got, _, _ = rw.walk_closest(count, er, ir, packed, tt, 32, t_rounds,
                                rw.pass_cap(tt, t_rounds))
    assert _bits(got, best)
    hit, _, plain, want = _closest(jt, tt, o, d, inf, 150, t_rounds)
    _check_closest(hit, plain, want)


def _edge_pair(filler_y):
    """64 faces on y = 0 and fillers, in face order: leaf 0 (faces 0-31)
    ends with A = (0,0,0) (1,0,0) (0,0,1), leaf 1 (32-63) starts with B =
    (1,0,0) (0,0,1) (1,0,1): their shared edge runs through (0.5, 0,
    0.5). The other faces are small triangles at x in [2, 3], y =
    filler_y[leaf], which set each leaf box's top face and so the order
    in which a ray from above enters them."""
    v, f = [], []
    for face in range(64):
        if face == 31:
            tri = [[0, 0, 0], [1, 0, 0], [0, 0, 1]]
        elif face == 32:
            tri = [[1, 0, 0], [0, 0, 1], [1, 0, 1]]
        else:
            x = 2.0 + (face % 8) / 8.0
            z = (face // 8) / 8.0
            y = filler_y[face // 32]
            tri = [[x, y, z], [x + 0.1, y, z], [x, y, z + 0.1]]
        f.append([len(v), len(v) + 1, len(v) + 2])
        v.extend(tri)
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int32)
    js = j_build_scene([JMesh(vertices=v[None], indices=f,
                              material=JMaterial())])
    ts = build_scene([Mesh(vertices=v[None], indices=f, material=Material())])
    return js, ts


@pytest.mark.parametrize("case,filler_y,prim", [("tie", (0.0, 0.0), 31),
                                                ("second_nearer",
                                                 (-1.0, 0.5), 32)])
def test_shared_edge_across_leaves(case, filler_y, prim):
    """Ray 0 of the block falls straight onto the shared edge of A (face
    31, leaf 0) and B (face 32, leaf 1) and hits both at t = 1. "tie":
    both leaf boxes are entered at t = 1 and leaf 0, the lower id, goes
    first; "second_nearer": leaf 1's box is entered at t = 0.5. The first
    leaf's face keeps the hit, as a later one needs t < best t. The other
    31 rays fall on the fillers or past them."""
    js, ts = _edge_pair(filler_y)
    jt, tt = tables(js, ts, 32)
    rng = np.random.default_rng(5)
    o = np.concatenate([[[0.5, 1.0, 0.5]],
                        rng.uniform([0, 1, 0], [3, 2, 1], (31, 3))])
    d = np.tile(np.asarray([[0.0, -1.0, 0.0]]), (32, 1))
    o, d = o.astype(np.float32), d.astype(np.float32)
    for t_rounds in (24, 1):
        got, _, plain, want = _closest(jt, tt, o, d, 1e16, None, t_rounds)
        _check_closest(got, plain, want)
        assert int(got.prim[0]) == prim and float(got.t[0]) == 1.0


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_cut_at_a_pass_cap(field, any_hit):
    """max_passes below what the walk needs (T = 2): the blocks still
    open stop at the cap with what they found, as the reference's loop
    cut after as many launches: every block's output rows equal, and the
    cursor rows of the blocks the cap cut."""
    js, ts, jt, tt = field
    o, d = rays(256, *BOX, 43)
    t_hi = 4.0 if any_hit else 1e16
    packed, _ = rw._pack(torch.as_tensor(o), torch.as_tensor(d),
                         1e-3 if any_hit else 0.01, t_hi, 32)
    count = torch.tensor([250], dtype=torch.int32)
    er, ir = rw._start(packed, 32)
    ref = rw.walk_any_ref if any_hit else rw.walk_closest_ref
    walk = rw.walk_any if any_hit else rw.walk_closest
    full = walk(count, er, ir, packed, tt, 32, 2, rw.pass_cap(tt, 2))[2]
    cap = 3
    assert int(full[:, 0].max()) > cap
    out, cur, counts = walk(count, er, ir, packed, tt, 32, 2, cap)
    assert int(counts[:, 0].max()) == cap
    want, c = ref(count, er, ir, packed, tt, 32, 2)
    open_ = c[:, 0] == 0.0
    for _ in range(cap - 1):
        if any_hit:
            o2, c = ref(count, c[:, 1].contiguous(), c[:, 2].to(torch.int32),
                        packed, tt, 32, 2)
            want = torch.maximum(want, o2)
        else:
            rays_p = torch.cat([packed[:, :7], want[:, :1]], dim=1)
            o2, c = ref(count, c[:, 1].contiguous(), c[:, 2].to(torch.int32),
                        rays_p, tt, 32, 2)
            want = torch.where((o2[:, 1] >= 0.0)[:, None], o2, want)
        open_ &= c[:, 0] == 0.0
    assert _bits(out, want)
    # a block open at the cap was open after each of the reference's
    # passes too (with occlusion kept, an any-hit block stops no later)
    cut = cur[:, 0] == 0.0
    assert cut.any() and not (cut & ~open_).any()
    assert _bits(cur[cut], c[cut]) and (counts[cut, 0] == cap).all()
