"""The resident-table block walk (K8): closest and any hits over flat
128-face leaves, one 32-ray block at a time.

Port of rendertoy3c_tpu/trace/pallas_walk.py: `WalkTable` (:56),
`build_walk_table` (:96), `_pack` (:375), the kernels `_closest_kernel`
(:196) and `_any_kernel` (:271) behind `_walk_call` (:331, pallas_call
:338), the pass loops of `trace_closest_walk` and `trace_any_walk`
(:391, :441), `max_walk_faces` and `make_walk_tracer` (:478). On a CUDA
device a walk is one launch of kernels/csrc/resident_walk.cu
(`walk_closest`, `walk_any`), in which every block runs its own passes;
`walk_closest_blocks_ref` and `walk_any_blocks_ref` are their plain
versions, vectorised over the blocks, which the wrappers run for tensors
on the CPU. `walk_closest_ref` and `walk_any_ref` are one pass of every
block, the reference's launch, and `plain=True` runs the reference's
pass loop over them.

A pass of a block of RT rays:
  1. slab pass: each ray's entry into every leaf box (BIG on a miss),
     reduced to the block's row emin [Lp], the minimum over its RT rays;
     a dead block (its first ray at or past `count`) takes a row of BIG;
  2. masking by the resume cursor (er, ir): leaves whose (entry, id) is
     lexicographically at or below it were visited by an earlier pass;
  3. up to T rounds: the nearest leaf (the row's argmin, the lowest id at
     a tie) while its entry is below the largest best t of the block's
     rays; Moller-Trumbore of every ray against its 128 faces with tmax =
     the ray's best t, the lowest face at equal t; the leaf leaves the
     row and becomes the cursor;
  4. output (t, prim, u, v) per ray and the cursor row (done, entry, id).
The any-hit walk keeps an occlusion flag per ray instead: tmax falls to
tmin once a ray is occluded, and rounds run while the row has a leaf
below BIG and a ray of the block is unoccluded.

Every ray of a live block enters its row and its largest best t, rays
past `count` and zero padding rows included, as in the reference:
gating is per block in the walk and per ray after it. A walk runs each
block's passes until its own done flag, at most ceil(n_leaves / T) + 1
after the first; a closest pass takes each ray's best t as its tmax, an
any-hit pass the occlusion so far. The reference's loop relaunches every
block while any is open and starts each any-hit pass unoccluded; its
results are the same (kernels/csrc/resident_walk.cu says why). A walk
cut at the pass cap returns what it found, as the reference's does.

The grid step's G blocks of the reference (`_pick_g`) amortise TPU grid
overhead and are not copied: results depend on the block alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import build as kbuild
from .intersect import Hit
from .leafwalk import LeafTable, build_leaf_table

RT = 32  # rays per block: the warp
T_ROUNDS = 24  # rounds per block per pass
LEAF = 128  # triangles per leaf row
LANE_PAD = 128  # the slab row's padding (aabb_lanes' width)
_BIG = 1e30
_DET_EPS = 1e-10
# the plain versions' slab pass runs this many blocks at a time
_SLAB_CHUNK = 512


@dataclass(frozen=True)
class WalkTable:
    """Leaf rows and leaf boxes of the walk, as tensors on one device."""

    rows: torch.Tensor  # [L, 9, LEAF] f32
    aabb_lanes: torch.Tensor  # [8, Lp] f32: rows lo xyz, hi xyz, 2 unused
    num_faces: int
    leaf: int
    n_leaves: int

    @classmethod
    def from_leaf_table(cls, tab: LeafTable, leaf: int, device="cpu"):
        """The walk's table of a leaf table: the boxes lane-padded to a
        multiple of 128, padding lanes and empty (inverted) leaves given
        the far point-box lo = hi = BIG, which every slab test misses
        (an inverted box would pass the unordered min/max test as an
        infinite box)."""
        n_l = tab.aabb_t.shape[1]
        l_pad = -(-n_l // LANE_PAD) * LANE_PAD
        aabb_lanes = np.full((8, l_pad), _BIG, np.float32)
        aabb_lanes[:6, :n_l] = np.asarray(tab.aabb_t)
        inv_box = aabb_lanes[0, :] > aabb_lanes[3, :]
        for c in range(6):
            aabb_lanes[c, inv_box] = _BIG
        rows = np.asarray(tab.rows, np.float32).reshape(n_l, 9, leaf)
        dev = torch.device(device)
        return cls(rows=torch.as_tensor(np.ascontiguousarray(rows),
                                        device=dev),
                   aabb_lanes=torch.as_tensor(aabb_lanes, device=dev),
                   num_faces=int(tab.num_faces), leaf=leaf, n_leaves=n_l)


def build_walk_table(geom, num_faces: int, leaf: int = LEAF,
                     device="cpu") -> WalkTable:
    """The walk table of key 0 of a GeometrySoA, on `device`."""
    tab = build_leaf_table(geom, leaf=leaf)._replace(num_faces=num_faces)
    return WalkTable.from_leaf_table(tab, leaf, device)


def max_walk_faces(vmem_budget_bytes: int = 12 << 20) -> int:
    """The largest face count the reference's resident-table budget takes
    (64 B per face, pallas_walk.py:470-474)."""
    return vmem_budget_bytes // 64


# ------------------------------------------------------ the plain versions
def _slab_emin(rays, aabb, tmin, tmax):
    """[B, Lp] block rows: the minimum over each block's rays of their
    slab entries (BIG on a miss). rays [B, RT, 8]; tmin, tmax [B, RT]."""
    o = rays[..., 0:3]
    d = rays[..., 3:6]
    inv = torch.where(torch.abs(d) > 1e-20, 1.0 / d,
                      torch.full_like(d, _BIG))
    tn = tf = None
    for c in range(3):
        lo = aabb[c][None, None, :]
        hi = aabb[c + 3][None, None, :]
        t0 = (lo - o[..., c:c + 1]) * inv[..., c:c + 1]
        t1 = (hi - o[..., c:c + 1]) * inv[..., c:c + 1]
        cn = torch.minimum(t0, t1)
        cf = torch.maximum(t0, t1)
        tn = cn if tn is None else torch.maximum(tn, cn)
        tf = cf if tf is None else torch.minimum(tf, cf)
    ok = ((tn <= tf) & (tf > tmin[..., None]) & (tn < tmax[..., None]))
    ent = torch.where(ok, torch.maximum(tn, tmin[..., None]),
                      torch.full_like(tn, _BIG))
    return ent.amin(dim=1)


def _block_emin(live, er, ir, rays, aabb, tmin, tmax):
    """The masked block rows [B, Lp] (pallas_walk.py `_block_emin`): BIG
    for dead blocks (live [B] false) and for leaves at or below the resume
    cursor."""
    b = rays.shape[0]
    emin = torch.cat([_slab_emin(rays[i:i + _SLAB_CHUNK], aabb,
                                 tmin[i:i + _SLAB_CHUNK],
                                 tmax[i:i + _SLAB_CHUNK])
                      for i in range(0, b, _SLAB_CHUNK)])
    big = torch.full_like(emin, _BIG)
    emin = torch.where(live[:, None], emin, big)
    lanes = torch.arange(emin.shape[1], device=rays.device)
    er = er[:, None]
    visited = (emin < er) | ((emin == er) & (lanes <= ir[:, None]))
    return torch.where(visited, big, emin)


def _argmin_lane(emin):
    """(minimum [B], the first lane at it [B]; Lp where none is, as with
    a NaN minimum) of block rows [B, Lp]."""
    m = emin.amin(dim=1)
    lanes = torch.arange(emin.shape[1], device=emin.device)
    lid = torch.where(emin <= m[:, None], lanes,
                      emin.shape[1]).amin(dim=1)
    return m, lid


def _mt_leaf(rays, tri, tmin, tmax):
    """Moller-Trumbore of each block's rays [S, RT, 8] against its leaf
    row tri [S, 9, LEAF], tmin and tmax [S, RT]: (t, u, v, hit), each [S,
    RT, LEAF] (pallas_walk.py `_mt_block`)."""
    ox, oy, oz, dx, dy, dz = (rays[..., c:c + 1] for c in range(6))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri[:, c][:, None, :] for c in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin[..., None]) & (t < tmax[..., None]))
    return t, u, v, hit


def _cursor(done, ce, ci):
    """The cursor rows [B, 8]: (done, entry, leaf id, 0, ...)."""
    cur = torch.zeros((done.shape[0], 8), dtype=torch.float32,
                      device=done.device)
    cur[:, 0] = done
    cur[:, 1] = ce
    cur[:, 2] = ci.to(torch.float32)
    return cur


def _closest_pass(live, er, ir, r, tab: WalkTable, t_rounds: int, best_t,
                  prim, bu, bv):
    """One closest pass of S blocks (pallas_walk.py `_closest_kernel`) from
    their cursors (er, ir): rays r [S, rt, 8], whose tmax is each ray's
    best t best_t [S, rt]; best_t, prim, bu and bv are updated in place.
    Returns (done [S], cursor entry, cursor id, rounds [S] int32)."""
    dev = r.device
    tmin = r[..., 6]
    emin = _block_emin(live, er, ir, r, tab.aabb_lanes, tmin, best_t)
    ce, ci = er.clone(), ir.clone()
    rounds = torch.zeros(r.shape[0], dtype=torch.int32, device=dev)
    lanes = torch.arange(tab.leaf, device=dev)
    for _ in range(t_rounds):
        m, lid = _argmin_lane(emin)
        todo = m < best_t.amax(dim=1)
        sub = torch.nonzero(todo)[:, 0]
        if sub.numel() == 0:
            break
        lid_s = lid[sub]
        t, u, v, hit = _mt_leaf(r[sub], tab.rows[lid_s], tmin[sub],
                                best_t[sub])
        tt = torch.where(hit, t, torch.full_like(t, _BIG))
        t_c = tt.amin(dim=2)
        at_min = tt <= t_c[..., None]
        lane_c = torch.where(at_min, lanes, tab.leaf).amin(dim=2)
        one = at_min & (lanes == lane_c[..., None])
        zero = torch.zeros_like(u)
        u_c = torch.where(one, u, zero).sum(dim=2)
        v_c = torch.where(one, v, zero).sum(dim=2)
        prim_c = (float(tab.leaf) * lid_s.to(torch.float32)[:, None]
                  + lane_c.to(torch.float32))
        better = t_c < best_t[sub]
        best_t[sub] = torch.where(better, t_c, best_t[sub])
        prim[sub] = torch.where(better, prim_c, prim[sub])
        bu[sub] = torch.where(better, u_c, bu[sub])
        bv[sub] = torch.where(better, v_c, bv[sub])
        emin[sub, lid_s] = _BIG
        ce[sub] = m[sub]
        ci[sub] = lid_s.to(ci.dtype)
        rounds[sub] += 1
    done = torch.where(emin.amin(dim=1) < best_t.amax(dim=1), 0.0, 1.0)
    return done, ce, ci, rounds


def _any_pass(live, er, ir, r, tab: WalkTable, t_rounds: int, occ,
              count_tests: bool):
    """One any-hit pass of S blocks (pallas_walk.py `_any_kernel`) from
    their cursors: rays r [S, rt, 8]; occ [S, rt] (0.0 or 1.0), the
    occlusion the pass starts from, is updated in place (an occluded ray
    tests with tmax = tmin: it cannot hit). Returns (done [S], cursor
    entry, cursor id, rounds [S] int32, tests: with count_tests, each ray
    unoccluded when a round starts against the leaf's faces up to its
    first hit, all LEAF where none is hit; else 0)."""
    dev = r.device
    tmin, tmax = r[..., 6], r[..., 7]
    emin = _block_emin(live, er, ir, r, tab.aabb_lanes, tmin, tmax)
    ce, ci = er.clone(), ir.clone()
    rounds = torch.zeros(r.shape[0], dtype=torch.int32, device=dev)
    tests = 0
    for _ in range(t_rounds):
        m, lid = _argmin_lane(emin)
        todo = (m < _BIG) & (occ.amin(dim=1) < 1.0)
        sub = torch.nonzero(todo)[:, 0]
        if sub.numel() == 0:
            break
        lid_s = lid[sub]
        occ_s = occ[sub]
        _, _, _, hit = _mt_leaf(r[sub], tab.rows[lid_s], tmin[sub],
                                torch.where(occ_s > 0.0, tmin[sub],
                                            tmax[sub]))
        hit_any = hit.any(dim=2)
        occ[sub] = torch.maximum(occ_s, hit_any.to(torch.float32))
        emin[sub, lid_s] = _BIG
        ce[sub] = m[sub]
        ci[sub] = lid_s.to(ci.dtype)
        rounds[sub] += 1
        if count_tests:
            # argmax of a bool row: its first True
            upto = torch.where(hit_any, hit.to(torch.int32).argmax(dim=2)
                               + 1, tab.leaf)
            tests += int(torch.where(occ_s == 0.0, upto, 0).sum())
    open_ = (emin.amin(dim=1) < _BIG) & (occ.amin(dim=1) < 1.0)
    return torch.where(open_, 0.0, 1.0), ce, ci, rounds, tests


def _walk_blocks_ref(any_hit: bool, count, er, ir, rays, tab: WalkTable,
                     rt: int, t_rounds: int, max_passes: int, stats):
    """The plain version of K8: every block runs its own passes from its
    cursor until its own done flag, at most max_passes, its state (best
    t, prim, u, v; or occlusion) kept across them. Returns (out, cursor
    [B, 8], counts [B, 2] int32: the passes and rounds each block ran)."""
    dev = rays.device
    b = rays.shape[0] // rt
    r = rays.reshape(b, rt, 8)
    live = torch.arange(b, device=dev) * rt < count[0]
    done = torch.ones(b, device=dev)
    ce, ci = er.clone(), ir.clone()
    counts = torch.zeros((b, 2), dtype=torch.int32, device=dev)
    if any_hit:
        occ = torch.zeros((b, rt), device=dev)
    else:
        best = [r[..., 7].clone(), torch.full((b, rt), -1.0, device=dev),
                torch.zeros((b, rt), device=dev),
                torch.zeros((b, rt), device=dev)]
    tests = 0
    sub = torch.arange(b, device=dev)
    for _ in range(max_passes):
        if any_hit:
            occ_s = occ[sub]
            d, ce_s, ci_s, rounds, n = _any_pass(
                live[sub], ce[sub], ci[sub], r[sub], tab, t_rounds, occ_s,
                stats is not None)
            occ[sub] = occ_s
        else:
            state = [x[sub] for x in best]
            d, ce_s, ci_s, rounds = _closest_pass(
                live[sub], ce[sub], ci[sub], r[sub], tab, t_rounds, *state)
            n = int(rounds.sum()) * rt * tab.leaf if stats is not None else 0
            for x, y in zip(best, state):
                x[sub] = y
        done[sub] = d
        ce[sub] = ce_s
        ci[sub] = ci_s
        counts[sub, 0] += 1
        counts[sub, 1] += rounds
        tests += n
        sub = sub[d == 0.0]
        if sub.numel() == 0:
            break
    if stats is not None:
        stats.append(tests)
    if any_hit:
        out = torch.zeros((b * rt, 4), device=dev)
        out[:, 0] = occ.reshape(-1)
    else:
        out = torch.stack(best, dim=2).reshape(b * rt, 4)
    return out, _cursor(done, ce, ci), counts


def walk_closest_blocks_ref(count, er, ir, rays, tab: WalkTable,
                            rt: int = RT, t_rounds: int = T_ROUNDS,
                            max_passes: int = 1, stats=None):
    """Plain version of K8 closest, vectorised over blocks. count int32
    [1]; er [B] f32 and ir [B] int32, the cursor; rays [B * rt, 8]. Each
    block runs passes from its cursor (pallas_walk.py `_closest_kernel`,
    each ray's tmax its best t so far) until its own done flag, at most
    max_passes. Returns (out [B * rt, 4]: t (tmax where nothing was hit),
    prim (-1.0 where nothing was hit), u, v; cursor [B, 8]; counts [B, 2]
    int32: passes and rounds per block). stats: a list that receives the
    ray-triangle tests the walk needs (every ray of a block against all
    LEAF faces of each round it ran)."""
    return _walk_blocks_ref(False, count, er, ir, rays, tab, rt, t_rounds,
                            max_passes, stats)


def walk_any_blocks_ref(count, er, ir, rays, tab: WalkTable, rt: int = RT,
                        t_rounds: int = T_ROUNDS, max_passes: int = 1,
                        stats=None):
    """Plain version of K8 any (pallas_walk.py `_any_kernel`), arguments
    and counts as walk_closest_blocks_ref; occlusion persists across a
    block's passes. out [B * rt, 4]: occlusion 0.0 or 1.0 in column 0,
    zeros. stats receives the tests the walk needs: each ray unoccluded
    when a round starts against the leaf's faces up to its first hit (all
    LEAF where none is hit)."""
    return _walk_blocks_ref(True, count, er, ir, rays, tab, rt, t_rounds,
                            max_passes, stats)


def walk_closest_ref(count, er, ir, rays, tab: WalkTable, rt: int = RT,
                     t_rounds: int = T_ROUNDS, stats=None):
    """Plain version of one closest launch of the reference
    (pallas_walk.py `_closest_kernel`): one pass of every block from its
    cursor, rays' tmax each ray's best t so far. Returns (out, cursor) as
    walk_closest_blocks_ref."""
    return walk_closest_blocks_ref(count, er, ir, rays, tab, rt, t_rounds,
                                   1, stats)[:2]


def walk_any_ref(count, er, ir, rays, tab: WalkTable, rt: int = RT,
                 t_rounds: int = T_ROUNDS, stats=None):
    """Plain version of one any-hit launch of the reference
    (pallas_walk.py `_any_kernel`): one pass of every block, every ray
    unoccluded at its start. Returns (out, cursor) as walk_any_blocks_ref."""
    return walk_any_blocks_ref(count, er, ir, rays, tab, rt, t_rounds, 1,
                               stats)[:2]


# ------------------------------------------------------ the kernel wrappers
def _launch(any_hit: bool, count, er, ir, rays, tab: WalkTable,
            t_rounds: int, max_passes: int):
    kbuild.require_cuda("resident_walk", er, rays, tab.rows, tab.aabb_lanes)
    kbuild.require_cuda("resident_walk", count, ir, dtype=torch.int32)
    r = rays.shape[0]
    if rays.ndim != 2 or rays.shape[1] != 8 or r % RT:
        raise ValueError(f"resident_walk: rays must be [R, 8] with R a "
                         f"multiple of {RT}")
    if tab.leaf != LEAF:
        raise ValueError(f"resident_walk: the kernel takes {LEAF}-face "
                         "leaves")
    b = r // RT
    out = torch.empty((r, 4), dtype=torch.float32, device=rays.device)
    cur = torch.empty((b, 8), dtype=torch.float32, device=rays.device)
    counts = torch.empty((b, 2), dtype=torch.int32, device=rays.device)
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_resident_walk(
        index, int(any_hit), count.data_ptr(), er.data_ptr(), ir.data_ptr(),
        rays.data_ptr(), b, tab.rows.data_ptr(), tab.rows.shape[0],
        tab.aabb_lanes.data_ptr(), tab.aabb_lanes.shape[1], t_rounds,
        max_passes, out.data_ptr(), cur.data_ptr(), counts.data_ptr(),
        stream)
    kbuild.check(err, "walk_any" if any_hit else "walk_closest")
    return out, cur, counts


def walk_closest(count, er, ir, rays, tab: WalkTable, rt: int = RT,
                 t_rounds: int = T_ROUNDS, max_passes: int = 1):
    """K8 closest: the CUDA kernel for CUDA rays (rt must be 32),
    `walk_closest_blocks_ref` on the CPU. max_passes = 1 is one pass of
    every block (the reference's launch); a walk passes its cap. Returns
    (out, cursor, counts)."""
    if rays.device.type == "cpu":
        return walk_closest_blocks_ref(count, er, ir, rays, tab, rt,
                                       t_rounds, max_passes)
    if rt != RT:
        raise ValueError(f"walk_closest: the kernel's block is {RT} rays")
    res = _launch(False, count, er, ir, rays, tab, t_rounds, max_passes)
    walk_closest.launches += 1
    return res


def walk_any(count, er, ir, rays, tab: WalkTable, rt: int = RT,
             t_rounds: int = T_ROUNDS, max_passes: int = 1):
    """K8 any: the CUDA kernel for CUDA rays (rt must be 32),
    `walk_any_blocks_ref` on the CPU; as walk_closest."""
    if rays.device.type == "cpu":
        return walk_any_blocks_ref(count, er, ir, rays, tab, rt, t_rounds,
                                   max_passes)
    if rt != RT:
        raise ValueError(f"walk_any: the kernel's block is {RT} rays")
    res = _launch(True, count, er, ir, rays, tab, t_rounds, max_passes)
    walk_any.launches += 1
    return res


walk_closest.launches = 0
walk_any.launches = 0


# ------------------------------------------------------ the pass loops
def _pack(o, d, tmin, tmax, rt: int):
    """([R_pad, 8] rays, R): zero rows pad R to a multiple of rt (d = 0:
    every slab test and every triangle test misses)."""
    r = o.shape[0]
    r_pad = -(-r // rt) * rt
    f32 = dict(dtype=torch.float32, device=o.device)
    rays = torch.zeros((r_pad, 8), **f32)
    rays[:r, 0:3] = o
    rays[:r, 3:6] = d
    rays[:r, 6] = torch.as_tensor(tmin, **f32).expand(r)
    rays[:r, 7] = torch.as_tensor(tmax, **f32).expand(r)
    return rays, r


def _count(count, r: int, device) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([r if count is None else int(count)],
                        dtype=torch.int32, device=device)


def _start(rays, rt: int):
    b = rays.shape[0] // rt
    return (torch.full((b,), -_BIG, device=rays.device),
            torch.full((b,), -1, dtype=torch.int32, device=rays.device))


def pass_cap(tab: WalkTable, t_rounds: int) -> int:
    """The passes a walk may take: the first and ceil(n_leaves / T) more
    (the reference's pass cap, pallas_walk.py:385)."""
    return -(-tab.n_leaves // t_rounds) + 2


def _reference_passes(launch, tab: WalkTable, t_rounds: int, first,
                      combine):
    """The reference's pass loop (the plain=True walk): `first` is the
    first pass's (state, cursor); each further pass launches every block
    from its cursor while any block is not done, up to the pass cap, and
    combine(state, out) folds its output in. Reads the done flags once per
    pass (one host synchronisation). Returns the state."""
    state, cur = first
    for _ in range(pass_cap(tab, t_rounds) - 1):
        if not bool((cur[:, 0] == 0.0).any()):
            break
        out, cur = launch(state, cur[:, 1].contiguous(),
                          cur[:, 2].to(torch.int32))
        state = combine(state, out)
    return state


def _no_passes(plain: bool, passes) -> None:
    if plain and passes is not None:
        raise ValueError("passes: the plain pass loop records no counts")


def trace_closest_walk(tab: WalkTable, o, d, tmin, tmax, *, count=None,
                       rt: int = RT, t_rounds: int = T_ROUNDS,
                       plain: bool = False, passes=None) -> Hit:
    """Closest hit by the resident-table walk; only the first `count`
    rays are live (an int or an int tensor, read on the device). The walk
    is one walk_closest of every block's own passes (K8 on a CUDA device,
    no host read). plain: the reference's pass loop over
    walk_closest_ref, on any device. passes: a list that receives the
    walk's per-block counts [B, 2] int32 (passes, rounds), on its device."""
    _no_passes(plain, passes)
    rays, r = _pack(o, d, tmin, tmax, rt)
    c = _count(count, r, o.device)
    er, ir = _start(rays, rt)
    if plain:
        def launch(best, er, ir):
            rays_p = torch.cat([rays[:, 0:7], best[:, 0:1]], dim=1)
            return walk_closest_ref(c, er, ir, rays_p, tab, rt, t_rounds)

        def combine(best, out):
            return torch.where((out[:, 1] >= 0.0)[:, None], out, best)

        best0 = torch.zeros((rays.shape[0], 4), dtype=torch.float32,
                            device=o.device)
        best0[:, 0] = rays[:, 7]
        best0[:, 1] = -1.0
        out, cur = launch(best0, er, ir)
        best = _reference_passes(launch, tab, t_rounds,
                                 (combine(best0, out), cur), combine)
    else:
        best, _, counts = walk_closest(c, er, ir, rays, tab, rt, t_rounds,
                                       pass_cap(tab, t_rounds))
        if passes is not None:
            passes.append(counts)
    best = best[:r]
    t, prim_f = best[:, 0], best[:, 1]
    # the strict per-ray gate (the walk gates whole blocks)
    live = torch.arange(r, device=o.device) < c[0]
    valid = (prim_f >= 0.0) & (prim_f < tab.num_faces) & (t < _BIG) & live
    zero = torch.zeros_like(t)
    return Hit(t=torch.where(valid, t, rays[:r, 7]),
               prim=torch.where(valid, prim_f.to(torch.int32),
                                torch.full_like(prim_f, -1).to(torch.int32)),
               u=torch.where(valid, best[:, 2], zero),
               v=torch.where(valid, best[:, 3], zero))


def trace_any_walk(tab: WalkTable, o, d, tmin, tmax, *, count=None,
                   rt: int = RT, t_rounds: int = T_ROUNDS,
                   plain: bool = False, passes=None) -> torch.Tensor:
    """Occlusion [R] bool by the resident-table walk; arguments as
    trace_closest_walk. The walk keeps a ray's occlusion across its
    block's passes; the reference's pass loop (plain) starts every pass
    with each ray unoccluded and combines the passes by the maximum."""
    _no_passes(plain, passes)
    rays, r = _pack(o, d, tmin, tmax, rt)
    c = _count(count, r, o.device)
    er, ir = _start(rays, rt)
    if plain:
        def launch(_occ, er, ir):
            return walk_any_ref(c, er, ir, rays, tab, rt, t_rounds)

        def combine(occ, out):
            return torch.maximum(occ, out[:, 0])

        out, cur = launch(None, er, ir)
        occ = _reference_passes(launch, tab, t_rounds, (out[:, 0], cur),
                                combine)
    else:
        out, _, counts = walk_any(c, er, ir, rays, tab, rt, t_rounds,
                                  pass_cap(tab, t_rounds))
        occ = out[:, 0]
        if passes is not None:
            passes.append(counts)
    live = torch.arange(r, device=o.device) < c[0]
    return (occ[:r] > 0.0) & live


def make_walk_tracer(scene, device, rt: int = RT, leaf: int = LEAF,
                     t_rounds: int = T_ROUNDS, plain: bool = False,
                     passes=None):
    """(closest, any_hit) over the resident-table walk of a static scene,
    each f(o, d, tmin, tmax, time, count=None) (time is ignored). Order
    the scene with accel.lbvh.split_order_scene first so that leaves are
    tight; rays sorted by the pool's sort_rays share leaves within a
    block. The walk is K8 on a CUDA device, its plain version on the CPU,
    the reference's pass loop with `plain`. passes: None, or a pair of
    lists that receive the per-block counts [B, 2] (passes, rounds) of
    each closest and each any-hit walk. A motion scene raises
    ValueError."""
    if scene.num_keys != 1:
        raise ValueError("walk tracer supports static scenes only")
    tab = build_walk_table(scene.geom, scene.num_faces, leaf=leaf,
                           device=device)
    sink = passes or (None, None)

    def closest(o, d, tmin, tmax, time=None, count=None):
        return trace_closest_walk(tab, o, d, tmin, tmax, count=count, rt=rt,
                                  t_rounds=t_rounds, plain=plain,
                                  passes=sink[0])

    def any_hit(o, d, tmin, tmax, time=None, count=None):
        return trace_any_walk(tab, o, d, tmin, tmax, count=count, rt=rt,
                              t_rounds=t_rounds, plain=plain,
                              passes=sink[1])

    closest.table = tab
    return closest, any_hit
