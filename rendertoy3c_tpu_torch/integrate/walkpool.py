"""The pipelined walk pool: the integrator of the hierwalk band (scenes of
more than 16384 faces), whose pool step is one traversal round.

Port of rendertoy3c_tpu/integrate/walkpool.py: `WalkPoolPipeline` (:116),
`make_walkpool_pipeline` (:151) and `make_inst_walkpool_pipeline` (:182)
with both shade stages, `_walk_round` (:363), `_walk_round_inst` (:456)
and `_render_pipepool` (:982) for P >= 2 paths per lane. Every pool
lane owns one walk scratch (the resumable ordered-DFS state of
trace/hierwalk.py) that P paths share: a round launches a pending walk of
one of the lane's paths into a free scratch, advances it by one round
(a 128-f32 row fetch, then the leaf's Moller-Trumbore tests or the
directory's slab tests, then the ordered pop), stashes a finished closest
walk into its path's columns and gates a finished shadow walk inline (the
pending NEE term added unless occluded, the bounce pended). Every K
rounds a phase boundary shades the stashed closest hits (K6 on C-major
misc, trace/shade.py `external_shade(transposed=True)`, or for the
scenes K6 does not shade the general stage `general_shade`, the port of
`_make_xla_shade_stage` (:255), in torch ops), pends the shadow walks,
retires and refills paths; every `flush_every` boundaries the retire
stash flushes into the image.

K9 (kernels/csrc/walk.cu) runs the K rounds between two boundaries in one
launch, a group of threads per lane; `_pipe_rounds_ref` is its plain version
(`_launch_ref`, `_walk_round`, `_stash_and_gate_ref`). Per-pixel results
do not depend on the schedule: every draw is keyed by pixel and sample
and one lane runs all samples of its pixel, so P, K and the cadence
change only when work happens.

The lane state is structure-of-arrays (`WalkState`): the scratch ray
[W, 8] row-major (32 contiguous bytes per lane), the per-lane scalars [W],
the pending-children entries [n_levels, fanout, W] and bases
[n_levels, W]; per path, misc C-major [P, MW, W] (K6's transposed input),
the rays [P, W, 8] and the scalars [P, W]. A bare walk (no paths) over
the stacked segment tables of an N-key scene (trace/hierwalk.py
`build_hier_table_nkey`) adds each lane's segment row offset `wseg` [W]
to its row gathers; the pool itself, as the reference's, takes at most 2
keys.

Left out, raising NotImplementedError with its ROADMAP item: the classic
P = 1 pool `_render_walkpool` (:578, A18; integrate/path.py). The
reference's TPU-only mechanisms have no counterpart: the round unroll,
the held-walk (non-inline) gate, the walk chunking and the RT3C_*
switches.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..kernels import build as kbuild
from ..math import rng
from ..math.vec import luminance
from ..scene.camera import camera_ray_dir
from ..trace.hier_instanced import _L_FIRST as _LI_FIRST
from ..trace.hier_instanced import _L_TYPE as _LI_TYPE
from ..trace.hier_instanced import (InstHierTable, _inst_space,
                                    baked_world_eligible,
                                    build_baked_world_table,
                                    build_inst_hier_table)
from ..trace.hierwalk import (_BIG, _L_FIRST, _L_TYPE, HierTable, _dir_entries,
                              _leaf_mt, _prune_cut, _safe_inv,
                              build_hier_table)
from ..trace.intersect import Hit
from ..trace.shade import (ACC_COLS, AOV_COLS, ExternalTables, ShadeConfig,
                           _first_failed, external_shade, inst_transform_rows,
                           misc_width, route_checks, shade_tables_for,
                           shading_checks)

# past this many (effective) faces the per-ray walk takes over from the MT
# band, and a static instance field takes the baked world table
LEAFWALK_MIN_FACES = 16384
# directory fanout of the walk pool's tables: 0 = auto (16 with fixed
# blocks or 20 with DP groups, hierwalk.build_hier_table)
POOL_DIR_FANOUT = 0
MAX_LEVELS = 8  # K9's directory levels (kernels/csrc/walk.cu)


@dataclass
class WalkState:
    """The walk pool's lane state on one device (see the module note).
    P = 0 paths is a bare walk (trace_closest_hier, trace_any_hier)."""

    ray: torch.Tensor  # [W, 8] f32 scratch ray: org dir tmin tmax
    wtime: torch.Tensor  # [W] f32 its time (2-key scenes)
    cur: torch.Tensor  # [W] i32 current row, -1 = no walk
    wslot: torch.Tensor  # [W] i32 owning path, -1 = none
    wmode: torch.Tensor  # [W] bool shadow (any-hit) walk
    wfound: torch.Tensor  # [W] bool occluder found
    wb_t: torch.Tensor  # [W] f32 best t (starts at tmax)
    wb_prim: torch.Tensor  # [W] i32 best prim, -1 = none
    wb_u: torch.Tensor  # [W] f32
    wb_v: torch.Tensor  # [W] f32
    ents: torch.Tensor  # [L, F, W] f32 pending child entries, _BIG = none
    bases: torch.Tensor  # [L, W] i32 first child row per level
    mc: torch.Tensor  # [P, MW, W] f32 path misc, C-major
    nrays: torch.Tensor  # [P, W, 8] f32 bounce ray from the last shade
    nee: torch.Tensor  # [P, 3, W] f32 pending NEE term
    pray: torch.Tensor  # [P, W, 8] f32 pending walk's ray
    ptime: torch.Tensor  # [P, W] f32 its time
    pmode: torch.Tensor  # [P, W] bool it is a shadow walk
    pvalid: torch.Tensor  # [P, W] bool a walk is pending
    btime: torch.Tensor  # [P, W] f32 bounce time, drawn at shade
    hray: torch.Tensor  # [P, W, 8] f32 finished closest walk: its ray
    ht: torch.Tensor  # [P, W] f32 and its hit
    hprim: torch.Tensor  # [P, W] i32
    hu: torch.Tensor  # [P, W] f32
    hv: torch.Tensor  # [P, W] f32
    hfound: torch.Tensor  # [P, W] bool
    hmode: torch.Tensor  # [P, W] bool
    hvalid: torch.Tensor  # [P, W] bool a finished walk awaits the boundary
    rows: torch.Tensor  # [1] int64 rows gathered (walking lane-rounds)
    # the instanced walk (K9-inst): the ray in the space it walks in, the
    # instance of that space (-1 = world), the best hit's instance, and
    # each path's finished closest walk's instance
    o_cur: torch.Tensor  # [W, 3] f32
    d_cur: torch.Tensor  # [W, 3] f32
    inst_cur: torch.Tensor  # [W] i32
    wb_inst: torch.Tensor  # [W] i32
    hinst: torch.Tensor  # [P, W] i32
    # a bare walk over a stacked N-key table (trace/hierwalk.py
    # build_hier_table_nkey): the row offset of each lane's segment, added
    # to every row gather and to nothing else
    wseg: torch.Tensor  # [W] i32

    @property
    def paths(self) -> int:
        return self.mc.shape[0]

    def clone(self) -> "WalkState":
        return WalkState(**{f.name: getattr(self, f.name).clone()
                            for f in fields(self)})

    def tensors(self):
        return [(f.name, getattr(self, f.name)) for f in fields(self)]


def new_walk_state(w: int, n_levels: int, fanout: int, paths: int,
                   misc_w: int, device, tmax: float = 1e16) -> WalkState:
    """An idle pool of w lanes (misc column 13, the pixel, at -1)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    mc = torch.zeros((paths, misc_w, w), **f32)
    if misc_w > 13:
        mc[:, 13] = -1.0
    return WalkState(
        ray=torch.zeros((w, 8), **f32), wtime=torch.zeros(w, **f32),
        cur=torch.full((w,), -1, **i32), wslot=torch.full((w,), -1, **i32),
        wmode=torch.zeros(w, **b), wfound=torch.zeros(w, **b),
        wb_t=torch.full((w,), tmax, **f32),
        wb_prim=torch.full((w,), -1, **i32),
        wb_u=torch.zeros(w, **f32), wb_v=torch.zeros(w, **f32),
        ents=torch.full((n_levels, fanout, w), _BIG, **f32),
        bases=torch.zeros((n_levels, w), **i32),
        mc=mc, nrays=torch.zeros((paths, w, 8), **f32),
        nee=torch.zeros((paths, 3, w), **f32),
        pray=torch.zeros((paths, w, 8), **f32),
        ptime=torch.zeros((paths, w), **f32),
        pmode=torch.zeros((paths, w), **b),
        pvalid=torch.zeros((paths, w), **b),
        btime=torch.zeros((paths, w), **f32),
        hray=torch.zeros((paths, w, 8), **f32),
        ht=torch.full((paths, w), tmax, **f32),
        hprim=torch.full((paths, w), -1, **i32),
        hu=torch.zeros((paths, w), **f32), hv=torch.zeros((paths, w), **f32),
        hfound=torch.zeros((paths, w), **b),
        hmode=torch.zeros((paths, w), **b),
        hvalid=torch.zeros((paths, w), **b),
        rows=torch.zeros(1, dtype=torch.int64, device=device),
        o_cur=torch.zeros((w, 3), **f32), d_cur=torch.zeros((w, 3), **f32),
        inst_cur=torch.full((w,), -1, **i32),
        wb_inst=torch.full((w,), -1, **i32),
        hinst=torch.full((paths, w), -1, **i32),
        wseg=torch.zeros(w, **i32))


# ------------------------------------------------ K9's plain version
def _launch_ref(s: WalkState, inst: bool = False) -> None:
    """Fill free scratches from the first pending path (walkpool.py
    :1170-1212): the walk restarts at the root with its ray's tmax as the
    best t; its entries need no reset (see _walk_round's pop). An
    instanced walk (`inst`) starts in world space with no instance."""
    free = s.cur < 0
    taken = torch.zeros_like(free)
    for p in range(s.paths):
        lp = free & s.pvalid[p] & ~taken
        taken |= lp
        s.ray.copy_(torch.where(lp[:, None], s.pray[p], s.ray))
        s.wtime.copy_(torch.where(lp, s.ptime[p], s.wtime))
        s.wmode.copy_(torch.where(lp, s.pmode[p], s.wmode))
        s.wslot.copy_(torch.where(lp, p, s.wslot))
        s.pvalid[p] &= ~lp
    s.wfound &= ~taken
    s.wb_t.copy_(torch.where(taken, s.ray[:, 7], s.wb_t))
    s.wb_prim.copy_(torch.where(taken, -1, s.wb_prim))
    s.cur.copy_(torch.where(taken, 0, s.cur))
    if inst:
        s.o_cur.copy_(torch.where(taken[:, None], s.ray[:, 0:3], s.o_cur))
        s.d_cur.copy_(torch.where(taken[:, None], s.ray[:, 3:6], s.d_cur))
        s.inst_cur.copy_(torch.where(taken, -1, s.inst_cur))
        s.wb_inst.copy_(torch.where(taken, -1, s.wb_inst))


def _walk_round(tab: HierTable, s: WalkState, motion: bool) -> None:
    """Advance every walking lane by one round (walkpool.py :363-453), in
    place. Closest lanes (wmode False) keep the best (t, prim, u, v) and
    prune by it; shadow lanes set wfound on any hit in range and stop.
    Lanes with cur < 0 only have their entries pruned, which leaves a
    finished walk's entries all _BIG. On a stacked N-key table every row
    gather adds the lane's segment offset wseg (hierwalk.py:563-564 of the
    reference); the levels are told by the segment-local row."""
    fanout = tab.fanout
    cur = s.cur
    o, d = s.ray[:, 0:3], s.ray[:, 3:6]
    tmin_c = s.ray[:, 6:7]
    walking = cur >= 0
    s.rows += walking.sum()
    inv = _safe_inv(d)
    lane = torch.arange(fanout, device=cur.device)[:, None]

    idx = torch.clamp(cur, min=0)
    if tab.n_seg > 1:
        idx = idx + s.wseg
    rows = tab.table[idx.to(torch.int64)]
    is_leaf = rows[:, _L_TYPE] > 0.5
    first = rows[:, _L_FIRST].to(torch.int32)

    # leaf: Moller-Trumbore over the inline triangles
    zero = torch.zeros_like(s.wb_t)
    tcur = torch.where(s.wfound, zero, s.wb_t)
    t, u, v, hit = _leaf_mt(rows, o, d, tmin_c, tcur[:, None],
                            time=s.wtime if motion else None)
    hit = hit & (is_leaf & walking)[:, None]
    wmode = s.wmode
    wfound = s.wfound | (wmode & hit.any(dim=1))
    cap = hit.shape[1]
    tt = torch.where(hit, t, torch.full_like(t, _BIG))
    t_leaf = tt.min(dim=1).values
    at_min = tt <= t_leaf[:, None]
    caps = torch.arange(cap, device=cur.device)
    lane_sel = torch.where(at_min, caps, cap).min(dim=1).values
    one = at_min & (caps == lane_sel[:, None])
    better = ~wmode & (t_leaf < s.wb_t)
    wb_t = torch.where(better, t_leaf, s.wb_t)
    s.wb_prim.copy_(torch.where(better, first + lane_sel.to(torch.int32),
                                s.wb_prim))
    s.wb_u.copy_(torch.where(better, torch.where(one, u, 0.0).sum(dim=1),
                             s.wb_u))
    s.wb_v.copy_(torch.where(better, torch.where(one, v, 0.0).sum(dim=1),
                             s.wb_v))
    s.wb_t.copy_(wb_t)
    s.wfound.copy_(wfound)

    # directory: slab-test the children against the pruning cut
    cut = _prune_cut(torch.where(wfound, zero, wb_t))
    ent = _dir_entries(rows, o, inv, tmin_c, cut[:, None], fanout).T
    is_dir = walking & ~is_leaf
    for lv, (lo_b, hi_b) in enumerate(tab.level_bounds()):
        at_lv = is_dir & (cur >= lo_b) & (cur < hi_b)
        s.ents[lv] = torch.where(at_lv[None], ent, s.ents[lv])
        s.bases[lv] = torch.where(at_lv, first, s.bases[lv])

    # ordered pop: the nearest pending child at the deepest level, the
    # lowest lane at a tie; the pruning and the popped slot are written
    # back as _BIG (best t only falls, so a pruned entry never revives)
    nxt = torch.full_like(cur, -1)
    for lv in reversed(range(tab.n_levels)):
        e = s.ents[lv]
        ee = torch.where(e < cut[None], e, torch.full_like(e, _BIG))
        e_min = ee.min(dim=0).values
        has = (e_min < _BIG) & walking & (nxt < 0) & ~wfound
        j = torch.where(ee <= e_min[None], lane, fanout).min(dim=0).values
        nxt = torch.where(has, s.bases[lv] + j.to(torch.int32), nxt)
        taken = has[None] & (lane == j[None])
        s.ents[lv] = torch.where(taken, torch.full_like(ee, _BIG), ee)
    s.cur.copy_(torch.where(walking, nxt, cur))


def _walk_round_inst(tab: InstHierTable, s: WalkState, motion: bool) -> None:
    """Advance every walking lane of an instanced table by one round
    (walkpool.py :456-576), in place: the leaf test and the slab tests run
    in the lane's current space (o_cur, d_cur; t stays in world units); an
    instance row moves the lane into its instance's object space (a 2-key
    row inverts its forward keys lerped to the walk's time) and jumps to
    the mesh's root without a pop; a pop from a world level restores the
    world ray and instance -1. The best hit keeps the instance it came
    with (wb_inst).

    The pop writes the pruned entries back as _BIG, as `_walk_round` does;
    the reference's instanced round writes back only the popped slot, so
    its finished walks leave pruned entries that the next walk in the
    scratch pops (ROADMAP C9)."""
    fanout = tab.fanout
    cur = s.cur
    o_w, d_w = s.ray[:, 0:3], s.ray[:, 3:6]
    o_cur, d_cur = s.o_cur, s.d_cur
    tmin_c = s.ray[:, 6:7]
    walking = cur >= 0
    s.rows += walking.sum()
    lane = torch.arange(fanout, device=cur.device)[:, None]

    rows = tab.table[torch.clamp(cur, min=0).to(torch.int64)]
    typ = rows[:, _LI_TYPE]
    is_inst = typ > 1.5
    is_leaf = (typ > 0.5) & ~is_inst
    first = rows[:, _LI_FIRST].to(torch.int32)

    # leaf: Moller-Trumbore in the current space
    zero = torch.zeros_like(s.wb_t)
    tcur = torch.where(s.wfound, zero, s.wb_t)
    t, u, v, hit = _leaf_mt(rows, o_cur, d_cur, tmin_c, tcur[:, None])
    hit = hit & (is_leaf & walking)[:, None]
    wmode = s.wmode
    wfound = s.wfound | (wmode & hit.any(dim=1))
    cap = hit.shape[1]
    tt = torch.where(hit, t, torch.full_like(t, _BIG))
    t_leaf = tt.min(dim=1).values
    at_min = tt <= t_leaf[:, None]
    caps = torch.arange(cap, device=cur.device)
    lane_sel = torch.where(at_min, caps, cap).min(dim=1).values
    one = at_min & (caps == lane_sel[:, None])
    better = ~wmode & (t_leaf < s.wb_t)
    wb_t = torch.where(better, t_leaf, s.wb_t)
    s.wb_prim.copy_(torch.where(better, first + lane_sel.to(torch.int32),
                                s.wb_prim))
    s.wb_inst.copy_(torch.where(better, s.inst_cur, s.wb_inst))
    s.wb_u.copy_(torch.where(better, torch.where(one, u, 0.0).sum(dim=1),
                             s.wb_u))
    s.wb_v.copy_(torch.where(better, torch.where(one, v, 0.0).sum(dim=1),
                             s.wb_v))
    s.wb_t.copy_(wb_t)
    s.wfound.copy_(wfound)

    # instance row: switch into object space
    o_t, d_t, iid = _inst_space(rows, o_w, d_w, s.wtime, motion)
    sel_i = walking & is_inst
    o_cur = torch.where(sel_i[:, None], o_t, o_cur)
    d_cur = torch.where(sel_i[:, None], d_t, d_cur)
    inst_cur = torch.where(sel_i, iid.to(torch.int32), s.inst_cur)

    # directory: slab-test the children in the current space
    cut = _prune_cut(torch.where(wfound, zero, wb_t))
    ent = _dir_entries(rows, o_cur, _safe_inv(d_cur), tmin_c, cut[:, None],
                       fanout).T
    is_dir = walking & ~is_leaf & ~is_inst
    for lv, (lo_b, hi_b) in enumerate(tab.level_bounds()):
        at_lv = is_dir & (cur >= lo_b) & (cur < hi_b)
        s.ents[lv] = torch.where(at_lv[None], ent, s.ents[lv])
        s.bases[lv] = torch.where(at_lv, first, s.bases[lv])

    # ordered pop (instance rows do not pop), then an instance row's jump
    nxt = torch.full_like(cur, -1)
    pop_lv = torch.full_like(cur, -1)
    for lv in reversed(range(tab.n_levels)):
        e = s.ents[lv]
        ee = torch.where(e < cut[None], e, torch.full_like(e, _BIG))
        e_min = ee.min(dim=0).values
        has = ((e_min < _BIG) & walking & ~is_inst & (nxt < 0) & ~wfound)
        j = torch.where(ee <= e_min[None], lane, fanout).min(dim=0).values
        nxt = torch.where(has, s.bases[lv] + j.to(torch.int32), nxt)
        pop_lv = torch.where(has, lv, pop_lv)
        taken = has[None] & (lane == j[None])
        s.ents[lv] = torch.where(taken, torch.full_like(ee, _BIG), ee)
    nxt = torch.where(walking & is_inst & ~wfound, first, nxt)

    # a pop at a world level leaves the instance: restore the world ray
    back = (pop_lv >= 0) & (pop_lv < tab.n_world)
    s.o_cur.copy_(torch.where(back[:, None], o_w, o_cur))
    s.d_cur.copy_(torch.where(back[:, None], d_w, d_cur))
    s.inst_cur.copy_(torch.where(back, -1, inst_cur))
    s.cur.copy_(torch.where(walking, nxt, cur))


def _stash_and_gate_ref(s: WalkState) -> None:
    """A finished closest walk parks in its path's columns for the
    boundary's shade; a finished shadow walk gates inline: the path's
    pending NEE term is added unless occluded, and a live path pends its
    bounce ray at the bounce time drawn at shade (walkpool.py
    :1243-1306)."""
    fin = (s.cur < 0) & (s.wslot >= 0)
    fin_sh = fin & s.wmode
    fin_cl = fin & ~fin_sh
    for p in range(s.paths):
        f = fin_cl & (s.wslot == p)
        s.hray[p] = torch.where(f[:, None], s.ray, s.hray[p])
        s.ht[p] = torch.where(f, s.wb_t, s.ht[p])
        s.hprim[p] = torch.where(f, s.wb_prim, s.hprim[p])
        s.hu[p] = torch.where(f, s.wb_u, s.hu[p])
        s.hv[p] = torch.where(f, s.wb_v, s.hv[p])
        s.hfound[p] = torch.where(f, s.wfound, s.hfound[p])
        s.hmode[p] = torch.where(f, s.wmode, s.hmode[p])
        s.hvalid[p] |= f
        s.hinst[p] = torch.where(f, s.wb_inst, s.hinst[p])
        fs = fin_sh & (s.wslot == p)
        gate = fs & ~s.wfound
        s.mc[p, 10:13] += torch.where(gate[None], s.nee[p], 0.0)
        cont = fs & (s.mc[p, 9] > 0)
        s.pray[p] = torch.where(cont[:, None], s.nrays[p], s.pray[p])
        s.ptime[p] = torch.where(cont, s.btime[p], s.ptime[p])
        s.pmode[p] &= ~cont
        s.pvalid[p] |= cont
    s.wslot.copy_(torch.where(fin, -1, s.wslot))


def _pipe_rounds_ref(s: WalkState, tab, motion: bool, rounds: int) -> None:
    """Plain version of K9 (a HierTable) and K9-inst (an InstHierTable):
    `rounds` pool rounds in place."""
    inst = isinstance(tab, InstHierTable)
    for _ in range(rounds):
        _launch_ref(s, inst)
        if inst:
            _walk_round_inst(tab, s, motion)
        else:
            _walk_round(tab, s, motion)
        _stash_and_gate_ref(s)


def walk_rounds(s: WalkState, tab, motion: bool, rounds: int,
                plain: bool = False) -> None:
    """K9 / K9-inst wrapper: `rounds` pool rounds (launch, walk round,
    stash, inline gate) over every lane, in place on `s`, over a HierTable
    (K9) or an InstHierTable (K9-inst, `motion`: 2-key instance rows). The
    CUDA kernel (kernels/csrc/walk.cu) for CUDA tensors,
    `_pipe_rounds_ref` on the CPU or with `plain`. A stacked N-key table
    (n_seg > 1) takes bare walks only (no paths: the walk pool, as the
    reference's, takes at most 2 keys), each lane's gathers offset by its
    wseg; K9 gets a null offset pointer for any other table."""
    seg = getattr(tab, "n_seg", 1) > 1
    if seg and s.paths:
        raise ValueError("walk_rounds: a stacked N-key table walks bare "
                         "walks only; the walk pool takes at most 2 keys")
    if plain or s.cur.device.type == "cpu":
        _pipe_rounds_ref(s, tab, motion, rounds)
        return
    w = s.cur.shape[0]
    n_levels, fanout = tab.n_levels, tab.fanout
    inst = isinstance(tab, InstHierTable)
    if n_levels > MAX_LEVELS:
        raise NotImplementedError(f"walk_rounds: {n_levels} directory "
                                  f"levels, K9 takes at most {MAX_LEVELS}")
    if s.ents.shape != (n_levels, fanout, w):
        raise ValueError("walk_rounds: the state's entries do not match the "
                         "table's levels and fanout")
    kbuild.require_cuda("walk_rounds", tab.table, s.ray, s.wtime, s.wb_t,
                        s.wb_u, s.wb_v, s.ents, s.mc, s.nrays, s.nee, s.pray,
                        s.ptime, s.btime, s.hray, s.ht, s.hu, s.hv, s.o_cur,
                        s.d_cur)
    kbuild.require_cuda("walk_rounds", s.cur, s.wslot, s.wb_prim, s.bases,
                        s.hprim, s.inst_cur, s.wb_inst, s.hinst, s.wseg,
                        dtype=torch.int32)
    kbuild.require_cuda("walk_rounds", s.wmode, s.wfound, s.pmode, s.pvalid,
                        s.hfound, s.hmode, s.hvalid, dtype=torch.bool)
    kbuild.require_cuda("walk_rounds", s.rows, dtype=torch.int64)
    lo = [0] * MAX_LEVELS
    hi = [0] * MAX_LEVELS
    for lv, (a, b) in enumerate(tab.level_bounds()):
        lo[lv], hi[lv] = a, b
    ptrs = {name: t.data_ptr() for name, t in s.tensors()}
    ptrs["wseg"] = ptrs["wseg"] if seg else None
    p = kbuild.WalkParams(
        w=w, n_levels=n_levels, fanout=fanout, paths=s.paths,
        misc_w=s.mc.shape[1], rounds=rounds, motion=int(motion),
        n_world=tab.n_world if inst else 0,
        level_lo=tuple(lo), level_hi=tuple(hi), **ptrs)
    index, stream = kbuild.launch_target(s.cur.device)
    err = kbuild.library().rt3c_walk_rounds(index, p, tab.table.data_ptr(),
                                            stream)
    kbuild.check(err, "walk_rounds")
    if inst:
        walk_rounds.inst_launches += 1
    elif seg:
        walk_rounds.seg_launches += 1
    else:
        walk_rounds.launches += 1


walk_rounds.launches = 0  # K9
walk_rounds.inst_launches = 0  # K9-inst
walk_rounds.seg_launches = 0  # K9 with segment offsets (N-key tables)


# ---------------------------------------------------------- the pipeline
@dataclass(frozen=True)
class GeneralStageConfig:
    """The general shade stage's parameters: the render config and
    whether the scene has 2 keys (the shadow ray then carries its time)."""

    cfg: object  # the RenderConfig
    motion: bool


def general_shade(rays, hit4, misc_t, tables, config: GeneralStageConfig,
                  transposed: bool = True, inst=None):
    """The walk pool's general shade stage (walkpool.py :255-360,
    `_make_xla_shade_stage`), for the scenes K6 does not shade
    (trace/shade.py shading_checks: environment maps, emissive and
    roughness textures, normal maps without images, the physical
    throughput model, scenes without lights), in torch ops on the lanes'
    device: no kernel of the reference shades them. It has K6's interface
    on C-major misc: rays [W, 8], hit4 [W, 4] (t, prim, u, v), misc_t
    [MW, W] and, for an instanced scene, inst [W]; it returns (rays
    [W, 8], misc [MW + 8, W], shadow [W, 8 | 16]) column for column as K6
    writes them. `tables` are integrate/path.py's GeneralTables.

    integrate/path.py `_shade_and_nee` shades every lane with a stub
    occlusion tracer that captures the shadow ray; the Russian roulette
    draw follows at the same stream position (its value never depended
    on the occlusion), and the pending NEE term leaves through misc
    columns MW to MW + 2 with 5 zero columns after it. A lane that wants
    no shadow ray gets a shadow tmax of 0."""
    # deferred: integrate/path.py imports this module
    from .path import _miss_radiance, _shade_and_nee

    if not transposed:
        raise ValueError("general_shade takes the walk pool's C-major misc")
    cfg = config.cfg
    misc = misc_t.transpose(0, 1)
    r = rays.shape[0]
    dev = rays.device
    f32 = dict(dtype=torch.float32, device=dev)
    org, d = rays[:, 0:3], rays[:, 3:6]
    seed = rng.bits_to_state(misc[:, 0])
    alive = misc[:, 9] > 0
    depth = misc[:, 8]
    prev_delta = misc[:, 7] > 0
    atten = misc[:, 1:4]
    last_atten = misc[:, 4:7]
    hit = Hit(t=hit4[:, 0], prim=hit4[:, 1].to(torch.int32), u=hit4[:, 2],
              v=hit4[:, 3],
              inst=None if inst is None else inst.to(torch.int32))
    cap = {}

    def stub_any(p, ldir, tmin_s, tmax_s, time_s, count=None):
        cap.update(p=p, ldir=ldir, tmax=tmax_s, time=time_s)
        return torch.zeros(r, dtype=torch.bool, device=dev)

    (seed, emitted, radiance, norg, ndir, atten_factor, want_shadow,
     is_delta, sh_albedo, sh_normal) = _shade_and_nee(
        tables, cfg, stub_any, hit, org, d, seed, alive)
    is_hit = hit.prim >= 0
    adv = alive & is_hit

    # the pending NEE term rides extra columns; the acc takes the emission
    # and the miss background now (K6's external branch)
    nee = radiance * last_atten
    bg = torch.tensor(cfg.bg_radiance, **f32)
    miss_rad = _miss_radiance(tables, bg, d)
    see_emit = is_hit & ((depth == 0) | prev_delta)
    contrib = (torch.where(see_emit[:, None], emitted, 0.0)
               + torch.where(is_hit[:, None], 0.0, miss_rad) * last_atten)

    new_at = torch.where(adv[:, None], atten * atten_factor, atten)
    new_last = torch.where(alive[:, None], new_at, last_atten)
    p_rr = luminance(new_at)
    seed, u_rr = rng.rnd_masked(seed, adv)
    survive = adv & (u_rr <= p_rr)
    new_at = torch.where(survive[:, None],
                         new_at / torch.clamp(p_rr, min=1e-12)[:, None],
                         new_at)
    acc_new = misc[:, 10:13] + torch.where(alive[:, None], contrib, 0.0)
    depth_new = depth + alive.to(torch.float32)
    alive_new = survive & (depth_new < float(cfg.max_depth))
    pdelta_new = torch.where(alive, is_delta, prev_delta)

    rays_out = torch.cat([torch.where(survive[:, None], norg, org),
                          torch.where(survive[:, None], ndir, d),
                          rays[:, 6:8]], dim=1)
    cols = [rng.state_to_bits(seed)[:, None], new_at, new_last,
            pdelta_new.to(torch.float32)[:, None], depth_new[:, None],
            alive_new.to(torch.float32)[:, None], acc_new, misc[:, 13:15],
            want_shadow.to(torch.float32)[:, None]]
    if cfg.aov:
        first = (adv & (depth == 0))[:, None]
        cols += [misc[:, 16:19] + torch.where(first, sh_albedo, 0.0),
                 misc[:, 19:22] + torch.where(first, sh_normal, 0.0),
                 torch.zeros((r, 2), **f32)]
    cols += [torch.where(want_shadow[:, None], nee, 0.0),
             torch.zeros((r, 5), **f32)]
    misc_out = torch.cat(cols, dim=1).transpose(0, 1).contiguous()

    tmax_s = torch.where(want_shadow, cap["tmax"], 0.0)
    sh_cols = [cap["p"], cap["ldir"],
               torch.full((r, 1), cfg.shadow_tmin, **f32), tmax_s[:, None]]
    if config.motion:
        sh_cols += [cap["time"][:, None], torch.zeros((r, 7), **f32)]
    return rays_out, misc_out, torch.cat(sh_cols, dim=1)


@dataclass(frozen=True)
class WalkPoolPipeline:
    """The hier table, the shade stage's tables and the launch functions
    of the walk pool, on one device. Build it with make_walkpool_pipeline
    (or make_inst_walkpool_pipeline) over the split-ordered scene that
    choose_tracer returns with it. `kernel` records the shade stage,
    picked when the pipeline is built by what the scene needs (walkpool.py
    :131): K6 (external_shade, True) or the general stage (general_shade,
    False) for the scenes K6 does not shade."""

    table: HierTable | InstHierTable
    num_faces: int  # faces of the ordered scene (hits past it are misses)
    motion: bool  # 2-key scene: leaf rows lerped by the walk's time
    shade_tables: object  # K6's ExternalTables, or the GeneralTables
    shade_config: object  # K6's ShadeConfig, or a GeneralStageConfig
    misc_w: int  # 16, or 24 with the AOV rows
    shadow_w: int  # 8, or 16 with the shadow ray's time (motion)
    device: torch.device
    kernel: bool = True  # K6 shades, else the general stage
    walk_fn: object = walk_rounds  # K9, or _pipe_rounds_ref-like
    # K6 (or external_shade_ref) with kernel, else general_shade
    shade_fn: object = external_shade
    # a trace-time instanced scene: the shade stage takes each hit's
    # instance
    instanced: bool = False
    # > 0: the walk rides a baked world table whose hits encode
    # eff = instance * inst_stride + face (decoded before shading)
    inst_stride: int = 0

    @property
    def n_levels(self) -> int:
        return self.table.n_levels

    @property
    def fanout(self) -> int:
        return self.table.fanout

    def shade(self, rays, hit4, misc_t, inst=None):
        """The shade stage on C-major misc [MW, W]: (rays [W, 8], misc
        [MW + 8, W], shadow [W, 8 | 16]); inst [W] int32: an instanced
        scene's hit instances."""
        kw = dict(inst=inst) if self.instanced else {}
        return self.shade_fn(rays, hit4, misc_t, self.shade_tables,
                             self.shade_config, transposed=True, **kw)

    def rounds(self, s: WalkState, k: int) -> None:
        self.walk_fn(s, self.table, self.motion, k)


def _shade_stage(scene, cfg, device):
    """(ExternalTables, ShadeConfig) of K6 for the walk pool's scene."""
    attr_t, lights_t, tex, params_base = shade_tables_for(scene, device)
    inst_rows = None
    if hasattr(scene, "instance_mesh"):
        inst_rows = torch.as_tensor(inst_transform_rows(scene), device=device)
    tables = ExternalTables(
        attr=torch.as_tensor(np.ascontiguousarray(attr_t.T), device=device),
        lights_t=torch.as_tensor(lights_t, device=device), tex=tex,
        params_base=params_base, inst_rows=inst_rows)
    config = ShadeConfig(
        max_depth=cfg.max_depth, num_lights=scene.num_lights,
        shadow_tmin=cfg.shadow_tmin, shadow_eps=cfg.shadow_tmax_eps,
        bg=tuple(float(b) for b in cfg.bg_radiance),
        motion=scene.num_keys == 2, power=cfg.light_sampler == "power",
        aov=cfg.aov)
    return tables, config


def _pick_stage(scene, cfg, device, shade_fn):
    """(kernel, tables, config, shade function) of the walk pool's shade
    stage for `scene`: K6's tables and `shade_fn` when K6 shades the
    scene, else integrate/path.py's GeneralTables and general_shade, as
    the reference picks its stage (walkpool.py :169, :236). The wave
    integrator and more than 2 keys are refused."""
    reason = _first_failed(route_checks(scene, cfg))
    if reason is not None:
        raise NotImplementedError(f"{reason}; the walk pool takes the pool "
                                  "integrator and at most 2 keys")
    if _first_failed(shading_checks(scene, cfg)) is not None:
        # deferred: integrate/path.py imports this module
        from .path import general_tables

        config = GeneralStageConfig(cfg=cfg, motion=scene.num_keys == 2)
        return False, general_tables(scene, device), config, general_shade
    return (True, *_shade_stage(scene, cfg, device), shade_fn)


def make_walkpool_pipeline(scene, cfg, device, walk_fn=walk_rounds,
                           shade_fn=external_shade) -> WalkPoolPipeline:
    """The node table (fanout auto) and the shade stage's tables for
    `scene`, already split-ordered (walkpool.py :151-172). walk_fn and
    shade_fn (K6's, where K6 shades the scene; else general_shade) default
    to the kernels' wrappers, which run the plain versions on CPU
    tensors."""
    device = torch.device(device)
    kernel, tables, config, shade_fn = _pick_stage(scene, cfg, device,
                                                   shade_fn)
    motion = scene.num_keys == 2
    tab = build_hier_table(scene.geom, scene.num_faces,
                           num_keys=scene.num_keys, fanout=POOL_DIR_FANOUT,
                           device=device)
    return WalkPoolPipeline(
        table=tab, num_faces=tab.num_faces, motion=motion,
        shade_tables=tables, shade_config=config,
        misc_w=misc_width(cfg.aov), shadow_w=16 if motion else 8,
        device=device, kernel=kernel, walk_fn=walk_fn, shade_fn=shade_fn)


def make_inst_walkpool_pipeline(iscene, cfg, device, walk_fn=walk_rounds,
                                shade_fn=external_shade,
                                bake: bool | None = None) -> WalkPoolPipeline:
    """The walk pool over a trace-time instanced scene of at most 2 keys,
    already split_order_instanced (walkpool.py :182-252): a static field
    of more than LEAFWALK_MIN_FACES effective faces that
    baked_world_eligible admits walks a baked world table on K9 (`bake`
    True / False forces it either way, for the tests); any other walks
    the instanced table on K9-inst. The shade stage (K6, which transforms
    each hit's normal by its instance's rows, or the general stage, as
    make_walkpool_pipeline picks it) takes each hit's instance either
    way."""
    if iscene.num_keys > 2:
        raise ValueError("the instanced walk pool takes at most 2 transform "
                         "keys (ROADMAP C1)")
    device = torch.device(device)
    kernel, tables, config, shade_fn = _pick_stage(iscene, cfg, device,
                                                   shade_fn)
    motion = iscene.num_keys == 2
    eff_faces = sum(iscene.mesh_ranges[m][1] for m in iscene.instance_mesh)
    if bake is None:
        bake = (baked_world_eligible(iscene)
                and eff_faces > LEAFWALK_MIN_FACES)
    if bake:
        tab, stride = build_baked_world_table(iscene, device=device)
        num_faces = stride
    else:
        tab = build_inst_hier_table(iscene, device=device)
        num_faces, stride = tab.num_faces, 0
    return WalkPoolPipeline(
        table=tab, num_faces=num_faces, motion=motion, shade_tables=tables,
        shade_config=config, misc_w=misc_width(cfg.aov),
        shadow_w=16 if motion else 8, device=device, kernel=kernel,
        walk_fn=walk_fn, shade_fn=shade_fn, instanced=True,
        inst_stride=stride)


def phase_rounds(cfg, n_levels: int, spacewalk: bool = False) -> int:
    """K, the rounds between two phase boundaries (walkpool.py
    :1037-1054): cfg.walk_phase_every, else 32 past 5 table levels, 20 for
    a space-switching instanced walk and 16 otherwise."""
    if cfg.walk_phase_every < 0:
        raise ValueError("walk_phase_every must be >= 0 (0 = auto)")
    if cfg.walk_phase_every:
        return cfg.walk_phase_every
    if n_levels > 5:
        return 32
    return 20 if spacewalk else 16


# ------------------------------------------------------------ the pool
class _Pool:
    """The pool of _render_pipepool beyond the walk state: the retire
    stashes, the images and the counters."""

    def __init__(self, n_pix: int, pool: int, aov: bool, stash2: bool,
                 device):
        f32 = dict(dtype=torch.float32, device=device)
        self.stash_px = torch.full((pool,), -1.0, **f32)
        self.stash_acc = torch.zeros((9 if aov else 3, pool), **f32)
        self.stash2_px = torch.full((pool,), -1.0, **f32) if stash2 else None
        self.stash2_rgb = torch.zeros((3, pool), **f32) if stash2 else None
        self.images = [torch.zeros((n_pix + 1, 3), **f32)
                       for _ in range(3 if aov else 1)]
        i64 = dict(dtype=torch.int64, device=device)
        self.next_work = torch.zeros((), **i64)
        self.n_rad = torch.zeros((), **i64)
        self.n_shad = torch.zeros((), **i64)


def _render_pipepool(scene, cfg, cam, pipe: WalkPoolPipeline, pixel_idx,
                     subframe_index: int, paths: int = 2):
    """The software-pipelined walk pool (walkpool.py :982-1628) with P =
    `paths` >= 2 paths per lane. Each window flushes the retire stash into
    the image, then runs flush_every supersteps of one boundary (every
    path shaded, pended, gated, retired and refilled; one K6 launch over
    the P x W lanes) and K walk rounds.
    The loop condition is read once per window. Returns (rgb [N, 3],
    (albedo, normal) or None, n_rad, n_shad, walk rounds)."""
    # deferred: integrate/path.py imports this module
    from .path import _lcg_advance_table, _next_pow2, _scf

    dev = pipe.device
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    pixel_base = int(pixel_idx[0])
    pool = max(min(cfg.ray_block, _next_pow2(n_pix * spp)), 256)
    k_phase = phase_rounds(cfg, pipe.n_levels,
                           spacewalk=pipe.instanced and not pipe.inst_stride)
    flush_n = cfg.flush_every or 8
    aov = cfg.aov
    stash2 = not aov  # the capacity-2 stash carries no AOV columns
    mw = pipe.misc_w
    s = new_walk_state(pool, pipe.n_levels, pipe.fanout, paths, mw, dev,
                       tmax=cfg.primary_tmax)
    pl = _Pool(n_pix, pool, aov, stash2, dev)
    jump = torch.as_tensor(_lcg_advance_table(spp).astype(np.int64),
                           device=dev)
    # every pixel's stream, hashed once: a boundary gathers its lanes'
    streams = rng.pixel_streams(torch.arange(pixel_base, pixel_base + n_pix,
                                             device=dev), subframe_index,
                                int(cfg.seed or 0))
    scf = _scf(cam)
    eye = torch.tensor(scf[0:3], dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    tmin = torch.full((paths * pool, 1), cfg.primary_tmin, **f32)
    tmax = torch.full((paths * pool, 1), cfg.primary_tmax, **f32)
    path_ids = torch.arange(paths, dtype=torch.int32, device=dev)[:, None]

    def boundary():
        """One phase boundary of every path (walkpool.py :1308-1513). The
        phases A-C and the new samples are per lane and run for all P
        paths at once (K6 over P x W lanes); the retire and the pixel claim
        share the stash and the work counter, so they run path after path
        as the reference's boundary does."""
        mc = s.mc
        # phase A: shade the paths whose closest walk finished
        m_a = s.hvalid & ~s.hmode
        hprim, hinst = s.hprim, s.hinst
        if pipe.inst_stride:
            # a baked world table's hit: eff = instance * stride + face
            # (walkpool.py :1248-1258, decoded here instead of per round)
            hinst = torch.where(hprim >= 0, hprim // pipe.inst_stride, -1)
            hprim = torch.where(hprim >= 0, hprim - hinst * pipe.inst_stride,
                                -1)
        valid = m_a & (hprim >= 0) & (hprim < pipe.num_faces)
        zero = torch.zeros_like(s.hu)
        hit4 = torch.stack([
            torch.where(valid, s.ht, s.hray[..., 7]),
            torch.where(valid, hprim, -1).to(torch.float32),
            torch.where(valid, s.hu, zero),
            torch.where(valid, s.hv, zero)], dim=-1)
        misc_in = mc.transpose(0, 1).reshape(mw, paths * pool)
        misc_in[9] = m_a.reshape(-1).to(torch.float32)
        inst = (torch.where(valid, hinst, -1).view(-1) if pipe.instanced
                else None)
        rays2, misc_e, sh = pipe.shade(s.hray.view(-1, 8), hit4.view(-1, 4),
                                       misc_in, inst)
        misc_e = misc_e.view(mw + 8, paths, pool).transpose(0, 1)
        mc.copy_(torch.where(m_a[:, None], misc_e[:, :mw], mc))
        s.nrays.copy_(torch.where(m_a[..., None],
                                  rays2.view(paths, pool, 8), s.nrays))
        s.nee.copy_(torch.where(m_a[:, None], misc_e[:, mw:mw + 3], s.nee))
        want_shadow = m_a & (misc_e[:, 15] > 0)
        pl.n_shad += want_shadow.sum()
        # the bounce's time draw, at the stream position of the classic
        # pool's launch draw; the inline gate pends the bounce with it
        seed_b, t_b = rng.rnd_masked(rng.bits_to_state(mc[:, 0]),
                                     want_shadow)
        mc[:, 0] = rng.state_to_bits(seed_b)
        s.btime.copy_(torch.where(want_shadow, t_b, s.btime))
        # phase B: pend the shadow walk
        sh = sh.view(paths, pool, -1)
        pray = torch.where(want_shadow[..., None], sh[..., 0:8], s.pray)
        ptime = torch.where(want_shadow, sh[..., 8] if pipe.motion else zero,
                            s.ptime)
        pmode = torch.where(m_a, want_shadow, s.pmode)
        pvalid = s.pvalid | want_shadow
        # phase C: a path without a shadow walk gates (nothing) and
        # bounces or retires here
        sh_done = s.hvalid & s.hmode
        m_c = sh_done | (m_a & ~want_shadow)
        gate = m_c & ~(s.hfound & sh_done)
        acc = mc[:, 10:13] + torch.where(gate[:, None], s.nee, 0.0)
        cont = m_c & (mc[:, 9] > 0)
        pray = torch.where(cont[..., None], s.nrays, pray)
        pmode = pmode & ~cont
        pvalid = pvalid | cont
        hvalid = s.hvalid & ~(m_a | sh_done)

        # retire into the stash, claim pixels from the work counter
        accs = torch.cat([acc] + ([mc[:, AOV_COLS:AOV_COLS + 6]] if aov
                                  else []), dim=1)
        pixel, samp = mc[:, 13].clone(), mc[:, 14].clone()
        walking = (s.cur >= 0) & (s.wslot == path_ids)
        idle = ~pvalid & ~hvalid & ~walking
        for p in range(paths):
            completed = idle[p] & (pixel[p] >= 0) & (samp[p] >= spp)
            can_stash = completed & (pl.stash_px < 0)
            pl.stash_px.copy_(torch.where(can_stash, pixel[p], pl.stash_px))
            pl.stash_acc.copy_(torch.where(can_stash[None], accs[p],
                                           pl.stash_acc))
            accs[p] = torch.where(can_stash[None], 0.0, accs[p])
            freed = can_stash
            if stash2:
                can_s2 = completed & ~can_stash & (pl.stash2_px < 0)
                pl.stash2_px.copy_(torch.where(can_s2, pixel[p],
                                               pl.stash2_px))
                pl.stash2_rgb.copy_(torch.where(can_s2[None], accs[p, :3],
                                                pl.stash2_rgb))
                accs[p] = torch.where(can_s2[None], 0.0, accs[p])
                freed = freed | can_s2
            pixel[p] = torch.where(freed, -1.0, pixel[p])
            samp[p] = torch.where(freed, 0.0, samp[p])
            fresh = idle[p] & (pixel[p] < 0)
            wpix = pl.next_work + torch.cumsum(fresh.to(torch.int64), 0) - 1
            take_px = fresh & (wpix < n_pix)
            pixel[p] = torch.where(take_px, (pixel_base + torch.clamp(
                wpix, 0, n_pix - 1)).to(torch.float32), pixel[p])
            samp[p] = torch.where(take_px, 0.0, samp[p])
            pl.next_work += take_px.sum()

        # start the new samples: seed, jitter, camera ray, time draw
        take = idle & (pixel >= 0) & (samp < spp)
        samp_i = samp.to(torch.int64)
        samp = torch.where(take, samp + 1.0, samp)
        new_pixel = torch.clamp(pixel, min=0.0).to(torch.int64).view(-1)
        st, jx, jy = rng.sample_start_from(
            streams[torch.clamp(new_pixel - pixel_base, 0, n_pix - 1)],
            samp_i.view(-1), jump)
        cam_dir = torch.stack(camera_ray_dir(scf, new_pixel, cfg.width,
                                             cfg.height, jx, jy), dim=1)
        launch = cont | take
        seed_u = torch.where(take, st.view(paths, pool),
                             rng.bits_to_state(mc[:, 0]))
        seed_u, t_draw = rng.rnd_masked(seed_u, launch)
        mc[:, 0] = rng.state_to_bits(seed_u)
        mc[:, 1:7] = torch.where(take[:, None], 1.0, mc[:, 1:7])
        mc[:, 7:9] = torch.where(take[:, None], 0.0, mc[:, 7:9])
        mc[:, 9] = torch.where(take, 1.0, mc[:, 9])
        mc[:, 10:13] = accs[:, :3]
        mc[:, 13] = pixel
        mc[:, 14] = samp
        if aov:
            mc[:, AOV_COLS:AOV_COLS + 6] = accs[:, 3:]
        cam8 = torch.cat([eye.expand(paths * pool, 3), cam_dir, tmin, tmax],
                         dim=1).view(paths, pool, 8)
        s.pray.copy_(torch.where(take[..., None], cam8, pray))
        s.ptime.copy_(torch.where(launch, t_draw, ptime))
        s.pmode.copy_(pmode & ~take)
        s.pvalid.copy_(pvalid | take)
        s.hvalid.copy_(hvalid)
        # the inline gate's bounce, counted now: every shadow walk of a
        # live path ends before the pool drains
        bounce_later = want_shadow & (mc[:, 9] > 0)
        pl.n_rad += (launch | bounce_later).sum()

    def flush():
        have = pl.stash_px >= 0
        target = torch.where(have, pl.stash_px.to(torch.int64) - pixel_base,
                             n_pix)
        for k, image in enumerate(pl.images):
            image.index_add_(0, target, pl.stash_acc[3 * k:3 * k + 3].T)
        pl.stash_acc.zero_()
        if stash2:  # slot 2 rolls into the cleared slot 1
            pl.stash_px.copy_(pl.stash2_px)
            pl.stash_acc[:3] = pl.stash2_rgb
            pl.stash2_px.fill_(-1.0)
            pl.stash2_rgb.zero_()
        else:
            pl.stash_px.fill_(-1.0)

    def busy() -> bool:
        pend = (s.cur >= 0) | (s.pvalid | s.hvalid | (
            (s.mc[:, 13] >= 0) & (s.mc[:, 14] < spp))).any(dim=0)
        return bool((pl.next_work < n_pix) | pend.any())

    n_round = 0
    while busy():
        flush()
        for _ in range(flush_n):
            boundary()
            pipe.rounds(s, k_phase)
        n_round += flush_n * k_phase

    # drain: the stashes and every path still holding a pixel
    inv_spp = torch.tensor(1.0, dtype=torch.float32) / float(spp)
    flush()
    if stash2:
        flush()
    out = []
    for image, (col, _) in zip(pl.images, ACC_COLS):
        for p in range(paths):
            pixel = s.mc[p, 13]
            target = torch.where(pixel >= 0,
                                 pixel.to(torch.int64) - pixel_base, n_pix)
            image.index_add_(0, target, s.mc[p, col:col + 3].T)
        out.append(image[:n_pix] * inv_spp.to(dev))
    return (out[0], tuple(out[1:]) if aov else None, pl.n_rad, pl.n_shad,
            n_round)
