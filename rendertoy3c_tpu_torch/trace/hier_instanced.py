"""The instanced hierarchical walk: the trace-time two-level (TLAS) tables,
their walk tracers, and the baked world-space tables of static fields.

Port of rendertoy3c_tpu/trace/hier_instanced.py: `_levels_at` and
`_resolve_inst_fanout` (:83-100, the auto rule only), `_inv3` (:131),
`_inst_space` (:155), `_mesh_subtree` (over trace/hierwalk.py's
`_build_levels`, shared with the flat tables),
`split_order_instanced` (:259), `build_inst_hier_table` (:323-492), the
tracers `trace_closest_inst_hier` / `trace_any_inst_hier` (:665-692) and
`make_inst_hierwalk_tracer` (:694), `baked_world_eligible` (:740, the auto
rule: static scenes only) and `build_baked_world_table` (:776), on host
numpy. The walk itself is K9-inst (kernels/csrc/walk.cu) or its plain
version (integrate/walkpool.py `_walk_round_inst`), run to completion by
those tracers as trace/hierwalk.py's tracers run K9.

One 128-f32 row table holds four row types (lane 127: 0 directory, 1
leaf, 2 instance):
  world directories: the child boxes of instances in world space;
  instance rows: a static row's world -> object affine in lanes 0-11 and
    its instance id in lane 12; a 2-key row's two forward keys in lanes
    0-23 and its id in lane 24; lane 126 the root row of its mesh;
  mesh directories: object-space child boxes, one subtree per mesh that
    every instance of the mesh shares;
  leaves: HIER_LEAF object-space triangles inline.
A walk carries the ray of the space it walks in; an instance row moves it
into object space (the direction unnormalized, so t stays in world units
and one best t prunes across spaces) and jumps to the mesh's root; a pop
that re-enters a world level restores the world ray. Directories of
fanout 32 hold bf16-packed boxes (trace/hierwalk.py `_pack_bf16_lohi`).

A baked world table (static fields of more than 16384 effective faces)
holds every instance's triangles pre-transformed to world space as a flat
hierwalk table, which K9 walks unchanged; a leaf's first-face id encodes
eff = instance * stride + face (stride = the stored face count), which
the walk pool decodes before shading.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..accel.lbvh import sah_split_perm
from .hierwalk import (_BIG, FANOUT, FANOUT20, FANOUT32, HIER_LEAF, ROW,
                       HierTable, _build_levels, _dir_half_area_sum,
                       _dir_table, _write_dir)
from .hierwalk import _L_FIRST as _H_FIRST
from .hierwalk import _L_TYPE as _H_TYPE
from .intersect import Hit

# row lanes (extending trace/hierwalk.py's)
_L_FIRST = 126  # child row / mesh root / leaf first face (f32, exact)
_L_INST = 12  # static instance row: id (lanes 0-11 the inverse affine)
_L_INST_M = 24  # 2-key instance row: id (lanes 0-11, 12-23 forward keys)
_L_TYPE = 127  # 0 directory, 1 leaf, 2 instance

# the baked table's budget of effective leaf rows (~512 B each), the
# reference's default (RT3C_INST_BAKE_ROWS)
INST_BAKE_MAX_ROWS = 409600


@dataclass(frozen=True)
class InstHierTable:
    """The instanced row table: [world dirs by level][instance rows]
    [mesh dirs by level][leaves]."""

    table: torch.Tensor  # [N, 128] f32
    world_starts: tuple  # first row of each world directory level
    inst_start: int
    mesh_starts: tuple  # first row of each mesh directory level
    leaf_start: int
    num_faces: int  # stored faces (hit prim validity bound)
    motion: bool = False  # instance rows carry both forward keys
    fanout: int = FANOUT

    @property
    def n_world(self) -> int:
        return len(self.world_starts)

    @property
    def n_levels(self) -> int:
        return len(self.world_starts) + len(self.mesh_starts)

    def level_bounds(self):
        """(lo, hi) row ranges of the world levels, then the mesh levels."""
        his = (tuple(self.world_starts[1:]) + (self.inst_start,)
               + tuple(self.mesh_starts[1:]) + (self.leaf_start,))
        return tuple(zip(tuple(self.world_starts) + tuple(self.mesh_starts),
                         his))


def _levels_at(n: int, fanout: int) -> int:
    lv = 0
    while n > 1:
        n = -(-n // fanout)
        lv += 1
    return max(lv, 1)


def _resolve_inst_fanout(iscene) -> int:
    """16 while the table has at most 4 levels, else 20 if that brings it
    to 4, else 32 (the bf16-packed rows)."""
    def depth(fo):
        mesh_lv = max(_levels_at(-(-cnt // HIER_LEAF), fo)
                      for _start, cnt in iscene.mesh_ranges)
        return _levels_at(iscene.num_instances, fo) + mesh_lv
    if depth(FANOUT) <= 4:
        return FANOUT
    if depth(FANOUT20) <= 4:
        return FANOUT20
    return FANOUT32


# ------------------------------------------------ the space switch
def _mat3_vec(lin, x):
    """[R, 3, 3] @ [R, 3] as three-term sums in lane order."""
    return (lin[:, :, 0] * x[:, 0:1] + lin[:, :, 1] * x[:, 1:2]
            + lin[:, :, 2] * x[:, 2:3])


def _inv3(m):
    """[R, 3, 3] closed-form inverse (cofactors over the determinant);
    zero where |det| <= 1e-30, so a singular lerp misses."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    ca = e * i - f * h
    cb = c * h - b * i
    cc = b * f - c * e
    cd = f * g - d * i
    ce = a * i - c * g
    cf = c * d - a * f
    cg = d * h - e * g
    ch = b * g - a * h
    ci = a * e - b * d
    det = a * ca + b * cd + c * cg
    # IEEE 1 / det (a tensor divisor: CUDA torch keeps the division)
    r = torch.where(torch.abs(det) > 1e-30, torch.ones_like(det) / det,
                    torch.zeros_like(det))
    return torch.stack([torch.stack([ca, cb, cc], dim=-1),
                        torch.stack([cd, ce, cf], dim=-1),
                        torch.stack([cg, ch, ci], dim=-1)],
                       dim=-2) * r[:, None, None]


def _inst_space(rows, o_w, d_w, time, motion: bool):
    """(o, d, instance id) in the object space of each lane's instance
    row: a static row's stored inverse affine, or the inverse of the
    forward keys lerped to the lane's time (never a lerp of inverses)."""
    r = rows.shape[0]
    if not motion:
        lin = rows[:, 0:9].reshape(r, 3, 3)
        return (_mat3_vec(lin, o_w) + rows[:, 9:12], _mat3_vec(lin, d_w),
                rows[:, _L_INST])
    m0 = rows[:, 0:12].reshape(r, 3, 4)
    m1 = rows[:, 12:24].reshape(r, 3, 4)
    mt = m0 + (m1 - m0) * time[:, None, None]
    lin = _inv3(mt[:, :, :3])
    return (_mat3_vec(lin, o_w - mt[:, :, 3]), _mat3_vec(lin, d_w),
            rows[:, _L_INST_M])


# ------------------------------------------------ host table builds
def _mesh_subtree(v0, e1, e2, first_face: int, fanout: int = FANOUT,
                  var: bool = False):
    """(levels, leaf_rows, root_lo, root_hi) of one mesh in object space."""
    f = v0.shape[0]
    n_leaf = max(1, -(-f // HIER_LEAF))
    f_pad = n_leaf * HIER_LEAF
    comp = np.zeros((9, f_pad), np.float32)
    comp[0:3, :f] = v0.T
    comp[3:6, :f] = e1.T
    comp[6:9, :f] = e2.T
    leaf_tris = (comp.reshape(9, n_leaf, HIER_LEAF).transpose(1, 0, 2)
                 .reshape(n_leaf, 9 * HIER_LEAF))
    p1 = v0 + e1
    p2 = v0 + e2
    lo_f = np.full((f_pad, 3), _BIG, np.float32)
    hi_f = np.full((f_pad, 3), -_BIG, np.float32)
    lo_f[:f] = np.minimum(np.minimum(v0, p1), p2)
    hi_f[:f] = np.maximum(np.maximum(v0, p1), p2)
    leaf_lo = lo_f.reshape(n_leaf, HIER_LEAF, 3).min(axis=1)
    leaf_hi = hi_f.reshape(n_leaf, HIER_LEAF, 3).max(axis=1)
    leaf_rows = np.zeros((n_leaf, ROW), np.float32)
    leaf_rows[:, :9 * HIER_LEAF] = leaf_tris
    leaf_rows[:, _L_FIRST] = (first_face + HIER_LEAF
                              * np.arange(n_leaf, dtype=np.float32))
    leaf_rows[:, _L_TYPE] = 1.0
    if n_leaf == 1:
        return [], leaf_rows, leaf_lo[0], leaf_hi[0]
    levels, root_lo, root_hi = _build_levels(leaf_lo, leaf_hi, fanout, var)
    return levels, leaf_rows, root_lo, root_hi


def _real_faces(g, start: int, cnt: int):
    """(v0, e1, e2) object-space slices of one mesh range and the mask of
    its real (not all-zero) faces."""
    v0 = np.asarray(g.v0[0][start:start + cnt], np.float32)
    e1 = np.asarray(g.e1[0][start:start + cnt], np.float32)
    e2 = np.asarray(g.e2[0][start:start + cnt], np.float32)
    real = ~((np.abs(v0).sum(1) == 0) & (np.abs(e1).sum(1) == 0)
             & (np.abs(e2).sum(1) == 0))
    return v0, e1, e2, real


def split_order_instanced(iscene):
    """Binned-SAH face order within each mesh range, and the instances in
    SAH order of their world boxes (when there are more than the fanout).
    Returns a new InstancedScene (prim and instance ids change)."""
    g = iscene.geom
    perm = np.arange(g.mat_id.shape[0])
    for start, cnt in iscene.mesh_ranges:
        v0, e1, e2, real = _real_faces(g, start, cnt)
        nf = int(real.sum())
        if nf <= HIER_LEAF:
            continue
        lo = np.minimum(np.minimum(v0[:nf], v0[:nf] + e1[:nf]),
                        v0[:nf] + e2[:nf])
        hi = np.maximum(np.maximum(v0[:nf], v0[:nf] + e1[:nf]),
                        v0[:nf] + e2[:nf])
        perm[start:start + nf] = start + sah_split_perm(lo, hi, HIER_LEAF)
    per_key = ("v0", "e1", "e2", "n0", "n1", "n2")
    geom = g._replace(**{k: np.asarray(getattr(g, k))[:, perm]
                         for k in per_key},
                      **{k: np.asarray(getattr(g, k))[perm]
                         for k in ("uv0", "uv1", "uv2", "mat_id")})
    inst = iscene.instances
    ifan = _resolve_inst_fanout(iscene)
    iperm = (sah_split_perm(inst.aabb_lo, inst.aabb_hi, ifan)
             if iscene.num_instances > ifan
             else np.arange(iscene.num_instances))
    inst = inst._replace(**{k: np.asarray(getattr(inst, k))[iperm]
                            for k in inst._fields})
    return replace(iscene, geom=geom, instances=inst,
                   instance_mesh=tuple(iscene.instance_mesh[int(j)]
                                       for j in iperm))


def build_inst_hier_table(iscene, fanout: int | None = None, *,
                          device) -> InstHierTable:
    """World levels over the instance boxes, the instance rows, and one
    object-space subtree per mesh (order the scene with
    split_order_instanced first). fanout None resolves it by depth. A
    2-key scene's world levels bound every time, since the instance boxes
    union both keys' boxes."""
    if fanout is None:
        fanout = _resolve_inst_fanout(iscene)
    if fanout not in (FANOUT, FANOUT20, FANOUT32):
        raise ValueError(f"fanout must be {FANOUT}, {FANOUT20} or {FANOUT32}")
    g = iscene.geom
    inst = iscene.instances
    n_inst = iscene.num_instances
    motion = iscene.num_keys == 2
    minv = np.asarray(inst.minv)[:, 0]
    mfwd = np.asarray(inst.m)
    ilo = np.asarray(inst.aabb_lo)
    ihi = np.asarray(inst.aabb_hi)

    def wants_var(lo_b, hi_b):
        # DP-grouped runs where fixed blocks bound loosely
        if lo_b.shape[0] <= FANOUT:
            return False
        return (_dir_half_area_sum(lo_b, hi_b, FANOUT)
                > _dir_half_area_sum(lo_b, hi_b, FANOUT20))

    mesh_sub = []
    for start, cnt in iscene.mesh_ranges:
        v0, e1, e2, real = _real_faces(g, start, cnt)
        nf = max(1, int(real.sum()))
        p1 = v0[:nf] + e1[:nf]
        p2 = v0[:nf] + e2[:nf]
        flo = np.minimum(np.minimum(v0[:nf], p1), p2)
        fhi = np.maximum(np.maximum(v0[:nf], p1), p2)
        nl = -(-nf // HIER_LEAF)
        pad = nl * HIER_LEAF - nf
        if pad:
            flo = np.concatenate([flo, np.full((pad, 3), _BIG, np.float32)])
            fhi = np.concatenate([fhi, np.full((pad, 3), -_BIG,
                                               np.float32)])
        llo = flo.reshape(nl, HIER_LEAF, 3).min(1)
        lhi = fhi.reshape(nl, HIER_LEAF, 3).max(1)
        mesh_sub.append(_mesh_subtree(v0[:nf], e1[:nf], e2[:nf], start,
                                      fanout=fanout,
                                      var=wants_var(llo, lhi)))
    mesh_depth = max(len(levels) for levels, *_ in mesh_sub)

    if n_inst > 1:
        wlevels, _, _ = _build_levels(ilo, ihi, fanout, wants_var(ilo, ihi))
    else:  # a 1-child root directory
        clo = np.full((1, fanout, 3), _BIG, np.float32)
        chi = np.full((1, fanout, 3), _BIG, np.float32)
        clo[0, 0] = ilo[0]
        chi[0, 0] = ihi[0]
        wlevels = [(clo, chi, np.zeros(1, np.int64))]

    world_starts = []
    acc = 0
    for clo, _, _ in wlevels:
        world_starts.append(acc)
        acc += clo.shape[0]
    inst_start = acc
    acc += n_inst
    mesh_starts = []
    mesh_level_rows = []  # per mesh level: [(mesh, level groups)]
    for lv in range(mesh_depth):
        mesh_starts.append(acc)
        rows_here = []
        for mi, (levels, *_rest) in enumerate(mesh_sub):
            if lv < len(levels):
                rows_here.append((mi, levels[lv]))
                acc += levels[lv][0].shape[0]
        mesh_level_rows.append(rows_here)
    leaf_start = acc
    leaf_base = {}
    for mi, (_, leaf_rows, _, _) in enumerate(mesh_sub):
        leaf_base[mi] = acc
        acc += leaf_rows.shape[0]
    level_base = {}
    for lv, rows_here in enumerate(mesh_level_rows):
        base = mesh_starts[lv]
        for mi, (clo, _, _) in rows_here:
            level_base[(mi, lv)] = base
            base += clo.shape[0]

    table = np.zeros((acc, ROW), np.float32)

    def fill_dir(base, clo, chi, first_rel, child_base):
        _write_dir(table[base:base + clo.shape[0]], clo, chi,
                   child_base + first_rel, fanout)

    for i, (clo, chi, first_rel) in enumerate(wlevels):
        child = world_starts[i + 1] if i + 1 < len(wlevels) else inst_start
        fill_dir(world_starts[i], clo, chi, first_rel, child)
    mesh_id = np.asarray(inst.mesh_id)
    for i in range(n_inst):
        row = table[inst_start + i]
        if motion:
            row[0:12] = mfwd[i, 0].reshape(12)
            row[12:24] = mfwd[i, 1].reshape(12)
            row[_L_INST_M] = float(i)
        else:
            row[0:9] = minv[i, :, :3].reshape(9)
            row[9:12] = minv[i, :, 3]
            row[_L_INST] = float(i)
        mi = int(mesh_id[i])
        row[_L_FIRST] = (level_base[(mi, 0)] if mesh_sub[mi][0]
                         else leaf_base[mi])
        row[_L_TYPE] = 2.0
    for lv, rows_here in enumerate(mesh_level_rows):
        for mi, (clo, chi, first_rel) in rows_here:
            levels = mesh_sub[mi][0]
            child = (level_base[(mi, lv + 1)] if lv + 1 < len(levels)
                     else leaf_base[mi])
            fill_dir(level_base[(mi, lv)], clo, chi, first_rel, child)
    for mi, (_, leaf_rows, _, _) in enumerate(mesh_sub):
        table[leaf_base[mi]:leaf_base[mi] + leaf_rows.shape[0]] = leaf_rows
    return InstHierTable(
        table=torch.as_tensor(table, device=device),
        world_starts=tuple(world_starts), inst_start=inst_start,
        mesh_starts=tuple(mesh_starts), leaf_start=leaf_start,
        num_faces=int(g.mat_id.shape[0]), motion=motion, fanout=fanout)


# ------------------------------------------------------ the walk tracers
def _inst_times(tab: InstHierTable, time, r: int, device):
    if not tab.motion:
        return None
    return torch.broadcast_to(torch.as_tensor(
        0.0 if time is None else time, dtype=torch.float32, device=device),
        (r,))


def trace_closest_inst_hier(tab: InstHierTable, o, d, tmin, tmax,
                            count=None, time=None, plain: bool = False,
                            walk_fn=None) -> Hit:
    """Closest hit and its instance by the instanced walk (only the first
    `count` rays are live). walk_fn replaces integrate/walkpool.py
    `walk_rounds` (same signature)."""
    from .hierwalk import _walk

    s = _walk(tab, o, d, tmin, tmax, count, False,
              _inst_times(tab, time, o.shape[0], o.device), plain, walk_fn)
    valid = (s.wb_prim >= 0) & (s.wb_prim < tab.num_faces)
    zero = torch.zeros_like(s.wb_u)
    return Hit(t=torch.where(valid, s.wb_t, s.ray[:, 7]),
               prim=torch.where(valid, s.wb_prim, -1),
               u=torch.where(valid, s.wb_u, zero),
               v=torch.where(valid, s.wb_v, zero),
               inst=torch.where(valid, s.wb_inst, -1))


def trace_any_inst_hier(tab: InstHierTable, o, d, tmin, tmax, count=None,
                        time=None, plain: bool = False,
                        walk_fn=None) -> torch.Tensor:
    """Occlusion [R] bool by the instanced walk; walk_fn as
    trace_closest_inst_hier."""
    from .hierwalk import _walk

    return _walk(tab, o, d, tmin, tmax, count, True,
                 _inst_times(tab, time, o.shape[0], o.device), plain,
                 walk_fn).wfound


def make_inst_hierwalk_tracer(iscene, device, plain: bool = False,
                              walk_fn=None):
    """(closest, any_hit) over the instanced walk of a static or 2-key
    scene (order it with split_order_instanced first), each f(o, d,
    tmin, tmax, time, count). The walk is K9-inst on a CUDA device, its
    plain version on the CPU or with `plain`; walk_fn, if given, replaces
    integrate/walkpool.py `walk_rounds` (same signature) in every launch,
    as the walk pool's walk_fn does."""
    if iscene.num_keys > 2:
        raise ValueError("the instanced walk takes at most 2 transform keys "
                         "(ROADMAP C1)")
    tab = build_inst_hier_table(iscene, device=device)

    def closest(o, d, tmin, tmax, time=None, count=None):
        return trace_closest_inst_hier(tab, o, d, tmin, tmax, count, time,
                                       plain, walk_fn)

    def any_hit(o, d, tmin, tmax, time=None, count=None):
        return trace_any_inst_hier(tab, o, d, tmin, tmax, count, time, plain,
                                   walk_fn)

    return closest, any_hit


# ------------------------------------------------ baked world tables
def baked_world_eligible(iscene) -> bool:
    """Static instanced scenes whose instance-expanded world table fits
    INST_BAKE_MAX_ROWS leaf rows and whose encoded hit ids stay f32-exact
    (num_instances * stride < 2^24). 2-key scenes walk the space-switching
    table (their baked boxes would bound every time)."""
    if iscene.num_keys != 1:
        return False
    stride = int(iscene.geom.mat_id.shape[0])
    if iscene.num_instances * stride >= 1 << 24:
        return False
    rows = sum(-(-iscene.mesh_ranges[m][1] // HIER_LEAF)
               for m in iscene.instance_mesh)
    return rows <= INST_BAKE_MAX_ROWS


def build_baked_world_table(iscene, fanout: int = 0, *, device):
    """(HierTable, stride): every instance's real faces transformed by its
    forward transform into ordinary hierwalk leaf rows (instance-major, in the
    split order), the directories over them as build_hier_table's (fanout
    0 picks 16 fixed or 20 DP-grouped by the half-area sums). Leaf ids
    encode eff = instance * stride + face; the table's num_faces is
    num_instances * stride, the eff validity bound."""
    g = iscene.geom
    n_inst = iscene.num_instances
    stride = int(g.mat_id.shape[0])
    if iscene.num_keys != 1:
        raise ValueError("baked world tables take static scenes only (2-key "
                         "scenes walk the space-switching table)")
    if fanout not in (0, FANOUT, FANOUT20):
        raise ValueError(f"baked world tables take fanout 0 (auto), {FANOUT} "
                         f"or {FANOUT20}")
    m_all = np.asarray(iscene.instances.m)
    mesh_faces = {}
    for mi, (start, cnt) in enumerate(iscene.mesh_ranges):
        v0, e1, e2, real = _real_faces(g, start, cnt)
        nf = max(1, int(real.sum()))
        mesh_faces[mi] = (start, v0[:nf], e1[:nf], e2[:nf])

    rows_all, lo_all, hi_all = [], [], []
    for i in range(n_inst):
        start, v0, e1, e2 = mesh_faces[iscene.instance_mesh[i]]
        nf = v0.shape[0]
        nl = -(-nf // HIER_LEAF)
        f_pad = nl * HIER_LEAF
        rows = np.zeros((nl, ROW), np.float32)
        lo_f = np.full((f_pad, 3), _BIG, np.float32)
        hi_f = np.full((f_pad, 3), -_BIG, np.float32)
        lin_t = m_all[i, 0, :, :3].T
        v0w = v0 @ lin_t + m_all[i, 0, :, 3]
        e1w = e1 @ lin_t
        e2w = e2 @ lin_t
        comp = np.zeros((9, f_pad), np.float32)
        comp[0:3, :nf] = v0w.T
        comp[3:6, :nf] = e1w.T
        comp[6:9, :nf] = e2w.T
        rows[:, :9 * HIER_LEAF] = (comp.reshape(9, nl, HIER_LEAF)
                                   .transpose(1, 0, 2)
                                   .reshape(nl, 9 * HIER_LEAF))
        lo_f[:nf] = np.minimum(np.minimum(v0w, v0w + e1w), v0w + e2w)
        hi_f[:nf] = np.maximum(np.maximum(v0w, v0w + e1w), v0w + e2w)
        rows[:, _H_FIRST] = (float(i * stride + start)
                             + HIER_LEAF * np.arange(nl, dtype=np.float32))
        rows[:, _H_TYPE] = 1.0
        rows_all.append(rows)
        lo_all.append(lo_f.reshape(nl, HIER_LEAF, 3).min(axis=1))
        hi_all.append(hi_f.reshape(nl, HIER_LEAF, 3).max(axis=1))
    leaf_rows = np.concatenate(rows_all)
    leaf_lo = np.concatenate(lo_all)
    leaf_hi = np.concatenate(hi_all)
    n_leaf = leaf_rows.shape[0]

    var = True
    if fanout == 0:
        if (_dir_half_area_sum(leaf_lo, leaf_hi, FANOUT)
                <= _dir_half_area_sum(leaf_lo, leaf_hi, FANOUT20)):
            fanout, var = FANOUT, False
        else:
            fanout = FANOUT20
    levels = _build_levels(leaf_lo, leaf_hi, fanout, var)[0]
    table, starts, leaf_start = _dir_table(levels, n_leaf, fanout)
    table[leaf_start:] = leaf_rows
    return (HierTable(table=torch.as_tensor(table, device=device),
                      level_starts=starts, leaf_start=leaf_start,
                      num_faces=n_inst * stride, fanout=fanout), stride)
