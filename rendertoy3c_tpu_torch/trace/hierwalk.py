"""The hierarchical node table and the ordered-DFS walk of the hierwalk
band (scenes of more than 16384 faces).

Port of rendertoy3c_tpu/trace/hierwalk.py: the row layout and constants,
`HierTable` (:84), `_dp_group_sizes` (:147), `_dir_half_area_sum` (:187),
`build_hier_table` (:215, host numpy), the stacked segment tables of
N-key motion `build_hier_table_nkey` (:390) with their per-ray pick
`_seg_select` (:429), and the per-round arithmetic as plain torch:
`_leaf_mt` (:438), `_dir_entries` (:479), `_safe_inv` (:514) and
`_prune_cut` (:518). `trace_closest_hier` and `trace_any_hier` (:675,
:696) run the walk round (K9, integrate/walkpool.py `walk_rounds`, or its
plain version) to completion over a ray batch; they serve the hierwalk
gate, the tests and `make_hierwalk_tracer` (:709), the bare tracer of the
wave integrator and the general pool. The pool integrator's render path
is the walk pool (integrate/walkpool.py), which runs the same round
inside its pool.

Table layout: one 128-f32 row per node, the directory levels first (root =
row 0), the leaves last. A leaf row holds HIER_LEAF (14) triangles inline
as component-major [9, 14] (v0 e1 e2), or HIER_LEAF_MOTION (7) triangles
of both keys of a 2-key scene ([9, 7] key 0 then key 1), lane 126 the
first face id and lane 127 = 1. A directory row holds its fanout (16 or
20) child boxes component-major (lo.x[F] lo.y lo.z hi.x hi.y hi.z; padding
children lo = hi = +BIG), lane 126 the first child's row and lane 127 = 0.

A 32-wide directory row (FANOUT32, the instanced tables of
trace/hier_instanced.py) packs each child's box as bf16 pairs, one f32
lane per child and axis: lo in the low 16 bits, hi in the high 16, each
rounded outward (`_bf16_outward` :108, `_pack_bf16_lohi` :122), so the
boxes only loosen.

A scene of N > 2 keys (piecewise-linear vertex motion, the reference's N
.obj keyframes) stacks N - 1 two-key segment tables (keys k, k + 1) of one
shared level structure, `seg_rows` rows each: a ray at time t walks
segment s = clip(floor(t (N - 1)), 0, N - 2) at the local time
t (N - 1) - s, every row gather offset by s * seg_rows (WalkState.wseg).
Levels, leaf start and child pointers stay segment-local.

Not ported, raising NotImplementedError with its ROADMAP item from
`build_hier_table`: the flat tables' 32-wide directories (FANOUT32, which
only an env knob of the reference reaches there).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .intersect import Hit

HIER_LEAF = 14  # triangles inline per leaf row (9 * 14 = 126 lanes)
HIER_LEAF_MOTION = 7  # 2-key leaves: both keys inline (2 * 9 * 7 = 126)
FANOUT = 16  # children per directory row (6 * 16 = 96 lanes of boxes)
FANOUT20 = 20  # 6 * 20 = 120 lanes of boxes
FANOUT32 = 32  # bf16-packed directories: the instanced tables only
ROW = 128
_BIG = 1e30
_DET_EPS = 1e-10
_L_FIRST = 126  # leaf: first face id / directory: first child row (f32)
_L_TYPE = 127  # 1.0 = leaf, 0.0 = directory

# the DP grouping of directories (the reference's RT3C_VAR_DIR defaults:
# on, lambda 0.5 mean leaf half-areas per group)
_VAR_DIR_LAM = 0.5


@dataclass(frozen=True)
class HierTable:
    """Flat node table: one 128-f32 row per node, levels contiguous."""

    table: torch.Tensor  # [N, 128] f32
    level_starts: tuple  # first row of each directory level (root = 0)
    leaf_start: int  # first leaf row; leaves end the table
    num_faces: int  # faces the table covers (padding faces past it)
    fanout: int = FANOUT  # children per directory row
    # N-key motion: rows of one segment table (0 = a single table) and
    # the segments stacked (build_hier_table_nkey)
    seg_rows: int = 0
    n_seg: int = 1

    @property
    def n_levels(self) -> int:
        return len(self.level_starts)

    def level_bounds(self):
        """(lo, hi) row ranges of each directory level."""
        his = tuple(self.level_starts[1:]) + (self.leaf_start,)
        return tuple(zip(self.level_starts, his))


def _bf16_outward(x: np.ndarray, up: bool) -> np.ndarray:
    """Box coordinates rounded outward (up: toward +inf) to bf16, as
    uint16 bits. The pre-pad of |x| * 2^-7 dominates the bf16 rounding
    error (<= |x| * 2^-9), so lo_b <= lo and hi_b >= hi."""
    x = np.asarray(x, np.float32)
    m = np.abs(x) * np.float32(2.0 ** -7) + np.float32(1e-34)
    y = (x + m if up else x - m).astype(np.float32)
    # round to nearest even on the upper 16 bits (finite values only)
    u = y.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def _pack_bf16_lohi(lo16: np.ndarray, hi16: np.ndarray) -> np.ndarray:
    """One f32 lane per child: the bf16 bits of lo in the low 16 bits and
    of hi in the high 16 (u << 16 and u & 0xFFFF0000 widen them back)."""
    u32 = ((hi16.astype(np.uint32) << 16) | lo16.astype(np.uint32))
    return u32.view(np.float32)


def _dp_group_sizes(lo: np.ndarray, hi: np.ndarray, fanout: int,
                    lam: float) -> list:
    """Boundary DP over the ordered node boxes: minimise the sum of group
    half-areas plus lam (in mean real-box half-areas) per group, groups of
    at most `fanout`. Returns the group sizes covering 0..n-1 in order."""
    n = lo.shape[0]
    d = np.maximum(hi - lo, 0.0)
    ha1 = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    real = lo[:, 0] < _BIG
    lam_abs = lam * float(ha1[real].mean()) if real.any() else 0.0
    # wha[i, k] = half-area of the union of boxes i-k..i
    wha = np.full((n, fanout), np.float32(_BIG))
    run_lo = lo.copy()
    run_hi = hi.copy()
    wha[:, 0] = ha1
    for k in range(1, fanout):
        run_lo[k:] = np.minimum(run_lo[k:], lo[:-k])
        run_hi[k:] = np.maximum(run_hi[k:], hi[:-k])
        dk = np.maximum(run_hi[k:] - run_lo[k:], 0.0)
        wha[k:, k] = (dk[:, 0] * dk[:, 1] + dk[:, 1] * dk[:, 2]
                      + dk[:, 2] * dk[:, 0])
    cost = np.full(n + 1, np.inf)
    cost[0] = 0.0
    back = np.zeros(n + 1, np.int32)
    for i in range(1, n + 1):
        kmax = min(fanout, i)
        c = cost[i - kmax:i][::-1] + wha[i - 1, :kmax] + lam_abs
        k = int(np.argmin(c))
        cost[i] = c[k]
        back[i] = k + 1
    sizes = []
    i = n
    while i > 0:
        sizes.append(int(back[i]))
        i -= back[i]
    sizes.reverse()
    return sizes


def _union_real(clo, chi):
    """Parent boxes [n_dir, 3] of child boxes [n_dir, fanout, 3], over the
    real children only (padding children are lo = hi = +BIG)."""
    real = (clo[:, :, 0] < _BIG)[:, :, None]
    lo = np.where(real, clo, _BIG).min(axis=1).astype(np.float32)
    hi = np.where(real, chi, -_BIG).max(axis=1).astype(np.float32)
    return lo, np.where(lo < _BIG, hi, _BIG)


def _fixed_groups(lo, hi, fanout: int):
    """(clo, chi, first_rel) of stride-`fanout` groups of nodes lo/hi."""
    m = lo.shape[0]
    n_dir = -(-m // fanout)
    glo = np.full((n_dir * fanout, 3), _BIG, np.float32)
    ghi = np.full((n_dir * fanout, 3), _BIG, np.float32)
    glo[:m] = lo
    ghi[:m] = hi
    return (glo.reshape(n_dir, fanout, 3), ghi.reshape(n_dir, fanout, 3),
            fanout * np.arange(n_dir, dtype=np.int64))


def _dir_half_area_sum(leaf_lo, leaf_hi, fanout: int) -> float:
    """Sum of the directory half-areas of fixed stride-`fanout` grouping:
    the visit-probability proxy of the fanout auto-pick."""
    lo, hi = leaf_lo, leaf_hi
    total = 0.0
    while lo.shape[0] > 1:
        clo, chi, _ = _fixed_groups(lo, hi, fanout)
        lo, hi = _union_real(clo, chi)
        ok = lo[:, 0] < _BIG
        d = np.maximum(hi[ok] - lo[ok], 0.0)
        total += float((d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                        + d[:, 2] * d[:, 0]).sum())
    return total


def _build_levels(lo, hi, fanout: int, var: bool):
    """Bottom-up directory levels over ordered node boxes lo/hi [n, 3]:
    DP-chosen runs of at most `fanout` (`var`) or fixed blocks. Returns
    (levels, root lo, root hi); levels root first, each (clo [n, fanout,
    3], chi, first_rel [n])."""
    levels = []
    while lo.shape[0] > 1:
        groups = None
        if var:
            sizes = _dp_group_sizes(lo, hi, fanout, _VAR_DIR_LAM)
            # a singleton-heavy solution must not stall the recursion
            if len(sizes) * 2 <= lo.shape[0]:
                n_dir = len(sizes)
                clo = np.full((n_dir, fanout, 3), _BIG, np.float32)
                chi = np.full((n_dir, fanout, 3), _BIG, np.float32)
                first_rel = np.zeros(n_dir, np.int64)
                pos = 0
                for gi, sz in enumerate(sizes):
                    clo[gi, :sz] = lo[pos:pos + sz]
                    chi[gi, :sz] = hi[pos:pos + sz]
                    first_rel[gi] = pos
                    pos += sz
                groups = (clo, chi, first_rel)
        if groups is None:
            groups = _fixed_groups(lo, hi, fanout)
        levels.insert(0, groups)
        lo, hi = _union_real(groups[0], groups[1])
    return levels, lo[0], hi[0]


def _write_dir(rows, clo, chi, first, fanout: int):
    """Directory rows in place: the child boxes (f32, or bf16-packed at
    FANOUT32), each row's first child row, type 0."""
    for c in range(3):
        if fanout == FANOUT32:
            rows[:, c * fanout:(c + 1) * fanout] = _pack_bf16_lohi(
                _bf16_outward(clo[:, :, c], up=False),
                _bf16_outward(chi[:, :, c], up=True))
        else:
            rows[:, c * fanout:(c + 1) * fanout] = clo[:, :, c]
            rows[:, (c + 3) * fanout:(c + 4) * fanout] = chi[:, :, c]
    rows[:, _L_FIRST] = first.astype(np.float32)
    rows[:, _L_TYPE] = 0.0


def _dir_table(levels, n_leaf: int, fanout: int):
    """(table [directory rows + n_leaf, ROW] f32 with the directory rows
    of `levels` written and the leaf rows zero, the levels' first rows,
    leaf_start)."""
    starts = []
    acc = 0
    for clo, _, _ in levels:
        starts.append(acc)
        acc += clo.shape[0]
    table = np.zeros((acc + n_leaf, ROW), np.float32)
    for li, (clo, chi, first_rel) in enumerate(levels):
        child_base = starts[li + 1] if li + 1 < len(levels) else acc
        _write_dir(table[starts[li]:starts[li] + clo.shape[0]], clo, chi,
                   child_base + first_rel, fanout)
    return table, tuple(starts), acc


def build_hier_table(geom, num_faces: int, num_keys: int = 1,
                     fanout: int = FANOUT, allow_var: bool = True,
                     device="cpu") -> HierTable:
    """Host (numpy) build over spatially ordered faces (order the scene
    with accel/lbvh.py split_order_scene(scene, leaf=cap) first).

    Leaves are consecutive runs of cap faces (HIER_LEAF static,
    HIER_LEAF_MOTION for a 2-key scene, whose leaves inline both keys);
    each directory level groups consecutive lower nodes in DP-chosen runs
    of at most `fanout` (`_dp_group_sizes`, allow_var) or fixed blocks.
    All-zero faces (the padding of a variable ordering) stay out of the
    leaf boxes. fanout=0 picks 16 with fixed blocks or 20 with DP groups
    by the smaller directory half-area sum of fixed grouping."""
    if num_keys != 1 and num_keys != 2:
        raise ValueError("hier table supports 1 or 2 motion keys; more keys "
                         "take build_hier_table_nkey")
    if fanout == FANOUT32:
        raise NotImplementedError(
            "the bf16-packed 32-wide directories (FANOUT32) are not ported "
            "yet (ROADMAP A17)")
    if fanout not in (0, FANOUT, FANOUT20):
        raise ValueError(f"fanout must be 0 (auto), {FANOUT} or {FANOUT20}")
    cap = HIER_LEAF if num_keys == 1 else HIER_LEAF_MOTION
    f = num_faces
    n_leaf = max(1, -(-f // cap))
    f_pad = n_leaf * cap

    def key_comp(key):
        v0 = np.asarray(geom.v0[key][:f], np.float32)
        e1 = np.asarray(geom.e1[key][:f], np.float32)
        e2 = np.asarray(geom.e2[key][:f], np.float32)
        comp = np.zeros((9, f_pad), np.float32)
        comp[0:3, :f] = v0.T
        comp[3:6, :f] = e1.T
        comp[6:9, :f] = e2.T
        tris = (comp.reshape(9, n_leaf, cap).transpose(1, 0, 2)
                .reshape(n_leaf, 9 * cap))
        return tris, v0, e1, e2

    def face_boxes(v0, e1, e2):
        return (np.minimum(np.minimum(v0, v0 + e1), v0 + e2),
                np.maximum(np.maximum(v0, v0 + e1), v0 + e2))

    def all_zero(v0, e1, e2):
        return ((np.abs(v0).sum(1) == 0) & (np.abs(e1).sum(1) == 0)
                & (np.abs(e2).sum(1) == 0))

    leaf_tris, v0, e1, e2 = key_comp(0)
    lo_f = np.full((f_pad, 3), _BIG, np.float32)
    hi_f = np.full((f_pad, 3), -_BIG, np.float32)
    lo_f[:f], hi_f[:f] = face_boxes(v0, e1, e2)
    fake = all_zero(v0, e1, e2)
    if num_keys == 2:
        # the union over both keys bounds every lerped time in [0, 1]
        tris1, v01, e11, e21 = key_comp(1)
        leaf_tris = np.concatenate([leaf_tris, tris1], axis=1)
        lo1, hi1 = face_boxes(v01, e11, e21)
        lo_f[:f] = np.minimum(lo_f[:f], lo1)
        hi_f[:f] = np.maximum(hi_f[:f], hi1)
        fake &= all_zero(v01, e11, e21)
    if fake.any():
        lo_f[:f][fake] = _BIG
        hi_f[:f][fake] = -_BIG
    leaf_lo = lo_f.reshape(n_leaf, cap, 3).min(axis=1)
    leaf_hi = hi_f.reshape(n_leaf, cap, 3).max(axis=1)

    var_dirs = allow_var
    if fanout == 0:
        c16 = _dir_half_area_sum(leaf_lo, leaf_hi, FANOUT)
        c20 = _dir_half_area_sum(leaf_lo, leaf_hi, FANOUT20)
        if c16 <= c20:
            fanout, var_dirs = FANOUT, False
        else:
            fanout = FANOUT20

    levels = _build_levels(leaf_lo, leaf_hi, fanout, var_dirs)[0]
    table, starts, leaf_start = _dir_table(levels, n_leaf, fanout)
    lrows = table[leaf_start:]
    lrows[:, :leaf_tris.shape[1]] = leaf_tris
    lrows[:, _L_FIRST] = cap * np.arange(n_leaf, dtype=np.float32)
    lrows[:, _L_TYPE] = 1.0
    return HierTable(table=torch.as_tensor(table, device=device),
                     level_starts=starts, leaf_start=leaf_start,
                     num_faces=f, fanout=fanout)


def build_hier_table_nkey(geom, num_faces: int, num_keys: int,
                          fanout: int = FANOUT, device="cpu") -> HierTable:
    """N-key piecewise-linear vertex motion (hierwalk.py:390-426 of the
    reference): one 2-key segment table per pair of keys (k, k + 1), built
    at the fixed `fanout` with fixed groups (allow_var=False), so that
    every segment has the same level structure, stacked row-wise. A ray's
    segment is then a row offset (`_seg_select`). Raises ValueError for
    num_keys <= 2 and for fanout 0 (the auto pick could differ between
    segments)."""
    if num_keys <= 2:
        raise ValueError("build_hier_table_nkey needs num_keys > 2")
    if fanout == 0:
        raise ValueError(
            "build_hier_table_nkey requires a fixed fanout (got 0 = auto); "
            "all motion segments must share one level structure")
    tabs = []
    for k in range(num_keys - 1):
        seg = geom._replace(**{name: getattr(geom, name)[k:k + 2] for name in
                               ("v0", "e1", "e2", "n0", "n1", "n2")})
        tabs.append(build_hier_table(seg, num_faces, num_keys=2,
                                     fanout=fanout, allow_var=False))
    t0 = tabs[0]
    if any(t.level_starts != t0.level_starts or t.leaf_start != t0.leaf_start
           for t in tabs[1:]):
        raise AssertionError("segment tables differ in their levels")
    return HierTable(table=torch.cat([t.table for t in tabs]).to(device),
                     level_starts=t0.level_starts, leaf_start=t0.leaf_start,
                     num_faces=num_faces, fanout=t0.fanout,
                     seg_rows=int(t0.table.shape[0]), n_seg=num_keys - 1)


def _seg_select(tab: HierTable, time, r: int, device):
    """(row offset [R] i32, local time [R] f32) of each ray's segment of a
    stacked table (hierwalk.py:429-435): ts = t * n_seg, s = clip(floor(ts),
    0, n_seg - 1), local time ts - s; time None is t = 0."""
    t = torch.broadcast_to(torch.as_tensor(
        0.0 if time is None else time, dtype=torch.float32, device=device),
        (r,))
    ts = t * float(tab.n_seg)
    s = torch.clamp(torch.floor(ts).to(torch.int32), 0, tab.n_seg - 1)
    return s * tab.seg_rows, ts - s.to(torch.float32)


# ------------------------------------------------------- plain arithmetic
def _leaf_mt(rows, o, d, tmin, tcur, time=None):
    """[R, cap] Moller-Trumbore test of each ray against its row's inline
    triangles; o, d [R, 3], tmin/tcur [R, 1]. With `time` [R] the rows hold
    both keys (HIER_LEAF_MOTION) and the raw row floats lerp before the
    test (row lerp == vertex lerp). Returns (t, u, v, hit)."""
    r = rows.shape[0]
    if time is None:
        cap = HIER_LEAF
        tri = rows[:, :9 * cap].reshape(r, 9, cap)
    else:
        cap = HIER_LEAF_MOTION
        t0 = rows[:, :9 * cap]
        t1 = rows[:, 9 * cap:18 * cap]
        tri = (t0 + time[:, None] * (t1 - t0)).reshape(r, 9, cap)
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tcur))
    return t, u, v, hit


def _dir_entries(rows, o, inv, tmin, tcur, fanout: int = FANOUT):
    """[R, fanout] child-box entry distances, _BIG where missed; o, inv
    [R, 3], tmin/tcur [R, 1]. Padding children (lo = hi = +BIG) fail the
    slab test by themselves. Rows of fanout 32 carry bf16-packed boxes."""
    r = rows.shape[0]
    tn = torch.full((r, fanout), -_BIG, dtype=rows.dtype, device=rows.device)
    tf = torch.full((r, fanout), _BIG, dtype=rows.dtype, device=rows.device)
    if fanout == FANOUT32:
        u = rows[:, :3 * FANOUT32].contiguous().view(torch.int32)
    for c in range(3):
        if fanout == FANOUT32:
            # the bf16 -> f32 widenings of the packed (lo, hi) halves
            uc = u[:, c * fanout:(c + 1) * fanout]
            lo = (uc << 16).view(torch.float32)
            hi = (uc & -65536).view(torch.float32)
        else:
            lo = rows[:, c * fanout:(c + 1) * fanout]
            hi = rows[:, (c + 3) * fanout:(c + 4) * fanout]
        oc = o[:, c:c + 1]
        ic = inv[:, c:c + 1]
        t0 = (lo - oc) * ic
        t1 = (hi - oc) * ic
        tn = _max0(tn, _min0(t0, t1))
        tf = _min0(tf, _max0(t0, t1))
    ok = (tn <= tf) & (tf > tmin) & (tn < tcur)
    return torch.where(ok, _max0(tn, tmin), torch.full_like(tn, _BIG))


def _min0(a, b):
    """torch.minimum with -0 below +0, as the reference's jnp.minimum
    orders the two zeros (torch keeps one operand when they tie)."""
    return torch.where(a == b, torch.where(torch.signbit(a), a, b),
                       torch.minimum(a, b))


def _max0(a, b):
    """torch.maximum with +0 above -0, as the reference's jnp.maximum."""
    return torch.where(a == b, torch.where(torch.signbit(a), b, a),
                       torch.maximum(a, b))


def _safe_inv(d):
    """1 / d, or _BIG where |d| <= 1e-20 (IEEE division: the divisor is a
    tensor, which CUDA torch does not turn into a reciprocal multiply)."""
    one = torch.ones_like(d)
    return torch.where(torch.abs(d) > 1e-20, one / d,
                       torch.full_like(d, _BIG))


def _prune_cut(best_t):
    """Conservative pruning bound: slab entries and MT hit t round
    differently by ~1 ulp, so the cut is widened by a relative and an
    absolute slack before pending subtrees are discarded."""
    return best_t * 1.00001 + 1e-6


# ------------------------------------------------------ the walk tracers
def _walk(tab, o, d, tmin, tmax, count, any_mode: bool, time=None,
          plain: bool = False, walk_fn=None):
    """Run the walk round (integrate/walkpool.py `walk_rounds`: K9 on a
    CUDA device, its plain version on the CPU or with `plain`; K9-inst
    for an instanced table) to completion over a ray batch, 16 rounds per
    launch. On a stacked N-key table each ray walks its segment
    (`_seg_select`: the row offset in wseg, the local time in wtime).
    walk_fn replaces walk_rounds (same signature). Returns the final walk
    state."""
    from ..integrate.walkpool import new_walk_state, walk_rounds

    walk_fn = walk_fn or walk_rounds

    r = o.shape[0]
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (r,))
    tmax = torch.broadcast_to(torch.as_tensor(tmax, **f32), (r,))
    live = torch.arange(r, device=dev) < (r if count is None else int(count))
    s = new_walk_state(r, tab.n_levels, tab.fanout, 0, 16, dev)
    s.ray.copy_(torch.cat([o.to(torch.float32), d.to(torch.float32),
                           tmin[:, None], tmax[:, None]], dim=1))
    # an instanced walk starts in world space
    s.o_cur.copy_(s.ray[:, 0:3])
    s.d_cur.copy_(s.ray[:, 3:6])
    if getattr(tab, "n_seg", 1) > 1:
        seg_off, time = _seg_select(tab, time, r, dev)
        s.wseg.copy_(seg_off)
    if time is not None:
        s.wtime.copy_(torch.broadcast_to(torch.as_tensor(time, **f32), (r,)))
    s.cur.copy_(torch.where(live, 0, -1).to(torch.int32))
    s.wmode.fill_(any_mode)
    s.wb_t.copy_(tmax)
    motion = time is not None
    while bool((s.cur >= 0).any()):
        walk_fn(s, tab, motion, 16, plain=plain)
    return s


def trace_closest_hier(tab: HierTable, o, d, tmin, tmax, count=None,
                       time=None, plain: bool = False) -> Hit:
    """Closest hit by the hierarchical walk (only the first `count` rays
    are live). time [R] selects the 2-key leaf layout (on a stacked N-key
    table, the segment and its local time)."""
    s = _walk(tab, o, d, tmin, tmax, count, False, time, plain)
    valid = (s.wb_prim >= 0) & (s.wb_prim < tab.num_faces)
    zero = torch.zeros_like(s.wb_u)
    return Hit(t=torch.where(valid, s.wb_t, s.ray[:, 7]),
               prim=torch.where(valid, s.wb_prim, -1),
               u=torch.where(valid, s.wb_u, zero),
               v=torch.where(valid, s.wb_v, zero))


def trace_any_hier(tab: HierTable, o, d, tmin, tmax, count=None, time=None,
                   plain: bool = False) -> torch.Tensor:
    """Occlusion [R] bool by the hierarchical walk."""
    return _walk(tab, o, d, tmin, tmax, count, True, time, plain).wfound


def make_hierwalk_tracer(scene, device, plain: bool = False):
    """(closest, any_hit) over the hierarchical walk of a scene of any
    number of keys (hierwalk.py:709-741 of the reference), each f(o, d,
    tmin, tmax, time, count=None); a motion scene walks at each ray's time
    (0 when time is None), a scene of more than 2 keys on the stacked
    segment tables of build_hier_table_nkey. Order the scene with
    split_order_scene(scene, leaf=HIER_LEAF or HIER_LEAF_MOTION) first.
    The walk is K9 on a CUDA device, its plain version on the CPU or with
    `plain`. The table is `closest.table`."""
    if scene.num_keys > 2:
        tab = build_hier_table_nkey(scene.geom, scene.num_faces,
                                    scene.num_keys, device=device)
    else:
        tab = build_hier_table(scene.geom, scene.num_faces,
                               num_keys=scene.num_keys, device=device)
    motion = scene.num_keys >= 2

    def time_col(time, o):
        if not motion:
            return None
        return torch.broadcast_to(torch.as_tensor(
            0.0 if time is None else time, dtype=torch.float32,
            device=o.device), (o.shape[0],))

    def closest(o, d, tmin, tmax, time=None, count=None):
        return trace_closest_hier(tab, o, d, tmin, tmax, count,
                                  time_col(time, o), plain)

    def any_hit(o, d, tmin, tmax, time=None, count=None):
        return trace_any_hier(tab, o, d, tmin, tmax, count,
                              time_col(time, o), plain)

    closest.table = tab
    return closest, any_hit
