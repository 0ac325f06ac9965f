"""Dense Moller-Trumbore tracers over a tiled triangle soup (K1/K2, K3).

Port of rendertoy3c_tpu/trace/pallas_mt.py: `build_tri_soup` (:70), the
static closest/any kernels `_closest_kernel` (:256) and `_any_kernel`
(:302) with their entry points `trace_closest_mt` (:382) and
`trace_any_mt` (:408); the 2-key motion kernels `_closest_kernel_motion`
(:545) and `_any_kernel_motion` (:593) with `motion_union_aabbs` (:488),
`_motion_cull_tables` (:620) and the entry points `trace_closest_mt_motion`
(:693) and `trace_any_mt_motion` (:715); and `make_pallas_mt_tracer`
(:420) as `make_mt_tracer`.

`mt_closest` / `mt_any` take packed rays [R, 8] (o, d, tmin, tmax; R a
multiple of 256) and a live-ray `count` (int32 [1] on the rays' device) and
return [R, 4]. On a CUDA tensor they launch the hand-written kernels
(kernels/csrc/mt_kernels.cu); on a CPU tensor they run `closest_ref` /
`any_ref`, the plain PyTorch versions of the same function. Ray tiles of
256 at or past `count` skip the sweep and write the miss row.

`mt_closest_motion` / `mt_any_motion` (K3) take the same rays plus a
per-ray time [R] in [0, 1] and lerp each triangle between the key-0 and
key-1 soups, `r0 + (r1 - r0) * time`; they cull by the union of both keys'
boxes and skip ray tiles of 128 (MOTION_RAY_TILE) at or past `count`
(plain versions `closest_motion_ref` / `any_motion_ref`).

Both the kernels and the plain versions cull ray by ray: each ray tests
the tiles whose boxes, padded by BOX_PAD of their size, its own slab test
lets in. The plain versions bound that test by the ray's best hit so far
(or, any-hit, stop at its first hit); the kernels bin each ray into the
lists of the tiles it enters at its tmax (`bin_ref` is that step's plain
version, `mt_bin` runs it alone), then test each tile's list densely and
merge the hits per ray in (t, prim) order. Culling only skips
tiles a ray cannot hit, so both return the hits of a dense sweep of every
tile, bit for bit (each ray's arithmetic is the same whichever rays share a
batch).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build as kbuild
from .intersect import Hit

RAY_TILE = 256
MOTION_RAY_TILE = 128  # the motion kernels' ray tile (pallas_mt.py:485)
TRI_TILE = 512
SUPER_TILE = 8  # tri tiles per supertile (2-level cull)
_BIG = 1e30
_DET_EPS = 1e-10
# the plain sweeps' box padding, relative to a box's size and place: far
# above the rounding of a hit point, so no ray is culled from a tile it hits
BOX_PAD = 1e-3


class TriSoup(NamedTuple):
    """Tiled component-major triangle table (on one device)."""

    tris: torch.Tensor  # [F/CT, 9, CT] f32: v0.xyz e1.xyz e2.xyz x CT
    num_faces: int  # real faces (padding beyond is all-zero, never hit)
    aabb: torch.Tensor  # [ceil8(F/CT), 8] f32 per-tile lo.xyz hi.xyz pad2
    super_aabb: torch.Tensor  # [ceil8(F/CT)/8, 8] f32 supertile boxes


class MotionSoup(NamedTuple):
    """Both keys of a 2-key scene, tiled alike, with union cull boxes."""

    tris0: torch.Tensor  # [F/CT, 9, CT] f32, key 0
    tris1: torch.Tensor  # [F/CT, 9, CT] f32, key 1
    num_faces: int
    aabb: torch.Tensor  # union of both keys' tile boxes
    super_aabb: torch.Tensor  # union of both keys' supertile boxes


def _soup_arrays(geom, key: int = 0, num_faces: int | None = None):
    """(tiles, aabb, super_aabb, num_faces) as numpy, exactly as the
    reference lays them out: the tile width CT is the smallest multiple of
    128 covering a one-tile scene, else 512; empty tiles get an inverted
    box; the box table is padded to a SUPER_TILE multiple."""
    v0 = np.asarray(geom.v0[key])
    e1 = np.asarray(geom.e1[key])
    e2 = np.asarray(geom.e2[key])
    f = v0.shape[0] if num_faces is None else num_faces
    ct = TRI_TILE if f > TRI_TILE else max(128, -(-f // 128) * 128)
    f_pad = -(-f // ct) * ct
    n_copy = min(f_pad, v0.shape[0])
    soup = np.zeros((9, f_pad), np.float32)
    soup[0:3, :n_copy] = v0[:n_copy].T
    soup[3:6, :n_copy] = e1[:n_copy].T
    soup[6:9, :n_copy] = e2[:n_copy].T
    tiled = soup.reshape(9, f_pad // ct, ct).transpose(1, 0, 2)

    n_tiles = f_pad // ct
    n_tiles_pad = -(-n_tiles // SUPER_TILE) * SUPER_TILE
    aabb = np.zeros((n_tiles_pad, 8), np.float32)
    aabb[:, 0:3] = 1e30
    aabb[:, 3:6] = -1e30
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    for k in range(n_tiles):
        s0, s1 = k * ct, min((k + 1) * ct, f)
        if s0 >= f:
            break
        pts = np.concatenate([p0[s0:s1], p1[s0:s1], p2[s0:s1]])
        aabb[k, 0:3] = pts.min(axis=0)
        aabb[k, 3:6] = pts.max(axis=0)
    n_super = n_tiles_pad // SUPER_TILE
    super_aabb = np.zeros((n_super, 8), np.float32)
    grp = aabb.reshape(n_super, SUPER_TILE, 8)
    super_aabb[:, 0:3] = grp[:, :, 0:3].min(axis=1)
    super_aabb[:, 3:6] = grp[:, :, 3:6].max(axis=1)
    return np.ascontiguousarray(tiled), aabb, super_aabb, f


def build_tri_soup(geom, device, key: int = 0,
                   num_faces: int | None = None) -> TriSoup:
    """Transpose and tile the scene's key-`key` triangles into the kernel
    layout, as tensors on `device`."""
    tiles, aabb, super_aabb, f = _soup_arrays(geom, key, num_faces)
    return TriSoup(tris=torch.as_tensor(tiles, device=device), num_faces=f,
                   aabb=torch.as_tensor(aabb, device=device),
                   super_aabb=torch.as_tensor(super_aabb, device=device))


def require_zero_padding(tris: torch.Tensor, num_faces: int) -> None:
    """Raise unless every column of the tiles tris [n_tiles, 9, CT] past
    the first num_faces is zero: the megakernels (K4, K5) stage and test
    only the real faces, which gives the dense sweep's hits only where
    the padding cannot hit (det = 0)."""
    cols = tris.permute(1, 0, 2).reshape(9, -1)
    if bool((cols[:, num_faces:] != 0).any()):
        raise ValueError(f"the soup's columns past its {num_faces} real "
                         "faces are not all zero")


def motion_union_aabbs(soup0: TriSoup, soup1: TriSoup):
    """(aabb, super_aabb) covering both motion keys: a triangle lerped to
    any time in [0, 1] stays inside the union of its endpoint boxes."""
    def union(a, b):
        return torch.cat([torch.minimum(a[:, 0:3], b[:, 0:3]),
                          torch.maximum(a[:, 3:6], b[:, 3:6]), a[:, 6:8]],
                         dim=1)

    return (union(soup0.aabb, soup1.aabb),
            union(soup0.super_aabb, soup1.super_aabb))


def build_motion_soup(geom, device, num_faces: int | None = None
                      ) -> MotionSoup:
    """Both keys' soups and the union cull tables (`_motion_cull_tables`;
    the boxes always exist here, so its cull-disabled branch is not
    needed)."""
    s0 = build_tri_soup(geom, device, key=0, num_faces=num_faces)
    s1 = build_tri_soup(geom, device, key=1, num_faces=num_faces)
    aabb, super_aabb = motion_union_aabbs(s0, s1)
    return MotionSoup(tris0=s0.tris, tris1=s1.tris, num_faces=s0.num_faces,
                      aabb=aabb.contiguous(), super_aabb=super_aabb.contiguous())


def mt_test(cols, tile: torch.Tensor, prim_base: int, tile1=None,
            tcol=None):
    """One Moller-Trumbore block: ray columns (each [R, 1]) against one
    tile [9, CT]. With `tile1` and `tcol` ([R, 1] times) each triangle
    component is lerped per ray, `r0 + (r1 - r0) * t` (`_mt_test_motion`).
    Returns (t, u, v, hit, prim_f), each [R, CT]."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = cols
    if tile1 is None:
        rows = [tile[c][None] for c in range(9)]
    else:
        rows = [tile[c][None] + (tile1[c][None] - tile[c][None]) * tcol
                for c in range(9)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
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
           & (t > tmin) & (t < tmax))
    ct = tile.shape[1]
    prim_f = (prim_base + torch.arange(ct, device=tile.device)).to(
        torch.float32)[None]
    return t, u, v, hit, prim_f


def live_rows(n: int, count: torch.Tensor,
              tile: int = RAY_TILE) -> torch.Tensor:
    """[n] bool: rays whose `tile`-ray tile starts before `count`."""
    tile_start = (torch.arange(n, device=count.device) // tile) * tile
    return tile_start < count.reshape(()).to(torch.int64)


def _slabs(rays, boxes):
    """(entered [R, B], tn [R, B], pad [B]): each ray's own slab test of
    every box padded by `pad` (an empty tile's inverted box enters no ray),
    before the bound by the ray's current t."""
    o, d, tmin = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.full_like(d, _BIG))
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    pad = BOX_PAD * (1.0 + torch.maximum(hi - lo, torch.maximum(
        lo.abs(), hi.abs())).amax(dim=1, keepdim=True))
    t0 = ((lo - pad)[None] - o[:, None]) * inv[:, None]
    t1 = ((hi + pad)[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=2)
    tf = torch.maximum(t0, t1).amin(dim=2)
    pad = pad[:, 0]
    entered = ((lo <= hi).all(dim=1)[None] & (tn <= tf)
               & (tf >= tmin[:, None] - pad[None]))
    return entered, tn, pad


def _culled_sweep(rays, count, tile, n_tiles, aabb, super_aabb, test,
                  any_hit: bool):
    """The plain sweep of a tiled soup, culled ray by ray: live rays (in
    ray tiles of `tile` before `count`, with tmax > tmin) visit, in tile
    order, the super-tiles and tiles whose padded boxes their own slab test
    lets in; test(cols, k, idx) -> (t, u, v, hit, prim_f) of tile k for
    the rays idx. Closest: min t, lowest prim at equal t, the box test
    bounded by the best hit so far; returns [R, 4] (t, prim_f, u, v).
    Any-hit: a ray stops at its first occluding tile; returns [R] bool.

    The slab tests of every ray against every box run in one batch before
    the sweep (the same operations on the same values as one box at a
    time); the sweep then only bounds them by each ray's current t, so a
    launch makes a few operations per tile beside the triangle tests."""
    r = rays.shape[0]
    dev = rays.device
    tmin = rays[:, 6]
    todo = live_rows(r, count, tile) & (rays[:, 7] > tmin)
    best_t = rays[:, 7].clone()
    best = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    best[:, 0] = -1.0  # prim_f, u, v
    occ = torch.zeros(r, dtype=torch.bool, device=dev)

    def own(box, k, among):
        """Rays of `among` that box k's slab test, bounded by their current
        t, lets in."""
        entered, tn, pad = box
        tcur = rays[:, 7] if any_hit else best_t
        return among & entered[:, k] & (tn[:, k] <= tcur + pad[k])

    def visit(k, m):
        idx = m.nonzero()[:, 0]
        if idx.numel() == 0:
            return
        sub = rays[idx]
        t, u, v, hit, prim_f = test(tuple(sub[:, c:c + 1] for c in range(8)),
                                    k, idx)
        if any_hit:
            occ[idx] = hit.any(dim=1)
            return
        t_c, j = torch.min(torch.where(hit, t, _BIG), dim=1)  # first = lowest
        bt = best_t[idx]
        better = t_c < bt
        best_t[idx] = torch.where(better, t_c, bt)
        got = torch.stack([prim_f[0, j], torch.gather(u, 1, j[:, None])[:, 0],
                           torch.gather(v, 1, j[:, None])[:, 0]], dim=1)
        best[idx] = torch.where(better[:, None], got, best[idx])

    tiles, supers = _slabs(rays, aabb[:n_tiles]), _slabs(rays, super_aabb)
    for ks in range(-(-n_tiles // SUPER_TILE)):
        ms = own(supers, ks, todo & ~occ)
        if not bool(ms.any()):
            continue
        for k in range(ks * SUPER_TILE, min((ks + 1) * SUPER_TILE, n_tiles)):
            visit(k, own(tiles, k, ms & ~occ))
    if any_hit:
        return occ
    return torch.cat([best_t[:, None], best], dim=1)


def _closest_out(rays, out, live):
    miss = torch.stack([rays[:, 7], torch.full_like(out[:, 0], -1.0),
                        torch.zeros_like(out[:, 0]),
                        torch.zeros_like(out[:, 0])], dim=1)
    return torch.where(live[:, None], out, miss)


def _any_out(occ, live):
    out = torch.zeros((occ.shape[0], 4), dtype=torch.float32,
                      device=occ.device)
    out[:, 0] = (occ & live).to(torch.float32)
    return out


def _static_test(soup: TriSoup):
    ct = soup.tris.shape[2]
    return lambda cols, k, idx: mt_test(cols, soup.tris[k], k * ct)


def closest_ref(rays: torch.Tensor, count: torch.Tensor,
                soup: TriSoup) -> torch.Tensor:
    """Plain version of K1: [R, 8] rays -> [R, 4] (t, prim_f, u, v), miss =
    (tmax, -1, 0, 0). min t, lowest prim at equal t."""
    out = _culled_sweep(rays, count, RAY_TILE, soup.tris.shape[0], soup.aabb,
                        soup.super_aabb, _static_test(soup), False)
    return _closest_out(rays, out, live_rows(rays.shape[0], count))


def any_ref(rays: torch.Tensor, count: torch.Tensor,
            soup: TriSoup) -> torch.Tensor:
    """Plain version of K2: [R, 8] rays -> [R, 4], column 0 = occluded."""
    occ = _culled_sweep(rays, count, RAY_TILE, soup.tris.shape[0], soup.aabb,
                        soup.super_aabb, _static_test(soup), True)
    return _any_out(occ, live_rows(rays.shape[0], count))


def _motion_test(time: torch.Tensor, msoup: MotionSoup):
    tcol = time[:, None]
    ct = msoup.tris0.shape[2]
    return lambda cols, k, idx: mt_test(cols, msoup.tris0[k], k * ct,
                                        msoup.tris1[k], tcol[idx])


def closest_motion_ref(rays: torch.Tensor, time: torch.Tensor,
                       count: torch.Tensor, msoup: MotionSoup,
                       tile: int = MOTION_RAY_TILE) -> torch.Tensor:
    """Plain version of K3 closest: rays [R, 8] at per-ray times [R] ->
    [R, 4] as closest_ref; ray tiles of `tile` past `count` miss (128 for
    K3, 256 for the motion sweeps inside the megakernels)."""
    out = _culled_sweep(rays, count, tile, msoup.tris0.shape[0], msoup.aabb,
                        msoup.super_aabb, _motion_test(time, msoup), False)
    return _closest_out(rays, out, live_rows(rays.shape[0], count, tile))


def any_motion_ref(rays: torch.Tensor, time: torch.Tensor,
                   count: torch.Tensor, msoup: MotionSoup,
                   tile: int = MOTION_RAY_TILE) -> torch.Tensor:
    """Plain version of K3 any-hit: [R, 4], column 0 = occluded."""
    occ = _culled_sweep(rays, count, tile, msoup.tris0.shape[0], msoup.aabb,
                        msoup.super_aabb, _motion_test(time, msoup), True)
    return _any_out(occ, live_rows(rays.shape[0], count, tile))


def _tiles(table) -> torch.Tensor:
    """The [n_tiles, 9, CT] triangle tiles of a TriSoup, key 0's of a
    MotionSoup."""
    return table.tris0 if isinstance(table, MotionSoup) else table.tris


def bin_ref(rays: torch.Tensor, count: torch.Tensor, table) -> torch.Tensor:
    """Plain version of the kernels' binning: [R, n_tiles] bool, the tiles
    whose lists ray i enters. A live ray (in a ray tile before `count`,
    with tmax > tmin) enters tile k when its own padded slab test, bounded
    by its tmax, lets it into k's supertile and into k (`_culled_sweep`'s
    test, unbounded by any hit)."""
    n_tiles = _tiles(table).shape[0]
    tile = MOTION_RAY_TILE if isinstance(table, MotionSoup) else RAY_TILE
    tmax = rays[:, 7:8]
    live = live_rows(rays.shape[0], count, tile) & (rays[:, 7] > rays[:, 6])
    (te, tn, tp), (se, sn, sp) = (_slabs(rays, table.aabb[:n_tiles]),
                                  _slabs(rays, table.super_aabb))
    tiles = te & (tn <= tmax + tp[None])
    supers = se & (sn <= tmax + sp[None])
    k = torch.arange(n_tiles, device=rays.device)
    return live[:, None] & supers[:, k // SUPER_TILE] & tiles


def workspace_words(r: int, n_tiles: int) -> int:
    """int32 words of a kernel sweep's workspace (laid out in
    kernels/csrc/mt_kernels.cu): R 64-bit hit keys, n_tiles list lengths
    and each tile's list of up to R ray indices (a ray enters a tile's list
    at most once)."""
    return 2 * r + n_tiles + n_tiles * r


_CLOSEST, _ANY, _BIN = 0, 1, 2  # rt3c_mt_sweep's modes


def _launch_sweep(mode: int, rays, count, table, time=None):
    """The kernels' sweep (or, mode _BIN, the binning alone) -> (out [R, 4],
    workspace). `table` is a TriSoup (K1/K2) or a MotionSoup (K3, with
    `time` unless binning)."""
    motion = isinstance(table, MotionSoup)
    name = "mt_motion" if motion else "mt"
    tris0 = _tiles(table)
    tris1 = table.tris1 if motion else None
    kbuild.require_cuda(name, rays, tris0, table.aabb, table.super_aabb,
                        *(t for t in (tris1, time) if t is not None))
    kbuild.require_cuda(name, count, dtype=torch.int32)
    r = rays.shape[0]
    tile = MOTION_RAY_TILE if motion else RAY_TILE
    if (rays.ndim != 2 or rays.shape[1] != 8 or r % tile
            or (time is not None and time.shape != (r,))
            or (motion and time is None and mode != _BIN)):
        raise ValueError(f"{name}: rays [R, 8] with R a multiple of {tile}"
                         + (" and time [R]" if motion else ""))
    n_tiles, _, ct = tris0.shape
    out = torch.empty((r, 4), dtype=torch.float32, device=rays.device)
    ws = torch.empty(workspace_words(r, n_tiles), dtype=torch.int32,
                     device=rays.device)
    index, stream = kbuild.launch_target(rays.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = kbuild.library().rt3c_mt_sweep(
        index, mode, rays.data_ptr(), ptr(time), r, tile, count.data_ptr(),
        tris0.data_ptr(), ptr(tris1), table.aabb.data_ptr(),
        table.super_aabb.data_ptr(), n_tiles, ct, ws.data_ptr(),
        out.data_ptr(), stream)
    kbuild.check(err, name + ("_closest", "_any", "_bin")[mode])
    return out, ws


def mt_bin(rays: torch.Tensor, count: torch.Tensor, table) -> torch.Tensor:
    """The kernels' binning alone: [n_tiles] int32, the length of each
    tile's ray list. The CUDA kernel for CUDA rays, `bin_ref` on the CPU."""
    if rays.device.type == "cpu":
        return bin_ref(rays, count, table).sum(dim=0, dtype=torch.int32)
    n_tiles = _tiles(table).shape[0]
    r = rays.shape[0]
    ws = _launch_sweep(_BIN, rays, count, table)[1]
    mt_bin.launches += 1
    return ws[2 * r:2 * r + n_tiles]


def mt_closest(rays: torch.Tensor, count: torch.Tensor,
               soup: TriSoup) -> torch.Tensor:
    """K1 wrapper: the CUDA kernels for CUDA rays, `closest_ref` on the CPU."""
    if rays.device.type == "cpu":
        return closest_ref(rays, count, soup)
    out = _launch_sweep(_CLOSEST, rays, count, soup)[0]
    mt_closest.launches += 1
    return out


def mt_any(rays: torch.Tensor, count: torch.Tensor,
           soup: TriSoup) -> torch.Tensor:
    """K2 wrapper: the CUDA kernels for CUDA rays, `any_ref` on the CPU."""
    if rays.device.type == "cpu":
        return any_ref(rays, count, soup)
    out = _launch_sweep(_ANY, rays, count, soup)[0]
    mt_any.launches += 1
    return out


def mt_closest_motion(rays: torch.Tensor, time: torch.Tensor,
                      count: torch.Tensor, msoup: MotionSoup) -> torch.Tensor:
    """K3 closest wrapper: the CUDA kernels for CUDA rays,
    `closest_motion_ref` on the CPU."""
    if rays.device.type == "cpu":
        return closest_motion_ref(rays, time, count, msoup)
    out = _launch_sweep(_CLOSEST, rays, count, msoup, time)[0]
    mt_closest_motion.launches += 1
    return out


def mt_any_motion(rays: torch.Tensor, time: torch.Tensor,
                  count: torch.Tensor, msoup: MotionSoup) -> torch.Tensor:
    """K3 any-hit wrapper: the CUDA kernels for CUDA rays, `any_motion_ref`
    on the CPU."""
    if rays.device.type == "cpu":
        return any_motion_ref(rays, time, count, msoup)
    out = _launch_sweep(_ANY, rays, count, msoup, time)[0]
    mt_any_motion.launches += 1
    return out


mt_bin.launches = 0
mt_closest.launches = 0
mt_any.launches = 0
mt_closest_motion.launches = 0
mt_any_motion.launches = 0


def pack_rays(o, d, tmin, tmax, tile: int = RAY_TILE):
    """[R, 3] o/d + scalar or [R] tmin/tmax -> ([R_pad, 8] rays, R), R_pad
    a multiple of `tile`."""
    r = o.shape[0]
    r_pad = -(-r // tile) * tile
    opts = dict(dtype=torch.float32, device=o.device)
    tmin = torch.as_tensor(tmin, **opts).expand(r)
    tmax = torch.as_tensor(tmax, **opts).expand(r)
    rays = torch.zeros((r_pad, 8), **opts)  # padding rays: d = 0, no hits
    rays[:r, 0:3] = o
    rays[:r, 3:6] = d
    rays[:r, 6] = tmin
    rays[:r, 7] = tmax
    return rays, r


def _count_tensor(count, r, device):
    if isinstance(count, torch.Tensor):
        return count.reshape(1).to(device=device, dtype=torch.int32)
    return torch.as_tensor([r if count is None else count],
                           dtype=torch.int32, device=device)


def _to_hit(out, rays, r, num_faces) -> Hit:
    out = out[:r]
    t, prim_f = out[:, 0], out[:, 1]
    # hits on padding faces (prim >= num_faces) count as misses
    valid = (prim_f >= 0.0) & (prim_f < num_faces) & (t < _BIG)
    zero = torch.zeros_like(t)
    return Hit(t=torch.where(valid, t, rays[:r, 7]),
               prim=torch.where(valid, prim_f.to(torch.int32),
                                torch.full_like(prim_f, -1).to(torch.int32)),
               u=torch.where(valid, out[:, 2], zero),
               v=torch.where(valid, out[:, 3], zero))


def _trace(fn, table, o, d, tmin, tmax, count, time):
    """Pack the rays (and times, for a motion table) and launch fn."""
    tile = RAY_TILE if time is None else MOTION_RAY_TILE
    rays, r = pack_rays(o, d, tmin, tmax, tile)
    c = _count_tensor(count, r, o.device)
    if time is None:
        return fn(rays, c, table), rays, r
    t = _pack_time(time, r, rays.shape[0], o.device)
    return fn(rays, t, c, table), rays, r


def _closest(fn, table, o, d, tmin, tmax, count, time=None) -> Hit:
    out, rays, r = _trace(fn, table, o, d, tmin, tmax, count, time)
    return _to_hit(out, rays, r, table.num_faces)


def _any(fn, table, o, d, tmin, tmax, count, time=None) -> torch.Tensor:
    out, _, r = _trace(fn, table, o, d, tmin, tmax, count, time)
    return out[:r, 0] > 0.0


def _pack_time(time, r, r_pad, device):
    t = torch.zeros(r_pad, dtype=torch.float32, device=device)
    t[:r] = torch.as_tensor(time, dtype=torch.float32, device=device)
    return t


def trace_closest_mt(soup: TriSoup, o, d, tmin, tmax, *, count=None) -> Hit:
    """Closest hit over the soup; only the first `count` rays are live."""
    return _closest(mt_closest, soup, o, d, tmin, tmax, count)


def trace_any_mt(soup: TriSoup, o, d, tmin, tmax, *, count=None):
    """Any-hit occlusion over the soup -> [R] bool."""
    return _any(mt_any, soup, o, d, tmin, tmax, count)


def trace_closest_mt_motion(msoup: MotionSoup, o, d, tmin, tmax, time, *,
                            count=None) -> Hit:
    """Closest hit over the 2-key soup at per-ray times in [0, 1]."""
    return _closest(mt_closest_motion, msoup, o, d, tmin, tmax, count, time)


def trace_any_mt_motion(msoup: MotionSoup, o, d, tmin, tmax, time, *,
                        count=None):
    """Any-hit occlusion over the 2-key soup -> [R] bool."""
    return _any(mt_any_motion, msoup, o, d, tmin, tmax, count, time)


def make_mt_tracer(scene, device, plain: bool = False):
    """(closest, any_hit) over the MT kernels, each called as
    f(o, d, tmin, tmax, time, count=None): K1/K2 for a static scene (time
    ignored), K3 for a 2-key scene. Only the real faces enter the soup.
    plain=True runs the kernels' plain versions on any device. More than
    2 keys raise ValueError, as the reference's make_pallas_mt_tracer
    (pallas_mt.py:430-432): such scenes take the brute tracer
    (trace/intersect.py) or the stacked hierwalk."""
    if scene.num_keys > 2:
        raise ValueError(
            "the MT tracer supports <= 2 motion keys; use the brute tracer")
    device = torch.device(device)
    if scene.num_keys == 2:
        table = build_motion_soup(scene.geom, device,
                                  num_faces=scene.num_faces)
        fns = ((closest_motion_ref, any_motion_ref) if plain
               else (mt_closest_motion, mt_any_motion))
    else:
        table = build_tri_soup(scene.geom, device, num_faces=scene.num_faces)
        fns = (closest_ref, any_ref) if plain else (mt_closest, mt_any)
    motion = scene.num_keys == 2

    def closest(o, d, tmin, tmax, time, count=None):
        return _closest(fns[0], table, o, d, tmin, tmax, count,
                        time if motion else None)

    def any_hit(o, d, tmin, tmax, time, count=None):
        return _any(fns[1], table, o, d, tmin, tmax, count,
                    time if motion else None)

    return closest, any_hit
