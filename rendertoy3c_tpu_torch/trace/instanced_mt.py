"""Two-level (instance -> mesh) Moller-Trumbore tracers for static
trace-time instanced scenes (K7).

Port of rendertoy3c_tpu/trace/pallas_instanced.py: `build_instanced_soup`
(:45), the instance sweep `_instance_sweep` (:76) with its closest and
any-hit updates `_closest_update` (:162) and `_any_update` (:182), the
kernel `_make_kernel` (:189) launched by `_trace_instanced` (:236), and
`make_pallas_instanced_tracer` (:266) as `make_instanced_mt_tracer`.

The plain version and the kernel cull ray by ray: a live ray (its
256-ray tile before `count`, tmax > tmin) walks the instances in table
order and enters one when its own slab test of the instance's world box,
padded by BOX_PAD of the box's size and place as trace/mt.py `_slabs`
pads a tile's box (`padded_boxes`, once at build), admits it, bounded by
its best t so far (closest) or its tmax (any-hit, until its first hit).
An entering ray moves into the instance's object space (the direction is
not normalized, so t stays world-parametric) and tests the mesh's
128-face tiles in order, each only up to its real face count
(`InstancedSoup.tile_faces`: the trailing all-zero padding of
INST_FACE_ALIGN never hits). The reference's 256-ray tile instead enters
an instance when any of its rays' unpadded tests admits it and tests
every face; culling only skips (ray, instance) pairs with no hit and
trimming only faces that never hit, so the hits are the reference's, bit
for bit, on rays within the argument's range (the argument, and where
raw rows differ: a ray with tmax above 1e30 that hits nothing, and the
pool's unread shadow rays of lanes that missed, starting 1e16 away, in
kernels/csrc/instanced_mt.cu).

`trace_instanced` takes packed rays [R, 8] (R a multiple of 256) and a
live-ray `count` (int32 [1]) and returns [R, 8]: closest (t, prim, u, v,
instance, 0, 0, 0), prim and instance as floats, miss = (tmax, -1, 0, 0,
-1); any-hit (occluded, 0, ...). On a CUDA tensor it launches the
hand-written kernel (kernels/csrc/instanced_mt.cu); on a CPU tensor it
runs `trace_instanced_ref`, the plain PyTorch version of the same
function.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build as kbuild
from ..scene.instanced import INST_FACE_ALIGN
from .intersect import Hit
from .mt import (BOX_PAD, RAY_TILE, _count_tensor, live_rows, mt_test,
                 pack_rays)

# the instanced triangle tile: one mesh tile of the object-space soup
ITILE = INST_FACE_ALIGN
_BIG = 1e30


class InstancedSoup(NamedTuple):
    """The object-space soup and instance table of a static instanced
    scene (on one device)."""

    tris: torch.Tensor  # [F/ITILE, 9, ITILE] f32: v0.xyz e1.xyz e2.xyz
    table: torch.Tensor  # [I, 20] f32: world->object 0:12, box 12:18
    tile_ranges: tuple  # per mesh: (first tile, tile count)
    inst_tiles: torch.Tensor  # [I, 2] int32: each instance's mesh tiles
    cull: torch.Tensor  # [I, 8] f32: padded box lo - pad, pad, hi + pad, ok
    tile_faces: torch.Tensor  # [F/ITILE] int32: each tile's real faces
    num_faces: int  # stored (padded) faces


def _soup_arrays(iscene):
    """(tiles, table, tile_ranges) as numpy, laid out as the reference's
    build_instanced_soup (:45-73)."""
    v0 = np.asarray(iscene.geom.v0[0])
    e1 = np.asarray(iscene.geom.e1[0])
    e2 = np.asarray(iscene.geom.e2[0])
    f = v0.shape[0]
    if f % ITILE:
        raise ValueError("mesh ranges are INST_FACE_ALIGN-padded")
    soup = np.zeros((9, f), np.float32)
    soup[0:3] = v0.T
    soup[3:6] = e1.T
    soup[6:9] = e2.T
    tiled = soup.reshape(9, f // ITILE, ITILE).transpose(1, 0, 2)
    inst = iscene.instances
    n_inst = iscene.num_instances
    table = np.zeros((n_inst, 20), np.float32)
    table[:, 0:12] = np.asarray(inst.minv)[:, 0].reshape(n_inst, 12)
    table[:, 12:15] = np.asarray(inst.aabb_lo)
    table[:, 15:18] = np.asarray(inst.aabb_hi)
    tile_ranges = tuple((start // ITILE, cnt // ITILE)
                        for start, cnt in iscene.mesh_ranges)
    return np.ascontiguousarray(tiled), table, tile_ranges


def padded_boxes(table: np.ndarray) -> np.ndarray:
    """[I, 8] f32: each instance's world box grown by BOX_PAD of its size
    and place on every side as trace/mt.py `_slabs` grows a tile's box:
    (lo - pad, pad, hi + pad, 1 if lo <= hi on every axis else 0)."""
    lo, hi = table[:, 12:15], table[:, 15:18]
    size = np.maximum(hi - lo, np.maximum(np.abs(lo), np.abs(hi)))
    pad = np.float32(BOX_PAD) * (np.float32(1.0) + size.max(axis=1))
    out = np.zeros((table.shape[0], 8), np.float32)
    out[:, 0:3] = lo - pad[:, None]
    out[:, 3] = pad
    out[:, 4:7] = hi + pad[:, None]
    out[:, 7] = (lo <= hi).all(axis=1)
    return out


def real_faces(tiles: np.ndarray) -> np.ndarray:
    """[T] int32: each tile's real faces, 1 + the index of its last face
    whose 9 floats are not all zero (0 for an all-zero tile)."""
    nz = (tiles != 0).any(axis=1)  # [T, ITILE]
    last = tiles.shape[2] - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


def build_instanced_soup(iscene, device) -> InstancedSoup:
    """The object-space soup [F/ITILE, 9, ITILE], the instance table
    [I, 20], the per-mesh tile ranges, the padded instance boxes and each
    tile's real face count, as tensors on `device`."""
    tiles, table, tile_ranges = _soup_arrays(iscene)
    inst_tiles = np.asarray([tile_ranges[m] for m in iscene.instance_mesh],
                            np.int32).reshape(-1, 2)
    return InstancedSoup(
        tris=torch.as_tensor(tiles, device=device),
        table=torch.as_tensor(table, device=device),
        tile_ranges=tile_ranges,
        inst_tiles=torch.as_tensor(inst_tiles, device=device),
        cull=torch.as_tensor(padded_boxes(table), device=device),
        tile_faces=torch.as_tensor(real_faces(tiles), device=device),
        num_faces=int(iscene.num_faces))


def trace_instanced_ref(rays: torch.Tensor, count: torch.Tensor,
                        soup: InstancedSoup, any_hit: bool = False,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain version of K7: rays [R, 8] (R a multiple of 256) -> [R, 8] as
    `trace_instanced`. The instances run in table order; a live ray enters
    an instance when its own padded slab test admits it, bounded by its
    best t so far (closest) or its tmax (any-hit, until its first hit),
    and tests
    the instance's mesh tiles in order up to each tile's real faces, each
    tile bounded by the ray's best t when the tile starts.

    `stats`, a dict, receives the work of the launch: `live` rays (each
    tests every instance box), the (ray, instance) `pairs` the cull admits
    (each a transform), the MT `tests` they need (closest: every real face
    of each entered mesh; any-hit: up to the ray's first hit), the
    (ray, tile) `visits` and the `real_faces` those tiles hold (of 128
    each stored), the `faces_read` of the tiles some ray visits, and the
    `vote_pairs` the reference's 256-ray vote admits (every row of a live
    tile in which some row's unpadded test, bounded as above, admits the
    instance)."""
    r = rays.shape[0]
    dev = rays.device
    o, d = rays[:, 0:3], rays[:, 3:6]
    tmin, tmax = rays[:, 6], rays[:, 7]
    tab = soup.table
    # each ray's padded slab test of every instance box at once, [R, I]
    entered, tn, pad = _padded_slabs(rays, soup.cull)
    live_tile = live_rows(r, count)
    todo = live_tile & (tmax > tmin)
    faces = soup.tile_faces.tolist()
    best_t = tmax.clone()
    best = torch.zeros((r, 4), dtype=torch.float32, device=dev)
    best[:, 0] = -1.0  # prim
    best[:, 3] = -1.0  # instance
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    if stats is not None:
        vote = _vote_slabs(rays, tab)
        work = dict(live=int(todo.sum()), pairs=0, tests=0, visits=0,
                    real_faces=0, faces_read=0, vote_pairs=0)
        read = set()
    for i, (start, n_tiles) in enumerate(soup.inst_tiles.tolist()):
        tcur = tmax if any_hit else best_t
        own = todo & entered[:, i] & (tn[:, i] <= tcur + pad[i]) & ~occ
        if stats is not None:
            votes = (vote[0][:, i] & (vote[1][:, i] <= tcur)).view(
                -1, RAY_TILE).any(dim=1) & live_tile.view(-1, RAY_TILE)[:, 0]
            work["vote_pairs"] += RAY_TILE * int(votes.sum())
        idx = own.nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        m = tab[i, 0:12]
        ox, oy, oz = o[idx, 0:1], o[idx, 1:2], o[idx, 2:3]
        dx, dy, dz = d[idx, 0:1], d[idx, 1:2], d[idx, 2:3]
        obj = (m[0] * ox + m[1] * oy + m[2] * oz + m[3],
               m[4] * ox + m[5] * oy + m[6] * oz + m[7],
               m[8] * ox + m[9] * oy + m[10] * oz + m[11],
               m[0] * dx + m[1] * dy + m[2] * dz,
               m[4] * dx + m[5] * dy + m[6] * dz,
               m[8] * dx + m[9] * dy + m[10] * dz)
        tmin_c = tmin[idx, None]
        if stats is not None:
            work["pairs"] += idx.numel()
        for k in range(start, start + n_tiles):
            nf = faces[k]
            if nf == 0:
                continue
            if any_hit:  # a ray occluded in an earlier tile stops
                keep = ~occ[idx]
                idx, obj, tmin_c = idx[keep], tuple(c[keep] for c in obj), \
                    tmin_c[keep]
                if idx.numel() == 0:
                    break
            bound = (tmax if any_hit else best_t)[idx, None]
            t, u, v, hit, prim_f = mt_test(obj + (tmin_c, bound),
                                           soup.tris[k][:, :nf], k * ITILE)
            if stats is not None:
                work["visits"] += idx.numel()
                work["real_faces"] += idx.numel() * nf
                read.add(k)
                if any_hit:
                    first = torch.where(hit.any(dim=1),
                                        hit.int().argmax(dim=1) + 1, nf)
                    work["tests"] += int(first.sum())
                else:
                    work["tests"] += idx.numel() * nf
            if any_hit:
                occ[idx] |= hit.any(dim=1)
                continue
            # _closest_update (:162-179): the tile's min t, the lowest
            # prim at it, u and v through masked sums
            t = torch.where(hit, t, _BIG)
            t_c = t.amin(dim=1, keepdim=True)
            at_min = t <= t_c
            prim_c = torch.where(at_min, prim_f, _BIG).amin(
                dim=1, keepdim=True)
            one = at_min & (prim_f == prim_c)
            u_c = torch.where(one, u, 0.0).sum(dim=1)
            v_c = torch.where(one, v, 0.0).sum(dim=1)
            better = t_c[:, 0] < best_t[idx]
            best_t[idx] = torch.where(better, t_c[:, 0], best_t[idx])
            got = torch.stack([prim_c[:, 0], u_c, v_c,
                               torch.full_like(u_c, float(i))], dim=1)
            best[idx] = torch.where(better[:, None], got, best[idx])
    if stats is not None:
        work["faces_read"] = sum(faces[k] for k in read)
        stats.update(work)
    out = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    if any_hit:
        out[:, 0] = occ.to(torch.float32)
    else:
        out[:, 0] = best_t
        out[:, 1:5] = best
    return out


def _padded_slabs(rays, cull):
    """(entered [R, I], tn [R, I], pad [I]): each ray's slab test of every
    padded instance box (`padded_boxes`), before the bound by the ray's
    current t, in the kernel's float order."""
    o, d, tmin = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.full_like(d, _BIG))
    t0 = (cull[None, :, 0:3] - o[:, None]) * inv[:, None]
    t1 = (cull[None, :, 4:7] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=2)
    tf = torch.maximum(t0, t1).amin(dim=2)
    pad = cull[:, 3]
    entered = ((cull[:, 7] != 0)[None] & (tn <= tf)
               & (tf >= tmin[:, None] - pad[None]))
    return entered, tn, pad


def _vote_slabs(rays, tab):
    """(ok [R, I], tn [R, I]): the reference's unpadded slab test of every
    instance box (_instance_sweep :109-121), before the bound by the ray's
    current t."""
    o, d, tmin = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.full_like(d, _BIG))
    t0 = (tab[None, :, 12:15] - o[:, None]) * inv[:, None]
    t1 = (tab[None, :, 15:18] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(dim=2)
    tf = torch.maximum(t0, t1).amin(dim=2)
    return (tn <= tf) & (tf >= tmin[:, None]), tn


def trace_instanced(rays: torch.Tensor, count: torch.Tensor,
                    soup: InstancedSoup,
                    any_hit: bool = False) -> torch.Tensor:
    """K7 wrapper: the CUDA kernel for CUDA rays
    (kernels/csrc/instanced_mt.cu `instanced_mt_kernel<kAny>`),
    `trace_instanced_ref` on the CPU. Counts one launch per call in
    `trace_instanced.launches` (closest) and `.any_launches`."""
    if rays.device.type == "cpu":
        return trace_instanced_ref(rays, count, soup, any_hit)
    kbuild.require_cuda("instanced_mt", rays, soup.tris, soup.table,
                        soup.cull)
    kbuild.require_cuda("instanced_mt", count, soup.inst_tiles,
                        soup.tile_faces, dtype=torch.int32)
    r = rays.shape[0]
    if rays.ndim != 2 or rays.shape[1] != 8 or r % RAY_TILE:
        raise ValueError("instanced_mt: rays must be [R, 8] with R a "
                         "multiple of 256")
    n_inst = soup.table.shape[0]
    if (soup.tris.shape[1:] != (9, ITILE) or soup.table.shape[1] != 20
            or soup.cull.shape != (n_inst, 8)
            or soup.tile_faces.shape != soup.tris.shape[:1]):
        raise ValueError("instanced_mt: soup [T, 9, 128], table [I, 20], "
                         "cull [I, 8], tile_faces [T]")
    out = torch.empty((r, 8), dtype=torch.float32, device=rays.device)
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_instanced_mt(
        index, int(any_hit), rays.data_ptr(), r, count.data_ptr(),
        soup.tris.data_ptr(), soup.table.data_ptr(),
        soup.inst_tiles.data_ptr(), soup.cull.data_ptr(),
        soup.tile_faces.data_ptr(), n_inst, out.data_ptr(), stream)
    kbuild.check(err, "instanced_mt_any" if any_hit else "instanced_mt")
    if any_hit:
        trace_instanced.any_launches += 1
    else:
        trace_instanced.launches += 1
    return out


trace_instanced.launches = 0  # K7 closest
trace_instanced.any_launches = 0  # K7 any-hit


def make_instanced_mt_tracer(iscene, device, plain: bool = False):
    """(closest, any_hit) over K7 for a static instanced scene, each called
    as f(o, d, tmin, tmax, time, count=None) (time ignored): closest gives
    a Hit with the instance. plain=True runs the plain version on any
    device. A scene of more than one key raises ValueError, as the
    reference does."""
    if iscene.num_keys != 1:
        raise ValueError("pallas instanced tracer supports static scenes; "
                         "matrix motion uses the jnp instanced tracer")
    soup = build_instanced_soup(iscene, torch.device(device))
    fn = trace_instanced_ref if plain else trace_instanced
    num_faces = soup.num_faces

    def run(o, d, tmin, tmax, count, any_hit):
        rays, r = pack_rays(o, d, tmin, tmax)
        c = _count_tensor(count, r, o.device)
        return fn(rays, c, soup, any_hit)[:r], rays[:r, 7]

    def closest(o, d, tmin, tmax, time=None, count=None):
        out, tmax_r = run(o, d, tmin, tmax, count, False)
        t, prim_f = out[:, 0], out[:, 1]
        valid = (prim_f >= 0.0) & (prim_f < num_faces) & (t < _BIG)
        zero = torch.zeros_like(t)
        none = torch.full_like(prim_f, -1).to(torch.int32)
        return Hit(t=torch.where(valid, t, tmax_r),
                   prim=torch.where(valid, prim_f.to(torch.int32), none),
                   u=torch.where(valid, out[:, 2], zero),
                   v=torch.where(valid, out[:, 3], zero),
                   inst=torch.where(valid, out[:, 4].to(torch.int32), none))

    def any_hit(o, d, tmin, tmax, time=None, count=None):
        return run(o, d, tmin, tmax, count, True)[0][:, 0] > 0.0

    closest.soup = soup
    return closest, any_hit
