"""Two-level (instance -> mesh) Moller-Trumbore tracers for static
trace-time instanced scenes (K7).

Port of rendertoy3c_tpu/trace/pallas_instanced.py: `build_instanced_soup`
(:45), the instance sweep `_instance_sweep` (:76) with its closest and
any-hit updates `_closest_update` (:162) and `_any_update` (:182), the
kernel `_make_kernel` (:189) launched by `_trace_instanced` (:236), and
`make_pallas_instanced_tracer` (:266) as `make_instanced_mt_tracer`.

Per 256-ray tile (RAY_TILE) and per instance, in table order, every ray
of the tile slab-tests the instance's world box, bounded by its current
best t (closest) or its tmax (any-hit). When no ray of the tile enters
the box, the tile skips the instance; otherwise every ray of the tile
moves into the instance's object space (the direction is not
normalized, so t stays world-parametric) and tests every 128-face tile
of the instance's mesh. The vote counts every row of the tile, padding
rows and live rows past `count` among them; only a tile at or past
`count` skips the sweep whole and writes the initial row.

`trace_instanced` takes packed rays [R, 8] (R a multiple of 256) and a
live-ray `count` (int32 [1]) and returns [R, 8]: closest (t, prim, u, v,
instance, 0, 0, 0), prim and instance as floats, miss = (tmax, -1, 0, 0,
-1); any-hit (occluded, 0, ...). On a CUDA tensor it launches the
hand-written kernel (kernels/csrc/instanced_mt.cu); on a CPU tensor it
runs `trace_instanced_ref`, the plain PyTorch version of the same
function, tile vote included.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build as kbuild
from ..scene.instanced import INST_FACE_ALIGN
from .intersect import Hit
from .mt import RAY_TILE, _count_tensor, live_rows, mt_test, pack_rays

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


def build_instanced_soup(iscene, device) -> InstancedSoup:
    """The object-space soup [F/ITILE, 9, ITILE], the instance table
    [I, 20] and the per-mesh tile ranges, as tensors on `device`."""
    tiles, table, tile_ranges = _soup_arrays(iscene)
    inst_tiles = np.asarray([tile_ranges[m] for m in iscene.instance_mesh],
                            np.int32).reshape(-1, 2)
    return InstancedSoup(
        tris=torch.as_tensor(tiles, device=device),
        table=torch.as_tensor(table, device=device),
        tile_ranges=tile_ranges,
        inst_tiles=torch.as_tensor(inst_tiles, device=device),
        num_faces=int(iscene.num_faces))


def trace_instanced_ref(rays: torch.Tensor, count: torch.Tensor,
                        soup: InstancedSoup,
                        any_hit: bool = False) -> torch.Tensor:
    """Plain version of K7: rays [R, 8] (R a multiple of 256) -> [R, 8] as
    `trace_instanced`. The instances run in table order; per instance the
    256-ray tiles vote as the kernel's blocks do, and the rays of every
    live tile that voted test the instance's mesh tiles in order, each
    tile bounded by the ray's best t when the tile starts (closest) or its
    tmax (any-hit)."""
    r = rays.shape[0]
    dev = rays.device
    o, d = rays[:, 0:3], rays[:, 3:6]
    tmin, tmax = rays[:, 6], rays[:, 7]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d,
                      torch.full_like(d, _BIG))
    tab = soup.table
    # the slab tests of every ray against every instance box at once
    # (_instance_sweep :109-121), [R, I]
    t0 = [(tab[None, :, 12 + c] - o[:, c:c + 1]) * inv[:, c:c + 1]
          for c in range(3)]
    t1 = [(tab[None, :, 15 + c] - o[:, c:c + 1]) * inv[:, c:c + 1]
          for c in range(3)]
    tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                     torch.minimum(t0[1], t1[1])),
                       torch.minimum(t0[2], t1[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                     torch.maximum(t0[1], t1[1])),
                       torch.maximum(t0[2], t1[2]))
    ok_static = (tn <= tf) & (tf >= tmin[:, None])
    live_tile = live_rows(r, count).view(-1, RAY_TILE)[:, 0]
    best_t = tmax.clone()
    best = torch.zeros((r, 4), dtype=torch.float32, device=dev)
    best[:, 0] = -1.0  # prim
    best[:, 3] = -1.0  # instance
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    rows = torch.arange(r, device=dev).view(-1, RAY_TILE)
    for i, (start, n_tiles) in enumerate(soup.inst_tiles.tolist()):
        tcur = tmax if any_hit else best_t
        hit_box = ok_static[:, i] & (tn[:, i] <= tcur)
        vote = hit_box.view(-1, RAY_TILE).any(dim=1) & live_tile
        idx = rows[vote].reshape(-1)
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
        for k in range(start, start + n_tiles):
            bound = (tmax if any_hit else best_t)[idx, None]
            t, u, v, hit, prim_f = mt_test(obj + (tmin_c, bound),
                                           soup.tris[k], k * ITILE)
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
    out = torch.zeros((r, 8), dtype=torch.float32, device=dev)
    if any_hit:
        out[:, 0] = occ.to(torch.float32)
    else:
        out[:, 0] = best_t
        out[:, 1:5] = best
    return out


def trace_instanced(rays: torch.Tensor, count: torch.Tensor,
                    soup: InstancedSoup,
                    any_hit: bool = False) -> torch.Tensor:
    """K7 wrapper: the CUDA kernel for CUDA rays
    (kernels/csrc/instanced_mt.cu `instanced_mt_kernel<kAny>`),
    `trace_instanced_ref` on the CPU. Counts its launches in
    `trace_instanced.launches` (closest) and `.any_launches`."""
    if rays.device.type == "cpu":
        return trace_instanced_ref(rays, count, soup, any_hit)
    kbuild.require_cuda("instanced_mt", rays, soup.tris, soup.table)
    kbuild.require_cuda("instanced_mt", count, soup.inst_tiles,
                        dtype=torch.int32)
    r = rays.shape[0]
    if rays.ndim != 2 or rays.shape[1] != 8 or r % RAY_TILE:
        raise ValueError("instanced_mt: rays must be [R, 8] with R a "
                         "multiple of 256")
    if soup.tris.shape[1:] != (9, ITILE) or soup.table.shape[1] != 20:
        raise ValueError("instanced_mt: soup [T, 9, 128], table [I, 20]")
    out = torch.empty((r, 8), dtype=torch.float32, device=rays.device)
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_instanced_mt(
        index, int(any_hit), rays.data_ptr(), r, count.data_ptr(),
        soup.tris.data_ptr(), soup.table.data_ptr(),
        soup.inst_tiles.data_ptr(), soup.table.shape[0], out.data_ptr(),
        stream)
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
