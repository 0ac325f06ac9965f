"""Dense Moller-Trumbore tracers over a tiled triangle soup (K1/K2).

Port of rendertoy3c_tpu/trace/pallas_mt.py for static scenes:
`build_tri_soup` (:70), the closest/any kernels `_closest_kernel` (:256) and
`_any_kernel` (:302), and their entry points `trace_closest_mt` (:382) and
`trace_any_mt` (:408).

`mt_closest` / `mt_any` take packed rays [R, 8] (o, d, tmin, tmax; R a
multiple of 256) and a live-ray `count` (int32 [1] on the rays' device) and
return [R, 4]. On a CUDA tensor they launch the hand-written kernel
(kernels/csrc/mt_kernels.cu); on a CPU tensor they run `closest_ref` /
`any_ref`, the plain PyTorch versions of the same function. Ray tiles of
256 at or past `count` skip the sweep and write the miss row.

The plain versions sweep every tile densely; the kernels cull tiles by
their boxes. Culling only skips tiles no ray of the block can hit, so both
return the same hits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build as kbuild
from .intersect import Hit

RAY_TILE = 256
TRI_TILE = 512
SUPER_TILE = 8  # tri tiles per supertile (2-level cull)
_BIG = 1e30
_DET_EPS = 1e-10


class TriSoup(NamedTuple):
    """Tiled component-major triangle table (on one device)."""

    tris: torch.Tensor  # [F/CT, 9, CT] f32: v0.xyz e1.xyz e2.xyz x CT
    num_faces: int  # real faces (padding beyond is all-zero, never hit)
    aabb: torch.Tensor  # [ceil8(F/CT), 8] f32 per-tile lo.xyz hi.xyz pad2
    super_aabb: torch.Tensor  # [ceil8(F/CT)/8, 8] f32 supertile boxes


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


def mt_test(cols, tile: torch.Tensor, prim_base: int):
    """One Moller-Trumbore block: ray columns (each [R, 1]) against one
    tile [9, CT]. Returns (t, u, v, hit, prim_f), each [R, CT]."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = cols
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tile[c][None]
                                                   for c in range(9))
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


def live_rows(n: int, count: torch.Tensor) -> torch.Tensor:
    """[n] bool: rays whose 256-ray tile starts before `count`."""
    tile_start = (torch.arange(n, device=count.device) // RAY_TILE) * RAY_TILE
    return tile_start < count.reshape(()).to(torch.int64)


def closest_ref(rays: torch.Tensor, count: torch.Tensor,
                soup: TriSoup) -> torch.Tensor:
    """Plain version of K1: [R, 8] rays -> [R, 4] (t, prim_f, u, v), miss =
    (tmax, -1, 0, 0). min t, lowest prim at equal t."""
    cols = tuple(rays[:, c:c + 1] for c in range(8))
    r = rays.shape[0]
    best_t = rays[:, 7].clone()
    best_prim = torch.full((r,), -1.0, dtype=torch.float32, device=rays.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=rays.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=rays.device)
    ct = soup.tris.shape[2]
    for k in range(soup.tris.shape[0]):
        t, u, v, hit, prim_f = mt_test(cols, soup.tris[k], k * ct)
        t = torch.where(hit, t, torch.full_like(t, _BIG))
        t_c, idx = torch.min(t, dim=1)  # first minimum = lowest prim
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        best_prim = torch.where(better, prim_f[0, idx], best_prim)
        best_u = torch.where(better, torch.gather(u, 1, idx[:, None])[:, 0],
                             best_u)
        best_v = torch.where(better, torch.gather(v, 1, idx[:, None])[:, 0],
                             best_v)
    out = torch.stack([best_t, best_prim, best_u, best_v], dim=1)
    miss = torch.stack([rays[:, 7], torch.full_like(best_t, -1.0),
                        torch.zeros_like(best_t), torch.zeros_like(best_t)],
                       dim=1)
    return torch.where(live_rows(r, count)[:, None], out, miss)


def any_ref(rays: torch.Tensor, count: torch.Tensor,
            soup: TriSoup) -> torch.Tensor:
    """Plain version of K2: [R, 8] rays -> [R, 4], column 0 = occluded."""
    cols = tuple(rays[:, c:c + 1] for c in range(8))
    r = rays.shape[0]
    occ = torch.zeros(r, dtype=torch.bool, device=rays.device)
    ct = soup.tris.shape[2]
    for k in range(soup.tris.shape[0]):
        _, _, _, hit, _ = mt_test(cols, soup.tris[k], k * ct)
        occ |= hit.any(dim=1)
    occ &= live_rows(r, count)
    out = torch.zeros((r, 4), dtype=torch.float32, device=rays.device)
    out[:, 0] = occ.to(torch.float32)
    return out


def _launch_mt(any_hit: bool, rays, count, soup: TriSoup) -> torch.Tensor:
    kbuild.require_cuda("mt", rays, soup.tris, soup.aabb, soup.super_aabb)
    kbuild.require_cuda("mt", count, dtype=torch.int32)
    r = rays.shape[0]
    if rays.ndim != 2 or rays.shape[1] != 8 or r % RAY_TILE:
        raise ValueError("mt: rays must be [R, 8] with R a multiple of 256")
    out = torch.empty((r, 4), dtype=torch.float32, device=rays.device)
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_mt_trace(
        index, int(any_hit), rays.data_ptr(), r, count.data_ptr(),
        soup.tris.data_ptr(), soup.aabb.data_ptr(), soup.super_aabb.data_ptr(),
        soup.tris.shape[0], soup.tris.shape[2], out.data_ptr(), stream)
    kbuild.check(err, "mt_any" if any_hit else "mt_closest")
    return out


def mt_closest(rays: torch.Tensor, count: torch.Tensor,
               soup: TriSoup) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA rays, `closest_ref` on the CPU."""
    if rays.device.type == "cpu":
        return closest_ref(rays, count, soup)
    out = _launch_mt(False, rays, count, soup)
    mt_closest.launches += 1
    return out


def mt_any(rays: torch.Tensor, count: torch.Tensor,
           soup: TriSoup) -> torch.Tensor:
    """K2 wrapper: the CUDA kernel for CUDA rays, `any_ref` on the CPU."""
    if rays.device.type == "cpu":
        return any_ref(rays, count, soup)
    out = _launch_mt(True, rays, count, soup)
    mt_any.launches += 1
    return out


mt_closest.launches = 0
mt_any.launches = 0


def pack_rays(o, d, tmin, tmax):
    """[R, 3] o/d + scalar or [R] tmin/tmax -> ([R_pad, 8] rays, R)."""
    r = o.shape[0]
    r_pad = -(-r // RAY_TILE) * RAY_TILE
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
    return torch.as_tensor([r if count is None else count],
                           dtype=torch.int32, device=device)


def trace_closest_mt(soup: TriSoup, o, d, tmin, tmax, *, count=None) -> Hit:
    """Closest hit over the soup; only the first `count` rays are live."""
    rays, r = pack_rays(o, d, tmin, tmax)
    out = mt_closest(rays, _count_tensor(count, r, o.device), soup)[:r]
    t, prim_f = out[:, 0], out[:, 1]
    # hits on padding faces (prim >= num_faces) count as misses
    valid = (prim_f >= 0.0) & (prim_f < soup.num_faces) & (t < _BIG)
    zero = torch.zeros_like(t)
    return Hit(t=torch.where(valid, t, rays[:r, 7]),
               prim=torch.where(valid, prim_f.to(torch.int32),
                                torch.full_like(prim_f, -1).to(torch.int32)),
               u=torch.where(valid, out[:, 2], zero),
               v=torch.where(valid, out[:, 3], zero))


def trace_any_mt(soup: TriSoup, o, d, tmin, tmax, *, count=None):
    """Any-hit occlusion over the soup -> [R] bool."""
    rays, r = pack_rays(o, d, tmin, tmax)
    out = mt_any(rays, _count_tensor(count, r, o.device), soup)
    return out[:r, 0] > 0.0
