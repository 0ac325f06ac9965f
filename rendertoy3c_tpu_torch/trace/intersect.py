"""Ray-triangle intersection and the brute-force tracers.

Port of rendertoy3c_tpu/trace/intersect.py: every ray tests every
triangle, chunk by chunk. Triangles are two-sided, barycentrics follow
OptiX (P = (1-u-v)*p0 + u*p1 + v*p2), and the closest hit takes the lowest
prim among equal t. Motion scenes lerp each triangle to the ray's time in
[0, 1] between its keys, `a + (b - a) * frac` (`_tri_chunk`, :75-100).
This is the oracle the MT kernels are held to, and with
`make_bruteforce_tracer` the bare tracer of render_pixels when none is
given.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_DET_EPS = 1e-10


class Hit(NamedTuple):
    t: torch.Tensor  # [R] f32 hit distance (tmax where miss)
    prim: torch.Tensor  # [R] int32 primitive index, -1 on miss
    u: torch.Tensor  # [R] f32 barycentric
    v: torch.Tensor  # [R] f32 barycentric
    inst: torch.Tensor | None = None  # [R] int32 instance, -1 on miss


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def ray_triangle(o, d, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore, broadcasting rays [..., 3] against triangles
    [..., 3]. Returns (t, u, v, hit) of the broadcast shape."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    px, py, pz = _cross(dx, dy, dz, *e2.unbind(-1))
    e1x, e1y, e1z = e1.unbind(-1)
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > _DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    v0x, v0y, v0z = v0.unbind(-1)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx, qy, qz = _cross(tx, ty, tz, e1x, e1y, e1z)
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    e2x, e2y, e2z = e2.unbind(-1)
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > tmin) & (t < tmax))
    return t, u, v, hit


def _geom(scene, device):
    g = scene.geom
    return tuple(torch.as_tensor(a, device=device)
                 for a in (g.v0, g.e1, g.e2))  # each [K, F, 3]


def _tri_chunk(geom, start: int, stop: int, time):
    """Triangles [start, stop) as (v0, e1, e2), each [1, C, 3] for a static
    scene or [R, C, 3] lerped to each ray's time for a motion scene."""
    k = geom[0].shape[0]
    if k == 1:
        return tuple(a[0, start:stop][None] for a in geom)
    ts = time * float(k - 1)
    k0 = torch.clamp(torch.floor(ts).to(torch.int64), 0, k - 2)
    frac = (ts - k0.to(torch.float32))[:, None, None]
    out = []
    for a in geom:
        chunk = a[:, start:stop]  # [K, C, 3]
        lo, hi = chunk[k0], chunk[torch.clamp(k0 + 1, max=k - 1)]
        out.append(lo + (hi - lo) * frac)
    return tuple(out)


def _times(scene, time, r, device):
    if scene.num_keys == 1:
        return None
    if time is None:
        raise ValueError("a motion scene needs per-ray times")
    return torch.as_tensor(time, dtype=torch.float32,
                           device=device).expand(r)


def trace_closest_bruteforce(scene, o, d, tmin, tmax, time=None,
                             chunk: int = 256) -> Hit:
    """Closest hit over all real faces, carrying the best hit over chunks.
    `time` ([R] or scalar in [0, 1]) is needed for motion scenes."""
    geom = _geom(scene, o.device)
    r = o.shape[0]
    time = _times(scene, time, r, o.device)
    tmin = torch.as_tensor(tmin, dtype=torch.float32,
                           device=o.device).expand(r)
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=o.device).expand(r)
    best_t = tmax.clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=o.device)
    for start in range(0, scene.num_faces, chunk):
        stop = min(start + chunk, scene.num_faces)
        v0, e1, e2 = _tri_chunk(geom, start, stop, time)
        t, u, v, hit = ray_triangle(o[:, None], d[:, None], v0, e1, e2,
                                    tmin[:, None], tmax[:, None])
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_c, idx = torch.min(t, dim=1)
        # torch.min's index is the first minimum: the lowest prim at equal t
        u_c = torch.gather(u, 1, idx[:, None])[:, 0]
        v_c = torch.gather(v, 1, idx[:, None])[:, 0]
        better = (t_c < best_t) & torch.isfinite(t_c)
        best_t = torch.where(better, t_c, best_t)
        best_prim = torch.where(better, (idx + start).to(torch.int32),
                                best_prim)
        best_u = torch.where(better, u_c, best_u)
        best_v = torch.where(better, v_c, best_v)
    return Hit(t=best_t, prim=best_prim, u=best_u, v=best_v)


def trace_any_bruteforce(scene, o, d, tmin, tmax, time=None,
                         chunk: int = 256) -> torch.Tensor:
    """Any-hit occlusion probe (traceOcclusion, shader_common.h:110-134)."""
    geom = _geom(scene, o.device)
    r = o.shape[0]
    time = _times(scene, time, r, o.device)
    tmin = torch.as_tensor(tmin, dtype=torch.float32,
                           device=o.device).expand(r)
    tmax = torch.as_tensor(tmax, dtype=torch.float32,
                           device=o.device).expand(r)
    occluded = torch.zeros(r, dtype=torch.bool, device=o.device)
    for start in range(0, scene.num_faces, chunk):
        stop = min(start + chunk, scene.num_faces)
        v0, e1, e2 = _tri_chunk(geom, start, stop, time)
        _, _, _, hit = ray_triangle(o[:, None], d[:, None], v0, e1, e2,
                                    tmin[:, None], tmax[:, None])
        occluded |= hit.any(dim=1)
    return occluded


def make_bruteforce_tracer(scene, chunk: int = 256):
    """(closest, any_hit) over the brute tracers, each f(o, d, tmin, tmax,
    time, count=None) (intersect.py:194-215 of the reference). count is
    accepted for the tracer interface and ignored: every ray is traced."""

    def closest(o, d, tmin, tmax, time, count=None):
        return trace_closest_bruteforce(scene, o, d, tmin, tmax, time, chunk)

    def any_hit(o, d, tmin, tmax, time, count=None):
        return trace_any_bruteforce(scene, o, d, tmin, tmax, time, chunk)

    return closest, any_hit
