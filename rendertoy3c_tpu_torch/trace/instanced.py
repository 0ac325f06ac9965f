"""The brute two-level tracer of trace-time instanced scenes.

Port of rendertoy3c_tpu/trace/instanced.py (`_lerp_minv` :27,
`_transform_rays` :51, `_trace_range` :58, `make_instanced_tracer`): for
every instance in turn, the rays move into its object space by the
inverse transform (the direction left unnormalized, so t stays in world
units) and test that mesh's faces; the closest hit over instances wins
(the lowest prim at equal t within an instance, the earlier instance at
equal t across them). A 2-key instance inverts its transform lerped to
each ray's time (hier_instanced.py `_inv3`: a singular lerp inverts to
zero and misses). It is the plain reference the instanced walk (K9-inst)
is held to, and the CPU tracer of instanced scenes in the tests.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..scene.instanced import InstancedScene
from .hier_instanced import _inv3, _mat3_vec
from .intersect import Hit, ray_triangle

_BIG = 1e30


def _lerp_minv(inst, i: int, time, motion: bool):
    """(lin [R|1, 3, 3], trans [R|1, 3]) world -> object of instance i at
    each ray's time."""
    if not motion:
        mi = inst["minv"][i, 0]
        return mi[None, :, :3], mi[None, :, 3]
    m0, m1 = inst["m"][i, 0], inst["m"][i, 1]
    mt = m0[None] + (m1 - m0)[None] * time[:, None, None]
    lin = _inv3(mt[:, :, :3])
    return lin, -_mat3_vec(lin, mt[:, :, 3])


def _transform_rays(lin, trans, o, d):
    r = o.shape[0]
    lin = lin.expand(r, 3, 3)
    return _mat3_vec(lin, o) + trans.expand(r, 3), _mat3_vec(lin, d)


def _trace_range(geom, start: int, count: int, o, d, tmin, tmax,
                 chunk: int = 512):
    """(t, prim, u, v) of the closest hit over faces [start, start +
    count), the hit t below the per-ray tmax."""
    if count % chunk:
        # mesh ranges are INST_FACE_ALIGN-padded: never spill past one
        chunk = math.gcd(count, chunk)
    v0a, e1a, e2a = geom
    r = o.shape[0]
    best_t = tmax
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=o.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=o.device)
    for c0 in range(start, start + count, chunk):
        t, u, v, hit = ray_triangle(
            o[:, None], d[:, None], v0a[None, c0:c0 + chunk],
            e1a[None, c0:c0 + chunk], e2a[None, c0:c0 + chunk],
            tmin[:, None], best_t[:, None])
        t = torch.where(hit, t, torch.full_like(t, _BIG))
        # torch.min's index is the first minimum: the lowest prim at equal t
        t_c, idx = torch.min(t, dim=1)
        u_c = torch.gather(u, 1, idx[:, None])[:, 0]
        v_c = torch.gather(v, 1, idx[:, None])[:, 0]
        better = (t_c < best_t) & (t_c < _BIG)
        best_t = torch.where(better, t_c, best_t)
        best_prim = torch.where(better, (idx + c0).to(torch.int32),
                                best_prim)
        best_u = torch.where(better, u_c, best_u)
        best_v = torch.where(better, v_c, best_v)
    return best_t, best_prim, best_u, best_v


def make_instanced_tracer(scene: InstancedScene, device, chunk: int = 512):
    """(closest, any_hit) over the instanced scene, each f(o, d, tmin,
    tmax, time, count) with the port's tracer signature (count is
    ignored: every ray is traced)."""
    dev = torch.device(device)
    it = scene.instances
    inst = {k: torch.tensor(np.asarray(getattr(it, k)), device=dev)
            for k in ("m", "minv")}
    geom = tuple(torch.tensor(np.asarray(getattr(scene.geom, k)[0]),
                              device=dev) for k in ("v0", "e1", "e2"))
    motion = scene.num_keys > 1

    def _prep(o, tmin, tmax, time):
        r = o.shape[0]
        f32 = dict(dtype=torch.float32, device=o.device)
        tmin = torch.broadcast_to(torch.as_tensor(tmin, **f32), (r,))
        tmax = torch.broadcast_to(torch.as_tensor(tmax, **f32), (r,))
        if motion:
            time = torch.broadcast_to(torch.as_tensor(
                0.0 if time is None else time, **f32), (r,))
        return tmin, tmax, time

    def closest(o, d, tmin, tmax, time=None, count=None):
        tmin, tmax, time = _prep(o, tmin, tmax, time)
        r = o.shape[0]
        best_t = tmax
        best_prim = torch.full((r,), -1, dtype=torch.int32, device=o.device)
        best_inst = torch.full_like(best_prim, -1)
        best_u = torch.zeros_like(best_t)
        best_v = torch.zeros_like(best_t)
        for i, mesh_i in enumerate(scene.instance_mesh):
            start, cnt = scene.mesh_ranges[mesh_i]
            o2, d2 = _transform_rays(*_lerp_minv(inst, i, time, motion), o, d)
            t_c, prim_c, u_c, v_c = _trace_range(geom, start, cnt, o2, d2,
                                                 tmin, best_t, chunk)
            better = (prim_c >= 0) & (t_c < best_t)
            best_t = torch.where(better, t_c, best_t)
            best_prim = torch.where(better, prim_c, best_prim)
            best_u = torch.where(better, u_c, best_u)
            best_v = torch.where(better, v_c, best_v)
            best_inst = torch.where(better, i, best_inst)
        return Hit(t=best_t, prim=best_prim, u=best_u, v=best_v,
                   inst=best_inst)

    def any_hit(o, d, tmin, tmax, time=None, count=None):
        tmin, tmax, time = _prep(o, tmin, tmax, time)
        occluded = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for i, mesh_i in enumerate(scene.instance_mesh):
            start, cnt = scene.mesh_ranges[mesh_i]
            o2, d2 = _transform_rays(*_lerp_minv(inst, i, time, motion), o, d)
            occluded |= _trace_range(geom, start, cnt, o2, d2, tmin, tmax,
                                     chunk)[1] >= 0
        return occluded

    return closest, any_hit
