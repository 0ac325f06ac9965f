"""Face reordering of a scene: the Morton order of the MT tracers.

Port of `reorder_scene_by_bvh` (:254) and `morton_order_scene` (:319) of
rendertoy3c_tpu/accel/lbvh.py, for the port's Scene. Host numpy: a
scene-load step. Only the face SoA is permuted; materials and lights do
not depend on face order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..scene.scene import GeometrySoA
from .morton import morton3d_np


def reorder_scene_by_bvh(scene, perm: np.ndarray):
    """Permute the scene's faces into `perm` order.

    Padding faces stay in place past num_faces. `perm` entries of -1 become
    all-zero degenerate faces (never hit) and num_faces grows to len(perm).
    The face axis stays 256-aligned. Returns a new Scene."""
    f = scene.num_faces
    total = scene.geom.mat_id.shape[0]
    m = len(perm)
    new_f = m if m > f else f
    n_tail = total - f
    length = -(-(new_f + n_tail) // 256) * 256
    full = np.full(length, -1, np.int64)
    full[:m] = perm
    if n_tail:
        full[new_f:new_f + n_tail] = np.arange(f, total)
    pad = full < 0
    safe = np.maximum(full, 0)

    def take(arr, per_key: bool):
        a = np.asarray(arr)
        out = a[:, safe] if per_key else a[safe]
        if pad.any():
            out = out.copy()
            if per_key:
                out[:, pad] = 0
            else:
                out[pad] = 0
        return out

    g = scene.geom
    geom = GeometrySoA(
        v0=take(g.v0, True), e1=take(g.e1, True), e2=take(g.e2, True),
        n0=take(g.n0, True), n1=take(g.n1, True), n2=take(g.n2, True),
        uv0=take(g.uv0, False), uv1=take(g.uv1, False),
        uv2=take(g.uv2, False), mat_id=take(g.mat_id, False))
    if m > f:
        return dataclasses.replace(scene, geom=geom, num_faces=m)
    return dataclasses.replace(scene, geom=geom)


def morton_order_scene(scene):
    """Reorder the scene's faces by the Morton code of their key-0
    centroids, which tightens the MT tracers' per-tile cull boxes.
    Returns the reordered Scene (prim ids change)."""
    g = scene.geom
    f = scene.num_faces
    v0 = np.asarray(g.v0[0][:f])
    e1 = np.asarray(g.e1[0][:f])
    e2 = np.asarray(g.e2[0][:f])
    centroid = v0 + (e1 + e2) / 3.0
    lo = centroid.min(axis=0)
    ext = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = morton3d_np((centroid - lo) / ext)
    perm = np.argsort(codes, kind="stable").astype(np.int32)
    return reorder_scene_by_bvh(scene, perm)
