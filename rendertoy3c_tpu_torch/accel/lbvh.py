"""Face reordering of a scene: the Morton order of the MT tracers and the
binned-SAH order of the hier tables.

Port of `reorder_scene_by_bvh` (:254), `morton_order_scene` (:319),
`sah_split_perm` as its numpy recursion `_sah_split_perm_py` (:381),
`merge_variable_clusters` (:446) and `split_order_scene` (:476) of
rendertoy3c_tpu/accel/lbvh.py, for the port's Scene. Host numpy: a
scene-load step. Only the face SoA is permuted; materials and lights do
not depend on face order. The reference's native SAH build
(native/sah.cc, bit-identical to the recursion) is not bound (ROADMAP
A15).
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


_SAH_BINS = 32
_BIG_F = np.float32(1e30)


def sah_split_perm(lo, hi, leaf: int, variable: bool = False) -> np.ndarray:
    """Recursive binned-SAH split permutation over the faces' boxes lo, hi
    [F, 3]: 32 centroid bins, the axis and split of least prefix/suffix
    half-area cost, the longest-axis median where no split helps.

    variable=False snaps each split to a multiple of `leaf`, so every
    cluster boundary stays run-aligned; returns the [F] permutation.
    variable=True splits where SAH wants and pads every cluster with -1
    up to the next multiple of `leaf` (reorder_scene_by_bvh turns them
    into degenerate faces); returns the [M >= F] padded permutation."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    f = lo.shape[0]
    cent = (lo + hi) * 0.5
    nb = _SAH_BINS

    def half_area(blo, bhi):
        d = np.maximum(bhi - blo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] \
            + d[..., 2] * d[..., 0]

    out = []
    stack = [np.arange(f)]
    while stack:
        idx = stack.pop()
        n = len(idx)
        if n <= leaf:
            if variable and n < leaf:
                idx = np.concatenate(
                    [idx, np.full(leaf - n, -1, idx.dtype)])
            out.append(idx)
            continue
        c = cent[idx]
        cmin = c.min(axis=0)
        ext = c.max(axis=0) - cmin
        best = None  # (cost, axis, split count)
        for ax in range(3):
            if ext[ax] <= 0:
                continue
            b = np.minimum((c[:, ax] - cmin[ax]) * (nb / ext[ax]),
                           nb - 1).astype(np.int32)
            cnt = np.bincount(b, minlength=nb)
            blo = np.full((nb, 3), _BIG_F, np.float32)
            bhi = np.full((nb, 3), -_BIG_F, np.float32)
            np.minimum.at(blo, b, lo[idx])
            np.maximum.at(bhi, b, hi[idx])
            pre_lo = np.minimum.accumulate(blo, 0)
            pre_hi = np.maximum.accumulate(bhi, 0)
            suf_lo = np.minimum.accumulate(blo[::-1], 0)[::-1]
            suf_hi = np.maximum.accumulate(bhi[::-1], 0)[::-1]
            nl = np.cumsum(cnt)[:-1]
            cost = (half_area(pre_lo[:-1], pre_hi[:-1]) * nl
                    + half_area(suf_lo[1:], suf_hi[1:]) * (n - nl))
            cost = np.where((nl > 0) & (nl < n), cost, np.inf)
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
                if variable:
                    half = int(nl[k])
                else:
                    half = int(round(nl[k] / leaf)) * leaf
                    half = min(max(half, leaf), ((n - 1) // leaf) * leaf)
                if 0 < half < n:
                    best = (cost[k], ax, half)
        if best is None:
            ax = int(np.argmax(ext))
            half = (n // 2 if variable
                    else min(-(-n // (2 * leaf)) * leaf, n - 1))
        else:
            _, ax, half = best
        srt = idx[np.argsort(c[:, ax], kind="stable")]
        stack.append(srt[half:])
        stack.append(srt[:half])
    return np.concatenate(out).astype(np.int32)


def merge_variable_clusters(perm: np.ndarray, leaf: int) -> np.ndarray:
    """Pack adjacent variable-SAH clusters into shared `leaf`-slot rows
    while their real faces fit (adjacent clusters are spatial siblings of
    the recursion), re-padding with -1. Returns the [M <= len(perm)]
    permutation."""
    cl = perm.reshape(-1, leaf)
    sizes = (cl >= 0).sum(axis=1)
    rows = []
    cur: list = []
    cur_n = 0
    for i in range(cl.shape[0]):
        n = int(sizes[i])
        if cur_n + n > leaf:
            cur.extend([-1] * (leaf - cur_n))
            rows.append(cur)
            cur, cur_n = [], 0
        cur.extend(cl[i, :n].tolist())
        cur_n += n
    if cur_n or not rows:
        cur.extend([-1] * (leaf - cur_n))
        rows.append(cur)
    return np.asarray([x for row in rows for x in row], dtype=perm.dtype)


def split_order_scene(scene, leaf: int = 256, variable: bool | None = None):
    """Reorder the scene's faces by the binned-SAH split (sah_split_perm),
    so consecutive `leaf`-face runs get tight boxes.

    variable=None (auto): orderings of leaf <= 16 (the hier tables) try
    variable-size leaves, merged by merge_variable_clusters, and keep them
    only when the real faces fill at least 0.8 of the slots (num_faces then
    grows by the degenerate padding faces); otherwise, and for larger
    leaves, the splits snap to leaf multiples. Returns the reordered
    Scene (prim ids change)."""
    g = scene.geom
    f = scene.num_faces
    v0 = np.asarray(g.v0[0][:f])
    e1 = np.asarray(g.e1[0][:f])
    e2 = np.asarray(g.e2[0][:f])
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    if variable or (variable is None and leaf <= 16):
        perm = merge_variable_clusters(
            sah_split_perm(lo, hi, leaf, variable=True), leaf)
        if variable or f / len(perm) >= 0.8:
            return reorder_scene_by_bvh(scene, perm)
    return reorder_scene_by_bvh(
        scene, sah_split_perm(lo, hi, leaf, variable=False))
