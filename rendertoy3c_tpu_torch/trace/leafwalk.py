"""The flat leaf table of the leaf walks: runs of LEAF triangles in face
order, one component-major row per leaf, and each leaf's box.

Port of rendertoy3c_tpu/trace/leafwalk.py `LeafTable` and
`build_leaf_table` (:53-95), host numpy, array-equal to the reference's.
The resident-table walk (trace/residentwalk.py, K8) reads it. The box of
the last leaf covers every face of the geometry, its padding faces (all
zero, never hit) included: `f` is the padded face count, as in the
reference. The leaf walk tracer itself (`--tracer leafwalk`) is not
ported (ROADMAP A17).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF = 256  # triangles per leaf
_BIG = 1e30


class LeafTable(NamedTuple):
    """Flat leaf-level table."""

    rows: np.ndarray  # [L, 9 * LEAF] f32, component-major leaf rows
    aabb_t: np.ndarray  # [6, L] f32 (lox loy loz hix hiy hiz); an empty
    #                     leaf carries an inverted box
    num_faces: int


def build_leaf_table(geom, key: int = 0, leaf: int = LEAF) -> LeafTable:
    """Pack motion key `key` of a GeometrySoA into leaf rows: row l =
    [v0x * LEAF, v0y * LEAF, ..., e2z * LEAF] over faces l * LEAF ...
    (l + 1) * LEAF - 1, zero past the last face."""
    v0 = np.asarray(geom.v0[key], np.float32)
    e1 = np.asarray(geom.e1[key], np.float32)
    e2 = np.asarray(geom.e2[key], np.float32)
    f = v0.shape[0]
    n_l = max(1, -(-f // leaf))
    f_pad = n_l * leaf

    comp = np.zeros((9, f_pad), np.float32)
    comp[0:3, :f] = v0.T
    comp[3:6, :f] = e1.T
    comp[6:9, :f] = e2.T
    rows = (comp.reshape(9, n_l, leaf).transpose(1, 0, 2)
            .reshape(n_l, 9 * leaf))

    aabb = np.zeros((6, n_l), np.float32)
    p1 = v0 + e1
    p2 = v0 + e2
    for c in range(3):
        lo = np.full((f_pad,), _BIG, np.float32)
        hi = np.full((f_pad,), -_BIG, np.float32)
        lo[:f] = np.minimum(np.minimum(v0[:, c], p1[:, c]), p2[:, c])
        hi[:f] = np.maximum(np.maximum(v0[:, c], p1[:, c]), p2[:, c])
        aabb[c] = lo.reshape(n_l, leaf).min(axis=1)
        aabb[c + 3] = hi.reshape(n_l, leaf).max(axis=1)
    return LeafTable(rows=np.ascontiguousarray(rows), aabb_t=aabb,
                     num_faces=f)
