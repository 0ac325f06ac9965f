"""Walk tables with ties, for the walk round's tie rules.

A cell's leaf holds 7 distinct triangles, each twice in a row (equal t on
lanes 2m and 2m + 1; a 2-key leaf holds 3 pairs and one single), and
every leaf appears twice in a row (two equal child boxes in one directory
level). The instanced form places one mesh of two such leaves under
instances that each appear twice (equal entries in a world level). All
coordinates are small integers and the rays, times and keys are dyadic,
so every product of the walk is exact and the reference's FMA
contractions cannot move a bit. Some rays run straight down through
vertices and edges (u or v of 0) and some start on a top face with a
negative tmin (t of +-0).

Imports neither jax nor the reference: shared by
tests/test_torch_walk_round.py (the port's plain rounds against the
reference's) and tests/test_torch_cuda.py (K9 and K9-inst against the
plain rounds).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

GRID = 6  # cells a side
OFFSET = np.float32([0.25, 0.0, 0.5])  # a 2-key scene's second key


class Geom(NamedTuple):
    """The faces as build_hier_table reads them: [K, F, 3] each."""

    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray


def _cell_tris(x, z, top):
    """The 7 distinct triangles of the cell at (x, z), as [7, 3, 3]."""
    p = np.float32
    return np.array([
        [[x, 0, z], [x + 1, 0, z], [x + 1, 0, z + 1]],
        [[x, 0, z], [x + 1, 0, z + 1], [x, 0, z + 1]],
        [[x, top, z], [x + 1, top, z], [x + 1, top, z + 1]],
        [[x, top, z], [x + 1, top, z + 1], [x, top, z + 1]],
        [[x, 0, z], [x, top, z], [x, top, z + 1]],
        [[x, 0, z], [x, top, z + 1], [x, 0, z + 1]],
        [[x, 0, z], [x + 1, top, z], [x, top, z + 1]],
    ], p)


def _leaf(x, z, top, motion):
    """One leaf's triangles: the cell's pairs (3 pairs and a single for a
    2-key leaf of 7)."""
    tris = _cell_tris(x, z, top)
    if motion:
        return np.stack([tris[0], tris[0], tris[2], tris[2], tris[4],
                         tris[4], tris[6]])
    return np.repeat(tris, 2, axis=0)


def flat_geom(motion: bool) -> Geom:
    """Every cell's leaf twice in a row, on a GRID x GRID grid of cells 2
    apart with tops at height 1 or 2."""
    leaves = []
    for cx in range(GRID):
        for cz in range(GRID):
            leaf = _leaf(2 * cx, 2 * cz, 1 + (cx + cz) % 2, motion)
            leaves += [leaf, leaf]
    tris = np.concatenate(leaves)
    keys = [tris] + ([tris + OFFSET] if motion else [])
    v0 = np.stack([t[:, 0] for t in keys])
    e1 = np.stack([t[:, 1] - t[:, 0] for t in keys])
    e2 = np.stack([t[:, 2] - t[:, 0] for t in keys])
    return Geom(v0.astype(np.float32), e1.astype(np.float32),
                e2.astype(np.float32))


def inst_parts(motion: bool):
    """(vertices [V, 3], indices [F, 3], per-instance transforms
    [KT, 3, 4]) of the instanced form: one mesh of a cell's leaf twice
    (2 leaves, one directory), placed at 12 spots, each spot twice; half
    the spots at scale 2. A 2-key instance moves by OFFSET."""
    leaf = _leaf(0, 0, 1, False)
    tris = np.concatenate([leaf, leaf])
    verts = tris.reshape(-1, 3)
    idx = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    xforms = []
    for k in range(12):
        t = np.zeros((3, 4), np.float32)
        t[:, :3] = np.eye(3) * (2.0 if k % 2 else 1.0)
        t[:, 3] = (3 * (k % 4) - 4, 0, 3 * (k // 4) - 4)
        keys = np.stack([t, t + np.concatenate(
            [np.zeros((3, 3), np.float32), OFFSET[:, None]], axis=1)]
            if motion else [t])
        xforms += [keys, keys]
    return verts, idx, xforms


def rays(n: int, seed: int, any_hit: bool, lo=-1, hi=2 * GRID + 1):
    """(o [n, 3], d [n, 3], tmin [n], tmax [n], time [n]) f32, dyadic:
    a quarter of the rays straight down from integer and half-integer
    points (vertices and edges), one in 16 from a top face at height 1
    with tmin -1, the rest from above in directions (a / 4, -1, b / 4);
    shadow rays end at tmax in [0.5, 8] by quarters."""
    rng = np.random.default_rng(seed)
    lo, hi = int(lo), int(hi)
    o = np.stack([rng.integers(4 * lo, 4 * hi, n) / 4,
                  rng.integers(12, 20, n) / 4,
                  rng.integers(4 * lo, 4 * hi, n) / 4], axis=1)
    d = np.stack([rng.integers(-4, 5, n) / 4, -np.ones(n),
                  rng.integers(-4, 5, n) / 4], axis=1)
    down = rng.uniform(size=n) < 0.25
    o[down, 0] = rng.integers(2 * lo, 2 * hi, int(down.sum())) / 2
    o[down, 2] = rng.integers(2 * lo, 2 * hi, int(down.sum())) / 2
    d[down] = (0.0, -1.0, 0.0)
    on_top = rng.uniform(size=n) < 1 / 16
    o[on_top, 1] = 1.0
    tmin = np.where(on_top, -1.0, 1e-3)
    tmax = (rng.integers(2, 33, n) / 4 if any_hit else np.full(n, 1e16))
    time = rng.integers(0, 9, n) / 8
    f = np.float32
    return (o.astype(f), d.astype(f), tmin.astype(f), tmax.astype(f),
            time.astype(f))


def has_equal_children(table: np.ndarray, fanout: int) -> bool:
    """Whether some directory row of a flat [rows, 128] table holds two
    equal child boxes side by side."""
    dirs = table[table[:, 127] < 0.5]
    boxes = dirs[:, :6 * fanout].reshape(-1, 6, fanout)
    same = (boxes[:, :, 1:] == boxes[:, :, :-1]).all(axis=1)
    real = boxes[:, 0, 1:] < 1e29
    return bool((same & real).any())
