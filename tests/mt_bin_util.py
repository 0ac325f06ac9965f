"""Synthetic triangle soups and rays for the tests of the MT sweeps' cases
(tests/test_torch_mt_bin.py against the reference, tests/test_torch_cuda.py
kernels against plain versions). numpy only: the CUDA tests import this on
a machine without jax."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TRI_TILE = 512
# a tie across tiles: face TIE_LOW (tile 1) and its copy TIE_HIGH (tile 20)
# of a 21-tile soup
TIE_FACES = 21 * TRI_TILE
TIE_LOW, TIE_HIGH = TRI_TILE + 88, 20 * TRI_TILE + 301
# (name, faces): one tile with ct < 512, one full tile, 9 tiles (one cull
# level in the reference), 18 tiles (two levels)
SOUP_SIZES = (("tiles1_ct384", 300), ("tiles1", 512), ("tiles9", 4500),
              ("tiles18", 9000))


class Geom(NamedTuple):
    """What both packages' `build_tri_soup` read: [K, F, 3] float32."""

    v0: np.ndarray
    e1: np.ndarray
    e2: np.ndarray


def scattered_soup(n_faces: int, seed: int, keys: int = 1,
                   tie: bool = False) -> Geom:
    """n_faces random triangles (edges ~1.5) in [-8, 8]^3, in x order (so tiles
    cover slabs and the cull has work), each key-1 face moved by up to 0.3.
    tie=True makes face TIE_HIGH a copy of face TIE_LOW at every key."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8.0, 8.0, (n_faces, 3))
    c = c[np.argsort(c[:, 0])]
    e1 = rng.normal(scale=1.5, size=(n_faces, 3))
    e2 = rng.normal(scale=1.5, size=(n_faces, 3))
    v0 = c - (e1 + e2) / 3.0
    v0s, e1s, e2s = [v0], [e1], [e2]
    for _ in range(keys - 1):
        v0s.append(v0 + rng.uniform(-0.3, 0.3, v0.shape))
        e1s.append(e1 + rng.uniform(-0.05, 0.05, e1.shape))
        e2s.append(e2 + rng.uniform(-0.05, 0.05, e2.shape))
    geom = Geom(*(np.stack(x).astype(np.float32) for x in (v0s, e1s, e2s)))
    if tie:
        for a in geom:
            a[:, TIE_HIGH] = a[:, TIE_LOW]
    return geom


def rays_at(geom: Geom, faces, n: int, seed: int, time=None):
    """n rays (o, d) float32, half aimed at random points of `faces` (at
    each ray's time, for 2 keys) from 0.05-0.6 away, half random through the
    soup's box."""
    rng = np.random.default_rng(seed)
    n_at = n // 2
    f = np.asarray(faces)[rng.integers(0, len(faces), n_at)]
    tm = np.zeros(n, np.float32) if time is None else time
    a, b = rng.uniform(0.1, 0.45, (2, n_at, 1))

    def at(x):
        if x.shape[0] == 1:
            return x[0, f]
        w = tm[:n_at, None]
        return x[0, f] + (x[1, f] - x[0, f]) * w

    target = at(geom.v0) + a * at(geom.e1) + b * at(geom.e2)
    away = rng.normal(size=(n_at, 3))
    away *= rng.uniform(0.05, 0.6, (n_at, 1)) / np.linalg.norm(
        away, axis=1, keepdims=True)
    o_at = target + away
    o_rand = rng.uniform(-9.0, 9.0, (n - n_at, 3))
    d_rand = rng.normal(size=(n - n_at, 3))
    o = np.concatenate([o_at, o_rand])
    d = np.concatenate([target - o_at, d_rand])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def case(name: str, keys: int, n_rays: int = 1280, seed: int = 0):
    """(geom, num_faces, o, d, time or None, faces aimed at) of a named
    case: "ties" or one of SOUP_SIZES."""
    tie = name == "ties"
    n_faces = TIE_FACES if tie else dict(SOUP_SIZES)[name]
    geom = scattered_soup(n_faces, seed + 11, keys, tie)
    rng = np.random.default_rng(seed + 12)
    time = (rng.uniform(0, 1, n_rays).astype(np.float32) if keys == 2
            else None)
    faces = [TIE_LOW] if tie else rng.integers(0, n_faces, 64)
    o, d = rays_at(geom, faces, n_rays, seed + 13, time)
    return geom, n_faces, o, d, time, faces


def counts(r: int):
    """The live counts every case runs: none, R - 1000 (ending inside a
    128- and a 256-ray tile), all."""
    return (0, r - 1000, r)
