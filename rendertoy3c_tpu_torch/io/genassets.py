"""Procedural .obj benchmark assets (BASELINE.md's "textured .obj scenes").

Port of rendertoy3c_tpu/io/genassets.py: `generate_town` (:81) and its
helpers, writing byte-equal .obj, .mtl and .png files (the PNGs through
this package's film/image.write_png).

The reference renders .obj files from disk (src/wavefront.cpp:290-302,
mesh.cpp:39-55); its repo ships no scene assets, so the benchmark suite
generates deterministic ones: a "town" of tessellated multi-material
buildings on a textured ground with an area lamp — written as real
.obj/.mtl/.png files and loaded back through io.obj.load_obj, exercising
the full asset path (MTL materials, texture files, per-material mesh
split, keyframe stacking for the motion variant).

Files are cached by parameters under the given directory; generation is
pure numpy + stdlib.
"""
from __future__ import annotations

import os

import numpy as np

from ..film.image import write_png


def _checker_png(path, n=64, c0=(200, 190, 170), c1=(90, 80, 70)):
    yy, xx = np.mgrid[0:n, 0:n]
    m = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    img = np.where(m[..., None] == 0, np.uint8(c0), np.uint8(c1))
    write_png(path, img.astype(np.uint8))


def _brick_png(path, n=64):
    yy, xx = np.mgrid[0:n, 0:n]
    row = yy // 8
    off = (row % 2) * 8
    mortar = ((yy % 8) < 1) | (((xx + off) % 16) < 1)
    rng = np.random.default_rng(7)
    base = np.stack([
        np.full((n, n), 150.0) + rng.uniform(-18, 18, (n, n)),
        np.full((n, n), 72.0) + rng.uniform(-12, 12, (n, n)),
        np.full((n, n), 56.0) + rng.uniform(-10, 10, (n, n)),
    ], axis=-1)
    img = np.where(mortar[..., None], 185.0, base)
    write_png(path, np.clip(img, 0, 255).astype(np.uint8))


def _grid_face(vs, fs, origin, eu, ev, s, mat, vt_base, vlines):
    """Append an s x s subdivided quad patch (origin + a*eu + b*ev)."""
    base = len(vs)
    for j in range(s + 1):
        for i in range(s + 1):
            p = origin + eu * (i / s) + ev * (j / s)
            vs.append(p)
    for j in range(s):
        for i in range(s):
            a = base + j * (s + 1) + i
            b = a + 1
            c = a + (s + 1)
            d = c + 1
            ta = vt_base + j * (s + 1) + i
            tb = ta + 1
            tc = ta + (s + 1)
            td = tc + 1
            fs.append((mat, (a, ta), (b, tb), (d, td)))
            fs.append((mat, (a, ta), (d, td), (c, tc)))


def _box_faces(vs, fs, lo, hi, s, mat, vt_base):
    """5 tessellated faces of an axis box (no bottom)."""
    lx, ly, lz = lo
    hx, hy, hz = hi
    ex = np.array([hx - lx, 0, 0])
    ey = np.array([0, hy - ly, 0])
    ez = np.array([0, 0, hz - lz])
    o = np.array(lo, float)
    _grid_face(vs, fs, o + ey, ex, ez, s, mat, vt_base, None)       # top
    _grid_face(vs, fs, o, ex, ey, s, mat, vt_base, None)            # -z
    _grid_face(vs, fs, o + ez, ey, ex, s, mat, vt_base, None)       # +z
    _grid_face(vs, fs, o, ey, ez, s, mat, vt_base, None)            # -x
    _grid_face(vs, fs, o + ex, ez, ey, s, mat, vt_base, None)       # +x


def generate_town(out_dir: str, faces_target: int = 50000,
                  two_key: bool = False, seed: int = 0):
    """Write (and cache) the town scene; returns (obj_paths, camera_kwargs).

    faces_target is approximate (+-2%). two_key=True also writes a second
    keyframe .obj (same topology, some buildings translated/sheared) for
    the reference's N-files-N-keyframes motion format."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"town{faces_target // 1000}k"
    paths = [os.path.join(out_dir, f"{tag}_k{k}.obj")
             for k in range(2 if two_key else 1)]
    mtl_path = os.path.join(out_dir, f"{tag}.mtl")
    cam = dict(eye=(38.0, 26.0, 46.0), lookat=(0.0, 1.5, 0.0), fov_y=42.0)
    if all(os.path.exists(p) for p in paths) and os.path.exists(mtl_path):
        return paths, cam

    _checker_png(os.path.join(out_dir, "checker.png"))
    _brick_png(os.path.join(out_dir, "brick.png"))
    with open(mtl_path, "w") as f:
        f.write("newmtl ground\nKd 0.75 0.75 0.75\nmap_Kd checker.png\n\n")
        f.write("newmtl brick\nKd 0.8 0.8 0.8\nmap_Kd brick.png\n\n")
        f.write("newmtl plaster\nKd 0.80 0.76 0.70\n\n")
        f.write("newmtl paint_red\nKd 0.66 0.28 0.24\n\n")
        f.write("newmtl paint_blue\nKd 0.30 0.45 0.70\n\n")
        f.write("newmtl paint_green\nKd 0.50 0.66 0.38\n\n")
        f.write("newmtl lamp\nKd 0 0 0\nKe 26 25 22\n\n")
        f.write("newmtl sign\nKd 0 0 0\nKe 9 4.5 1.8\n\n")

    rng = np.random.default_rng(seed)
    nb = 56
    ground_s = 32
    fixed = 2 * ground_s * ground_s + 2 + 2 * 2  # ground + lamp + 2 signs
    s = max(1, int(np.ceil(np.sqrt(max(faces_target - fixed, 10)
                                   / (nb * 5 * 2)))))

    # building placement: an 8x8 grid, skip 8 cells for streets
    cells = [(i, j) for i in range(8) for j in range(8)]
    rng.shuffle(cells)
    cells = cells[:nb]
    mats = ["brick", "plaster", "paint_red", "paint_blue", "paint_green"]

    def build(key):
        # fresh stream per keyframe: both keys must draw IDENTICAL sizes
        # so the two .obj files share topology (motion = positions only)
        rng = np.random.default_rng(seed + 1)
        vs: list = []
        fs: list = []
        # shared vt grid for all patches
        vt = [(i / s, j / s) for j in range(s + 1) for i in range(s + 1)]
        gvt_base = len(vt)
        vt += [(i / ground_s * 8, j / ground_s * 8)
               for j in range(ground_s + 1) for i in range(ground_s + 1)]
        # ground
        _grid_face(vs, fs, np.array([-22.0, 0.0, -22.0]),
                   np.array([44.0, 0, 0]), np.array([0, 0, 44.0]),
                   ground_s, "ground", gvt_base, None)
        # fix ground vt base (grid_face used per-cell vt offsets of size
        # (ground_s+1)^2 starting at gvt_base) — handled by vt_base arg
        for bi, (ci, cj) in enumerate(cells):
            cx = ci * 5.0 - 17.5 + rng.uniform(-0.4, 0.4)
            cz = cj * 5.0 - 17.5 + rng.uniform(-0.4, 0.4)
            w = rng.uniform(1.4, 2.1)
            dpt = rng.uniform(1.4, 2.1)
            h = rng.uniform(1.5, 7.0)
            lo = np.array([cx - w, 0.0, cz - dpt])
            hi = np.array([cx + w, h, cz + dpt])
            if key == 1 and bi % 3 == 0:
                # motion: every third building rises and shears
                lo = lo + np.array([0.35, 0.0, 0.0])
                hi = hi + np.array([0.35, 0.6, 0.0])
            _box_faces(vs, fs, lo, hi, s, mats[bi % len(mats)], 0)
        # lamp: large area light overhead
        base = len(vs)
        for p in ([-7, 20, -7], [-7, 20, 7], [7, 20, 7], [7, 20, -7]):
            vs.append(np.array(p, float))
        t0 = 0
        fs.append(("lamp", (base, t0), (base + 1, t0), (base + 2, t0)))
        fs.append(("lamp", (base, t0), (base + 2, t0), (base + 3, t0)))
        # two emissive signs
        for k2, x in enumerate((-6.0, 9.0)):
            b2 = len(vs)
            for p in ([x, 3.0, -19.0], [x + 2.5, 3.0, -19.0],
                      [x + 2.5, 4.5, -19.0], [x, 4.5, -19.0]):
                vs.append(np.array(p, float))
            fs.append(("sign", (b2, t0), (b2 + 1, t0), (b2 + 2, t0)))
            fs.append(("sign", (b2, t0), (b2 + 2, t0), (b2 + 3, t0)))
        return vs, fs, vt

    for key, path in enumerate(paths):
        vs, fs, vt = build(key)
        with open(path, "w") as f:
            f.write(f"mtllib {os.path.basename(mtl_path)}\n")
            f.write("o town\n")
            for p in vs:
                f.write(f"v {p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
            for (tu, tv) in vt:
                f.write(f"vt {tu:.5f} {tv:.5f}\n")
            cur = None
            for mat, a, b, c in fs:
                if mat != cur:
                    f.write(f"usemtl {mat}\n")
                    cur = mat
                f.write(
                    f"f {a[0] + 1}/{a[1] + 1} {b[0] + 1}/{b[1] + 1} "
                    f"{c[0] + 1}/{c[1] + 1}\n"
                )
    return paths, cam
