"""Built-in Cornell box (port of rendertoy3c_tpu/scene/builtin.py
`cornell_box`, with its `quad` and `box_mesh` helpers)."""
from __future__ import annotations

import numpy as np

from .camera import Camera
from .material import Material
from .mesh import Mesh


def quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    """Two-triangle quad: vertices [4,3], indices [2,3]."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def _quad_mesh(p0, p1, p2, p3, material: Material) -> Mesh:
    v, f = quad(p0, p1, p2, p3)
    return Mesh(vertices=v[None], indices=f, material=material)


def box_mesh(lo, hi, material: Material) -> Mesh:
    """Axis-aligned box with outward normals."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    f = np.array(
        [
            [4, 5, 6], [4, 6, 7],  # +z
            [1, 0, 3], [1, 3, 2],  # -z
            [5, 1, 2], [5, 2, 6],  # +x
            [0, 4, 7], [0, 7, 3],  # -x
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 1, 5], [0, 5, 4],  # -y
        ],
        np.int32,
    )
    return Mesh(vertices=v[None], indices=f, material=material)


def cornell_box(light_emission=(15.0, 15.0, 15.0), with_blocks: bool = True):
    """Cornell-style box in [-1,1]x[0,2]x[-1,1], open toward a +z camera.

    Returns (meshes, camera), one mesh per material."""
    white = Material(diffuse=(0.73, 0.73, 0.73))
    red = Material(diffuse=(0.65, 0.05, 0.05))
    green = Material(diffuse=(0.12, 0.45, 0.15))
    light = Material(diffuse=(0.0, 0.0, 0.0), emissive=tuple(light_emission))

    meshes = [
        _quad_mesh([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], white),  # floor
        _quad_mesh([-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1], white),  # ceiling
        _quad_mesh([-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1], white),  # back
        _quad_mesh([-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1], red),  # left
        _quad_mesh([1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1], green),  # right
        _quad_mesh(
            [-0.4, 1.99, -0.4], [-0.4, 1.99, 0.4], [0.4, 1.99, 0.4],
            [0.4, 1.99, -0.4], light,
        ),
    ]
    if with_blocks:
        meshes.append(box_mesh([-0.6, 0.0, -0.55], [-0.05, 1.1, 0.0], white))
        meshes.append(box_mesh([0.1, 0.0, 0.0], [0.65, 0.55, 0.5], white))

    camera = Camera(eye=(0.0, 1.0, 3.4), lookat=(0.0, 1.0, 0.0),
                    up=(0.0, 1.0, 0.0), fov_y=45.0, aspect_ratio=1.0)
    return meshes, camera
