"""The scenes of the megakernels' tests (K4 and K5, kernels/csrc/
megakernel.cuh, and their sweeps in mt.cuh), in the forms the kernels take:
static, 2-key motion, textured, the material dispatch, and AOV (the static
scene under `RenderConfig(aov=True)`).

  ties       the form's base scene (the Cornell box; the normal-mapped
             textured quad; the Cornell box with all four material types)
             with its first two faces repeated under another material an
             odd number of columns further on (37 or 5), so that a face and
             its copy fall to different threads of a lane's group (of 2 or
             4) and hit at equal t: the lower prim must win;
  multitile  the base scene with a 10 x 10 grid of small boxes on its
             floor (1200 faces more, three 512-face tiles), so that the
             sweeps cull by tile boxes and merge a group's hits after each
             tile: chip_smoke.py's `multitile_scene`.

The motion form gives the base scene's last mesh a second key at +0.1 in
x. Port only, numpy: the CUDA tests import this on a machine without jax
(run from the repository root, which holds chip_smoke.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from chip_smoke import multitile_scene
from rendertoy3c_tpu_torch.scene.builtin import (cornell_box,
                                                  material_cornell_box,
                                                  textured_quad_variant)
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene

FORMS = ("static", "motion", "textured", "dispatch", "aov")
KINDS = ("ties", "multitile")


def _moving(mesh: Mesh) -> Mesh:
    """`mesh` with a second key at +0.1 in x."""
    v = mesh.vertices
    return dataclasses.replace(
        mesh, vertices=np.concatenate([v[:1], v[:1] + np.float32(
            [0.1, 0, 0])]))


def _base(form: str):
    """(meshes, textures or None, camera) of a form's base scene."""
    if form == "textured":
        return textured_quad_variant("normal_map")
    if form == "dispatch":
        meshes, camera = material_cornell_box(False)
        return meshes, None, camera
    meshes, camera = cornell_box()
    return meshes, None, camera


def _copies(meshes) -> Mesh:
    """The first two faces of `meshes[0]` repeated under a blue diffuse
    material, after one far-away face."""
    first = meshes[0]
    v = first.vertices[0]
    tri = v[first.indices[:2]].reshape(-1, 3)
    far = np.float32([[40, -40, 40], [41, -40, 40], [40, -40, 41]])
    verts = np.concatenate([far, tri]).astype(np.float32)
    return Mesh(vertices=verts[None],
                indices=np.arange(9, dtype=np.int32).reshape(3, 3),
                material=Material(diffuse=(0.2, 0.45, 0.8)))


def fused_scene(kind: str, form: str):
    """(scene, camera, aov) of a test scene (`kind` in KINDS) in a form of
    FORMS; the multi-tile scene is chip_smoke.py's (phase 41)."""
    if kind == "multitile":
        return (*multitile_scene(form), form == "aov")
    if kind != "ties":
        raise ValueError(kind)
    meshes, textures, camera = _base(form)
    meshes = list(meshes)
    copies = _copies(meshes)
    if form == "motion":
        meshes[-1] = _moving(meshes[-1])
    kw = {} if textures is None else dict(textures=textures)
    return build_scene(meshes + [copies], **kw), camera, form == "aov"


def tie_columns(scene) -> list[tuple[int, int]]:
    """The (face, copy) column pairs of a ties scene: equal triangles at
    key 0, the copy later."""
    g = scene.geom
    n = scene.num_faces
    tri = np.concatenate([np.asarray(g.v0[0][:n]), np.asarray(g.e1[0][:n]),
                          np.asarray(g.e2[0][:n])], axis=1)
    pairs = []
    for j in range(n):
        for k in range(j + 1, n):
            if np.array_equal(tri[j], tri[k]):
                pairs.append((j, k))
    return pairs
