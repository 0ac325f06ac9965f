"""The generated town scene, loaded through the .obj asset path.

Counterpart of bench.py `_town_scene` (:307-337): `generate_town` writes the
.obj/.mtl/.png files, `load_obj` reads them back (two files are two motion
keyframes) with the ground's checker and the buildings' brick textures,
and the scene is built with the generator's own camera. `textured=False`
strips the textures (the `untextured=True` form); `principled=True` makes
every non-emissive mesh PRINCIPLED with the roughness and metallic draws of
bench.py's BASELINE config 5 (:327-334).
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np

from ..io.genassets import generate_town
from ..io.obj import load_obj
from .camera import Camera
from .material import MaterialType
from .scene import build_scene


def town_scene(faces: int, two_key: bool = False, out_dir: str | None = None,
               textured: bool = False, principled: bool = False):
    """(scene, camera) of the town of about `faces` faces, with 2 motion
    keys if `two_key`, its textures if `textured` and PRINCIPLED materials
    if `principled`. The files go to `out_dir`, or to a temporary directory
    that is removed after loading."""
    if out_dir is None:
        with tempfile.TemporaryDirectory(prefix="rt3c_town_") as tmp:
            return town_scene(faces, two_key, tmp, textured, principled)
    paths, camkw = generate_town(out_dir, faces_target=faces,
                                 two_key=two_key)
    meshes, textures = load_obj(paths if two_key else paths[:1])
    if not textured:
        for m in meshes:
            m.material = dataclasses.replace(
                m.material, diffuse_texture_id=-1, emissive_texture_id=-1,
                roughness_texture_id=-1, normal_texture_id=-1)
        textures = []
    if principled:
        rng = np.random.default_rng(5)
        for m in meshes:
            if max(m.material.emissive) > 0:
                continue
            m.material = dataclasses.replace(
                m.material, material_type=MaterialType.PRINCIPLED,
                roughness=float(rng.uniform(0.15, 0.7)),
                metallic=float(rng.uniform(0.0, 0.9)))
    return build_scene(meshes, textures=textures or None), Camera(**camkw)
