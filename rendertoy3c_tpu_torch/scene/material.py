"""Host-side material description.

Port of the part of rendertoy3c_tpu/scene/material.py the port uses
(src/material.h:7-38): the fields the .obj loader fills, the texture ids,
the principled extras `metallic` and `sheen`, and the texture-coordinate
transform (`uv_transform_row`, `has_uv_transform`, :60-102). The renderer
shades the four material types, emission, diffuse textures and normal
maps in every pipeline, and the emissive and roughness maps in the
general shading of the bare tracers (integrate/path.py `_shade_and_nee`),
where trace/auto.py sends the scenes that carry them.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass


class MaterialType(enum.IntEnum):
    DIFFUSE = 0
    SPECULAR = 1
    FRESNEL_TRANSMISSIVE = 2
    PRINCIPLED = 3


@dataclass
class Material:
    """Defaults match src/material.h:15-38."""

    material_type: MaterialType = MaterialType.DIFFUSE
    diffuse: tuple = (1.0, 1.0, 1.0)
    diffuse_texture_id: int = -1
    emissive: tuple = (0.0, 0.0, 0.0)
    emissive_texture_id: int = -1
    roughness: float = 0.5
    roughness_texture_id: int = -1
    anisotropy: float = 0.0
    ior: float = 1.333
    transmittance: float = 0.0
    normal_texture_id: int = -1
    # principled-BSDF extras (the reference's defaults)
    metallic: float = 0.0
    sheen: float = 0.0
    # texture-coordinate transform (cuda/MaterialData.h texture desc
    # offset/rotation/scale; glTF KHR_texture_transform):
    # uv' = offset + R(rotation) @ (scale * uv)
    tex_offset: tuple = (0.0, 0.0)
    tex_rotation: float = 0.0
    tex_scale: tuple = (1.0, 1.0)

    def uv_transform_row(self):
        """Packed (m00, m01, m10, m11, ox, oy) row for the material table."""
        c, sn = math.cos(self.tex_rotation), math.sin(self.tex_rotation)
        sx, sy = self.tex_scale
        return (c * sx, -sn * sy, sn * sx, c * sy,
                self.tex_offset[0], self.tex_offset[1])

    def has_uv_transform(self) -> bool:
        return (self.tex_offset != (0.0, 0.0) or self.tex_rotation != 0.0
                or self.tex_scale != (1.0, 1.0))
