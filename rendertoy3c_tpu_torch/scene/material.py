"""Host-side material description.

Port of the part of rendertoy3c_tpu/scene/material.py the port uses
(src/material.h:7-38): the fields the .obj loader fills. The renderer
shades diffuse and emission; other material types and textures are
declared so that a scene can name them, and the tracer choice rejects them
(trace/auto.py).
"""
from __future__ import annotations

import enum
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
