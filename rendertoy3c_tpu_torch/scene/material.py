"""Host-side material description, diffuse and emission only.

Port of the part of rendertoy3c_tpu/scene/material.py the slice uses
(src/material.h:7-38). Other material types and textures are declared so
that a scene can name them, and the tracer choice rejects them
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
