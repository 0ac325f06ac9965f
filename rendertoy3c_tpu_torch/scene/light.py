"""Emissive-triangle area light table (src/light.h, wavefront.cpp:257-275).

Port of rendertoy3c_tpu/scene/light.py's host build. Every triangle of an
emissive mesh becomes one light; `power_cdf` is the inclusive normalised
CDF of luminance * area (the power sampler's table, carried for parity).
`pick_light_uniform` is the uniform pick, clamped to count - 1, in the
float form of the megakernel (pallas_shade.py:711-713).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LightTable(NamedTuple):
    v0: np.ndarray  # [L, 3]
    v1: np.ndarray  # [L, 3]
    v2: np.ndarray  # [L, 3]
    emission: np.ndarray  # [L, 3]
    normal: np.ndarray  # [L, 3]
    area: np.ndarray  # [L]
    power_cdf: np.ndarray  # [L]


def build_light_table(v0, v1, v2, emission) -> LightTable:
    """Host build from numpy arrays of emissive triangles [L, 3]."""
    v0 = np.asarray(v0, np.float32).reshape(-1, 3)
    v1 = np.asarray(v1, np.float32).reshape(-1, 3)
    v2 = np.asarray(v2, np.float32).reshape(-1, 3)
    emission = np.asarray(emission, np.float32).reshape(-1, 3)
    if len(v0) == 0:
        # one dark degenerate light keeps the table well-formed; callers
        # gate on num_lights == 0
        v0 = v1 = v2 = np.zeros((1, 3), np.float32)
        emission = np.zeros((1, 3), np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    area = 0.5 * nlen[..., 0]
    normal = n / np.maximum(nlen, 1e-20)
    power = np.sum(emission * np.array([0.30, 0.59, 0.11], np.float32),
                   -1) * area
    total = power.sum()
    cdf = np.cumsum(power) / (total if total > 0 else 1.0)
    return LightTable(v0=v0, v1=v1, v2=v2, emission=emission, normal=normal,
                      area=area.astype(np.float32),
                      power_cdf=cdf.astype(np.float32))


def pick_light_uniform(u: torch.Tensor, num_lights: int):
    """Uniform pick: index = int(u * count) (closehit_radiance.cu:12),
    clamped to count - 1, since the reference indexes one past the end as
    u -> 1 (SURVEY.md S3.3). Returns (index as float32, pick pdf)."""
    idx = torch.clamp(torch.floor(u * float(num_lights)),
                      max=float(num_lights - 1))
    return idx, 1.0 / float(num_lights)
