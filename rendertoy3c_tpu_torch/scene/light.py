"""Emissive-triangle area light table (src/light.h, wavefront.cpp:257-275).

Port of rendertoy3c_tpu/scene/light.py's host build. Every triangle of an
emissive mesh becomes one light; `power_cdf` is the inclusive normalised
CDF of luminance * area, the power sampler's table. `pick_light_uniform`
is the uniform pick, clamped to count - 1, in the float form of the
megakernel (pallas_shade.py:711-713); `pick_light_power` the power pick
(light.py:88-95 of the reference). `light_tensors` and `sample_light`
(Light::Sample, light.py:97-134) serve the general shading of
integrate/path.py.
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


def pick_light_power(u: torch.Tensor, power_cdf: torch.Tensor,
                     num_lights: int):
    """Power-proportional pick by CDF inversion: index = searchsorted(cdf,
    u, right), clamped to count - 1; pdf = cdf[i] - cdf[i - 1] in f32.
    power_cdf: the table's CDF [>= num_lights] on u's device. Returns
    (index as float32, pick pdf [...]). For a nondecreasing CDF the index
    is the kernels' count of entries <= u, ties (zero-power lights)
    included."""
    cdf = power_cdf[:num_lights].contiguous()
    idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True),
                      max=num_lights - 1)
    lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)],
                     torch.zeros_like(u))
    return idx.to(torch.float32), cdf[idx] - lo


def light_tensors(lights: LightTable, device) -> LightTable:
    """The table's arrays as float32 tensors on `device`."""
    return LightTable(*(torch.as_tensor(np.asarray(a, np.float32),
                                        device=device) for a in lights))


def sample_light(lights: LightTable, idx: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, p: torch.Tensor):
    """Light::Sample (src/light.h:33-60) on [R] lanes: a uniform point of
    light `idx` seen from p [R, 3]. lights: light_tensors' table. Returns
    (position [R, 3], emission * solid angle [R, 3], pdf [R]) with the pdf
    in solid angle (1 / omega) and the reference's guards: dist^2 < 1e-5
    or omega < 1e-5 give emission 0 and pdf 1."""
    from ..math.sampling import sample_uniform_triangle
    from ..math.vec import dot

    b0, b1, b2 = sample_uniform_triangle(u, v)
    pos = (b0[:, None] * lights.v0[idx] + b1[:, None] * lights.v1[idx]
           + b2[:, None] * lights.v2[idx])
    dvec = pos - p
    dist2 = dot(dvec, dvec)
    safe_dist2 = torch.clamp(dist2, min=1e-20)
    ndir = dvec * (1.0 / torch.sqrt(safe_dist2))[:, None]
    omega = (torch.abs(dot(ndir, lights.normal[idx])) * lights.area[idx]
             / safe_dist2)
    degenerate = (dist2 < 1e-5) | (omega < 1e-5)
    emission = torch.where(degenerate[:, None], 0.0,
                           lights.emission[idx] * omega[:, None])
    pdf = torch.where(degenerate, 1.0,
                      1.0 / torch.clamp(omega, min=1e-20))
    return pos, emission, pdf
