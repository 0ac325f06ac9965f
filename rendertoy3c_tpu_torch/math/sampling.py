"""Monte-Carlo sampling primitives on component tensors.

Port of the part of rendertoy3c_tpu/math/sampling.py the slice needs
(src/util/sampling.h, src/light.h:36-40), with the float order of the
megakernel (pallas_shade.py:543-547, :722-725).
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def sample_cosine_hemisphere(u1: torch.Tensor, u2: torch.Tensor):
    """Cosine-weighted direction in the local +z frame -> (x, y, z)."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return x, y, z


def sample_uniform_triangle(u: torch.Tensor, v: torch.Tensor):
    """Uniform barycentric point via the sqrt warp -> (b0, b1, b2)."""
    su = torch.sqrt(u)
    b0 = 1.0 - su
    b1 = v * su
    return b0, b1, 1.0 - b0 - b1


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """src/util/math.h:21-23: sqrt of max(0, x)."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def cosine_hemisphere_pdf(cos_theta: torch.Tensor) -> torch.Tensor:
    """src/util/sampling.h:40-42."""
    return cos_theta * (1.0 / math.pi)


def power_heuristic(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic (beta = 2), shader_common.h:137-145."""
    p1_2 = p1 * p1
    p2_2 = p2 * p2
    return p1_2 / (p1_2 + p2_2)
