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
