"""Vector helpers on component tensors.

Port of the part of rendertoy3c_tpu/math/vec.py the slice needs, in the
component form the megakernel uses (pallas_shade.py _normalize3, :206).
The reciprocal square root is 1/sqrt(x), as in the CUDA kernels.
"""
from __future__ import annotations

import torch


def normalize3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
               eps: float = 1e-20):
    """(x, y, z) / |(x, y, z)| with the squared length clamped at eps.
    Returns (x, y, z, 1/length)."""
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=eps))
    return x * inv, y * inv, z * inv, inv


# ---- [..., 3] forms, for the general shading of integrate/path.py (the
# reference's vec.py :13-68 in its operation order)
def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, ((a0 b0 + a1 b1) + a2 b2)."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """a / |a| over the trailing axis; eps > 0 clamps the squared length
    from below (eps = 0: no guard, as the reference's rsqrt)."""
    d = dot(a, a)[..., None]
    if eps:
        d = torch.clamp(d, min=eps)
    return a * (1.0 / torch.sqrt(d))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """NTSC luminance (cuda/helpers.h:68-72: 0.30, 0.59, 0.11)."""
    w = torch.tensor([0.30, 0.59, 0.11], dtype=rgb.dtype, device=rgb.device)
    return dot(rgb, w)


def faceforward(n: torch.Tensor, i: torch.Tensor,
                nref: torch.Tensor) -> torch.Tensor:
    """n * copysign(1, dot(i, nref)) (sutil/vec_math.h faceforward)."""
    s = torch.where(dot(i, nref) >= 0.0, 1.0, -1.0)
    return n * s[..., None]
