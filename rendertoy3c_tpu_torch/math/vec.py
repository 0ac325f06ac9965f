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
