"""Orthonormal basis about a normal, on component tensors.

Port of rendertoy3c_tpu/math/onb.py (src/shader/shader_common.h:15-48),
with the |n.x| > |n.z| branch as a select, as the megakernel writes it
(pallas_shade.py:549-556).
"""
from __future__ import annotations

import torch

from .vec import normalize3


def onb_from_normal(nx: torch.Tensor, ny: torch.Tensor, nz: torch.Tensor):
    """Returns ((tx, ty, tz), (bx, by, bz)): tangent and binormal of n."""
    use_x = torch.abs(nx) > torch.abs(nz)
    zero = torch.zeros_like(nx)
    bx = torch.where(use_x, -ny, zero)
    by = torch.where(use_x, nx, -nz)
    bz = torch.where(use_x, zero, ny)
    bx, by, bz, _ = normalize3(bx, by, bz)
    tx = by * nz - bz * ny
    ty = bz * nx - bx * nz
    tz = bx * ny - by * nx
    return (tx, ty, tz), (bx, by, bz)
