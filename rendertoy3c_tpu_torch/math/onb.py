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


def onb_local_to_world(p_local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Onb::inverse_transform on [R, 3] tensors: p.x t + p.y b + p.z n
    (the reference's onb.py :35-41)."""
    (tx, ty, tz), (bx, by, bz) = onb_from_normal(n[:, 0], n[:, 1], n[:, 2])
    t = torch.stack([tx, ty, tz], dim=-1)
    b = torch.stack([bx, by, bz], dim=-1)
    return p_local[:, 0:1] * t + p_local[:, 1:2] * b + p_local[:, 2:3] * n


def onb_world_to_local(p_world: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """A world vector in the (t, b, n) frame, [R, 3] (onb.py :44-54)."""
    from .vec import dot

    (tx, ty, tz), (bx, by, bz) = onb_from_normal(n[:, 0], n[:, 1], n[:, 2])
    t = torch.stack([tx, ty, tz], dim=-1)
    b = torch.stack([bx, by, bz], dim=-1)
    return torch.stack([dot(p_world, t), dot(p_world, b), dot(p_world, n)],
                       dim=-1)
