"""30-bit 3D Morton codes for spatial sorting.

Port of rendertoy3c_tpu/accel/morton.py: `morton3d_np` (:13-30), points
quantized to a 1024^3 grid with bits interleaved x/y/z on the host, and
`morton3d` (:33-49), the same code on a device tensor for the per-bounce
ray sort. torch on the CPU has no uint32 shifts, so `morton3d` carries the
codes in int64 (a 30-bit code never reaches the sign bit).
"""
from __future__ import annotations

import numpy as np
import torch


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d_np(xyz01: np.ndarray) -> np.ndarray:
    """Normalized [N,3] float coords in [0,1] -> uint32 Morton codes."""
    q = np.clip(xyz01 * 1024.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits_np(q[:, 0]) << 2)
        | (_expand_bits_np(q[:, 1]) << 1)
        | _expand_bits_np(q[:, 2])
    )


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(xyz01: torch.Tensor) -> torch.Tensor:
    """[..., 3] float32 coords in [0, 1] -> int64 Morton codes (the uint32
    values of the reference): clipped to [0, 1023] after x1024, then
    truncated."""
    q = torch.clamp(xyz01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))
