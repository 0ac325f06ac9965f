"""ACES tonemap, sRGB transfer and 8-bit quantisation (cuda/helpers.h:35-66).

Port of rendertoy3c_tpu/film/tonemap.py.
"""
from __future__ import annotations

import torch


def aces_tonemap(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz 2015 ACES filmic curve (src/gui/display.cpp)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (a * x + b)) / (x * (c * x + d) + e)


def to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer (cuda/helpers.h:35-43)."""
    powed = torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.4)
    return torch.where(c < 0.0031308, 12.92 * c, 1.055 * powed - 0.055)


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """clamp to [0,1] then min(uint(x*256), 255) (cuda/helpers.h:50-55)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.clamp((x * 256.0).to(torch.int64), max=255).to(torch.uint8)


def make_color(c: torch.Tensor, alpha: bool = True) -> torch.Tensor:
    """Linear RGB [..., 3] -> sRGB u8 [..., 3|4] (cuda/helpers.h:57-66)."""
    rgb = quantize_u8(to_srgb(torch.clamp(c, 0.0, 1.0)))
    if not alpha:
        return rgb
    a = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                   device=rgb.device)
    return torch.cat([rgb, a], dim=-1)
