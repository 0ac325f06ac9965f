"""Edge-aware a-trous wavelet denoiser.

Port of rendertoy3c_tpu/film/denoise.py `atrous_denoise` (:37): N
iterations of the 5x5 B3-spline a-trous filter with taps `1 << it` apart,
edge-clamped shifts (`_shift2d`, :21-34), and edge-stopping weights from
the colour difference and the optional normal and position guide buffers
(the SVGF-style joint filter), with the reference's sigmas. The reference
computes it with plain jnp operations and no Pallas kernel, so plain torch
operations on the image's device are its port; the terms are taken in the
reference's order.
"""
from __future__ import annotations

import torch

# B3-spline 5-tap kernel
_H = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2D shift of [H, W, C]: out[y, x] = img[clamp(y - dy),
    clamp(x - dx)]."""
    h, w = img.shape[:2]
    ys = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[ys][:, xs]


def _weight(buf: torch.Tensor, tap: torch.Tensor, sigma: float):
    """exp(-|tap - buf|^2 / (2 sigma^2)), [H, W, 1]."""
    d = tap - buf
    den = torch.tensor(2.0 * sigma * sigma, dtype=buf.dtype,
                       device=buf.device)
    return torch.exp(-torch.sum(d * d, dim=-1, keepdim=True) / den)


def atrous_denoise(rgb: torch.Tensor, normal: torch.Tensor | None = None,
                   position: torch.Tensor | None = None,
                   iterations: int = 3, sigma_color: float = 0.25,
                   sigma_normal: float = 0.2,
                   sigma_position: float = 0.5) -> torch.Tensor:
    """Denoise a linear-radiance image [H, W, 3] on its device. normal and
    position: optional [H, W, 3] guide buffers, which add SVGF-style
    edge-stopping terms."""
    out = rgb
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype,
                           device=out.device)
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                k = float(_H[iy + 2] * _H[ix + 2])
                tap = _shift2d(out, iy * step, ix * step)
                w = _weight(out, tap, sigma_color)
                for guide, sigma in ((normal, sigma_normal),
                                     (position, sigma_position)):
                    if guide is not None:
                        w = w * _weight(guide, _shift2d(
                            guide, iy * step, ix * step), sigma)
                acc = acc + k * w * tap
                wsum = wsum + k * w
        out = acc / torch.clamp(wsum, min=1e-8)
    return out
