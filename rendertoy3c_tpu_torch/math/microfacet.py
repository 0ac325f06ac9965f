"""Microfacet BSDF building blocks: GGX distribution, Smith masking,
Schlick Fresnel.

Port of rendertoy3c_tpu/math/microfacet.py (:19-88), in its operation
order, on tensors batched over leading axes, in the local shading frame
(+z = the shading normal). The general shading of integrate/bsdf.py uses
them; the kernels carry their own copy of the same arithmetic
(kernels/csrc/shade.cuh, and trace/bsdf.py as its plain version).
"""
from __future__ import annotations

import math

import torch

M_PI = math.pi


def schlick_weight(cos_theta: torch.Tensor) -> torch.Tensor:
    """(1 - cos)^5, clamped to [0, 1] first."""
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def schlick_fresnel(f0: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """F = f0 + (1 - f0) (1 - cos)^5 (whitted_cuda.h:47-50); the shapes
    broadcast (cos_theta[..., None] against an rgb f0)."""
    return f0 + (1.0 - f0) * schlick_weight(cos_theta)


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Exact unpolarised dielectric Fresnel; cos_i >= 0 on the entering
    side, eta = ior transmitted / ior incident; 1 under total internal
    reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t,
                                                min=1e-12)
    r_perp = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t,
                                                 min=1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, torch.ones_like(f), f)


def d_ggx(cos_h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX normal distribution D(h) at half-vector z-cosine cos_h."""
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(M_PI * denom * denom, min=1e-12)


def smith_g1(cos_v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Smith masking G1 for GGX."""
    a2 = alpha * alpha
    c2 = torch.clamp(cos_v * cos_v, 1e-12, 1.0)
    tan2 = (1.0 - c2) / c2
    return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))


def smith_g(cos_i, cos_o, alpha):
    return smith_g1(cos_i, alpha) * smith_g1(cos_o, alpha)


def sample_ggx_half(u1: torch.Tensor, u2: torch.Tensor,
                    alpha: torch.Tensor) -> torch.Tensor:
    """A GGX half-vector about local +z, [..., 3]; pdf(h) = D(h) cos_h."""
    a2 = alpha * alpha
    phi = 2.0 * M_PI * u1
    denom = 1.0 + (a2 - 1.0) * u2
    cos_h = torch.sqrt(torch.clamp((1.0 - u2) / torch.clamp(denom, min=1e-12),
                                   0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    return torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi),
                        cos_h], dim=-1)


def ggx_half_pdf(cos_h: torch.Tensor, cos_oh: torch.Tensor,
                 alpha: torch.Tensor) -> torch.Tensor:
    """pdf of the reflected direction when h ~ D(h) cos_h:
    D(h) cos_h / (4 |wo . h|)."""
    return d_ggx(cos_h, alpha) * torch.clamp(cos_h, min=0.0) / torch.clamp(
        4.0 * torch.abs(cos_oh), min=1e-12)
