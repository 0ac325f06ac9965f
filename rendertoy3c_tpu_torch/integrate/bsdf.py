"""The four-type BSDF of the general shading (`_shade_and_nee`), on lane
tensors [R] / [R, 3].

Port of rendertoy3c_tpu/integrate/bsdf.py (`MatParams`, `BsdfSample`,
the `_principled_*` helpers, `bsdf_sample` :120, `bsdf_eval` :206) in its
XLA operation order: every lobe is computed for every lane and the result
picked by material type.

  DIFFUSE              Lambertian, cosine-hemisphere sampling;
  SPECULAR             the mirror about +z, weight = albedo (a delta lobe);
  FRESNEL_TRANSMISSIVE the exact dielectric Fresnel picks reflection or
                       refraction by z1 (delta lobes);
  PRINCIPLED           a one-sample mix of the Lambertian base and a GGX /
                       Smith / Schlick specular lobe with sheen.

Directions point away from the surface, `wo` toward the viewer, in the
frame of the faceforwarded shading normal. Delta lobes have pdf 0 and
`is_delta`, and NEE skips them.

trace/bsdf.py holds the same BSDF in the megakernel's order, as component
lists, and is the plain version of the kernels' dispatch; no function of
it is reused here, since its forms differ (component lists, its own
fused Fresnel), and this module follows the reference's [R, 3] forms and
math/microfacet.py instead.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math.microfacet import (d_ggx, fresnel_dielectric, ggx_half_pdf,
                               sample_ggx_half, schlick_fresnel,
                               schlick_weight, smith_g)
from ..math.onb import onb_local_to_world, onb_world_to_local
from ..math.sampling import sample_cosine_hemisphere
from ..math.vec import dot, luminance, normalize
from ..scene.material import MaterialType

_INV_PI = 1.0 / math.pi
_EPS = 1e-7


class BsdfSample(NamedTuple):
    wi: torch.Tensor  # [R, 3] world-space sampled direction
    weight: torch.Tensor  # [R, 3] f * cos / pdf (or the delta throughput)
    pdf: torch.Tensor  # [R] solid-angle pdf of wi (0 on delta lobes)
    is_delta: torch.Tensor  # [R] bool: NEE skips these lanes


class MatParams(NamedTuple):
    """Per-lane material parameters gathered from the material table."""

    mtype: torch.Tensor  # [R] int
    albedo: torch.Tensor  # [R, 3] diffuse colour or texture
    roughness: torch.Tensor  # [R]
    metallic: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]
    transmittance: torch.Tensor  # [R]
    sheen: torch.Tensor  # [R]


def _principled_f0(p: MatParams) -> torch.Tensor:
    """Specular F0: the dielectric base from ior, lerped to the albedo by
    metallic."""
    r0 = (p.ior - 1.0) / (p.ior + 1.0)
    f0d = (r0 * r0)[:, None]
    return (f0d * (1.0 - p.metallic[:, None])
            + p.albedo * p.metallic[:, None])


def _ggx_alpha(p: MatParams) -> torch.Tensor:
    return torch.clamp(p.roughness * p.roughness, min=1e-4)


def _principled_spec_prob(p: MatParams, f0) -> torch.Tensor:
    """The one-sample selection probability of the specular lobe."""
    spec_w = luminance(f0)
    diff_w = luminance(p.albedo) * (1.0 - p.metallic)
    return torch.clamp(spec_w / torch.clamp(spec_w + diff_w, min=1e-9),
                       0.05, 0.98)


def _principled_eval_local(p: MatParams, f0, wo_l, wi_l):
    """(f [R, 3], pdf [R]) of the principled model in the local frame,
    reflection side only; both 0 when wi or wo is below the surface."""
    cos_o = wo_l[..., 2]
    cos_i = wi_l[..., 2]
    valid = (cos_i > _EPS) & (cos_o > _EPS)
    h = normalize(wo_l + wi_l, eps=1e-20)
    cos_h = h[..., 2]
    cos_oh = dot(wo_l, h)
    alpha = _ggx_alpha(p)

    f_spec = (schlick_fresnel(f0, torch.clamp(cos_oh, 0.0, 1.0)[:, None])
              * (d_ggx(cos_h, alpha) * smith_g(cos_i, cos_o, alpha)
                 / torch.clamp(4.0 * cos_i * cos_o, min=1e-9))[:, None])
    # Disney-style sheen on the Fresnel edge
    f_sheen = (p.sheen * schlick_weight(cos_oh))[:, None] * torch.ones_like(
        f_spec)
    f_diff = p.albedo * ((1.0 - p.metallic) * _INV_PI)[:, None]
    f = torch.where(valid[:, None], f_diff + f_spec + f_sheen, 0.0)

    p_spec = _principled_spec_prob(p, f0)
    pdf_spec = ggx_half_pdf(cos_h, cos_oh, alpha)
    pdf_diff = torch.clamp(cos_i, min=0.0) * _INV_PI
    pdf = torch.where(valid, p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff,
                      0.0)
    return f, pdf


def _pick(mt, spec, glass, prin, diff):
    """The value of each lane's own material type (mt [R] or [R, 1])."""
    return torch.where(
        mt == int(MaterialType.SPECULAR), spec,
        torch.where(mt == int(MaterialType.FRESNEL_TRANSMISSIVE), glass,
                    torch.where(mt == int(MaterialType.PRINCIPLED), prin,
                                diff)))


def bsdf_sample(p: MatParams, ns, wo_world, z1, u1, u2) -> BsdfSample:
    """One bounce direction per lane, dispatched on material type. z1
    picks the lobe (specular or diffuse for PRINCIPLED, reflect or refract
    for FRESNEL_TRANSMISSIVE); u1, u2 warp the chosen lobe."""
    wo_l = onb_world_to_local(wo_world, ns)
    cos_o = torch.clamp(wo_l[..., 2], min=_EPS)
    ones = torch.ones_like(wo_l)

    # DIFFUSE: the cosine hemisphere (closehit_radiance.cu:90-112)
    wi_diff_l = torch.stack(sample_cosine_hemisphere(u1, u2), dim=-1)
    pdf_diff = torch.clamp(wi_diff_l[..., 2], min=0.0) * _INV_PI
    w_diff = p.albedo  # f cos / pdf = albedo / pi cos / (cos / pi)

    # SPECULAR: the mirror about +z
    wi_mirr_l = wo_l * torch.tensor([-1.0, -1.0, 1.0], device=wo_l.device)
    w_mirr = p.albedo

    # FRESNEL_TRANSMISSIVE: the smooth dielectric, entering on the
    # faceforwarded side
    f_diel = fresnel_dielectric(cos_o, p.ior)
    eta = 1.0 / p.ior
    sin2_t = eta * eta * torch.clamp(1.0 - cos_o * cos_o, min=0.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_refr_l = torch.stack([-eta * wo_l[..., 0], -eta * wo_l[..., 1],
                             -cos_t], dim=-1)
    choose_refl = z1 < f_diel
    wi_glass_l = torch.where(choose_refl[:, None], wi_mirr_l, wi_refr_l)
    # the one-sample Fresnel estimator: weight 1 on both branches (tinted)
    w_glass = torch.where(
        choose_refl[:, None], ones,
        p.albedo * p.transmittance[:, None]
        + (1.0 - p.transmittance[:, None]))

    # PRINCIPLED: the one-sample mix of diffuse and GGX
    f0 = _principled_f0(p)
    p_spec = _principled_spec_prob(p, f0)
    alpha = _ggx_alpha(p)
    h_l = sample_ggx_half(u1, u2, alpha)
    cos_oh = dot(wo_l, h_l)
    wi_spec_l = 2.0 * cos_oh[:, None] * h_l - wo_l
    take_spec = z1 < p_spec
    wi_prin_l = torch.where(take_spec[:, None], wi_spec_l, wi_diff_l)
    f_prin, pdf_prin = _principled_eval_local(p, f0, wo_l, wi_prin_l)
    w_prin = torch.where(
        (pdf_prin > _EPS)[:, None],
        f_prin * (torch.clamp(wi_prin_l[..., 2], min=0.0)
                  / torch.clamp(pdf_prin, min=_EPS))[:, None],
        0.0)

    mt = p.mtype[:, None]
    wi_l = _pick(mt, wi_mirr_l, wi_glass_l, wi_prin_l, wi_diff_l)
    weight = _pick(mt, w_mirr, w_glass, w_prin, w_diff)
    zero = torch.zeros_like(pdf_diff)
    pdf = torch.where(
        p.mtype == int(MaterialType.PRINCIPLED), pdf_prin,
        torch.where(p.mtype == int(MaterialType.DIFFUSE), pdf_diff, zero))
    is_delta = ((p.mtype == int(MaterialType.SPECULAR))
                | (p.mtype == int(MaterialType.FRESNEL_TRANSMISSIVE)))
    wi = onb_local_to_world(wi_l, ns)
    return BsdfSample(wi=wi, weight=weight, pdf=pdf, is_delta=is_delta)


def bsdf_eval(p: MatParams, ns, wo_world, wi_world):
    """(f(wo, wi) [R, 3], pdf [R]) for NEE; 0 on delta lanes."""
    wo_l = onb_world_to_local(wo_world, ns)
    wi_l = onb_world_to_local(wi_world, ns)
    cos_i = torch.clamp(wi_l[..., 2], min=0.0)

    f_diff = p.albedo * _INV_PI
    pdf_diff = cos_i * _INV_PI

    f0 = _principled_f0(p)
    f_prin, pdf_prin = _principled_eval_local(p, f0, wo_l, wi_l)

    is_prin = (p.mtype == int(MaterialType.PRINCIPLED))[:, None]
    is_diff = (p.mtype == int(MaterialType.DIFFUSE))[:, None]
    f = torch.where(is_prin, f_prin, torch.where(is_diff, f_diff, 0.0))
    zero = torch.zeros_like(pdf_diff)
    pdf = torch.where(
        p.mtype == int(MaterialType.PRINCIPLED), pdf_prin,
        torch.where(p.mtype == int(MaterialType.DIFFUSE), pdf_diff, zero))
    return f, pdf
