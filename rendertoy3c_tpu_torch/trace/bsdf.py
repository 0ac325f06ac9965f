"""The four-type material dispatch of the shading body, on lane tensors.

Port of the `dispatch=True` branch of rendertoy3c_tpu/trace/pallas_shade.py
`_make_shade_kernel` (:563-700, NEE :826-843), which is
rendertoy3c_tpu/integrate/bsdf.py in the megakernel's operation order:

  DIFFUSE              the cosine-hemisphere draw, weight = albedo;
  SPECULAR             the mirror about the shading normal, weight = albedo;
  FRESNEL_TRANSMISSIVE the exact dielectric Fresnel at cos_o (total internal
                       reflection at sin2_t >= 1), reflect or refract by z1,
                       weight 1 or albedo * T + (1 - T);
  PRINCIPLED           a one-sample mix of the Lambertian base and a
                       GGX / Smith / Schlick specular lobe with sheen,
                       picked by z1 < p_spec, weight f * cos / pdf.

Directions are in the local frame (t, b, n) of the faceforwarded shading
normal, `wo` toward the viewer. This is the plain version of the
`kDispatch` code of kernels/csrc/shade.cuh `shade_lane`; divisions stay
tensor by tensor, as the kernel divides (CUDA torch turns a division by a
Python scalar into a multiply).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..math.sampling import TWO_PI
from ..math.vec import normalize3

INV_PI = 1.0 / math.pi
E7 = 1e-7  # the kernel's guard against zero (_E7)

SPECULAR, FRESNEL_TRANSMISSIVE, PRINCIPLED = 1.0, 2.0, 3.0


class MaterialLanes(NamedTuple):
    """One lane's material, from the 6 parameter rows of its attribute row
    (mtype roughness metallic ior transmittance sheen) and its albedo."""

    is_spec: torch.Tensor
    is_glass: torch.Tensor
    is_prin: torch.Tensor
    is_diff: torch.Tensor
    albedo: list
    metal: torch.Tensor
    ior: torch.Tensor
    transm: torch.Tensor
    sheen: torch.Tensor
    a2: torch.Tensor  # the GGX alpha squared
    f0: list  # the Schlick F0, rgb
    p_spec: torch.Tensor  # the principled lobe's specular share

    @property
    def is_delta(self) -> torch.Tensor:
        return self.is_spec | self.is_glass


def material_lanes(a, params_base: int, albedo) -> MaterialLanes:
    """The lanes' materials from attribute rows `a` (indexable by row) with
    the parameters at `params_base`, and their albedo [3 x R]."""
    mt, rough, metal, ior, transm, sheen = (a[params_base + k]
                                            for k in range(6))
    is_spec, is_glass, is_prin = (mt == SPECULAR, mt == FRESNEL_TRANSMISSIVE,
                                  mt == PRINCIPLED)
    alpha = torch.clamp(rough * rough, min=1e-4)
    r0 = (ior - 1.0) / (ior + 1.0)
    f0d = r0 * r0
    f0 = [f0d * (1.0 - metal) + albedo[c] * metal for c in range(3)]
    spec_w = 0.30 * f0[0] + 0.59 * f0[1] + 0.11 * f0[2]
    diff_w = (0.30 * albedo[0] + 0.59 * albedo[1]
              + 0.11 * albedo[2]) * (1.0 - metal)
    p_spec = torch.clamp(
        spec_w / torch.clamp(spec_w + diff_w, min=1e-9), 0.05, 0.98)
    return MaterialLanes(
        is_spec=is_spec, is_glass=is_glass, is_prin=is_prin,
        is_diff=~(is_spec | is_glass | is_prin), albedo=list(albedo),
        metal=metal, ior=ior, transm=transm, sheen=sheen, a2=alpha * alpha,
        f0=f0, p_spec=p_spec)


def _schlick5(c):
    """c^5 as the kernel computes it, (c c)(c c) c."""
    return (c * c) * (c * c) * c


def principled_eval(m: MaterialLanes, wo, wi):
    """(f rgb list, pdf) of the principled lobe pair at local directions
    wo, wi (each a 3-tuple of [R]), both 0 below the surface
    (_principled_eval_local of the reference, in the kernel's order)."""
    wox, woy, woz = wo
    wix, wiy, wiz = wi
    a2 = m.a2
    cos_i = wiz
    valid = (cos_i > E7) & (woz > E7)
    hx, hy, hz, _ = normalize3(wox + wix, woy + wiy, woz + wiz, eps=1e-20)
    cos_h = hz
    cos_oh = wox * hx + woy * hy + woz * hz
    denom = cos_h * cos_h * (a2 - 1.0) + 1.0
    d_g = a2 / torch.clamp(math.pi * denom * denom, min=1e-12)

    def smith_g1(cos_v):
        c2 = torch.clamp(cos_v * cos_v, 1e-12, 1.0)
        return 2.0 / (1.0 + torch.sqrt(1.0 + a2 * (1.0 - c2) / c2))

    g_sm = smith_g1(cos_i) * smith_g1(woz)
    spec_s = d_g * g_sm / torch.clamp(4.0 * cos_i * woz, min=1e-9)
    sw = _schlick5(torch.clamp(1.0 - torch.clamp(cos_oh, 0.0, 1.0), 0.0, 1.0))
    f_sheen = m.sheen * _schlick5(torch.clamp(1.0 - cos_oh, 0.0, 1.0))
    zero = torch.zeros_like(cos_i)
    f = [torch.where(valid, m.albedo[c] * ((1.0 - m.metal) * INV_PI)
                     + (m.f0[c] + (1.0 - m.f0[c]) * sw) * spec_s + f_sheen,
                     zero)
         for c in range(3)]
    pdf_spec = (d_g * torch.clamp(cos_h, min=0.0)
                / torch.clamp(4.0 * torch.abs(cos_oh), min=1e-12))
    pdf = torch.where(valid, m.p_spec * pdf_spec + (1.0 - m.p_spec)
                      * torch.clamp(cos_i, min=0.0) * INV_PI, zero)
    return f, pdf


def _pick4(m: MaterialLanes, spec_v, glass_v, prin_v, diff_v):
    return torch.where(m.is_spec, spec_v, torch.where(
        m.is_glass, glass_v, torch.where(m.is_prin, prin_v, diff_v)))


def dispatch_sample(m: MaterialLanes, wo, w_diff, z1, u1, u2):
    """(wi local 3-tuple, attenuation factor rgb list) of the lanes' own
    lobes: w_diff is the cosine-hemisphere draw of (u1, u2), z1 the lobe
    choice (pallas_shade.py :578-700)."""
    wox, woy, woz = wo
    one = torch.ones_like(woz)
    cos_o = torch.clamp(woz, min=E7)
    ior = m.ior
    # SPECULAR: the mirror
    mir = (-wox, -woy, woz)
    # FRESNEL_TRANSMISSIVE: the exact dielectric Fresnel at cos_o
    cos_ci = torch.clamp(cos_o, 0.0, 1.0)
    sin2_t = (1.0 - cos_ci * cos_ci) / torch.clamp(ior * ior, min=1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (ior * cos_ci - cos_t) / torch.clamp(ior * cos_ci + cos_t,
                                                 min=1e-12)
    r_perp = (cos_ci - ior * cos_t) / torch.clamp(cos_ci + ior * cos_t,
                                                  min=1e-12)
    f_diel = torch.where(tir, one, 0.5 * (r_par * r_par + r_perp * r_perp))
    eta = 1.0 / ior
    sin2_r = eta * eta * torch.clamp(1.0 - cos_o * cos_o, min=0.0)
    cos_rt = torch.sqrt(torch.clamp(1.0 - sin2_r, min=0.0))
    choose_refl = z1 < f_diel
    gl = (torch.where(choose_refl, mir[0], -eta * wox),
          torch.where(choose_refl, mir[1], -eta * woy),
          torch.where(choose_refl, mir[2], -cos_rt))
    w_glass = [torch.where(choose_refl, one,
                           m.albedo[c] * m.transm + (1.0 - m.transm))
               for c in range(3)]
    # PRINCIPLED: the one-sample mix (sample_ggx_half on u1, u2)
    phi_g = TWO_PI * u1
    den_g = 1.0 + (m.a2 - 1.0) * u2
    cos_hg = torch.sqrt(torch.clamp(
        (1.0 - u2) / torch.clamp(den_g, min=1e-12), 0.0, 1.0))
    sin_hg = torch.sqrt(torch.clamp(1.0 - cos_hg * cos_hg, min=0.0))
    hg = (sin_hg * torch.cos(phi_g), sin_hg * torch.sin(phi_g), cos_hg)
    cos_ohg = wox * hg[0] + woy * hg[1] + woz * hg[2]
    take_spec = z1 < m.p_spec
    pr = tuple(torch.where(take_spec, 2.0 * cos_ohg * h - w, wd)
               for h, w, wd in zip(hg, wo, w_diff))
    f_pr, pdf_pr = principled_eval(m, wo, pr)
    # cos / pdf first, as XLA orders it
    w_scale = (torch.clamp(pr[2], min=0.0)
               / torch.clamp(pdf_pr, min=E7))
    zero = torch.zeros_like(woz)
    w_prin = [torch.where(pdf_pr > E7, f_pr[c] * w_scale, zero)
              for c in range(3)]
    wi = tuple(_pick4(m, s, g, p, d)
               for s, g, p, d in zip(mir, gl, pr, w_diff))
    at_fac = [_pick4(m, m.albedo[c], w_glass[c], w_prin[c], m.albedo[c])
              for c in range(3)]
    return wi, at_fac


def nee_bsdf(m: MaterialLanes, wo, wl):
    """f(wo, wl) of the NEE term (:826-838): the principled eval, the
    Lambertian albedo / pi, 0 on delta lobes."""
    f_pr, _ = principled_eval(m, wo, wl)
    zero = torch.zeros_like(wo[2])
    return [torch.where(m.is_prin, f_pr[c],
                        torch.where(m.is_diff, m.albedo[c] * INV_PI, zero))
            for c in range(3)]
