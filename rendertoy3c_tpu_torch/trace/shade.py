"""The pool pipelines: shade tables, the slice gates, the megakernel with
in-kernel refill (K4) and without it (K5), and the external shade kernel
(K6).

Port of rendertoy3c_tpu/trace/pallas_shade.py for the port's
configurations: all-diffuse (the Lambertian branch, :557-563 and
:816-863) or the four-type material dispatch (`dispatch`, :563-700 and
:826-843, in trace/bsdf.py), untextured or with diffuse textures, uv
transforms and normal maps (:459-535), the uniform or the power light
sampler (:710-720, :742-745), without or with the first-hit AOV rows
(`aov`, :881-893, misc width 16 or 24). It holds
`build_shade_tables` (:72); `texture_state` (the
reference's `_fused_texture_state`, :1101, without its TPU atlas limits);
`fused_unsupported` (the narrowing of `fused_shade_eligible`, :1116),
`FusedPipeline` (:1379) with `trace_shade` (K5, the merged megakernel of
`make_fused_shader`, :1224-1275, :1371-1375), `closest_raw` (:1431, K1
or K3's raw output) and `refill_shader` (:1437) over the wrapper of K4,
for static or 2-key scenes of up to 2048 faces; `make_fused_shader`
(:1131) with merged=False, the non-merged K5 (the same kernel with the
closest hit hit4 [P, 4] given);
and `external_unsupported` (the narrowing of `external_shade_eligible`,
:1459), `ExternalPipeline` (:1820) and the wrapper of K6
(`make_external_shader`, :1678), for static or 2-key scenes of up to
16384 faces, with the closest and shadow any-hit traced outside the shade
kernel by an MT tracer (trace/mt.py `make_mt_tracer`).

Per-lane state layout (pallas_shade.py:32-36):
  rays  [P, 8]  f32: org.xyz dir.xyz tmin tmax
  misc  [P, 16] f32: 0 seed(bits) | 1-3 atten | 4-6 last_atten
        | 7 prev_delta | 8 depth | 9 alive | 10-12 acc | 13 pixel
        | 14 samp | 15 want_shadow
        AOV (misc [P, 24]): | 16-18 first-hit albedo acc
        | 19-21 first-hit shading-normal acc | 22-23 zero
  stash [P, 16] f32: 0 pixel (-1 = free) | 1-3 acc | 4-9 the AOV accs
                     (zero without AOV) | 10-15 zero
  time  [P]     f32: the ray time of a 2-key scene (the reference's
                     time8 [P, 8] holds it in each of its 8 columns)
  stats [4] int32  : next_work, count_hint, n_live, 0

K4 updates rays, misc, stash (and time) in place. K5 reads rays, misc (and
time) and returns new rays and misc. Both sweep their rays in 256-ray
tiles, static or motion, and skip the sweeps of tiles at or past the live
count. The non-merged K5 reads rays, hit4 and misc: no time, since the
shadow rays' time is a peek of the seed in both forms (:756-760).

K6 reads rays, the closest hit hit4 [R, 4] (t, prim_f, u, v) and misc
[R, W] (W = 16, or 24 with AOV), and writes new arrays: rays_out [R, 8],
misc_out [R, W + 8] (columns 0 to W-1 as misc, W to W+2 the pending NEE
term, the rest zero) and the shadow rays [R, 8] (org, dir, tmin, tmax),
[R, 16] for motion with the ray time in column 8. The walk pool's
`transposed` layout takes misc C-major [W, R] and returns misc_out
[W + 8, R] (integrate/walkpool.py).

A textured scene (texture_state 'diffuse') widens the attribute rows to
24-40 and carries a TexState: the atlas's RGBA8 texels and meta rows on
the device, which the kernels' textured variants read (shade.cuh
`tex_fetch`) and the plain versions sample through
`sample_texture_bilinear`. A scene with a non-diffuse material appends the
6 material-parameter rows at `params_base` (16, or 23-33 textured) and
takes the kernels' dispatch variants; `power=True` picks lights by the
CDF the light table carries in row 17.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..kernels import build as kbuild
from ..math import rng
from ..math.onb import onb_from_normal
from ..math.sampling import sample_cosine_hemisphere, sample_uniform_triangle
from ..math.vec import normalize3
from ..scene.camera import camera_ray_dir
from ..scene.light import pick_light_power, pick_light_uniform
from ..scene.texture import TextureAtlas, atlas_to, sample_texture_bilinear
from .bsdf import dispatch_sample, material_lanes, nee_bsdf
from .mt import (RAY_TILE, MotionSoup, TriSoup, any_motion_ref, any_ref,
                 build_tri_soup, closest_motion_ref, closest_ref,
                 motion_union_aabbs, mt_closest, mt_closest_motion,
                 require_zero_padding)

_INV_PI = 1.0 / math.pi
MAX_FACES = 2048  # the fused path's face limit (pallas_shade.py:59)
EXTERNAL_MAX_FACES = 16384  # the MT band's limit (auto.py:28)
AOV_COLS = 16  # first misc column of the AOV accs (16-18 albedo, 19-21 ns)
STASH_AOV = 4  # first stash column of a retired lane's AOV accs (4-9)
# (misc column, stash column) of each image's acc: the radiance, and with
# AOV the first-hit albedo and shading normal
ACC_COLS = ((10, 1), (AOV_COLS, STASH_AOV), (AOV_COLS + 3, STASH_AOV + 3))


def misc_width(aov: bool) -> int:
    """The misc state's width: 16, or 24 with the AOV rows."""
    return 24 if aov else 16


def build_shade_tables(scene, textured: bool = False,
                       uv_xform: bool = False, normal_maps: bool = False,
                       f_limit: int | None = None, dispatch: bool = False):
    """(attr_t [H, F], lights_t [24, Lp]) numpy tables, laid out as the
    reference's (pallas_shade.py:72-152).

    Attr rows 0-15: n0 n1 n2 emission diffuse pad (H = 16). A textured
    scene appends rows 16-21 uv0.xy uv1.xy uv2.xy and 22 the diffuse
    texture id; with `uv_xform` rows 23-28 the material's uv transform
    (m00 m01 m10 m11 ox oy); with `normal_maps`, from `nmap_base` (23 or
    29) the raw per-face tangent e1 * duv2.y - e2 * duv1.y and the normal
    texture id. `dispatch` appends the 6 material-parameter rows at
    `params_row` (mtype roughness metallic ior transmittance sheen). H is
    padded to a multiple of 8. Light rows: v0 v1 v2 emission normal area,
    row 16 = per-light power-pick probability, row 17 = the power CDF the
    kernels' pick searches (the reference bakes it into its kernel as
    constants). f_limit truncates the face axis to the traced soup's
    padded width."""
    g = scene.geom
    f = g.mat_id.shape[0]
    if f_limit is not None:
        f = min(f, f_limit)
    mat_id = np.asarray(g.mat_id)[:f]
    nmap_base = nmap_row(uv_xform)
    params_base = params_row(textured, uv_xform, normal_maps)
    height = params_base + 6 if dispatch else params_base
    attr = np.zeros((f, -(-height // 8) * 8), np.float32)
    attr[:, 0:3] = np.asarray(g.n0[0])[:f]
    attr[:, 3:6] = np.asarray(g.n1[0])[:f]
    attr[:, 6:9] = np.asarray(g.n2[0])[:f]
    attr[:, 9:12] = np.asarray(scene.materials.emission)[mat_id]
    attr[:, 12:15] = np.asarray(scene.materials.diffuse)[mat_id]
    if textured:
        attr[:, 16:18] = np.asarray(g.uv0)[:f]
        attr[:, 18:20] = np.asarray(g.uv1)[:f]
        attr[:, 20:22] = np.asarray(g.uv2)[:f]
        attr[:, 22] = np.asarray(scene.materials.diffuse_tex)[mat_id]
        if uv_xform:
            attr[:, 23:29] = np.asarray(scene.materials.uv_xform)[mat_id]
        if normal_maps:
            duv1 = (np.asarray(g.uv1) - np.asarray(g.uv0))[:f]
            duv2 = (np.asarray(g.uv2) - np.asarray(g.uv0))[:f]
            tang = (np.asarray(g.e1[0])[:f] * duv2[:, 1:2]
                    - np.asarray(g.e2[0])[:f] * duv1[:, 1:2])
            attr[:, nmap_base:nmap_base + 3] = tang
            attr[:, nmap_base + 3] = np.asarray(
                scene.materials.normal_tex)[mat_id]
    if dispatch:
        m = scene.materials
        for k, col in enumerate((m.mtype, m.roughness, m.metallic, m.ior,
                                 m.transmittance, m.sheen)):
            attr[:, params_base + k] = np.asarray(col)[mat_id]

    lt = scene.lights
    n_l = max(scene.num_lights, 1)
    lp = -(-n_l // 8) * 8
    lights = np.zeros((lp, 24), np.float32)
    lights[:n_l, 0:3] = np.asarray(lt.v0)[:n_l]
    lights[:n_l, 3:6] = np.asarray(lt.v1)[:n_l]
    lights[:n_l, 6:9] = np.asarray(lt.v2)[:n_l]
    lights[:n_l, 9:12] = np.asarray(lt.emission)[:n_l]
    lights[:n_l, 12:15] = np.asarray(lt.normal)[:n_l]
    lights[:n_l, 15] = np.asarray(lt.area)[:n_l]
    cdf = np.asarray(lt.power_cdf, np.float32)[:n_l]
    prev = np.concatenate([np.zeros(1, np.float32), cdf[:-1]])
    lights[:n_l, 16] = cdf - prev
    lights[:n_l, 17] = cdf
    return (np.ascontiguousarray(attr.T), np.ascontiguousarray(lights.T))


def nmap_row(uv_xform: bool) -> int:
    """First normal-map row of a textured attribute table."""
    return 29 if uv_xform else 23


def params_row(textured: bool, uv_xform: bool, normal_maps: bool) -> int:
    """First material-parameter row (the reference's attr_params_base,
    pallas_shade.py:62-69): the rows before it end there."""
    if not textured:
        return 16
    return nmap_row(uv_xform) + (4 if normal_maps else 0)


def texture_state(scene) -> str:
    """'none' (no texture images), 'diffuse' (diffuse textures and normal
    maps, which the kernels fetch) or 'unsupported' (emissive or roughness
    textures): the reference's `_fused_texture_state` (:1101-1113) without
    its atlas limits, MAX_ATLAS_TEXELS and the quad table's 1 << 20 texels,
    which are VMEM and gather limits of the TPU (ROADMAP A9)."""
    if not scene.textured:
        return "none"
    m = scene.materials
    if (np.asarray(m.roughness_tex) >= 0).any() or (
            np.asarray(m.emissive_tex) >= 0).any():
        return "unsupported"
    return "diffuse"


@dataclass(frozen=True)
class TexState:
    """The texture side of a textured pipeline: the atlas on the device
    (RGBA8 data and meta, no quad table) and the attribute-row switches."""

    atlas: TextureAtlas
    uv_xform: bool
    normal_maps: bool

    @property
    def nmap_base(self) -> int:
        return nmap_row(self.uv_xform)

    def params(self):
        """The kernels' kbuild.TexParams (keeps no reference to the
        tensors: the TexState must outlive the launch)."""
        return kbuild.TexParams(
            texels=self.atlas.data.data_ptr(), meta=self.atlas.meta.data_ptr(),
            aw=self.atlas.data.shape[1], uv_xform=int(self.uv_xform),
            normal_maps=int(self.normal_maps), nmap_base=self.nmap_base)


def shade_tables_for(scene, device, f_limit: int | None = None):
    """(attr_t [H, F], lights_t [24, Lp], TexState or None, params_base)
    of a scene the gates accept: textured tables where texture_state is
    'diffuse', the material-parameter rows at params_base where a material
    is not DIFFUSE (params_base 0 for an all-diffuse scene)."""
    textured = texture_state(scene) == "diffuse"
    uv_xform = textured and scene.any_uv_transform
    normal_maps = textured and scene.any_normal_map
    dispatch = not scene.all_diffuse
    attr_t, lights_t = build_shade_tables(scene, textured, uv_xform,
                                          normal_maps, f_limit, dispatch)
    tex = None
    if textured:
        # the kernels read meta rows by these ids unchecked
        n_tex = scene.atlas.meta.shape[0]
        for kind, ids in (("diffuse", scene.materials.diffuse_tex),
                          ("normal", scene.materials.normal_tex)):
            if (np.asarray(ids) >= n_tex).any():
                raise ValueError(f"a material's {kind} texture id "
                                 f"{int(np.max(ids))} names none of the "
                                 f"scene's {n_tex} textures")
        tex = TexState(atlas=atlas_to(scene.atlas, device),
                       uv_xform=uv_xform, normal_maps=normal_maps)
    params_base = (params_row(textured, uv_xform, normal_maps) if dispatch
                   else 0)
    return attr_t, lights_t, tex, params_base


def route_checks(scene, cfg):
    """(failed, reason) pairs of what no pipeline takes: the wave
    integrator and more than 2 keys, which bare tracers render."""
    return (
        (cfg.integrator != "pool",
         "the wave integrator renders bare tracers only"),
        (scene.num_keys > 2, "more than 2 motion keys need the N-key "
         "brute tracer (ROADMAP A5)"),
    )


def shading_checks(scene, cfg):
    """(failed, reason) pairs of what the kernels do not shade, as the
    reference's eligibility refuses it (pallas_shade.py:1116-1128,
    :1459-1481). The tracer choice sends such scenes to a bare tracer up to
    16384 faces and past them to the walk pool's general shade stage
    (integrate/walkpool.py general_shade), both shaded by
    integrate/path.py `_shade_and_nee` in torch ops."""
    general = "shaded outside the kernels (integrate/path.py _shade_and_nee)"
    return (
        (texture_state(scene) == "unsupported", "emissive and roughness "
         f"textures are {general}"),
        (scene.any_normal_map and texture_state(scene) != "diffuse",
         f"normal maps without texture images are {general}"),
        (cfg.throughput_model != "reference",
         f"the physical throughput model is {general}"),
        (scene.num_lights < 1, f"scenes without lights are {general}"),
        (getattr(scene, "env", None) is not None,
         f"environment maps are {general}"),
    )


def _slice_checks(scene, cfg):
    """The checks both pipelines' gates share: route_checks, then
    shading_checks."""
    return route_checks(scene, cfg) + shading_checks(scene, cfg)


def fused_unsupported(scene, cfg) -> str | None:
    """Why (scene, cfg) is outside the ported slice, naming the ROADMAP
    item that adds it; None when the fused pipeline renders it."""
    return _first_failed(_slice_checks(scene, cfg) + (
        (scene.num_faces > MAX_FACES,
         f"scenes of more than {MAX_FACES} faces take the external "
         "pipeline (ExternalPipeline)"),))


def external_unsupported(scene, cfg) -> str | None:
    """Why (scene, cfg) is outside the external pipeline's slice, naming
    the ROADMAP item that adds it; None when ExternalPipeline renders it.
    A trace-time instanced scene has no face limit here: its tracer is
    the instanced walk (pallas_shade.py:1473-1478)."""
    instanced = hasattr(scene, "instance_mesh")
    return _first_failed(_slice_checks(scene, cfg) + (
        (not instanced and scene.num_faces > EXTERNAL_MAX_FACES,
         f"scenes of more than {EXTERNAL_MAX_FACES} faces take the "
         "hierwalk band's walk pool (WalkPoolPipeline)"),))


def _first_failed(checks) -> str | None:
    for failed, reason in checks:
        if failed:
            return reason
    return None


@dataclass(frozen=True)
class RefillConfig:
    """Static parameters of one refill megakernel (one pool geometry)."""

    n_pix: int
    spp: int
    width: int
    height: int
    max_depth: int
    num_lights: int
    primary_tmin: float
    primary_tmax: float
    shadow_tmin: float
    shadow_eps: float
    bg: tuple
    seed_rot: int
    power: bool = False  # the power light pick
    aov: bool = False  # misc [P, 24] with the first-hit AOV rows


@dataclass(frozen=True)
class ShadeConfig:
    """Static parameters of the shading body (K5, K6)."""

    max_depth: int
    num_lights: int
    shadow_tmin: float
    shadow_eps: float
    bg: tuple
    motion: bool
    power: bool = False  # the power light pick
    aov: bool = False  # misc [R, 24] with the first-hit AOV rows


@dataclass(frozen=True)
class ShadeTables:
    """Device tables the megakernels (K4, K5) read."""

    soup: TriSoup  # key 0, with its own cull boxes
    attr_t: torch.Tensor  # [H, F'] f32 (H = 16, or 24-40 textured)
    lights_t: torch.Tensor  # [24, Lp] f32
    jump: torch.Tensor  # [spp, 2] int64 (uint32 values): per-sample (a, c)
    jump_u32: torch.Tensor  # the same table as uint32 bits (int32), for K4
    # a 2-key scene: both keys' tiles and the union cull boxes the sweeps use
    msoup: MotionSoup | None = None
    tex: TexState | None = None  # a textured scene's atlas and switches
    params_base: int = 0  # material-parameter rows (dispatch), 0 = none

    def sweep_tables(self):
        """(tris, tris1, aabb, super_aabb) the kernels sweep: tris1 is None
        for a static scene."""
        if self.msoup is None:
            s = self.soup
            return s.tris, None, s.aabb, s.super_aabb
        m = self.msoup
        return m.tris0, m.tris1, m.aabb, m.super_aabb


def _plain_sweeps(tables: ShadeTables, count, time):
    """The plain closest and shadow sweeps of K4/K5 at 256-ray tiles:
    (closest(rays) -> hit4 [R, 4], occluded(shadow_rays, shadow_time) ->
    occ [R]). A motion scene sweeps the closest rays at `time` [R] and the
    shadow rays at their own time."""
    if tables.msoup is None:
        return (lambda rays: closest_ref(rays, count, tables.soup),
                lambda sh, _t: any_ref(sh, count, tables.soup)[:, 0])
    m = tables.msoup
    return (lambda rays: closest_motion_ref(rays, time, count, m, RAY_TILE),
            lambda sh, t: any_motion_ref(sh, t, count, m, RAY_TILE)[:, 0])


def _textured_normal_and_albedo(a, w0, bu, bv, ng, tex: TexState, it=None):
    """The texture work of the shading body (pallas_shade.py :459-535):
    uvs interpolated at (w0, bu, bv), the material's uv transform,
    the normal map applied to the interpolated normal `ng` before the
    faceforward, and the diffuse texture. Returns (ng, texture rgb [R, 3],
    diffuse texture id [R], (u, v)); fetches by sample_texture_bilinear.
    it: an instanced lane's transform rows [18, R], whose forward rows
    9-17 move the object-space tangent to world space (:487-501)."""
    tid = a[22]
    tu = w0 * a[16] + bu * a[18] + bv * a[20]
    tv = w0 * a[17] + bu * a[19] + bv * a[21]
    if tex.uv_xform:
        tu, tv = (a[23] * tu + a[24] * tv + a[27],
                  a[25] * tu + a[26] * tv + a[28])
    if tex.normal_maps:
        nb = tex.nmap_base
        ntex = a[nb + 3]
        ntsx, ntsy, ntsz = (c * 2.0 - 1.0 for c in sample_texture_bilinear(
            tex.atlas, ntex, tu, tv).unbind(1))
        ngx, ngy, ngz = ng
        tgx, tgy, tgz = a[nb], a[nb + 1], a[nb + 2]
        if it is not None:
            tgx, tgy, tgz = (it[9] * tgx + it[10] * tgy + it[11] * tgz,
                             it[12] * tgx + it[13] * tgy + it[14] * tgz,
                             it[15] * tgx + it[16] * tgy + it[17] * tgz)
        d_tn = tgx * ngx + tgy * ngy + tgz * ngz
        tgx, tgy, tgz, _ = normalize3(tgx - ngx * d_tn, tgy - ngy * d_tn,
                                      tgz - ngz * d_tn, eps=1e-12)
        btx = ngy * tgz - ngz * tgy
        bty = ngz * tgx - ngx * tgz
        btz = ngx * tgy - ngy * tgx
        mg = normalize3(ntsx * tgx + ntsy * btx + ntsz * ngx,
                        ntsx * tgy + ntsy * bty + ntsz * ngy,
                        ntsx * tgz + ntsy * btz + ntsz * ngz, eps=1e-12)[:3]
        ng = tuple(torch.where(ntex >= 0.0, m, n) for m, n in zip(mg, ng))
    return ng, sample_texture_bilinear(tex.atlas, tid, tu, tv), tid, (tu, tv)


def _shade_lanes(rays, hit4, misc, a, lights_t, sc, shadow_occluded=None,
                 tex: TexState | None = None, params_base: int = 0, it=None):
    """The shading body shared by K4, K5 and K6 (pallas_shade.py
    :436-880): emission at depth 0 and after delta lobes, miss ambient,
    textures (`tex`), the Lambertian draw or (params_base > 0) the
    four-type dispatch (trace/bsdf.py), the uniform or (sc.power) power
    light pick and area sample, NEE, RR, the next state, and (sc.aov) the
    AOV rows: misc columns 16-21 plus the albedo and the face-forwarded
    shading normal where `adv & (depth == 0)` (:881-893).

    hit4 [R, 4] (t, prim_f, u, v); a: attribute rows [>=15, R] gathered by
    prim (the textured rows and the material-parameter rows at
    params_base too). it: an instanced scene's transform rows [18, R] of
    each lane's instance (inst_transform_rows), whose inverse-transpose
    rows 0-8 move the object-space normal to world space (:447-457).
    `shadow_occluded(shadow_rays [R, 8], time [R]) -> occ [R]` runs
    the in-kernel shadow sweep (K4, K5) at the shadow rays' time, a peek of
    the post-NEE stream; None is the external variant (K6): NEE is
    provisional on want_shadow and leaves as `nee`, for the caller to add
    on unoccluded lanes, and the shadow rays leave with that time. sc
    carries max_depth, num_lights, shadow_tmin, shadow_eps, bg, power, aov.
    Returns a dict of the per-lane results; "cond" holds the intermediates
    that decide how far a last-ulp difference carries (the sampled cosine
    wz, cos_l, n.l, the light distance, p_rr, the draws u_rr and u_pick,
    the light index)."""
    t_hit, prim_f, bu, bv = hit4.unbind(1)
    ox, oy, oz, dx, dy, dz = rays[:, :6].unbind(1)

    seed = rng.bits_to_state(misc[:, 0])
    atten = misc[:, 1:4].unbind(1)
    last_at = misc[:, 4:7].unbind(1)
    prev_delta, depth = misc[:, 7], misc[:, 8]
    alive = misc[:, 9] > 0.0
    acc = misc[:, 10:13].unbind(1)
    one, zero = torch.ones_like(depth), torch.zeros_like(depth)
    emit_gate = torch.where((depth == 0.0) | (prev_delta > 0.0), one, zero)
    is_hit = prim_f >= 0.0

    # --- shading attributes ---
    w0 = 1.0 - bu - bv
    ngx = w0 * a[0] + bu * a[3] + bv * a[6]
    ngy = w0 * a[1] + bu * a[4] + bv * a[7]
    ngz = w0 * a[2] + bu * a[5] + bv * a[8]
    ngx, ngy, ngz, _ = normalize3(ngx, ngy, ngz)
    if it is not None:
        ngx, ngy, ngz, _ = normalize3(
            it[0] * ngx + it[1] * ngy + it[2] * ngz,
            it[3] * ngx + it[4] * ngy + it[5] * ngz,
            it[6] * ngx + it[7] * ngy + it[8] * ngz)
    if tex is not None:
        (ngx, ngy, ngz), tex_rgb, tid, tex_uv = _textured_normal_and_albedo(
            a, w0, bu, bv, (ngx, ngy, ngz), tex, it)
    side = torch.where(-(dx * ngx + dy * ngy + dz * ngz) >= 0.0, one, -one)
    nsx, nsy, nsz = ngx * side, ngy * side, ngz * side
    px, py, pz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    hit_f = is_hit.to(torch.float32)
    emitted = [a[9 + c] * emit_gate * hit_f for c in range(3)]
    albedo = [a[12 + c] for c in range(3)]
    if tex is not None:
        albedo = [torch.where(tid >= 0.0, tex_rgb[:, c], albedo[c])
                  for c in range(3)]

    # --- BSDF sample (cosine hemisphere; reference draw order) ---
    adv = is_hit & alive
    seed, z1 = rng.rnd_masked(seed, adv)
    seed, _ = rng.rnd_masked(seed, adv)
    seed, u1 = rng.rnd_masked(seed, adv)
    seed, u2 = rng.rnd_masked(seed, adv)
    wx, wy, wz = sample_cosine_hemisphere(u1, u2)
    (txx, txy, txz), (bx0, by0, bz0) = onb_from_normal(nsx, nsy, nsz)
    mat = None
    if params_base:
        # the four-type dispatch in the (t, b, n) frame, wo = -d
        mat = material_lanes(a, params_base, albedo)
        wo = (-(dx * txx + dy * txy + dz * txz),
              -(dx * bx0 + dy * by0 + dz * bz0),
              -(dx * nsx + dy * nsy + dz * nsz))
        (wx, wy, wz), at_fac = dispatch_sample(mat, wo, (wx, wy, wz), z1,
                                               u1, u2)
    else:
        # reference Lambertian: attenuation = albedo * (1/pi) / (cos/pi)
        inv_cos = 1.0 / torch.clamp(wz * _INV_PI, min=1e-12) * _INV_PI
        at_fac = [albedo[c] * inv_cos for c in range(3)]
    ndx = wx * txx + wy * bx0 + wz * nsx
    ndy = wx * txy + wy * by0 + wz * nsy
    ndz = wx * txz + wy * bz0 + wz * nsz

    # --- NEE: uniform or power light pick, clamped to count - 1 ---
    seed, u_pick = rng.rnd_masked(seed, adv)
    seed, lu = rng.rnd_masked(seed, adv)
    seed, lv = rng.rnd_masked(seed, adv)
    if sc.power:
        lidx, _ = pick_light_power(u_pick, lights_t[17], sc.num_lights)
    else:
        lidx, _ = pick_light_uniform(u_pick, sc.num_lights)
    lrow = lights_t[:, lidx.to(torch.int64)]
    # the pick pdf: the picked light's row 16, or 1 / count (a tensor: CUDA
    # torch multiplies by the reciprocal of a Python divisor)
    pick_pdf = (lrow[16] if sc.power
                else torch.full_like(u_pick, 1.0 / float(sc.num_lights)))
    b0, b1, b2 = sample_uniform_triangle(lu, lv)
    lpx = b0 * lrow[0] + b1 * lrow[3] + b2 * lrow[6]
    lpy = b0 * lrow[1] + b1 * lrow[4] + b2 * lrow[7]
    lpz = b0 * lrow[2] + b1 * lrow[5] + b2 * lrow[8]
    lvx, lvy, lvz = lpx - px, lpy - py, lpz - pz
    dist2 = lvx * lvx + lvy * lvy + lvz * lvz
    sdist2 = torch.clamp(dist2, min=1e-20)
    inv_d = 1.0 / torch.sqrt(sdist2)
    ldist = sdist2 * inv_d
    ldx, ldy, ldz = lvx * inv_d, lvy * inv_d, lvz * inv_d
    cos_l = torch.abs(ldx * lrow[12] + ldy * lrow[13] + ldz * lrow[14])
    omega = cos_l * lrow[15] / sdist2
    degen = (dist2 < 1e-5) | (omega < 1e-5)
    le = [torch.where(degen, zero, lrow[9 + c] * omega) for c in range(3)]
    pdf_light = torch.where(degen, one,
                            1.0 / torch.clamp(omega, min=1e-20)) * pick_pdf
    n_dl = nsx * ldx + nsy * ldy + nsz * ldz
    want_shadow = adv & (n_dl > 0.0)
    if mat is not None:  # no NEE on delta lobes
        want_shadow = want_shadow & ~mat.is_delta

    # --- shadow rays: swept here (K4) or handed to the caller (K6) ---
    tmax_s = torch.where(want_shadow, ldist - sc.shadow_eps, zero)
    shadow = torch.stack([px, py, pz, ldx, ldy, ldz,
                          torch.full_like(px, sc.shadow_tmin), tmax_s], dim=1)
    # the shadow ray's time: a peek of the post-NEE stream
    occl_time = rng.rnd(seed)[1]
    external = shadow_occluded is None
    if external:
        lit = want_shadow
    else:
        lit = want_shadow & (shadow_occluded(shadow, occl_time) < 0.5)

    if mat is None:
        # weight = albedo/pi * powerHeuristic(pdf_light, |n.l|/pi)
        pdf_sc = torch.abs(n_dl) * _INV_PI
        ph = (pdf_light * pdf_light) / torch.clamp(
            pdf_light * pdf_light + pdf_sc * pdf_sc, min=1e-20)
        radiance = [torch.where(lit, le[c] * albedo[c] * (ph * _INV_PI),
                                zero) for c in range(3)]
    else:
        # the general NEE, Le omega f(wo, wl) n.l / pick_pdf, no MIS
        wl = (ldx * txx + ldy * txy + ldz * txz,
              ldx * bx0 + ldy * by0 + ldz * bz0,
              ldx * nsx + ldy * nsy + ldz * nsz)
        f_ev = nee_bsdf(mat, wo, wl)
        scale = n_dl / torch.clamp(pick_pdf, min=1e-12)
        radiance = [torch.where(lit, le[c] * f_ev[c] * scale, zero)
                    for c in range(3)]
    nee = None
    if external:
        nee = [radiance[c] * last_at[c] for c in range(3)]
        radiance = [zero] * 3
    radiance = [torch.where(is_hit, radiance[c], torch.full_like(zero, b))
                for c, b in zip(range(3), sc.bg)]
    contrib = [emitted[c] + radiance[c] * last_at[c] for c in range(3)]
    new_at = [torch.where(adv, atten[c] * at_fac[c], atten[c])
              for c in range(3)]
    new_last = [torch.where(alive, new_at[c], last_at[c]) for c in range(3)]

    # --- Russian roulette: drawn on hit lanes only ---
    p_rr = 0.30 * new_at[0] + 0.59 * new_at[1] + 0.11 * new_at[2]
    seed, u_rr = rng.rnd_masked(seed, adv)
    survive = adv & (u_rr <= p_rr)
    inv_p = 1.0 / torch.clamp(p_rr, min=1e-12)
    new_at = [torch.where(survive, new_at[c] * inv_p, new_at[c])
              for c in range(3)]
    accs = [acc[c] + torch.where(alive, contrib[c], zero) for c in range(3)]
    depth_new = depth + alive.to(torch.float32)
    alive_b = survive & (depth_new < float(sc.max_depth))
    pdelta_new = torch.where(
        alive, zero if mat is None else mat.is_delta.to(torch.float32),
        prev_delta)
    aov = None
    if sc.aov:
        first = adv & (depth == 0.0)
        aov = [misc[:, AOV_COLS + k] + torch.where(first, x, zero)
               for k, x in enumerate(albedo + [nsx, nsy, nsz])]
    return dict(seed=seed, survive=survive, alive=alive, alive_b=alive_b,
                want_shadow=want_shadow, new_at=new_at, new_last=new_last,
                accs=accs, depth_new=depth_new, pdelta_new=pdelta_new,
                p=(px, py, pz), nd=(ndx, ndy, ndz), o=(ox, oy, oz),
                d=(dx, dy, dz), one=one, zero=zero, nee=nee, shadow=shadow,
                occl_time=occl_time, aov=aov,
                tex_uv=None if tex is None else tex_uv,
                cond=dict(wz=wz, cos_l=cos_l, n_dl=n_dl, ldist=ldist,
                          p_rr=p_rr, u_rr=u_rr, u_pick=u_pick, lidx=lidx))


def _next_state(rays, misc, r):
    """(rays_out [R, 8], misc columns 0-15, and 16-23 with the AOV rows,
    as a list of [R]) of a lane shaded without the refill (pallas_shade.py
    :893-918): the bounce ray on surviving lanes, tmin/tmax, pixel and
    sample passed on."""
    rays_out = torch.stack(
        [torch.where(r["survive"], p, o)
         for p, o in zip(r["p"] + r["nd"], r["o"] + r["d"])]
        + [rays[:, 6], rays[:, 7]], dim=1)
    cols = ([rng.state_to_bits(r["seed"])] + r["new_at"] + r["new_last"]
            + [r["pdelta_new"], r["depth_new"],
               r["alive_b"].to(torch.float32)]
            + r["accs"] + [misc[:, 13], misc[:, 14],
                           r["want_shadow"].to(torch.float32)])
    if r["aov"] is not None:
        cols += r["aov"] + [r["zero"]] * 2
    return rays_out, cols


def _shade_in_place_sweeps(rays, misc, count, tables: ShadeTables, sc,
                           time):
    """The closest sweep, the attribute fetch and the shading body with
    the shadow sweep in place: the front of K4 and all of K5."""
    closest, occluded = _plain_sweeps(tables, count, time)
    hit4 = closest(rays)
    a = tables.attr_t[:, torch.clamp(hit4[:, 1], min=0.0).to(torch.int64)]
    return _shade_lanes(rays, hit4, misc, a, tables.lights_t, sc, occluded,
                        tables.tex, tables.params_base)


def _tex_params(name: str, tex: TexState | None):
    """The kernels' TexParams of a textured launch (validated), or None."""
    if tex is None:
        return None
    kbuild.require_cuda(name, tex.atlas.data, dtype=torch.uint8)
    kbuild.require_cuda(name, tex.atlas.meta, dtype=torch.int32)
    return tex.params()


def trace_shade_ref(rays, misc, count, tables: ShadeTables, sc: ShadeConfig,
                    time=None):
    """Plain version of K5: one pool iteration without the refill. rays
    [P, 8], misc [P, 16] ([P, 24] with sc.aov), count int32 [1] (256-ray
    tiles at or past it skip the sweeps), time [P] of a 2-key scene.
    Returns (rays_out, misc_out)."""
    r = _shade_in_place_sweeps(rays, misc, count, tables, sc, time)
    rays_out, cols = _next_state(rays, misc, r)
    return rays_out, torch.stack(cols, dim=1)


def trace_shade_hit_ref(rays, hit4, misc, count, tables: ShadeTables,
                        sc: ShadeConfig):
    """Plain version of the non-merged K5 (make_fused_shader(merged=False),
    pallas_shade.py :1213-1275): trace_shade_ref with the closest hit
    hit4 [P, 4] (t, prim_f, u, v) given; the shadow sweep runs in place."""
    _, occluded = _plain_sweeps(tables, count, None)
    a = tables.attr_t[:, torch.clamp(hit4[:, 1], min=0.0).to(torch.int64)]
    r = _shade_lanes(rays, hit4, misc, a, tables.lights_t, sc, occluded,
                     tables.tex, tables.params_base)
    rays_out, cols = _next_state(rays, misc, r)
    return rays_out, torch.stack(cols, dim=1)


def _launch_trace_shade(rays, misc, count, tables: ShadeTables,
                        sc: ShadeConfig, time, hit4, name: str):
    """One launch of trace_shade_kernel: the merged K5 (hit4 None) or the
    non-merged one."""
    tris, tris1, aabb, super_aabb = tables.sweep_tables()
    motion = tris1 is not None
    sweep_time = motion and hit4 is None
    kbuild.require_cuda(name, rays, misc, tris, aabb, super_aabb,
                        tables.attr_t, tables.lights_t,
                        *((tris1,) if motion else ()),
                        *((time,) if sweep_time else ()),
                        *((hit4,) if hit4 is not None else ()))
    kbuild.require_cuda(name, count, dtype=torch.int32)
    tex = _tex_params(name, tables.tex)
    pool = rays.shape[0]
    mw = misc_width(sc.aov)
    if (rays.shape != (pool, 8) or misc.shape != (pool, mw)
            or pool % RAY_TILE or (sweep_time and time.shape != (pool,))
            or (hit4 is not None and hit4.shape != (pool, 4))):
        raise ValueError(f"{name}: rays [P, 8], misc [P, {mw}] (and time "
                         "[P] for the merged motion kernel, hit4 [P, 4] for "
                         "the non-merged one) with P a multiple of 256")
    f32 = dict(dtype=torch.float32, device=rays.device)
    rays_out = torch.empty((pool, 8), **f32)
    misc_out = torch.empty((pool, mw), **f32)
    p = kbuild.TraceShadeParams(
        max_depth=sc.max_depth, num_lights=sc.num_lights,
        attr_stride=tables.attr_t.shape[1],
        light_stride=tables.lights_t.shape[1], n_tiles=tris.shape[0],
        ct=tris.shape[2], n_faces=tables.soup.num_faces, motion=int(motion),
        power=int(sc.power), params_base=tables.params_base, aov=int(sc.aov),
        shadow_tmin=sc.shadow_tmin,
        shadow_eps=sc.shadow_eps, pick_pdf=1.0 / float(sc.num_lights),
        bg=(sc.bg[0], sc.bg[1], sc.bg[2]))
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_trace_shade(
        index, p, rays.data_ptr(), misc.data_ptr(),
        time.data_ptr() if sweep_time else None,
        hit4.data_ptr() if hit4 is not None else None, pool,
        count.data_ptr(), tris.data_ptr(),
        tris1.data_ptr() if motion else None, aabb.data_ptr(),
        super_aabb.data_ptr(), tables.attr_t.data_ptr(),
        tables.lights_t.data_ptr(), rays_out.data_ptr(), misc_out.data_ptr(),
        tex, stream)
    kbuild.check(err, name)
    return rays_out, misc_out


def trace_shade(rays, misc, count, tables: ShadeTables, sc: ShadeConfig,
                time=None):
    """K5 wrapper: the CUDA kernel for CUDA tensors
    (kernels/csrc/megakernel.cuh `trace_shade_kernel`), `trace_shade_ref` on
    the CPU."""
    if rays.device.type == "cpu":
        return trace_shade_ref(rays, misc, count, tables, sc, time)
    out = _launch_trace_shade(rays, misc, count, tables, sc, time, None,
                              "trace_shade")
    trace_shade.launches += 1
    return out


def trace_shade_hit(rays, hit4, misc, count, tables: ShadeTables,
                    sc: ShadeConfig):
    """Non-merged K5 wrapper: `trace_shade_kernel` with hit4 given for
    CUDA tensors, `trace_shade_hit_ref` on the CPU."""
    if rays.device.type == "cpu":
        return trace_shade_hit_ref(rays, hit4, misc, count, tables, sc)
    out = _launch_trace_shade(rays, misc, count, tables, sc, None, hit4,
                              "trace_shade_hit")
    trace_shade_hit.launches += 1
    return out


trace_shade.launches = 0
trace_shade_hit.launches = 0  # the non-merged K5


def trace_shade_refill_ref(rays, misc, stash, stats_in, stats_out,
                           pixel_base: int, subframe_index: int, scf,
                           time=None, *, tables: ShadeTables,
                           rc: RefillConfig) -> None:
    """Plain version of K4: one pool launch over all lanes, in place. With
    rc.aov, misc is [P, 24] and a lane retired into the stash takes its
    AOV accs there (stash columns 4-9, pallas_shade.py:964-967).

    Pixels are claimed by a cumulative sum over idle lanes in lane order,
    which is the TPU kernel's sequential claim order, so on the CPU this
    matches the reference kernel lane for lane. stats_in = (next_work,
    count, ...) of the previous launch; stats_out receives this launch's.
    time [P] (a 2-key scene): the lanes' ray times, replaced by the times
    drawn for the next launch."""
    dev = rays.device
    count = stats_in[1:2]
    r = _shade_in_place_sweeps(rays, misc, count, tables, rc, time)
    seed, survive, alive_b = r["seed"], r["survive"], r["alive_b"]
    one, zero = r["one"], r["zero"]
    new_at, new_last, accs = r["new_at"], r["new_last"], r["accs"]
    px, py, pz = r["p"]
    ox, oy, oz = r["o"]
    dx, dy, dz = r["d"]
    ndx, ndy, ndz = r["nd"]
    depth_new, pdelta_new = r["depth_new"], r["pdelta_new"]
    want_shadow = r["want_shadow"]

    # ==== refill epilogue ====
    deadr = ~alive_b
    pixf, sampf = misc[:, 13], misc[:, 14]
    st = stash[:, 0:4].unbind(1)
    completed = deadr & (pixf >= 0.0) & (sampf >= float(rc.spp))
    can_stash = completed & (st[0] < 0.0)
    new_st = [torch.where(can_stash, pixf, st[0])]
    new_st += [torch.where(can_stash, accs[c], st[1 + c]) for c in range(3)]
    accs = [torch.where(can_stash, zero, x) for x in accs]
    aov = r["aov"]
    if aov is not None:
        new_st += [torch.where(can_stash, x, stash[:, STASH_AOV + k])
                   for k, x in enumerate(aov)]
        aov = [torch.where(can_stash, zero, x) for x in aov]
    pixf = torch.where(can_stash, -one, pixf)
    sampf = torch.where(can_stash, zero, sampf)

    # pixel claim: idle lanes in lane order take the next pixels
    idle = deadr & (pixf < 0.0)
    incl = torch.cumsum(idle.to(torch.int64), 0).to(torch.float32)
    wpixf = stats_in[0].to(torch.float32) + (incl - 1.0)
    take_px = idle & (wpixf < float(rc.n_pix))
    pixf = torch.where(take_px, float(pixel_base)
                       + torch.clamp(wpixf, 0.0, float(rc.n_pix - 1)), pixf)
    sampf = torch.where(take_px, zero, sampf)
    next_work = stats_in[0].to(torch.int64) + take_px.sum()

    take = deadr & (pixf >= 0.0) & (sampf < float(rc.spp))
    samp_idx = sampf
    sampf = torch.where(take, sampf + 1.0, sampf)
    npix = torch.clamp(pixf, min=0.0).to(torch.int64)
    s_new, jx, jy = rng.sample_start(npix, subframe_index, rc.seed_rot,
                                     samp_idx.to(torch.int64), tables.jump)
    cdx, cdy, cdz = camera_ray_dir(scf, npix, rc.width, rc.height, jx, jy)

    seed_u = torch.where(take, s_new, seed)
    alive2 = alive_b | take
    # the per-ray time draw, kept by a motion scene on every lane
    s_adv, t_draw = rng.rnd(seed_u)
    seed_u = torch.where(alive2, s_adv, seed_u)
    if time is not None:
        time.copy_(t_draw)

    def sel(take_v, surv_v, keep_v):
        return torch.where(take, take_v, torch.where(survive, surv_v, keep_v))

    rays.copy_(torch.stack([
        sel(scf[0], px, ox), sel(scf[1], py, oy), sel(scf[2], pz, oz),
        sel(cdx, ndx, dx), sel(cdy, ndy, dy), sel(cdz, ndz, dz),
        torch.full_like(zero, rc.primary_tmin),
        torch.full_like(zero, rc.primary_tmax)], dim=1))
    misc.copy_(torch.stack(
        [rng.state_to_bits(seed_u)]
        + [torch.where(take, one, new_at[c]) for c in range(3)]
        + [torch.where(take, one, new_last[c]) for c in range(3)]
        + [torch.where(take, zero, pdelta_new),
           torch.where(take, zero, depth_new), alive2.to(torch.float32)]
        + accs + [pixf, sampf, want_shadow.to(torch.float32)]
        + ([] if aov is None else aov + [zero] * 2), dim=1))
    stash.zero_()
    stash[:, 0:len(new_st)] = torch.stack(new_st, dim=1)

    lane = torch.arange(rays.shape[0], device=dev)
    count_hint = torch.where(alive2, lane + 1, torch.zeros_like(lane)).max()
    stats_out.copy_(torch.stack([next_work, count_hint, alive2.sum(),
                                 torch.zeros_like(next_work)]).to(torch.int32))


def trace_shade_refill(rays, misc, stash, stats_in, stats_out,
                       pixel_base: int, subframe_index: int, scf, time=None,
                       *, tables: ShadeTables, rc: RefillConfig) -> None:
    """K4 wrapper: one pool launch, in place on rays/misc/stash (and the
    time [P] of a 2-key scene); fills stats_out from stats_in. The CUDA
    kernel for CUDA tensors (kernels/csrc/megakernel.cuh `refill_kernel`),
    `trace_shade_refill_ref` on the CPU."""
    if rays.device.type == "cpu":
        trace_shade_refill_ref(rays, misc, stash, stats_in, stats_out,
                               pixel_base, subframe_index, scf, time,
                               tables=tables, rc=rc)
        return
    tris, tris1, aabb, super_aabb = tables.sweep_tables()
    motion = tris1 is not None
    kbuild.require_cuda("trace_shade_refill", rays, misc, stash, tris, aabb,
                        super_aabb, tables.attr_t, tables.lights_t,
                        *((tris1, time) if motion else ()))
    kbuild.require_cuda("trace_shade_refill", stats_in, stats_out,
                        tables.jump_u32, dtype=torch.int32)
    tex = _tex_params("trace_shade_refill", tables.tex)
    pool = rays.shape[0]
    mw = misc_width(rc.aov)
    if (rays.shape != (pool, 8) or misc.shape != (pool, mw)
            or stash.shape != (pool, 16) or pool % RAY_TILE
            or (motion and time.shape != (pool,))):
        raise ValueError(f"trace_shade_refill: rays [P, 8], misc [P, {mw}], "
                         "stash [P, 16] (and time [P] for motion) with P a "
                         "multiple of 256")
    if stats_in.data_ptr() == stats_out.data_ptr():
        raise ValueError("trace_shade_refill: stats_in and stats_out must "
                         "be different buffers")
    p = kbuild.RefillParams(
        n_pix=rc.n_pix, spp=rc.spp, width=rc.width, max_depth=rc.max_depth,
        num_lights=rc.num_lights, pixel_base=pixel_base,
        subframe_index=subframe_index, attr_stride=tables.attr_t.shape[1],
        light_stride=tables.lights_t.shape[1], n_tiles=tris.shape[0],
        ct=tris.shape[2], n_faces=tables.soup.num_faces, motion=int(motion),
        power=int(rc.power), params_base=tables.params_base, aov=int(rc.aov),
        seed_rot=rc.seed_rot & rng.M32,
        width_f=float(rc.width), height_f=float(rc.height),
        tmin=rc.primary_tmin, tmax=rc.primary_tmax,
        shadow_tmin=rc.shadow_tmin, shadow_eps=rc.shadow_eps,
        pick_pdf=1.0 / float(rc.num_lights), bg=(rc.bg[0], rc.bg[1],
                                                  rc.bg[2]),
        cam=tuple(scf))
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_trace_shade_refill(
        index, p, rays.data_ptr(), misc.data_ptr(), stash.data_ptr(),
        time.data_ptr() if motion else None, pool, stats_in.data_ptr(),
        stats_out.data_ptr(), tris.data_ptr(),
        tris1.data_ptr() if motion else None, aabb.data_ptr(),
        super_aabb.data_ptr(), tables.attr_t.data_ptr(),
        tables.lights_t.data_ptr(), tables.jump_u32.data_ptr(), tex, stream)
    kbuild.check(err, "trace_shade_refill")
    trace_shade_refill.launches += 1


trace_shade_refill.launches = 0


def _fused_tables(scene, cfg, device, soup: TriSoup, soup1=None):
    """(ShadeTables, ShadeConfig) of the megakernels over `soup` (and the
    key-1 `soup1` of a 2-key scene, with the union cull boxes)."""
    # deferred: integrate.path imports this module
    from ..integrate.path import _lcg_advance_table

    for s in (soup, soup1):  # the kernels test only the real faces
        if s is not None:
            require_zero_padding(s.tris, s.num_faces)
    msoup = None
    if soup1 is not None:
        aabb, super_aabb = motion_union_aabbs(soup, soup1)
        msoup = MotionSoup(tris0=soup.tris, tris1=soup1.tris,
                           num_faces=scene.num_faces,
                           aabb=aabb.contiguous(),
                           super_aabb=super_aabb.contiguous())
    f_limit = soup.tris.shape[0] * soup.tris.shape[2]
    attr_t, lights_t, tex, params_base = shade_tables_for(scene, device,
                                                          f_limit)
    jump = _lcg_advance_table(cfg.samples_per_launch).astype(np.int64)
    tables = ShadeTables(
        soup=soup,
        attr_t=torch.as_tensor(attr_t, device=device),
        lights_t=torch.as_tensor(lights_t, device=device),
        jump=torch.as_tensor(jump, device=device),
        jump_u32=torch.as_tensor(jump.astype(np.uint32).view(np.int32),
                                 device=device),
        msoup=msoup, tex=tex, params_base=params_base)
    config = ShadeConfig(
        max_depth=cfg.max_depth, num_lights=scene.num_lights,
        shadow_tmin=cfg.shadow_tmin, shadow_eps=cfg.shadow_tmax_eps,
        bg=tuple(float(b) for b in cfg.bg_radiance),
        motion=soup1 is not None, power=cfg.light_sampler == "power",
        aov=cfg.aov)
    return tables, config


def make_fused_shader(scene, cfg, soup: TriSoup, soup1: TriSoup | None = None):
    """The reference's make_fused_shader(merged=False) (pallas_shade.py
    :1131-1275) over `soup` (the key-1 `soup1` for a 2-key scene), on the
    soup's device: shade(rays, hit4, misc, count) -> (rays, misc), the
    non-merged K5, whose closest hit hit4 [P, 4] (t, prim_f, u, v) comes
    from outside (FusedPipeline.closest_raw). The merged form is
    FusedPipeline.trace_shade. The wrapper runs the kernel for CUDA
    tensors and the plain version on the CPU."""
    reason = fused_unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(reason)
    tables, config = _fused_tables(scene, cfg, soup.tris.device, soup, soup1)
    return lambda rays, hit4, misc, count: trace_shade_hit(
        rays, hit4, misc, count, tables, config)


class FusedPipeline:
    """The megakernel pipeline of the pool integrator, on one device, for
    static and 2-key scenes (`motion`).

    `trace_shade` runs K5 (the merged megakernel, no refill) for the
    XLA-refill loop of sorted and sample-major pools; `refill_shader`
    builds K4 (in-kernel refill) for the pixel-major unsorted pool.
    refill_fn and shade_fn are the launch functions; the defaults pick the
    kernel or its plain version by the tensors' device. Passing
    trace_shade_refill_ref and trace_shade_ref runs the plain versions on
    any device (the reference on the card)."""

    def __init__(self, scene, cfg, device, refill_fn=trace_shade_refill,
                 shade_fn=trace_shade):
        reason = fused_unsupported(scene, cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.motion = scene.num_keys == 2
        self.merged = True  # the closest sweep runs inside the megakernel
        self.soup = build_tri_soup(scene.geom, self.device,
                                   num_faces=scene.num_faces)
        soup1 = (build_tri_soup(scene.geom, self.device, key=1,
                                num_faces=scene.num_faces)
                 if self.motion else None)
        self.tables, self.config = _fused_tables(scene, cfg, self.device,
                                                 self.soup, soup1)
        self.refill_fn = refill_fn
        self.shade_fn = shade_fn

    def closest_raw(self, rays_padded, count, time_col=None):
        """The raw closest hits [P, 4] (t, prim_f, u, v; miss (tmax, -1,
        0, 0)) of packed rays [P, 8]: K1, or K3 at the per-ray times
        time_col ([P] or [P, 1]) of a 2-key scene (pallas_mt.py :727-745,
        pallas_shade.py :1431-1435)."""
        if self.motion:
            return mt_closest_motion(rays_padded, time_col.reshape(-1),
                                     count, self.tables.msoup)
        return mt_closest(rays_padded, count, self.soup)

    def trace_shade(self, rays, misc, count, time=None):
        """One pool iteration through K5: closest sweep, shading, shadow
        sweep, RR and the next state. count: int32 [1] live-lane hint;
        time: per-lane ray time [P] of a motion scene. Returns (rays [P, 8],
        misc [P, 16|24])."""
        return self.shade_fn(rays, misc, count, self.tables, self.config,
                             time if self.motion else None)

    def refill_shader(self, n_pix: int):
        """The refill megakernel for a pool over n_pix pixels:
        shade(rays, misc, stash, stats_in, stats_out, pixel_base,
        subframe_index, scf, time=None), time [P] for a motion scene. The
        in-kernel refill always stashes (integrate/path.py:1024-1030); the
        reference's stashless variant is reached only through its A/B
        environment switch, which the port leaves out."""
        cfg = self.cfg
        rc = RefillConfig(
            n_pix=int(n_pix), spp=cfg.samples_per_launch, width=cfg.width,
            height=cfg.height, max_depth=cfg.max_depth,
            num_lights=self.scene.num_lights,
            primary_tmin=cfg.primary_tmin, primary_tmax=cfg.primary_tmax,
            shadow_tmin=cfg.shadow_tmin, shadow_eps=cfg.shadow_tmax_eps,
            bg=tuple(float(b) for b in cfg.bg_radiance),
            seed_rot=int(cfg.seed or 0), power=self.config.power,
            aov=cfg.aov)
        return partial(self.refill_fn, tables=self.tables, rc=rc)


# ---------------------------------------------------------------- K6
@dataclass(frozen=True)
class ExternalTables:
    """Device tables K6 reads."""

    attr: torch.Tensor  # [F, H] f32 attribute rows, read by prim
    lights_t: torch.Tensor  # [24, Lp] f32
    tex: TexState | None = None  # a textured scene's atlas and switches
    params_base: int = 0  # material-parameter rows (dispatch), 0 = none
    # an instanced scene's transform rows [I, 18] (inst_transform_rows)
    inst_rows: torch.Tensor | None = None


_IDENTITY9 = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def inst_transform_rows(scene) -> np.ndarray:
    """[I, 18] f32 per-instance rows of K6 (the reference's
    `inst_attr_pack`, pallas_shade.py:1522): the key-0 inverse-transpose,
    row-major, then the key-0 forward linear part (read only under normal
    maps)."""
    it = scene.instances
    n = scene.num_instances
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(it.inv_t)[:, 0].reshape(n, 9),
         np.asarray(it.m)[:, 0, :, :3].reshape(n, 9)], axis=1), np.float32)


def gather_inst_rows(inst_rows, inst):
    """[18, R] transform rows of each lane's instance id, the identity
    where inst < 0 (pallas_shade.py `gather_inst_rows`, :1548)."""
    g = inst_rows[torch.clamp(inst, min=0).to(torch.int64)]
    iden = torch.tensor(_IDENTITY9 * 2, dtype=g.dtype, device=g.device)
    return torch.where((inst >= 0)[:, None], g, iden[None]).T


def external_shade_ref(rays, hit4, misc, tables: ExternalTables,
                       ec: ShadeConfig, transposed: bool = False,
                       inst=None):
    """Plain version of K6: (rays_out [R, 8], misc_out [R, W + 8], shadow
    [R, 8|16]) from rays [R, 8], hit4 [R, 4] and misc [R, W], W = 16 or
    (ec.aov) 24. `transposed` (the walk pool's layout, pallas_shade.py
    :1761-1820): misc comes C-major [W, R] and misc_out leaves [W + 8, R];
    rays, hits and shadow rays stay row-major. An instanced scene
    (tables.inst_rows) takes each lane's hit instance `inst` [R] int32
    (-1: none) and transforms the normal (and the tangent) by its rows."""
    if transposed:
        misc = misc.T
    a = tables.attr[torch.clamp(hit4[:, 1], min=0.0).to(torch.int64)].T
    it = (None if tables.inst_rows is None
          else gather_inst_rows(tables.inst_rows, inst))
    r = _shade_lanes(rays, hit4, misc, a, tables.lights_t, ec, tex=tables.tex,
                     params_base=tables.params_base, it=it)
    rays_out, cols = _next_state(rays, misc, r)
    misc_out = torch.stack(cols + r["nee"] + [r["zero"]] * 5,
                           dim=0 if transposed else 1)
    shadow = r["shadow"]
    if ec.motion:
        shadow = torch.cat([shadow, r["occl_time"][:, None],
                            torch.zeros_like(shadow[:, :7])], dim=1)
    return rays_out, misc_out, shadow


def external_shade(rays, hit4, misc, tables: ExternalTables,
                   ec: ShadeConfig, transposed: bool = False, inst=None):
    """K6 wrapper: the CUDA kernel for CUDA tensors
    (kernels/csrc/external.cu), `external_shade_ref` on the CPU. With
    `transposed`, misc is C-major [W, R] and misc_out [W + 8, R]; an
    instanced scene's launch takes the hit instances `inst` [R] int32 and
    gathers their transform rows in the kernel."""
    if rays.device.type == "cpu":
        return external_shade_ref(rays, hit4, misc, tables, ec, transposed,
                                  inst)
    kbuild.require_cuda("external_shade", rays, hit4, misc, tables.attr,
                        tables.lights_t)
    n_inst = 0
    if tables.inst_rows is not None:
        kbuild.require_cuda("external_shade", rays, tables.inst_rows)
        kbuild.require_cuda("external_shade", inst, dtype=torch.int32)
        n_inst = tables.inst_rows.shape[0]
        if inst.shape != (rays.shape[0],) or tables.inst_rows.shape[1] != 18:
            raise ValueError("external_shade: inst [R] int32 and inst_rows "
                             "[I, 18]")
    tex = _tex_params("external_shade", tables.tex)
    n = rays.shape[0]
    attr_w = tables.attr.shape[1]
    mw = misc_width(ec.aov)
    misc_shape = (mw, n) if transposed else (n, mw)
    if (rays.shape != (n, 8) or hit4.shape != (n, 4)
            or misc.shape != misc_shape or attr_w % 8 or attr_w < 16):
        raise ValueError(f"external_shade: rays [R, 8], hit4 [R, 4], misc "
                         f"{list(misc_shape)}, attr [F, 16 + 8k]")
    f32 = dict(dtype=torch.float32, device=rays.device)
    rays_out = torch.empty((n, 8), **f32)
    misc_out = torch.empty((mw + 8, n) if transposed else (n, mw + 8), **f32)
    shadow = torch.empty((n, 16 if ec.motion else 8), **f32)
    p = kbuild.ExternalParams(
        max_depth=ec.max_depth, num_lights=ec.num_lights,
        light_stride=tables.lights_t.shape[1], motion=int(ec.motion),
        shadow_tmin=ec.shadow_tmin, shadow_eps=ec.shadow_eps,
        pick_pdf=1.0 / float(ec.num_lights),
        bg=(ec.bg[0], ec.bg[1], ec.bg[2]), attr_w=attr_w,
        power=int(ec.power), params_base=tables.params_base,
        aov=int(ec.aov), transposed=int(transposed), n_inst=n_inst)
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_external_shade(
        index, p, rays.data_ptr(), hit4.data_ptr(), misc.data_ptr(),
        tables.attr.data_ptr(), tables.attr.shape[0],
        tables.lights_t.data_ptr(), n, rays_out.data_ptr(),
        misc_out.data_ptr(), shadow.data_ptr(), tex,
        tables.inst_rows.data_ptr() if n_inst else None,
        inst.data_ptr() if n_inst else None, stream)
    kbuild.check(err, "external_shade")
    if n_inst:
        external_shade.inst_launches += 1
    else:
        external_shade.launches += 1
    return rays_out, misc_out, shadow


external_shade.launches = 0  # K6
external_shade.inst_launches = 0  # K6 with instance rows


class ExternalPipeline:
    """K6 between an external (closest, any_hit) tracer pair, for the pool
    integrator's XLA-refill loop (integrate/path.py).

    tracer: callables f(o, d, tmin, tmax, time, count) as returned by
    trace/mt.py `make_mt_tracer`, or for a trace-time instanced scene by
    trace/hier_instanced.py `make_inst_hierwalk_tracer` (its hits carry
    their instance, and K6 takes the scene's instance rows, the
    reference's `_inst_pack`, :1849-1873). shade_fn is the K6 launch
    function; the default picks the kernel or its plain version by the
    tensors' device, and external_shade_ref runs the plain version on any
    device."""

    def __init__(self, scene, cfg, tracer, device, shade_fn=external_shade):
        reason = external_unsupported(scene, cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        self.device = torch.device(device)
        self.motion = scene.num_keys == 2
        self._closest, self._any = tracer
        attr_t, lights_t, tex, params_base = shade_tables_for(scene,
                                                              self.device)
        self.instanced = hasattr(scene, "instance_mesh")
        self.tables = ExternalTables(
            attr=torch.as_tensor(np.ascontiguousarray(attr_t.T),
                                 device=self.device),
            lights_t=torch.as_tensor(lights_t, device=self.device), tex=tex,
            params_base=params_base,
            inst_rows=(torch.as_tensor(inst_transform_rows(scene),
                                       device=self.device)
                       if self.instanced else None))
        self.config = ShadeConfig(
            max_depth=cfg.max_depth, num_lights=scene.num_lights,
            shadow_tmin=cfg.shadow_tmin, shadow_eps=cfg.shadow_tmax_eps,
            bg=tuple(float(b) for b in cfg.bg_radiance), motion=self.motion,
            power=cfg.light_sampler == "power", aov=cfg.aov)
        self.shade_fn = shade_fn

    def trace_shade(self, rays, misc, count, time=None):
        """One pool iteration (pallas_shade.py:1857-1891): closest hit,
        K6, shadow any-hit, and the NEE term added on unoccluded lanes.
        count: int32 [1] live-lane hint; time: per-lane ray time [R] of a
        motion scene. Returns (rays [R, 8], misc [R, 16|24])."""
        hit = self._closest(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                            rays[:, 7], time, count)
        hit4 = torch.stack([hit.t, hit.prim.to(torch.float32), hit.u,
                            hit.v], dim=1)
        kw = dict(inst=hit.inst.to(torch.int32)) if self.instanced else {}
        rays2, misc_e, sh = self.shade_fn(rays, hit4, misc, self.tables,
                                          self.config, **kw)
        occ = self._any(sh[:, 0:3], sh[:, 3:6], sh[:, 6], sh[:, 7],
                        sh[:, 8] if self.motion else None, count)
        w = misc_width(self.config.aov)
        nee = torch.where(occ[:, None], 0.0, misc_e[:, w:w + 3])
        return rays2, torch.cat(
            [misc_e[:, :10], misc_e[:, 10:13] + nee, misc_e[:, 13:w]], dim=1)
