"""The fused pool pipeline: shade tables, the slice gate, and the
in-kernel-refill megakernel (K4).

Port of rendertoy3c_tpu/trace/pallas_shade.py for the slice's
configuration: static (one key), untextured, all-diffuse (the Lambertian
branch, :557-563 and :816-863), uniform light sampler, no AOV, retire
stash on, misc width 16. It holds `build_shade_tables` (:72, untextured
and without dispatch), `fused_unsupported` (the slice's narrowing of
`fused_shade_eligible`, :1116), `FusedPipeline` (:1379) with
`refill_shader` (:1437), and the wrapper of kernel K4.

Per-lane state layout (pallas_shade.py:32-36), updated in place:
  rays  [P, 8]  f32: org.xyz dir.xyz tmin tmax
  misc  [P, 16] f32: 0 seed(bits) | 1-3 atten | 4-6 last_atten
        | 7 prev_delta | 8 depth | 9 alive | 10-12 acc | 13 pixel
        | 14 samp | 15 want_shadow
  stash [P, 16] f32: 0 pixel (-1 = free) | 1-3 acc | 4-15 zero
  stats [4] int32  : next_work, count_hint, n_live, 0
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
from ..scene.light import pick_light_uniform
from .mt import RAY_TILE, TriSoup, any_ref, build_tri_soup, closest_ref

_INV_PI = 1.0 / math.pi
MAX_FACES = 2048  # the fused path's face limit (pallas_shade.py:59)


def build_shade_tables(scene, f_limit: int | None = None):
    """(attr_t [16, F], lights_t [24, Lp]) numpy tables, laid out as the
    reference's.

    Attr rows: n0 n1 n2 emission diffuse pad. Light rows: v0 v1 v2
    emission normal area, row 16 = per-light power-pick probability.
    f_limit truncates the face axis to the traced soup's padded width."""
    g = scene.geom
    f = g.mat_id.shape[0]
    if f_limit is not None:
        f = min(f, f_limit)
    mat_id = np.asarray(g.mat_id)[:f]
    attr = np.zeros((f, 16), np.float32)
    attr[:, 0:3] = np.asarray(g.n0[0])[:f]
    attr[:, 3:6] = np.asarray(g.n1[0])[:f]
    attr[:, 6:9] = np.asarray(g.n2[0])[:f]
    attr[:, 9:12] = np.asarray(scene.materials.emission)[mat_id]
    attr[:, 12:15] = np.asarray(scene.materials.diffuse)[mat_id]

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
    return (np.ascontiguousarray(attr.T), np.ascontiguousarray(lights.T))


def fused_unsupported(scene, cfg) -> str | None:
    """Why (scene, cfg) is outside the ported slice, naming the ROADMAP
    item that adds it; None when the fused pipeline renders it."""
    checks = (
        (cfg.integrator != "pool",
         "the wave integrator is not ported yet (ROADMAP A6)"),
        (not cfg.pool_pixel_major or cfg.sort_rays,
         "sample-major or sorted pools need the non-refill shade kernel "
         "K5 (ROADMAP A8)"),
        (cfg.pool_stash == 0, "the stashless pool is not ported yet "
         "(ROADMAP A8)"),
        (scene.num_keys != 1, "motion (num_keys > 1) is not ported yet "
         "(ROADMAP A11, kernel K3)"),
        (scene.textured, "textures are not ported yet (ROADMAP A12)"),
        (not scene.all_diffuse, "material dispatch (non-diffuse "
         "materials) is not ported yet (ROADMAP A12)"),
        (cfg.light_sampler != "uniform",
         "the power light sampler is not ported yet (ROADMAP A12)"),
        (cfg.aov, "AOV buffers are not ported yet (ROADMAP A13)"),
        (cfg.throughput_model != "reference",
         "the physical throughput model is not ported yet (ROADMAP A22)"),
        (scene.num_lights < 1, "scenes without lights take the general "
         "pool, not ported yet (ROADMAP A7)"),
        (scene.num_faces > MAX_FACES,
         f"scenes of more than {MAX_FACES} faces need the external "
         "pipeline (ROADMAP A16)"),
    )
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


@dataclass(frozen=True)
class ShadeTables:
    """Device tables the megakernel reads."""

    soup: TriSoup
    attr_t: torch.Tensor  # [16, F'] f32
    lights_t: torch.Tensor  # [24, Lp] f32
    jump: torch.Tensor  # [spp, 2] int64 (uint32 values): per-sample (a, c)
    jump_u32: torch.Tensor  # the same table as uint32 bits (int32), for K4


def trace_shade_refill_ref(rays, misc, stash, stats_in, stats_out,
                           pixel_base: int, subframe_index: int, scf,
                           tables: ShadeTables, rc: RefillConfig) -> None:
    """Plain version of K4: one pool launch over all lanes, in place.

    Pixels are claimed by a cumulative sum over idle lanes in lane order,
    which is the TPU kernel's sequential claim order, so on the CPU this
    matches the reference kernel lane for lane. stats_in = (next_work,
    count, ...) of the previous launch; stats_out receives this launch's."""
    dev = rays.device
    count = stats_in[1:2]

    # --- closest sweep ---
    hit4 = closest_ref(rays, count, tables.soup)
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

    # --- attribute fetch by prim (indexed fp32 loads) ---
    a = tables.attr_t[:, torch.clamp(prim_f, min=0.0).to(torch.int64)]
    w0 = 1.0 - bu - bv
    ngx = w0 * a[0] + bu * a[3] + bv * a[6]
    ngy = w0 * a[1] + bu * a[4] + bv * a[7]
    ngz = w0 * a[2] + bu * a[5] + bv * a[8]
    ngx, ngy, ngz, _ = normalize3(ngx, ngy, ngz)
    side = torch.where(-(dx * ngx + dy * ngy + dz * ngz) >= 0.0, one, -one)
    nsx, nsy, nsz = ngx * side, ngy * side, ngz * side
    px, py, pz = ox + t_hit * dx, oy + t_hit * dy, oz + t_hit * dz
    hit_f = is_hit.to(torch.float32)
    emitted = [a[9 + c] * emit_gate * hit_f for c in range(3)]
    albedo = [a[12 + c] for c in range(3)]

    # --- BSDF sample (cosine hemisphere; reference draw order) ---
    adv = is_hit & alive
    seed, _ = rng.rnd_masked(seed, adv)
    seed, _ = rng.rnd_masked(seed, adv)
    seed, u1 = rng.rnd_masked(seed, adv)
    seed, u2 = rng.rnd_masked(seed, adv)
    wx, wy, wz = sample_cosine_hemisphere(u1, u2)
    (txx, txy, txz), (bx0, by0, bz0) = onb_from_normal(nsx, nsy, nsz)
    inv_cos = 1.0 / torch.clamp(wz * _INV_PI, min=1e-12) * _INV_PI
    ndx = wx * txx + wy * bx0 + wz * nsx
    ndy = wx * txy + wy * by0 + wz * nsy
    ndz = wx * txz + wy * bz0 + wz * nsz

    # --- NEE: uniform light pick, clamped to count - 1 ---
    seed, u_pick = rng.rnd_masked(seed, adv)
    seed, lu = rng.rnd_masked(seed, adv)
    seed, lv = rng.rnd_masked(seed, adv)
    lidx, pick_pdf = pick_light_uniform(u_pick, rc.num_lights)
    lrow = tables.lights_t[:, lidx.to(torch.int64)]
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

    # --- shadow sweep ---
    tmax_s = torch.where(want_shadow, ldist - rc.shadow_eps, zero)
    sh = torch.stack([px, py, pz, ldx, ldy, ldz,
                      torch.full_like(px, rc.shadow_tmin), tmax_s], dim=1)
    occ = any_ref(sh, count, tables.soup)[:, 0]
    lit = want_shadow & (occ < 0.5)

    pdf_sc = torch.abs(n_dl) * _INV_PI
    ph = (pdf_light * pdf_light) / torch.clamp(
        pdf_light * pdf_light + pdf_sc * pdf_sc, min=1e-20)
    radiance = [torch.where(lit, le[c] * albedo[c] * (ph * _INV_PI), zero)
                for c in range(3)]
    radiance = [torch.where(is_hit, radiance[c], torch.full_like(zero, b))
                for c, b in zip(range(3), rc.bg)]
    contrib = [emitted[c] + radiance[c] * last_at[c] for c in range(3)]
    new_at = [torch.where(adv, atten[c] * (albedo[c] * inv_cos), atten[c])
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
    alive_b = survive & (depth_new < float(rc.max_depth))
    pdelta_new = torch.where(alive, zero, prev_delta)

    # ==== refill epilogue ====
    deadr = ~alive_b
    pixf, sampf = misc[:, 13], misc[:, 14]
    st = stash[:, 0:4].unbind(1)
    completed = deadr & (pixf >= 0.0) & (sampf >= float(rc.spp))
    can_stash = completed & (st[0] < 0.0)
    new_st = [torch.where(can_stash, pixf, st[0])]
    new_st += [torch.where(can_stash, accs[c], st[1 + c]) for c in range(3)]
    accs = [torch.where(can_stash, zero, x) for x in accs]
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
    s_new = rng.tea(npix, subframe_index)
    if rc.seed_rot:
        s_new = s_new ^ (rc.seed_rot & rng.M32)
    si = torch.where((samp_idx >= 1.0) & (samp_idx < float(rc.spp)),
                     samp_idx.to(torch.int64), torch.zeros_like(npix))
    jump = tables.jump[si]
    s_new = (rng.mul32(jump[:, 0], s_new) + jump[:, 1]) & rng.M32
    s_new, jx = rng.rnd(s_new)
    s_new, jy = rng.rnd(s_new)
    pxc = (npix % rc.width).to(torch.float32)
    pyc = (npix // rc.width).to(torch.float32)
    # tensor divisors: CUDA torch turns division by a Python scalar into a
    # multiplication by its reciprocal, which the kernel does not do
    dxc = 2.0 * ((pxc + jx) / torch.full_like(zero, float(rc.width))) - 1.0
    dyc = 2.0 * ((pyc + jy) / torch.full_like(zero, float(rc.height))) - 1.0
    cdx = dxc * scf[3] + dyc * scf[6] + scf[9]
    cdy = dxc * scf[4] + dyc * scf[7] + scf[10]
    cdz = dxc * scf[5] + dyc * scf[8] + scf[11]
    cdx, cdy, cdz, _ = normalize3(cdx, cdy, cdz)

    seed_u = torch.where(take, s_new, seed)
    alive2 = alive_b | take
    s_adv, _ = rng.rnd(seed_u)  # the motion path's per-ray time draw
    seed_u = torch.where(alive2, s_adv, seed_u)

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
        + accs + [pixf, sampf, want_shadow.to(torch.float32)], dim=1))
    stash.zero_()
    stash[:, 0:4] = torch.stack(new_st, dim=1)

    lane = torch.arange(rays.shape[0], device=dev)
    count_hint = torch.where(alive2, lane + 1, torch.zeros_like(lane)).max()
    stats_out.copy_(torch.stack([next_work, count_hint, alive2.sum(),
                                 torch.zeros_like(next_work)]).to(torch.int32))


def trace_shade_refill(rays, misc, stash, stats_in, stats_out,
                       pixel_base: int, subframe_index: int, scf,
                       tables: ShadeTables, rc: RefillConfig) -> None:
    """K4 wrapper: one pool launch, in place on rays/misc/stash; fills
    stats_out from stats_in. The CUDA kernel for CUDA tensors
    (kernels/csrc/megakernel.cu), `trace_shade_refill_ref` on the CPU."""
    if rays.device.type == "cpu":
        trace_shade_refill_ref(rays, misc, stash, stats_in, stats_out,
                               pixel_base, subframe_index, scf, tables, rc)
        return
    soup = tables.soup
    kbuild.require_cuda("trace_shade_refill", rays, misc, stash, soup.tris,
                        soup.aabb, soup.super_aabb, tables.attr_t,
                        tables.lights_t)
    kbuild.require_cuda("trace_shade_refill", stats_in, stats_out,
                        tables.jump_u32, dtype=torch.int32)
    pool = rays.shape[0]
    if (rays.shape != (pool, 8) or misc.shape != (pool, 16)
            or stash.shape != (pool, 16) or pool % RAY_TILE):
        raise ValueError("trace_shade_refill: rays [P, 8], misc [P, 16], "
                         "stash [P, 16] with P a multiple of 256")
    if stats_in.data_ptr() == stats_out.data_ptr():
        raise ValueError("trace_shade_refill: stats_in and stats_out must "
                         "be different buffers")
    p = kbuild.RefillParams(
        n_pix=rc.n_pix, spp=rc.spp, width=rc.width, max_depth=rc.max_depth,
        num_lights=rc.num_lights, pixel_base=pixel_base,
        subframe_index=subframe_index, attr_stride=tables.attr_t.shape[1],
        light_stride=tables.lights_t.shape[1], n_tiles=soup.tris.shape[0],
        ct=soup.tris.shape[2], pad_i=0, seed_rot=rc.seed_rot & rng.M32,
        width_f=float(rc.width), height_f=float(rc.height),
        tmin=rc.primary_tmin, tmax=rc.primary_tmax,
        shadow_tmin=rc.shadow_tmin, shadow_eps=rc.shadow_eps,
        pick_pdf=1.0 / float(rc.num_lights), bg=(rc.bg[0], rc.bg[1],
                                                  rc.bg[2]),
        cam=tuple(scf))
    index, stream = kbuild.launch_target(rays.device)
    err = kbuild.library().rt3c_trace_shade_refill(
        index, p, rays.data_ptr(), misc.data_ptr(), stash.data_ptr(), pool,
        stats_in.data_ptr(), stats_out.data_ptr(), soup.tris.data_ptr(),
        soup.aabb.data_ptr(), soup.super_aabb.data_ptr(),
        tables.attr_t.data_ptr(), tables.lights_t.data_ptr(),
        tables.jump_u32.data_ptr(), stream)
    kbuild.check(err, "trace_shade_refill")
    trace_shade_refill.launches += 1


trace_shade_refill.launches = 0


class FusedPipeline:
    """The megakernel pipeline of the pool integrator, on one device.

    refill_fn is the launch function; the default picks the kernel or its
    plain version by the tensors' device. Passing trace_shade_refill_ref
    runs the plain version on any device (the reference on the card)."""

    def __init__(self, scene, cfg, device, refill_fn=trace_shade_refill):
        # deferred: integrate.path imports this module
        from ..integrate.path import _lcg_advance_table

        reason = fused_unsupported(scene, cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        self.device = torch.device(device)
        self.scene = scene
        self.cfg = cfg
        self.soup = build_tri_soup(scene.geom, self.device,
                                   num_faces=scene.num_faces)
        f_limit = self.soup.tris.shape[0] * self.soup.tris.shape[2]
        attr_t, lights_t = build_shade_tables(scene, f_limit=f_limit)
        jump = _lcg_advance_table(cfg.samples_per_launch).astype(np.int64)
        self.tables = ShadeTables(
            soup=self.soup,
            attr_t=torch.as_tensor(attr_t, device=self.device),
            lights_t=torch.as_tensor(lights_t, device=self.device),
            jump=torch.as_tensor(jump, device=self.device),
            jump_u32=torch.as_tensor(jump.astype(np.uint32).view(np.int32),
                                     device=self.device))
        self.refill_fn = refill_fn

    def refill_shader(self, n_pix: int, use_stash: bool):
        """The refill megakernel for a pool over n_pix pixels:
        shade(rays, misc, stash, stats_in, stats_out, pixel_base,
        subframe_index, scf)."""
        if not use_stash:
            raise NotImplementedError(
                "the stashless refill kernel is not ported yet (ROADMAP A8)")
        cfg = self.cfg
        rc = RefillConfig(
            n_pix=int(n_pix), spp=cfg.samples_per_launch, width=cfg.width,
            height=cfg.height, max_depth=cfg.max_depth,
            num_lights=self.scene.num_lights,
            primary_tmin=cfg.primary_tmin, primary_tmax=cfg.primary_tmax,
            shadow_tmin=cfg.shadow_tmin, shadow_eps=cfg.shadow_tmax_eps,
            bg=tuple(float(b) for b in cfg.bg_radiance),
            seed_rot=int(cfg.seed or 0))
        return partial(self.refill_fn, tables=self.tables, rc=rc)
