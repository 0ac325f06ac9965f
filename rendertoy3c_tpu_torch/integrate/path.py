"""The persistent ray pools over the pipelines, and the render entry
points.

Port of the pool paths of rendertoy3c_tpu/integrate/path.py:
`_lcg_advance_table` (:463), `RenderStats`, the stash and flush-cadence
rule of `_render_pool_fused` (:1016-1048), `_render_pool_fused_krefill`
(:832-989) over the refill megakernel (K4), the XLA-refill loop of
`_render_pool_fused` (:1060-1393) over either pipeline's `trace_shade`
(K5, or K6 between MT tracers) with its pixel-major and sample-major
schedules and the ray sort, and `render_pixels` (which sends a
WalkPoolPipeline to integrate/walkpool.py), `render_subframe`,
`make_render_fn`, `render_frame` (:1396-1549). With cfg.aov every loop
carries the first-hit albedo and shading-normal accs (misc columns 16-21,
stash columns 4-9) into two more images beside the radiance, which
`render_subframe` blends into the film's guide buffers.

A bare (closest, any) tracer renders under the general pool
`_render_pool` (:485-830) or the wave integrator `_trace_block`
(:296-460, the wave branch of `render_pixels` :1436-1457), shaded by
`_shade_and_nee` (:98-293) in torch ops on [R, 3] lane tensors, in the
reference's XLA operation order (the reference shades this path outside
any Pallas kernel), with `_camera_ray` (:87) and `_miss_radiance` (:77),
which samples the scene's environment map (scene/envmap.py) where it has
one.

The loops mirror the reference's while_loops. The loop condition is read
once per window (one host synchronisation), and each window runs
`flush_every` iterations that stay on the device (`next_work`, `count`
and the ray counters are device tensors): the pixel-major windows start
with the flush, as the reference's do. The sample-major reference checks
its condition before every iteration; here an iteration run after the
condition turned false finds every lane dead and no work left, changes
nothing, and is not counted.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..accel.morton import morton3d
from ..film.film import Film, film_accumulate, film_create
from ..math import rng
from ..math.onb import onb_local_to_world
from ..math.sampling import power_heuristic, sample_cosine_hemisphere
from ..math.vec import dot, faceforward, length, luminance, normalize
from ..scene.camera import camera_ray_dir
from ..scene.envmap import EnvMap, env_map_to, sample_env_map
from ..scene.light import LightTable, light_tensors, sample_light
from ..scene.texture import TextureAtlas, atlas_to, sample_texture_bilinear
from ..trace.intersect import Hit, make_bruteforce_tracer
from ..trace.shade import (ACC_COLS, AOV_COLS, ExternalPipeline,
                           FusedPipeline, misc_width)
from .bsdf import MatParams, bsdf_eval, bsdf_sample
from .walkpool import WalkPoolPipeline, _render_pipepool


class RenderStats(NamedTuple):
    radiance_rays: torch.Tensor  # int64 scalar
    shadow_rays: torch.Tensor  # int64 scalar
    pool_iters: int = 0  # megakernel launches this subframe
    walk_rounds: int = 0  # walk-pool traversal rounds this subframe


def _lcg_advance_table(spp: int) -> np.ndarray:
    """Per-sample affine LCG jumps: row s = (a, c) with
    state_after_2s_draws = a * state0 + c (mod 2^32), so a pool lane starts
    sample s of a pixel where the sequential spp loop would be (2 jitter
    draws per earlier sample, raygen.cu:32-39)."""
    a_step, c_step = 1664525, 1013904223
    a, c = 1, 0
    rows = []
    for _ in range(spp):
        rows.append((a, c))
        for _ in range(2):
            a = (a_step * a) & 0xFFFFFFFF
            c = (a_step * c + c_step) & 0xFFFFFFFF
    return np.array(rows, np.uint64).astype(np.uint32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_AOV_ACCS = slice(AOV_COLS, AOV_COLS + 6)  # misc columns of the AOV accs


def _new_images(n_pix: int, aov: bool, device):
    """The radiance image (and the two AOV images) of a pool, [n_pix + 1,
    3] each: row n_pix is the sink of lanes with nothing to flush."""
    return [torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=device)
            for _ in range(3 if aov else 1)]


def _flush(images, misc, stash, spp: int, pixel_base: int, sink: int) -> None:
    """Scatter the stash (None when off) and the parked completed lanes
    into the images and free them (path.py:915-955, :1297-1345). Lanes with
    nothing to flush add into the sink row `sink`, which is dropped at the
    end."""
    pixel = misc[:, 13]
    completed = (misc[:, 9] <= 0) & (pixel >= 0) & (misc[:, 14] >= spp)
    target = torch.where(completed, pixel.to(torch.int64) - pixel_base,
                         sink)
    if stash is not None:
        sp = stash[:, 0]
        starget = torch.where(sp >= 0, sp.to(torch.int64) - pixel_base, sink)
    for image, (mc, sc) in zip(images, ACC_COLS):
        if stash is not None:
            image.index_add_(0, starget, stash[:, sc:sc + 3])
        image.index_add_(0, target, misc[:, mc:mc + 3])
    if stash is not None:
        stash.zero_()
        stash[:, 0] = -1.0
    misc[:, 10:13] = torch.where(completed[:, None], 0.0, misc[:, 10:13])
    if len(images) > 1:
        misc[:, _AOV_ACCS] = torch.where(completed[:, None], 0.0,
                                         misc[:, _AOV_ACCS])
    misc[:, 13] = torch.where(completed, -1.0, pixel)
    misc[:, 14] = torch.where(completed, 0.0, misc[:, 14])


def _pool_busy(misc, next_work, n_pix: int, spp: int) -> bool:
    """The pixel-major loop condition: work left to claim, a live lane, or
    a lane holding a pixel with samples left. One host synchronisation."""
    pending = (misc[:, 13] >= 0) & (misc[:, 14] < spp)
    return bool((next_work < n_pix) | (misc[:, 9] > 0).any() | pending.any())


def _scf(cam) -> tuple:
    """The camera's (eye, u, v, w) as 12 floats."""
    return tuple(float(x) for x in np.concatenate(
        [cam.eye, cam.u, cam.v, cam.w]).astype(np.float32))


def _claim_pixels(idle, pixel, samp, next_work, n_pix: int,
                  pixel_base: int):
    """The pixel-major pools' claim: idle lanes take the next fresh
    pixels in lane order (a cumulative sum), each from sample 0. pixel,
    samp: [P] int64. Returns (pixel, samp, next_work)."""
    wpix = next_work + torch.cumsum(idle.to(torch.int64), 0) - 1
    take_px = idle & (wpix < n_pix)
    pixel = torch.where(take_px,
                        pixel_base + torch.clamp(wpix, 0, n_pix - 1), pixel)
    return (pixel, torch.where(take_px, 0, samp),
            next_work + take_px.sum())


def _claim_samples(dead, next_work, n_pix: int, total_work: int,
                   pixel_base: int):
    """The sample-major pools' claim: dead lanes take the next work items
    in lane order; item w is sample w // n_pix of pixel w % n_pix.
    Returns (take, pixel [P] int64, sample [P] int64, next_work)."""
    w = next_work + torch.cumsum(dead.to(torch.int64), 0) - 1
    take = dead & (w < total_work)
    w_c = torch.clamp(w, 0, total_work - 1)
    return take, pixel_base + w_c % n_pix, w_c // n_pix, next_work + take.sum()


def _render_pool_fused_krefill(cfg, cam, pixel_idx, subframe_index: int,
                               fused: FusedPipeline, pool: int,
                               flush_every: int):
    """Megakernel pool with in-kernel refill; a motion pipeline carries the
    lanes' ray times [P] through every launch, zero at the start
    (path.py:863-864). Returns (rgb [N, 3], (albedo, normal) [N, 3] each
    with cfg.aov else None, n_rad, n_shad, launches)."""
    dev = fused.device
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    pixel_base = int(pixel_idx[0])
    shader = fused.refill_shader(n_pix)
    f32 = dict(dtype=torch.float32, device=dev)

    rays = torch.zeros((pool, 8), **f32)
    misc = torch.zeros((pool, misc_width(cfg.aov)), **f32)
    misc[:, 13] = -1.0
    stash = torch.zeros((pool, 16), **f32)
    stash[:, 0] = -1.0
    time = torch.zeros(pool, **f32) if fused.motion else None
    images = _new_images(n_pix, cfg.aov, dev)
    # (next_work, count, n_live, 0) of the last launch; two buffers, since a
    # launch reads one while its blocks update the other
    stats = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(2)]
    n_rad = torch.zeros((), dtype=torch.int64, device=dev)
    n_shad = torch.zeros((), dtype=torch.int64, device=dev)
    scf = _scf(cam)

    cur = 0
    launches = 0
    while _pool_busy(misc, stats[cur][0], n_pix, spp):
        _flush(images, misc, stash, spp, pixel_base, n_pix)
        for _ in range(flush_every):
            shader(rays, misc, stash, stats[cur], stats[1 - cur], pixel_base,
                   subframe_index, scf, time)
            cur = 1 - cur
            n_rad += stats[cur][2]
            n_shad += (misc[:, 15] > 0).sum()
            launches += 1
    _flush(images, misc, stash, spp, pixel_base, n_pix)
    return (*_finish(images, n_pix, spp), n_rad, n_shad, launches)


def _finish(images, n_pix: int, spp: int):
    """(rgb [N, 3], (albedo, normal) or None): the images without their
    sink row, divided by spp."""
    inv_spp = torch.tensor(1.0, dtype=torch.float32) / float(spp)
    out = [img[:n_pix] * inv_spp.to(img.device) for img in images]
    return out[0], (tuple(out[1:]) if len(out) > 1 else None)


def sort_key(rays, alive, lo, inv):
    """The ray sort's key (path.py:1250-1257): the direction octant above
    the Morton code of the origin in the scene box, [P] int64 holding the
    reference's uint32; dead lanes take 0xFFFFFFFF. lo, inv: [3] float32,
    the box corner and 1 / its extent."""
    d = rays[:, 3:6] >= 0
    octant = (d[:, 0].to(torch.int64) + 2 * d[:, 1].to(torch.int64)
              + 4 * d[:, 2].to(torch.int64))
    key = (octant << 27) | (morton3d((rays[:, 0:3] - lo) * inv) >> 3)
    return torch.where(alive, key, torch.full_like(key, 0xFFFFFFFF))


def sort_box(scene, instanced: bool = False):
    """(lo, inv) of the ray sort: the box of key 0's v0 over the real faces
    and 1 / max(extent, 1e-6) in float32 (path.py:1067-1071); with
    `instanced` (the general pool on a trace-time instanced scene,
    :524-527) the box of the instances' world boxes."""
    if instanced:
        lo = np.asarray(scene.instances.aabb_lo, np.float32).min(axis=0)
        hi = np.asarray(scene.instances.aabb_hi, np.float32).max(axis=0)
    else:
        v0s = np.asarray(scene.geom.v0[0])[:scene.num_faces]
        lo, hi = v0s.min(axis=0), v0s.max(axis=0)
    inv = np.float32(1.0) / np.maximum(hi - lo, np.float32(1e-6))
    return lo.astype(np.float32), inv.astype(np.float32)


def _render_pool_xla_refill(scene, cfg, cam, pixel_idx, subframe_index: int,
                            pipe, pool: int, use_stash: bool,
                            flush_every: int):
    """The XLA-refill pool (path.py:1060-1393) over a pipeline with
    `trace_shade` (FusedPipeline's K5 or ExternalPipeline). Each iteration
    takes new work for dead lanes, seeds each new sample (tea, per-sample
    LCG jump, two jitter draws), builds its camera ray, draws every live
    lane's ray time, optionally sorts the lanes, and runs one trace_shade.

    Pixel-major (cfg.pool_pixel_major): a lane renders all samples of its
    pixel; completed lanes retire into the stash (when on), idle lanes
    claim pixels by a cumulative sum in lane order, and the image takes
    the completed lanes at each window's flush. Sample-major: work item w
    is sample w // n_pix of pixel w % n_pix; every dying path is flushed
    into the image in the iteration after it dies, and dead lanes take the
    next work items in lane order. cfg.sort_rays orders the lanes by
    sort_key (a stable sort, as jnp.argsort) and the live count is then
    the number of live lanes. With cfg.aov the AOV accs (misc columns
    16-21) ride with the radiance acc: into the stash's columns 4-9, the
    flushes, the resets and the sort. Returns (rgb [N, 3], (albedo,
    normal) or None, n_rad, n_shad, iterations)."""
    dev = pipe.device
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    total_work = n_pix * spp
    pixel_major = cfg.pool_pixel_major
    pixel_base = int(pixel_idx[0])
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    jump = torch.as_tensor(_lcg_advance_table(spp).astype(np.int64),
                           device=dev)
    scf = _scf(cam)
    eye = torch.tensor(scf[0:3], **f32)
    if cfg.sort_rays:
        lo, inv = (torch.as_tensor(x, device=dev) for x in sort_box(scene))

    aov = cfg.aov
    n_acc = 9 if aov else 3  # the radiance acc, then the AOV accs
    rays = torch.zeros((pool, 8), **f32)
    misc = torch.zeros((pool, misc_width(aov)), **f32)
    misc[:, 13] = -1.0
    # stash [P, 16]: col 0 pixel (-1 = free), 1-3 acc, 4-9 the AOV accs,
    # as the K4 pool's
    stash = None
    if use_stash:
        stash = torch.zeros((pool, 16), **f32)
        stash[:, 0] = -1.0
    images = _new_images(n_pix, aov, dev)
    next_work = torch.zeros((), **i64)
    n_rad = torch.zeros((), **i64)
    n_shad = torch.zeros((), **i64)
    iters = torch.zeros((), **i64)
    lane = torch.arange(pool, **i64)
    tmin = torch.full((pool, 1), cfg.primary_tmin, **f32)
    tmax = torch.full((pool, 1), cfg.primary_tmax, **f32)

    def take_pixel_major(dead, pixel, samp, acc, next_work):
        if use_stash:
            completed = dead & (pixel >= 0) & (samp >= spp)
            can_stash = completed & (stash[:, 0] < 0)
            stash[:, 0] = torch.where(can_stash, pixel, stash[:, 0])
            stash[:, 1:1 + n_acc] = torch.where(can_stash[:, None], acc,
                                                stash[:, 1:1 + n_acc])
            acc = torch.where(can_stash[:, None], 0.0, acc)
            pixel = torch.where(can_stash, -1.0, pixel)
            samp = torch.where(can_stash, 0.0, samp)

        # assign fresh pixels to idle lanes, in lane order
        pixel_i, samp_i, next_work = _claim_pixels(
            dead & (pixel < 0), pixel.to(torch.int64), samp.to(torch.int64),
            next_work, n_pix, pixel_base)
        pixel = pixel_i.to(torch.float32)
        samp = samp_i.to(torch.float32)

        # (re)start: any dead lane holding a pixel with samples left
        take = dead & (pixel >= 0) & (samp < spp)
        samp_i = samp.to(torch.int64)  # this sample's index: its LCG jump
        samp = torch.where(take, samp + 1.0, samp)
        new_pixel = torch.clamp(pixel, min=0.0).to(torch.int64)
        return take, pixel, samp, samp_i, new_pixel, acc, next_work

    def take_sample_major(dead, pixel, samp, acc, next_work):
        # flush every dying path; refill dead lanes with the next samples
        flush = dead & (pixel >= 0)
        target = torch.where(flush, pixel.to(torch.int64) - pixel_base,
                             n_pix)
        for k, image in enumerate(images):
            image.index_add_(0, target, acc[:, 3 * k:3 * k + 3])
        take, new_pixel, samp_i, next_work = _claim_samples(
            dead, next_work, n_pix, total_work, pixel_base)
        pixel = torch.where(take, new_pixel.to(torch.float32),
                            torch.where(flush, -1.0, pixel))
        acc = torch.where((take | flush)[:, None], 0.0, acc)
        samp = torch.where(take, samp_i.to(torch.float32), samp)
        return take, pixel, samp, samp_i, new_pixel, acc, next_work

    take_work = take_pixel_major if pixel_major else take_sample_major

    def body(rays, misc, next_work):
        alive = misc[:, 9] > 0
        dead = ~alive
        # acc: the radiance acc and (AOV) the albedo and normal accs
        acc = (torch.cat([misc[:, 10:13], misc[:, _AOV_ACCS]], dim=1) if aov
               else misc[:, 10:13])
        take, pixel, samp, samp_i, new_pixel, acc, next_work = take_work(
            dead, misc[:, 13], misc[:, 14], acc, next_work)
        st, jx, jy = rng.sample_start(new_pixel, subframe_index,
                                      int(cfg.seed or 0), samp_i, jump)
        new_dir = torch.stack(camera_ray_dir(scf, new_pixel, cfg.width,
                                             cfg.height, jx, jy), dim=1)

        take2 = take[:, None]
        seed_u = torch.where(take, st, rng.bits_to_state(misc[:, 0]))
        alive2 = alive | take
        # per-ray motion time draw, advancing live lanes only
        seed_u, time = rng.rnd_masked(seed_u, alive2)
        rays = torch.cat([torch.where(take2, eye, rays[:, 0:3]),
                          torch.where(take2, new_dir, rays[:, 3:6]),
                          tmin, tmax], dim=1)
        misc = torch.cat([
            rng.state_to_bits(seed_u)[:, None],
            torch.where(take2, 1.0, misc[:, 1:4]),
            torch.where(take2, 1.0, misc[:, 4:7]),
            torch.where(take2, 0.0, misc[:, 7:9]),
            alive2.to(torch.float32)[:, None], acc[:, :3], pixel[:, None],
            samp[:, None], torch.zeros_like(pixel)[:, None]]
            + ([acc[:, 3:], torch.zeros_like(acc[:, :2])] if aov else []),
            dim=1)
        n_live = alive2.sum()
        if cfg.sort_rays:
            order = torch.argsort(sort_key(rays, alive2, lo, inv),
                                  stable=True)
            rays, misc, time = rays[order], misc[order], time[order]
            count_hint = n_live  # sorted: the live lanes are a prefix
        else:
            count_hint = torch.where(alive2, lane, -1).max() + 1
        rays, misc = pipe.trace_shade(
            rays, misc, count_hint.to(torch.int32).reshape(1),
            time if pipe.motion else None)
        return rays, misc, next_work, n_live, (misc[:, 15] > 0).sum()

    def busy():
        if pixel_major:
            return _pool_busy(misc, next_work, n_pix, spp)
        return bool((next_work < total_work) | (misc[:, 9] > 0).any())

    while busy():
        if pixel_major:
            _flush(images, misc, stash, spp, pixel_base, n_pix)
        for _ in range(flush_every):
            if not pixel_major:  # the reference's per-iteration condition
                iters += (next_work < total_work) | (misc[:, 9] > 0).any()
            rays, misc, next_work, live, shad = body(rays, misc, next_work)
            n_rad += live
            n_shad += shad
            if pixel_major:
                iters += 1
    if pixel_major:
        _flush(images, misc, stash, spp, pixel_base, n_pix)
    else:  # every lane is dead: flush what each still holds
        pixel = misc[:, 13]
        target = torch.where(pixel >= 0, pixel.to(torch.int64) - pixel_base,
                             n_pix)
        for image, (mc, _) in zip(images, ACC_COLS):
            image.index_add_(0, target, misc[:, mc:mc + 3])
    return (*_finish(images, n_pix, spp), n_rad, n_shad, int(iters))


def _render_pool_fused(scene, cfg, cam, pixel_idx, subframe_index: int,
                       pipe):
    """The stash and flush-cadence rule of the reference (path.py:
    1016-1048). The in-kernel refill (K4) runs for a pixel-major, unsorted
    FusedPipeline and always stashes; every other case takes the XLA-refill
    loop, where cfg.pool_stash -1 (auto) is off when the frame is more than
    32 pools or the pipeline is ExternalPipeline and on otherwise, 0 off
    and 1 on, and only a pixel-major pool ever stashes. The cadence is 32
    iterations with the stash or sample-major and 16 without, halved when
    the frame is more than 32 pools."""
    n_pix = int(pixel_idx.shape[0])
    pool = min(cfg.ray_block, _next_pow2(n_pix * cfg.samples_per_launch))
    kernel_refill = (cfg.pool_pixel_major and not cfg.sort_rays
                     and isinstance(pipe, FusedPipeline))
    wide = n_pix > 32 * pool
    if kernel_refill:
        use_stash = True
    elif cfg.pool_stash == -1:
        use_stash = (cfg.pool_pixel_major
                     and not (wide or isinstance(pipe, ExternalPipeline)))
    else:
        use_stash = cfg.pool_pixel_major and cfg.pool_stash != 0
    if cfg.flush_every:
        flush_every = cfg.flush_every
    elif use_stash or not cfg.pool_pixel_major:
        flush_every = 16 if wide else 32
    else:
        flush_every = 8 if wide else 16
    if kernel_refill:
        return _render_pool_fused_krefill(cfg, cam, pixel_idx,
                                          subframe_index, pipe, pool,
                                          flush_every)
    return _render_pool_xla_refill(scene, cfg, cam, pixel_idx,
                                   subframe_index, pipe, pool, use_stash,
                                   flush_every)


# --------------------------------------------- the general shading and pools
_INV_PI = 1.0 / math.pi


class GeneralTables(NamedTuple):
    """The scene's tables on one device for `_shade_and_nee`: key 0's
    normals, edges and uvs by face, the material and light tables, the
    atlas, and for a trace-time instanced scene the instances' key-0
    inverse-transposes and linear parts."""

    n0: torch.Tensor  # [F, 3]
    n1: torch.Tensor
    n2: torch.Tensor
    e1: torch.Tensor  # [F, 3]
    e2: torch.Tensor
    uv0: torch.Tensor  # [F, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # [F] int64
    mat: dict  # the MaterialTable's fields as tensors (ids as int64)
    lights: LightTable  # light_tensors' table
    atlas: TextureAtlas  # atlas_to's tensors
    inv_t: Optional[torch.Tensor]  # [I, 3, 3]
    lin: Optional[torch.Tensor]  # [I, 3, 3]
    has_textures: bool
    all_diffuse: bool
    any_uv_transform: bool
    any_normal_map: bool
    num_lights: int
    device: torch.device
    env: Optional[EnvMap] = None  # the miss lanes' environment map


def general_tables(scene, device) -> GeneralTables:
    """GeneralTables of `scene` on `device`."""
    dev = torch.device(device)
    g = scene.geom

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    mat = {k: put(v, torch.int64 if np.asarray(v).dtype.kind in "iu"
                  else torch.float32)
           for k, v in scene.materials._asdict().items()}
    inv_t = lin = None
    if hasattr(scene, "instance_mesh"):
        inv_t = put(scene.instances.inv_t[:, 0])
        lin = put(scene.instances.m[:, 0, :, :3])
    return GeneralTables(
        n0=put(g.n0[0]), n1=put(g.n1[0]), n2=put(g.n2[0]), e1=put(g.e1[0]),
        e2=put(g.e2[0]), uv0=put(g.uv0), uv1=put(g.uv1), uv2=put(g.uv2),
        mat_id=put(g.mat_id, torch.int64), mat=mat,
        lights=light_tensors(scene.lights, dev),
        atlas=atlas_to(scene.atlas, dev), inv_t=inv_t, lin=lin,
        has_textures=scene.atlas.data.shape[:2] != (1, 1),
        all_diffuse=scene.all_diffuse,
        any_uv_transform=bool(scene.any_uv_transform),
        any_normal_map=bool(scene.any_normal_map),
        num_lights=int(scene.num_lights), device=dev,
        env=env_map_to(getattr(scene, "env", None), dev))


def _mat3_rows(m, x):
    """m [R, 3, 3] times x [R, 3], each row summed left to right."""
    return torch.stack([m[:, i, 0] * x[:, 0] + m[:, i, 1] * x[:, 1]
                        + m[:, i, 2] * x[:, 2] for i in range(3)], dim=-1)


def _miss_radiance(sc: GeneralTables, bg, direction):
    """The background radiance of miss lanes (path.py:77-84): the
    environment map sampled by direction where sc has one, else the
    constant ambient bg [3] (miss.cu:30, test.cu:3-6) broadcast to
    direction's shape."""
    if sc.env is not None:
        return sample_env_map(sc.env, direction)
    return bg.expand(direction.shape)


def _camera_ray(scf, pixel, jx, jy, width: int, height: int):
    """The jittered pinhole ray of each pixel (raygen.cu:32-39; path.py
    :87): (origin [R, 3], direction [R, 3])."""
    d = torch.stack(camera_ray_dir(scf, pixel, width, height, jx, jy), 1)
    eye = torch.tensor(scf[0:3], dtype=torch.float32, device=d.device)
    return eye.expand(d.shape), d


def _pick_light(sc: GeneralTables, cfg, u):
    """(light index [R] int64, pick pdf [R]) by cfg.light_sampler, as the
    reference's pick_light_uniform and pick_light_power (light.py:70-95):
    the index clamped to num_lights - 1, so a scene without lights reads
    index -1, its dark light."""
    n = sc.num_lights
    cdf = sc.lights.power_cdf
    if cfg.light_sampler == "power":
        idx = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True),
                          max=n - 1)
        lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], 0.0)
        return idx, cdf[idx % cdf.shape[0]] - lo
    idx = torch.clamp((u * float(n)).to(torch.int64), max=n - 1)
    return idx, torch.full_like(u, 1.0 / max(n, 1))


def _shade_and_nee(sc: GeneralTables, cfg, trace_any, hit: Hit, org,
                   direction, seed, active, count=None):
    """The closest-hit program body (closehit_radiance.cu:60-160) on every
    lane (path.py:98-293): the shading normal (through the instance's
    inverse-transpose for an instanced hit, then the normal map), the uv
    transform, the diffuse, roughness and emissive textures, the BSDF
    draw (the Lambertian closure, or the four-type dispatch of
    integrate/bsdf.py), the light pick and sample, the shadow ray through
    trace_any, and the NEE term under cfg.throughput_model. Returns (seed,
    emitted, radiance, new_org, new_dir, atten_factor, want_shadow,
    is_delta, albedo, ns), defined on every lane; callers mask with
    active & hit."""
    prim = torch.clamp(hit.prim.to(torch.int64), min=0)
    u, v = hit.u, hit.v
    w0 = (1.0 - u - v)[:, None]
    w1 = u[:, None]
    w2 = v[:, None]
    # shading attributes come from motion key 0 (cuda_scene.h:78-81)
    ng = normalize(w0 * sc.n0[prim] + w1 * sc.n1[prim] + w2 * sc.n2[prim])
    inst = None
    if hit.inst is not None:
        # two-level AS: the object-space normal into world space by the
        # instance's inverse-transpose (key 0)
        inst = torch.clamp(hit.inst.to(torch.int64), min=0)
        ng = normalize(_mat3_rows(sc.inv_t[inst], ng))
    texcoord = w0 * sc.uv0[prim] + w1 * sc.uv1[prim] + w2 * sc.uv2[prim]
    mid = sc.mat_id[prim]
    mat = sc.mat
    if sc.any_uv_transform:
        # uv' = offset + M uv, the material's texture transform
        xf = mat["uv_xform"][mid]
        tu = xf[:, 0] * texcoord[:, 0] + xf[:, 1] * texcoord[:, 1] + xf[:, 4]
        tv = xf[:, 2] * texcoord[:, 0] + xf[:, 3] * texcoord[:, 1] + xf[:, 5]
        texcoord = torch.stack([tu, tv], dim=-1)
    if sc.any_normal_map:
        # tangent-space normal mapping: the tangent from the uv
        # parameterisation, Gram-Schmidt against ng
        ntex = mat["normal_tex"][mid]
        n_ts = sample_texture_bilinear(sc.atlas, ntex, texcoord[:, 0],
                                       texcoord[:, 1]) * 2.0 - 1.0
        duv1 = sc.uv1[prim] - sc.uv0[prim]
        duv2 = sc.uv2[prim] - sc.uv0[prim]
        e1w, e2w = sc.e1[prim], sc.e2[prim]
        if inst is not None:
            # the object-space edges into world space by the instance's
            # linear part (key 0, as the normal)
            e1w = _mat3_rows(sc.lin[inst], e1w)
            e2w = _mat3_rows(sc.lin[inst], e2w)
        tang = e1w * duv2[:, 1:2] - e2w * duv1[:, 1:2]
        tang = tang - ng * dot(tang, ng)[:, None]
        tang = normalize(tang, eps=1e-12)
        bitan = torch.stack([
            ng[:, 1] * tang[:, 2] - ng[:, 2] * tang[:, 1],
            ng[:, 2] * tang[:, 0] - ng[:, 0] * tang[:, 2],
            ng[:, 0] * tang[:, 1] - ng[:, 1] * tang[:, 0]], dim=-1)
        ng_mapped = normalize(n_ts[:, 0:1] * tang + n_ts[:, 1:2] * bitan
                              + n_ts[:, 2:3] * ng, eps=1e-12)
        ng = torch.where((ntex >= 0)[:, None], ng_mapped, ng)
    ns = faceforward(ng, -direction, ng)
    p = org + hit.t[:, None] * direction
    emitted = mat["emission"][mid]

    is_hit = hit.prim >= 0
    adv = active & is_hit  # the lanes whose stream advances in shading

    # the BSDF draws (closehit_radiance.cu:90-112): four on every
    # material, z1 the dispatch's lobe choice
    seed, z1 = rng.rnd_masked(seed, adv)
    seed, _z2 = rng.rnd_masked(seed, adv)
    seed, u1 = rng.rnd_masked(seed, adv)
    seed, u2 = rng.rnd_masked(seed, adv)

    albedo = mat["diffuse"][mid]
    if sc.has_textures:
        tex_id = mat["diffuse_tex"][mid]
        tex_rgb = sample_texture_bilinear(sc.atlas, tex_id, texcoord[:, 0],
                                          texcoord[:, 1])
        albedo = torch.where((tex_id >= 0)[:, None], tex_rgb, albedo)

    if sc.all_diffuse:
        # the reference's Lambertian closure
        w_local = torch.stack(sample_cosine_hemisphere(u1, u2), dim=-1)
        pdf_bsdf_sampled = w_local[:, 2] * _INV_PI
        new_dir = onb_local_to_world(w_local, ns)
        if cfg.throughput_model == "reference":
            # attenuation *= albedo * bsdf / pdf (bsdf 1/pi, pdf cos/pi)
            atten_factor = albedo * (
                _INV_PI / torch.clamp(pdf_bsdf_sampled, min=1e-12))[:, None]
        else:
            atten_factor = albedo  # physical: f cos / pdf = albedo
        is_delta = torch.zeros_like(adv)
        params = None
    else:
        rough = mat["roughness"][mid]
        if sc.has_textures:
            rtex = mat["roughness_tex"][mid]
            rough_tex = sample_texture_bilinear(
                sc.atlas, rtex, texcoord[:, 0], texcoord[:, 1])[:, 0]
            rough = torch.where(rtex >= 0, rough_tex, rough)
            etex = mat["emissive_tex"][mid]
            emis_rgb = sample_texture_bilinear(sc.atlas, etex, texcoord[:, 0],
                                               texcoord[:, 1])
            emitted = torch.where((etex >= 0)[:, None], emitted * emis_rgb,
                                  emitted)
        params = MatParams(
            mtype=mat["mtype"][mid], albedo=albedo, roughness=rough,
            metallic=mat["metallic"][mid], ior=mat["ior"][mid],
            transmittance=mat["transmittance"][mid],
            sheen=mat["sheen"][mid])
        samp = bsdf_sample(params, ns, -direction, z1, u1, u2)
        new_dir = samp.wi
        atten_factor = samp.weight
        is_delta = samp.is_delta

    # next-event estimation (closehit_radiance.cu:117-156)
    seed, u_pick = rng.rnd_masked(seed, adv)
    seed, lu = rng.rnd_masked(seed, adv)
    seed, lv = rng.rnd_masked(seed, adv)
    lidx, pick_pdf = _pick_light(sc, cfg, u_pick)
    light_pos, light_emission, pdf_samp = sample_light(
        sc.lights, lidx, lu, lv, p)
    pdf_light = pdf_samp * pick_pdf  # SampleLights: pdf /= light_count

    lvec = light_pos - p
    ldist = length(lvec)
    ldir = lvec / torch.clamp(ldist, min=1e-20)[:, None]
    n_dl = dot(ns, ldir)

    # the shadow ray's time comes from a fork of the post-NEE stream that
    # never rejoins (prd.seed is stored before traceOcclusion): a peek
    _, occl_time = rng.rnd(seed)
    want_shadow = adv & (n_dl > 0.0) & (sc.num_lights > 0) & ~is_delta
    occluded = trace_any(p, ldir, cfg.shadow_tmin,
                         ldist - cfg.shadow_tmax_eps, occl_time, count=count)

    lit = (want_shadow & ~occluded)[:, None]
    if sc.all_diffuse:
        pdf_scatter = torch.abs(n_dl) * _INV_PI
        if cfg.throughput_model == "reference":
            weight = albedo * (power_heuristic(pdf_light, pdf_scatter)
                               * _INV_PI)[:, None]
            radiance = light_emission * torch.where(lit, weight, 0.0)
        else:
            # unbiased NEE for diffuse: Le omega f cos / pick_pdf
            contrib = light_emission * albedo * (
                _INV_PI * n_dl / torch.clamp(pick_pdf, min=1e-12))[:, None]
            radiance = torch.where(lit, contrib, 0.0)
    else:
        # general NEE: Le omega f(wo, wl) cos / pick_pdf, without MIS (NEE
        # is the only sampler of direct light on non-delta lobes)
        f_eval, _pdf_eval = bsdf_eval(params, ns, -direction, ldir)
        contrib = light_emission * f_eval * (
            n_dl / torch.clamp(pick_pdf, min=1e-12))[:, None]
        radiance = torch.where(lit, contrib, 0.0)

    return (seed, emitted, radiance, p, new_dir, atten_factor, want_shadow,
            is_delta, albedo, ns)


def _segment(sc, cfg, tracer, s, alive, count, bg):
    """One path segment of every live lane, the bounce body that the pool
    (path.py:714-759) and the wave integrator (:359-411) share: the ray
    time draw, the closest hit, the shading and NEE, the miss ambient,
    emission at depth 0 and after delta lobes, the throughput and Russian
    roulette. Updates s's seed, atten, last_atten and prev_delta; returns
    (contribution [P, 3], zero off the live lanes; survive; hit mask;
    want_shadow; albedo; ns; the next origin; the next direction)."""
    trace_closest, trace_any = tracer
    seed, time = rng.rnd_masked(s["seed"], alive)
    hit = trace_closest(s["org"], s["dir"], cfg.primary_tmin,
                        cfg.primary_tmax, time, count=count)
    (seed, emitted, radiance, new_org, new_dir, atten_factor, want_shadow,
     is_delta, albedo, ns) = _shade_and_nee(
        sc, cfg, trace_any, hit, s["org"], s["dir"], seed, alive,
        count=count)
    is_hit = hit.prim >= 0
    radiance = torch.where(is_hit[:, None], radiance,
                           _miss_radiance(sc, bg, s["dir"]))
    see_emit = is_hit & ((s["depth"] == 0) | s["prev_delta"])
    emitted = torch.where(see_emit[:, None], emitted, 0.0)
    contrib = torch.where(alive[:, None],
                          emitted + radiance * s["last_atten"], 0.0)
    atten = torch.where((alive & is_hit)[:, None],
                        s["atten"] * atten_factor, s["atten"])
    s["last_atten"] = torch.where(alive[:, None], atten, s["last_atten"])
    # Russian roulette from bounce 0 (raygen.cu:62-66), drawn on hit lanes
    p_rr = luminance(atten)
    seed, u_rr = rng.rnd_masked(seed, alive & is_hit)
    survive = is_hit & (u_rr <= p_rr)
    s["atten"] = torch.where(
        (alive & survive)[:, None],
        atten / torch.clamp(p_rr, min=1e-12)[:, None], atten)
    s["seed"] = seed
    s["prev_delta"] = torch.where(alive, is_delta, s["prev_delta"])
    return contrib, survive, is_hit, want_shadow, albedo, ns, new_org, new_dir


def _lane_state(n: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return dict(org=torch.zeros((n, 3), **f32),
                dir=torch.zeros((n, 3), **f32),
                seed=torch.zeros(n, dtype=torch.int64, device=device),
                atten=torch.ones((n, 3), **f32),
                last_atten=torch.ones((n, 3), **f32),
                prev_delta=torch.zeros(n, dtype=torch.bool, device=device))


def _trace_block(sc, cfg, cam, tracer, pixel_idx, subframe_index: int):
    """The wave integrator on one block of pixels (path.py:296-460): the
    spp loop, and per sample the bounce loop over the block's lanes, which
    sorts the live lanes to the front (a stable sort: every lane's state
    and stream ride along) and traces the live prefix. Padding lanes
    (pixel -1) never come alive. Returns (rgb [B, 3], (albedo, normal)
    [B, 3] each with cfg.aov else None, radiance rays, shadow rays)."""
    dev = sc.device
    b = pixel_idx.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    valid = pixel_idx >= 0
    pixel = torch.clamp(pixel_idx, min=0)
    scf = _scf(cam)
    outer = rng.pixel_streams(pixel, subframe_index, int(cfg.seed or 0))
    bg = torch.tensor(cfg.bg_radiance, **f32)
    result = torch.zeros((b, 3), **f32)
    aov_sum = [torch.zeros((b, 3), **f32) for _ in range(2 if cfg.aov else 0)]
    n_rad = torch.zeros((), dtype=torch.int64, device=dev)
    n_shad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(cfg.samples_per_launch):
        outer, jx = rng.rnd(outer)
        outer, jy = rng.rnd(outer)
        s = _lane_state(b, dev)
        s["org"], s["dir"] = _camera_ray(scf, pixel, jx, jy, cfg.width,
                                         cfg.height)
        s["seed"] = outer  # prd.seed = seed (raygen.cu:43)
        s["result"] = result
        s["alive"] = valid
        s["slot"] = torch.arange(b, device=dev)
        if cfg.aov:
            s["aov_alb"] = torch.zeros((b, 3), **f32)
            s["aov_nrm"] = torch.zeros((b, 3), **f32)
        depth = 0
        while depth < cfg.max_depth and bool(s["alive"].any()):
            # compaction: the live lanes first, in lane order
            order = torch.argsort((~s["alive"]).to(torch.int8), stable=True)
            s = {k: x[order] for k, x in s.items()}
            alive = s["alive"]
            n_alive = alive.sum()
            s["depth"] = torch.full((b,), depth, dtype=torch.int64,
                                    device=dev)
            contrib, survive, is_hit, want_shadow, albedo, ns, new_org, \
                new_dir = _segment(sc, cfg, tracer, s, alive, n_alive, bg)
            del s["depth"]
            if cfg.aov and depth == 0:
                first = (alive & is_hit)[:, None]
                s["aov_alb"] = torch.where(first, albedo, s["aov_alb"])
                s["aov_nrm"] = torch.where(first, ns, s["aov_nrm"])
            s["result"] = s["result"] + contrib
            new_alive = alive & survive
            s["org"] = torch.where(new_alive[:, None], new_org, s["org"])
            s["dir"] = torch.where(new_alive[:, None], new_dir, s["dir"])
            s["alive"] = new_alive
            depth += 1
            n_rad += n_alive
            n_shad += want_shadow.sum()
        # undo the compaction: each lane's sums back to its pixel's slot
        result = torch.zeros_like(result).index_copy_(0, s["slot"],
                                                      s["result"])
        for k, name in enumerate(("aov_alb", "aov_nrm")[:len(aov_sum)]):
            aov_sum[k] = aov_sum[k].index_add(0, s["slot"], s[name])
    inv_spp = torch.tensor(1.0, **f32) / float(cfg.samples_per_launch)
    aov = tuple(a * inv_spp for a in aov_sum) if cfg.aov else None
    return result * inv_spp, aov, n_rad, n_shad


def _render_wave(sc, cfg, cam, tracer, pixel_idx, subframe_index: int):
    """The wave branch of render_pixels (path.py:1440-1457): blocks of
    min(ray_block, next_pow2(N)) pixels, the last padded with pixel -1.
    Returns render_pixels' tuple."""
    n = pixel_idx.shape[0]
    block = min(cfg.ray_block, _next_pow2(n))
    n_padded = -(-n // block) * block
    idx = torch.cat([pixel_idx.to(sc.device), torch.full(
        (n_padded - n,), -1, dtype=torch.int64, device=sc.device)])
    rgb, aovs, n_rad, n_shad = [], [], 0, 0
    for blk in idx.reshape(-1, block):
        c, a, r, sh = _trace_block(sc, cfg, cam, tracer, blk, subframe_index)
        rgb.append(c)
        aovs.append(a)
        n_rad = n_rad + r
        n_shad = n_shad + sh
    aov = (tuple(torch.cat([a[k] for a in aovs])[:n] for k in range(2))
           if cfg.aov else None)
    return torch.cat(rgb)[:n], aov, n_rad, n_shad, 0


def _render_pool(scene, sc, cfg, cam, tracer, pixel_idx,
                 subframe_index: int):
    """The general persistent ray pool over a bare (closest, any) tracer
    (path.py:485-830): a fixed pool of lanes; each iteration refills the
    dead lanes with new work and runs one path segment on every live lane
    (`_segment`). Pixel-major (cfg.pool_pixel_major): a lane renders all
    samples of its pixel back to back, idle lanes claim pixels in lane
    order, and each window of flush_every iterations starts with the
    flush of the completed lanes into the image. Sample-major: work item
    w is sample w // N of pixel w % N, every dying path flushes in the
    iteration after it dies, and dead lanes take the next work items in
    lane order. cfg.sort_rays orders the lanes by sort_key (a stable
    sort, as jnp.argsort) before the trace, and the tracer's live count
    is then the number of live lanes; else the highest live lane + 1.
    With cfg.aov the first-hit albedo and normal accumulate beside the
    radiance. The loop condition is read once per window (pixel-major)
    or once per iteration (sample-major), as the reference's while
    loops. Returns (rgb [N, 3], (albedo, normal) or None, radiance rays,
    shadow rays, 0)."""
    dev = sc.device
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    pool = min(cfg.ray_block, _next_pow2(n_pix * spp))
    flush_every = cfg.flush_every or (8 if n_pix > 32 * pool else 16)
    total_work = n_pix * spp
    bg = torch.tensor(cfg.bg_radiance, **f32)
    jump = torch.as_tensor(_lcg_advance_table(spp).astype(np.int64),
                           device=dev)
    pixel_base = int(pixel_idx[0])
    scf = _scf(cam)
    if cfg.sort_rays:
        lo, inv = (torch.as_tensor(x, device=dev) for x in sort_box(
            scene, instanced=hasattr(scene, "instance_mesh")))
    accs = ("acc", "acc_alb", "acc_nrm") if cfg.aov else ("acc",)
    s = _lane_state(pool, dev)
    s.update(pixel=torch.full((pool,), -1, **i64),
             depth=torch.zeros(pool, **i64),
             alive=torch.zeros(pool, dtype=torch.bool, device=dev),
             samp=torch.zeros(pool, **i64))
    for k in accs:
        s[k] = torch.zeros((pool, 3), **f32)
    images = _new_images(n_pix, cfg.aov, dev)
    n_rad = torch.zeros((), **i64)
    n_shad = torch.zeros((), **i64)
    lane = torch.arange(pool, **i64)

    def take_pixel_major(dead, next_work):
        # idle lanes claim fresh pixels in lane order
        pixel, samp, next_work = _claim_pixels(
            dead & (s["pixel"] < 0), s["pixel"], s["samp"], next_work, n_pix,
            pixel_base)
        # (re)start any dead lane holding a pixel with samples left
        take = dead & (pixel >= 0) & (samp < spp)
        s["pixel"] = pixel
        s["samp"] = torch.where(take, samp + 1, samp)
        return take, torch.clamp(pixel, min=0), samp, next_work

    def take_sample_major(dead, next_work):
        # flush every dying path, refill dead lanes with the next samples
        flush = dead & (s["pixel"] >= 0)
        target = torch.where(flush, s["pixel"] - pixel_base, n_pix)
        for image, k in zip(images, accs):
            image.index_add_(0, target,
                             torch.where(flush[:, None], s[k], 0.0))
        take, new_pixel, samp, next_work = _claim_samples(
            dead, next_work, n_pix, total_work, pixel_base)
        for k in accs:
            s[k] = torch.where((take | flush)[:, None], 0.0, s[k])
        s["pixel"] = torch.where(take, new_pixel,
                                 torch.where(flush, -1, s["pixel"]))
        return take, new_pixel, samp, next_work

    take_work = (take_pixel_major if cfg.pool_pixel_major
                 else take_sample_major)

    def body(next_work):
        nonlocal s
        take, new_pixel, samp, next_work = take_work(~s["alive"], next_work)
        st, jx, jy = rng.sample_start(new_pixel, subframe_index,
                                      int(cfg.seed or 0), samp, jump)
        new_org, new_dir = _camera_ray(scf, new_pixel, jx, jy, cfg.width,
                                       cfg.height)
        take2 = take[:, None]
        s["org"] = torch.where(take2, new_org, s["org"])
        s["dir"] = torch.where(take2, new_dir, s["dir"])
        s["seed"] = torch.where(take, st, s["seed"])
        s["atten"] = torch.where(take2, 1.0, s["atten"])
        s["last_atten"] = torch.where(take2, 1.0, s["last_atten"])
        s["depth"] = torch.where(take, 0, s["depth"])
        s["prev_delta"] = s["prev_delta"] & ~take
        s["alive"] = s["alive"] | take
        if cfg.sort_rays:
            # the coherence sort: direction octant, then the origin's
            # Morton code; dead lanes last, so the live lanes are a prefix
            key = sort_key(torch.cat([s["org"], s["dir"]], 1), s["alive"],
                           lo, inv)
            order = torch.argsort(key, stable=True)
            s = {k: x[order] for k, x in s.items()}
        alive = s["alive"]
        n_live = alive.sum()
        count = (n_live if cfg.sort_rays
                 else torch.where(alive, lane, -1).max() + 1)
        contrib, survive, is_hit, want_shadow, albedo, ns, new_org, \
            new_dir = _segment(sc, cfg, tracer, s, alive, count, bg)
        if cfg.aov:
            first = (alive & is_hit & (s["depth"] == 0))[:, None]
            s["acc_alb"] = s["acc_alb"] + torch.where(first, albedo, 0.0)
            s["acc_nrm"] = s["acc_nrm"] + torch.where(first, ns, 0.0)
        s["acc"] = s["acc"] + contrib
        s["depth"] = torch.where(alive, s["depth"] + 1, s["depth"])
        new_alive = alive & survive & (s["depth"] < cfg.max_depth)
        s["org"] = torch.where(new_alive[:, None], new_org, s["org"])
        s["dir"] = torch.where(new_alive[:, None], new_dir, s["dir"])
        s["alive"] = new_alive
        return next_work, n_live, want_shadow.sum()

    def flush_stage():
        # the completed lanes into the image, and freed (path.py:780-798)
        completed = ~s["alive"] & (s["pixel"] >= 0) & (s["samp"] >= spp)
        target = torch.where(completed, s["pixel"] - pixel_base, n_pix)
        for image, k in zip(images, accs):
            image.index_add_(0, target,
                             torch.where(completed[:, None], s[k], 0.0))
            s[k] = torch.where(completed[:, None], 0.0, s[k])
        s["pixel"] = torch.where(completed, -1, s["pixel"])
        s["samp"] = torch.where(completed, 0, s["samp"])

    next_work = torch.zeros((), **i64)
    if cfg.pool_pixel_major:
        while bool((next_work < n_pix) | s["alive"].any()
                   | ((s["pixel"] >= 0) & (s["samp"] < spp)).any()):
            flush_stage()
            for _ in range(flush_every):
                next_work, live, shad = body(next_work)
                n_rad += live
                n_shad += shad
    else:
        while bool((next_work < total_work) | s["alive"].any()):
            next_work, live, shad = body(next_work)
            n_rad += live
            n_shad += shad
    # the final flush: every lane still holding a pixel
    target = torch.where(s["pixel"] >= 0, s["pixel"] - pixel_base, n_pix)
    for image, k in zip(images, accs):
        image.index_add_(0, target, s[k])
    return (*_finish(images, n_pix, spp), n_rad, n_shad, 0)


def render_pixels(scene, cfg, cam, tracer, pixel_idx, subframe_index: int,
                  device=None):
    """Path-trace a flat list of pixel indices. tracer: a pipeline
    (WalkPoolPipeline, FusedPipeline, ExternalPipeline), a bare (closest,
    any) pair, which renders under the general pool (cfg.integrator
    "pool") or the wave integrator ("wave"), or None for the brute tracer.
    A bare tracer's shading tables go to `device` (default: pixel_idx's).
    Returns (rgb [N, 3], the AOV slot: (albedo [N, 3], normal [N, 3])
    with cfg.aov else None, radiance rays, shadow rays, pool iterations
    or, for the walk pool, walk rounds; 0 for a bare tracer)."""
    if isinstance(tracer, WalkPoolPipeline):
        if cfg.integrator != "pool":
            raise ValueError("WalkPoolPipeline requires cfg.integrator='pool'")
        paths = cfg.pool_paths or 2
        if paths < 2:
            # the reference's classic pool (walkpool.py :578), which it
            # holds bit-identical per pixel to P = 2
            raise NotImplementedError(
                "the classic walk pool (pool_paths=1) is not ported yet; "
                "pool_paths 0 (auto) and >= 2 take the pipelined pool "
                "(ROADMAP A18)")
        return _render_pipepool(scene, cfg, cam, tracer, pixel_idx,
                                subframe_index, paths=paths)
    if isinstance(tracer, (FusedPipeline, ExternalPipeline)):
        if cfg.integrator != "pool":
            raise ValueError("FusedPipeline requires cfg.integrator='pool'")
        pool = min(cfg.ray_block,
                   _next_pow2(pixel_idx.shape[0] * cfg.samples_per_launch))
        if pool % 256:
            raise ValueError("fused pipeline needs a pool multiple of 256")
        return _render_pool_fused(scene, cfg, cam, pixel_idx,
                                  subframe_index, tracer)
    # a bare (closest, any) tracer: the general pool or the wave
    # integrator (path.py:1436-1457)
    sc = general_tables(scene, device or pixel_idx.device)
    if tracer is None:
        tracer = make_bruteforce_tracer(scene, chunk=cfg.tri_chunk)
    if cfg.integrator == "pool":
        return _render_pool(scene, sc, cfg, cam, tracer, pixel_idx,
                            subframe_index)
    return _render_wave(sc, cfg, cam, tracer, pixel_idx, subframe_index)


def render_subframe(scene, cam, film: Film, cfg, tracer=None):
    """Render one progressive subframe and fold it into the film
    (src/wavefront.cpp:203-222, raygen.cu:75-86). Returns (film, stats)."""
    if tracer is None:
        from ..trace.auto import choose_tracer

        scene, tracer = choose_tracer(scene, cfg, film.accum.device)
    n_pixels = cfg.width * cfg.height
    pixel_idx = torch.arange(n_pixels, dtype=torch.int64)
    rgb, aov, n_rad, n_shad, steps = render_pixels(
        scene, cfg, cam, tracer, pixel_idx, film.subframe_index,
        device=film.accum.device)
    film = film_accumulate(film, rgb.reshape(cfg.height, cfg.width, 3),
                           aov=aov)
    if isinstance(tracer, WalkPoolPipeline):
        return film, RenderStats(radiance_rays=n_rad, shadow_rays=n_shad,
                                 walk_rounds=steps)
    return film, RenderStats(radiance_rays=n_rad, shadow_rays=n_shad,
                             pool_iters=steps)


def make_render_fn(scene, cfg, tracer=None, *, device) -> Callable:
    """The subframe step step(cam, film) -> (film, stats), with the tracer
    built once for `device` (the accumulator stays on the device across
    subframes, cuda_scene.h:172-178)."""
    if tracer is None:
        from ..trace.auto import choose_tracer

        scene, tracer = choose_tracer(scene, cfg, device)

    def step(cam, film: Film):
        return render_subframe(scene, cam, film, cfg, tracer=tracer)

    return step


def render_frame(scene, camera_params, cfg, subframes: int = 1,
                 film: Optional[Film] = None, tracer=None, *, device):
    """Offline progressive render of `subframes` launches. Returns
    (film, total stats)."""
    step = make_render_fn(scene, cfg, tracer=tracer, device=device)
    if film is None:
        film = film_create(cfg.height, cfg.width, device=device,
                           aov=cfg.aov)
    total_rad = 0
    total_shad = 0
    for _ in range(subframes):
        film, stats = step(camera_params, film)
        total_rad += int(stats.radiance_rays)
        total_shad += int(stats.shadow_rays)
    return film, RenderStats(radiance_rays=torch.tensor(total_rad),
                             shadow_rays=torch.tensor(total_shad))
