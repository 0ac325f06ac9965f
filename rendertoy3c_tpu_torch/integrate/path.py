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

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..accel.morton import morton3d
from ..film.film import Film, film_accumulate, film_create
from ..math import rng
from ..scene.camera import camera_ray_dir
from ..trace.shade import (ACC_COLS, AOV_COLS, ExternalPipeline,
                           FusedPipeline, misc_width)
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
    scf = tuple(float(x) for x in np.concatenate(
        [cam.eye, cam.u, cam.v, cam.w]).astype(np.float32))

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


def sort_box(scene):
    """(lo, inv) of the ray sort: the box of key 0's v0 over the real faces
    and 1 / max(extent, 1e-6) in float32 (path.py:1067-1071)."""
    v0s = np.asarray(scene.geom.v0[0])[:scene.num_faces]
    lo = v0s.min(axis=0)
    inv = np.float32(1.0) / np.maximum(v0s.max(axis=0) - lo, np.float32(1e-6))
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
    scf = tuple(float(x) for x in np.concatenate(
        [cam.eye, cam.u, cam.v, cam.w]).astype(np.float32))
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
        idle = dead & (pixel < 0)
        wpix = next_work + torch.cumsum(idle.to(torch.int64), 0) - 1
        take_px = idle & (wpix < n_pix)
        pixel = torch.where(
            take_px, (pixel_base + torch.clamp(wpix, 0, n_pix - 1))
            .to(torch.float32), pixel)
        samp = torch.where(take_px, 0.0, samp)
        next_work = next_work + take_px.sum()

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
        w = next_work + torch.cumsum(dead.to(torch.int64), 0) - 1
        take = dead & (w < total_work)
        w_c = torch.clamp(w, 0, total_work - 1)
        samp_i = w_c // n_pix
        new_pixel = pixel_base + w_c % n_pix
        pixel = torch.where(take, new_pixel.to(torch.float32),
                            torch.where(flush, -1.0, pixel))
        acc = torch.where((take | flush)[:, None], 0.0, acc)
        samp = torch.where(take, samp_i.to(torch.float32), samp)
        next_work = next_work + take.sum()
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


def render_pixels(scene, cfg, cam, tracer, pixel_idx, subframe_index: int):
    """Path-trace a flat list of pixel indices. Returns (rgb [N, 3], the
    AOV slot: (albedo [N, 3], normal [N, 3]) with cfg.aov else None,
    radiance rays, shadow rays, pool iterations or, for the walk pool,
    walk rounds)."""
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
    if not isinstance(tracer, (FusedPipeline, ExternalPipeline)):
        raise NotImplementedError(
            "only the fused and external pipelines are ported yet; the "
            "brute and walk tracers under the general pool are ROADMAP "
            "A7/A17")
    pool = min(cfg.ray_block,
               _next_pow2(pixel_idx.shape[0] * cfg.samples_per_launch))
    if pool % 256:
        raise ValueError("fused pipeline needs a pool multiple of 256")
    return _render_pool_fused(scene, cfg, cam, pixel_idx, subframe_index,
                              tracer)


def render_subframe(scene, cam, film: Film, cfg, tracer=None):
    """Render one progressive subframe and fold it into the film
    (src/wavefront.cpp:203-222, raygen.cu:75-86). Returns (film, stats)."""
    if tracer is None:
        from ..trace.auto import choose_tracer

        scene, tracer = choose_tracer(scene, cfg, film.accum.device)
    n_pixels = cfg.width * cfg.height
    pixel_idx = torch.arange(n_pixels, dtype=torch.int64)
    rgb, aov, n_rad, n_shad, steps = render_pixels(
        scene, cfg, cam, tracer, pixel_idx, film.subframe_index)
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
