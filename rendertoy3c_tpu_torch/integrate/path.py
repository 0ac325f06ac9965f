"""The persistent ray pools over the pipelines, and the render entry
points.

Port of the pool paths of rendertoy3c_tpu/integrate/path.py:
`_lcg_advance_table` (:463), `RenderStats`, the
stash and flush-cadence choice of `_render_pool_fused` (:1016-1048),
`_render_pool_fused_krefill` (:832-989) over the refill megakernel (K4),
the XLA-refill pixel-major loop of `_render_pool_fused` (:1060-1393) over
the external pipeline (K6 between MT tracers), and `render_pixels`,
`render_subframe`, `make_render_fn`, `render_frame` (:1396-1549).

Both loops mirror the reference's while_loop: the loop condition is read
once per window (one host synchronisation), and each window runs one
flush and then `flush_every` iterations that stay on the device
(`next_work`, `count` and the ray counters are device tensors).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..film.film import Film, film_accumulate, film_create
from ..math import rng
from ..scene.camera import camera_ray_dir
from ..trace.shade import ExternalPipeline, FusedPipeline


class RenderStats(NamedTuple):
    radiance_rays: torch.Tensor  # int64 scalar
    shadow_rays: torch.Tensor  # int64 scalar
    pool_iters: int = 0  # megakernel launches this subframe


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


def _flush(image, misc, stash, spp: int, pixel_base: int, sink: int) -> None:
    """Scatter the stash (None when off) and the parked completed lanes
    into the image and free them (path.py:915-955, :1297-1345). Lanes with
    nothing to flush add into the sink row `sink` of the image, which is
    dropped at the end."""
    pixel = misc[:, 13]
    completed = (misc[:, 9] <= 0) & (pixel >= 0) & (misc[:, 14] >= spp)
    target = torch.where(completed, pixel.to(torch.int64) - pixel_base, sink)
    if stash is not None:
        sp = stash[:, 0]
        starget = torch.where(sp >= 0, sp.to(torch.int64) - pixel_base, sink)
        image.index_add_(0, starget, stash[:, 1:4])
    image.index_add_(0, target, misc[:, 10:13])
    if stash is not None:
        stash.zero_()
        stash[:, 0] = -1.0
    misc[:, 10:13] = torch.where(completed[:, None], 0.0, misc[:, 10:13])
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
    """Megakernel pool with in-kernel refill. Returns (rgb [N, 3], None,
    n_rad, n_shad, launches)."""
    dev = fused.device
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    pixel_base = int(pixel_idx[0])
    shader = fused.refill_shader(n_pix, use_stash=True)
    f32 = dict(dtype=torch.float32, device=dev)

    rays = torch.zeros((pool, 8), **f32)
    misc = torch.zeros((pool, 16), **f32)
    misc[:, 13] = -1.0
    stash = torch.zeros((pool, 16), **f32)
    stash[:, 0] = -1.0
    # row n_pix is the sink of lanes with nothing to flush
    image = torch.zeros((n_pix + 1, 3), **f32)
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
        _flush(image, misc, stash, spp, pixel_base, n_pix)
        for _ in range(flush_every):
            shader(rays, misc, stash, stats[cur], stats[1 - cur], pixel_base,
                   subframe_index, scf)
            cur = 1 - cur
            n_rad += stats[cur][2]
            n_shad += (misc[:, 15] > 0).sum()
            launches += 1
    _flush(image, misc, stash, spp, pixel_base, n_pix)
    return _finish(image, n_pix, spp), None, n_rad, n_shad, launches


def _finish(image, n_pix: int, spp: int):
    inv_spp = torch.tensor(1.0, dtype=torch.float32) / float(spp)
    return image[:n_pix] * inv_spp.to(image.device)


def _render_pool_xla_refill(cfg, cam, pixel_idx, subframe_index: int,
                            pipe: ExternalPipeline, pool: int,
                            use_stash: bool, flush_every: int):
    """The pixel-major XLA-refill pool (path.py:1060-1393) over a pipeline
    with `trace_shade`: each iteration retires completed lanes into the
    stash (when on), claims pixels for idle lanes by a cumulative sum in
    lane order, seeds each new sample (tea, per-sample LCG jump, two jitter
    draws), builds its camera ray, draws every live lane's ray time, and
    runs one trace_shade. Returns (rgb [N, 3], None, n_rad, n_shad,
    iterations)."""
    dev = pipe.device
    n_pix = int(pixel_idx.shape[0])
    spp = cfg.samples_per_launch
    pixel_base = int(pixel_idx[0])
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    jump = torch.as_tensor(_lcg_advance_table(spp).astype(np.int64),
                           device=dev)
    scf = tuple(float(x) for x in np.concatenate(
        [cam.eye, cam.u, cam.v, cam.w]).astype(np.float32))
    eye = torch.tensor(scf[0:3], **f32)

    rays = torch.zeros((pool, 8), **f32)
    misc = torch.zeros((pool, 16), **f32)
    misc[:, 13] = -1.0
    # stash [P, 16]: col 0 pixel (-1 = free), 1-3 acc, as the K4 pool's
    stash = None
    if use_stash:
        stash = torch.zeros((pool, 16), **f32)
        stash[:, 0] = -1.0
    image = torch.zeros((n_pix + 1, 3), **f32)  # row n_pix: the sink
    next_work = torch.zeros((), **i64)
    n_rad = torch.zeros((), **i64)
    n_shad = torch.zeros((), **i64)
    lane = torch.arange(pool, **i64)
    tmin = torch.full((pool, 1), cfg.primary_tmin, **f32)
    tmax = torch.full((pool, 1), cfg.primary_tmax, **f32)

    def body(rays, misc, next_work):
        alive = misc[:, 9] > 0
        dead = ~alive
        pixel, samp = misc[:, 13], misc[:, 14]
        acc = misc[:, 10:13]
        if use_stash:
            completed = dead & (pixel >= 0) & (samp >= spp)
            can_stash = completed & (stash[:, 0] < 0)
            stash[:, 0] = torch.where(can_stash, pixel, stash[:, 0])
            stash[:, 1:4] = torch.where(can_stash[:, None], acc,
                                        stash[:, 1:4])
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
            alive2.to(torch.float32)[:, None], acc, pixel[:, None],
            samp[:, None], torch.zeros_like(pixel)[:, None]], dim=1)
        n_live = alive2.sum()
        count_hint = torch.where(alive2, lane, -1).max() + 1
        rays, misc = pipe.trace_shade(
            rays, misc, count_hint.to(torch.int32).reshape(1),
            time if pipe.motion else None)
        return rays, misc, next_work, n_live, (misc[:, 15] > 0).sum()

    iters = 0
    while _pool_busy(misc, next_work, n_pix, spp):
        _flush(image, misc, stash, spp, pixel_base, n_pix)
        for _ in range(flush_every):
            rays, misc, next_work, live, shad = body(rays, misc, next_work)
            n_rad += live
            n_shad += shad
            iters += 1
    _flush(image, misc, stash, spp, pixel_base, n_pix)
    return _finish(image, n_pix, spp), None, n_rad, n_shad, iters


def _render_pool_fused(cfg, cam, pixel_idx, subframe_index: int, fused):
    """The stash and flush-cadence choice of the reference (path.py:
    1016-1048). The refill megakernel (FusedPipeline) always stashes; the
    external pipeline takes cfg.pool_stash, and auto (-1) is off for it.
    The cadence is 32 iterations with the stash and 16 without, halved
    when the frame is more than 32 pools."""
    n_pix = int(pixel_idx.shape[0])
    pool = min(cfg.ray_block, _next_pow2(n_pix * cfg.samples_per_launch))
    kernel_refill = isinstance(fused, FusedPipeline)
    use_stash = kernel_refill or cfg.pool_stash > 0
    if cfg.flush_every:
        flush_every = cfg.flush_every
    elif use_stash:
        flush_every = 16 if n_pix > 32 * pool else 32
    else:
        flush_every = 8 if n_pix > 32 * pool else 16
    if kernel_refill:
        return _render_pool_fused_krefill(cfg, cam, pixel_idx,
                                          subframe_index, fused, pool,
                                          flush_every)
    return _render_pool_xla_refill(cfg, cam, pixel_idx, subframe_index,
                                   fused, pool, use_stash, flush_every)


def render_pixels(scene, cfg, cam, tracer, pixel_idx, subframe_index: int):
    """Path-trace a flat list of pixel indices. Returns (rgb [N, 3], None
    (the AOV slot), radiance rays, shadow rays, pool iterations)."""
    if not isinstance(tracer, (FusedPipeline, ExternalPipeline)):
        raise NotImplementedError(
            "only the fused and external pipelines are ported yet; the "
            "brute and walk tracers under the general pool are ROADMAP "
            "A7/A17")
    if not cfg.pool_pixel_major or cfg.sort_rays:
        raise NotImplementedError(
            "sample-major or sorted pools need the non-refill shade kernel "
            "K5 (ROADMAP A8)")
    pool = min(cfg.ray_block,
               _next_pow2(pixel_idx.shape[0] * cfg.samples_per_launch))
    if pool % 256:
        raise ValueError("fused pipeline needs a pool multiple of 256")
    return _render_pool_fused(cfg, cam, pixel_idx, subframe_index, tracer)


def render_subframe(scene, cam, film: Film, cfg, tracer=None):
    """Render one progressive subframe and fold it into the film
    (src/wavefront.cpp:203-222, raygen.cu:75-86). Returns (film, stats)."""
    if tracer is None:
        from ..trace.auto import choose_tracer

        scene, tracer = choose_tracer(scene, cfg, film.accum.device)
    n_pixels = cfg.width * cfg.height
    pixel_idx = torch.arange(n_pixels, dtype=torch.int64)
    rgb, _, n_rad, n_shad, launches = render_pixels(
        scene, cfg, cam, tracer, pixel_idx, film.subframe_index)
    film = film_accumulate(film, rgb.reshape(cfg.height, cfg.width, 3))
    return film, RenderStats(radiance_rays=n_rad, shadow_rays=n_shad,
                             pool_iters=launches)


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
        film = film_create(cfg.height, cfg.width, device=device)
    total_rad = 0
    total_shad = 0
    for _ in range(subframes):
        film, stats = step(camera_params, film)
        total_rad += int(stats.radiance_rays)
        total_shad += int(stats.shadow_rays)
    return film, RenderStats(radiance_rays=torch.tensor(total_rad),
                             shadow_rays=torch.tensor(total_shad))
