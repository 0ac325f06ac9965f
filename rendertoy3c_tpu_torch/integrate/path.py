"""The persistent ray pool over the refill megakernel, and the render entry
points.

Port of the main path of rendertoy3c_tpu/integrate/path.py:
`_lcg_advance_table` (:463), `RenderStats`, the stash and flush-cadence
choice of `_render_pool_fused` (:1016-1048), `_render_pool_fused_krefill`
(:832-989), and `render_pixels`, `render_subframe`, `make_render_fn`,
`render_frame` (:1396-1549).

The pool loop mirrors the reference's while_loop: the loop condition is
read once per window (one host synchronisation), and each window runs one
flush and then `flush_every` megakernel launches that stay on the device
(`next_work`, `count` and the ray counters are device tensors).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..film.film import Film, film_accumulate, film_create
from ..trace.shade import FusedPipeline


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
    """Scatter the stash and the parked completed lanes into the image and
    free them (path.py:915-955). Lanes with nothing to flush add into the
    sink row `sink` of the image, which is dropped at the end."""
    pixel = misc[:, 13]
    completed = (misc[:, 9] <= 0) & (pixel >= 0) & (misc[:, 14] >= spp)
    target = torch.where(completed, pixel.to(torch.int64) - pixel_base, sink)
    sp = stash[:, 0]
    starget = torch.where(sp >= 0, sp.to(torch.int64) - pixel_base, sink)
    image.index_add_(0, starget, stash[:, 1:4])
    image.index_add_(0, target, misc[:, 10:13])
    stash.zero_()
    stash[:, 0] = -1.0
    misc[:, 10:13] = torch.where(completed[:, None], 0.0, misc[:, 10:13])
    misc[:, 13] = torch.where(completed, -1.0, pixel)
    misc[:, 14] = torch.where(completed, 0.0, misc[:, 14])


def _render_pool_fused_krefill(cfg, cam, pixel_idx, subframe_index: int,
                               fused: FusedPipeline, pool: int,
                               flush_every: int):
    """Megakernel pool with in-kernel refill. Returns (rgb [N, 3], n_rad,
    n_shad, launches)."""
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

    def busy(s):
        pending = (misc[:, 13] >= 0) & (misc[:, 14] < spp)
        return bool((s[0] < n_pix) | (misc[:, 9] > 0).any() | pending.any())

    cur = 0
    launches = 0
    while busy(stats[cur]):
        _flush(image, misc, stash, spp, pixel_base, n_pix)
        for _ in range(flush_every):
            shader(rays, misc, stash, stats[cur], stats[1 - cur], pixel_base,
                   subframe_index, scf)
            cur = 1 - cur
            n_rad += stats[cur][2]
            n_shad += (misc[:, 15] > 0).sum()
            launches += 1
    _flush(image, misc, stash, spp, pixel_base, n_pix)
    inv_spp = torch.tensor(1.0, dtype=torch.float32) / float(spp)
    return image[:n_pix] * inv_spp.to(dev), n_rad, n_shad, launches


def _render_pool_fused(cfg, cam, pixel_idx, subframe_index: int,
                       fused: FusedPipeline):
    """The stash and flush-cadence choice of the reference (path.py:
    1016-1048) for the in-kernel-refill path: pixel-major, unsorted, so
    the stash is on and the cadence is 32 launches, 16 when the frame is
    more than 32 pools."""
    n_pix = int(pixel_idx.shape[0])
    pool = min(cfg.ray_block, _next_pow2(n_pix * cfg.samples_per_launch))
    if cfg.flush_every:
        flush_every = cfg.flush_every
    else:
        flush_every = 16 if n_pix > 32 * pool else 32
    return _render_pool_fused_krefill(cfg, cam, pixel_idx, subframe_index,
                                      fused, pool, flush_every)


def render_pixels(scene, cfg, cam, tracer, pixel_idx, subframe_index: int):
    """Path-trace a flat list of pixel indices. Returns (rgb [N, 3],
    radiance rays, shadow rays, launches)."""
    if not isinstance(tracer, FusedPipeline):
        raise NotImplementedError(
            "only the fused pipeline is ported yet; the brute and walk "
            "tracers under the general pool are ROADMAP A7/A17")
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
    rgb, n_rad, n_shad, launches = render_pixels(
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
