"""Render configuration.

A copy of rendertoy3c_tpu/integrate/config.py with the same fields and
defaults, so one config describes a render in both packages. The port
renders the slice of them that trace/auto.py accepts and raises
NotImplementedError, naming the ROADMAP item, for the rest.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 768  # src/wavefront.cpp:300
    height: int = 768
    samples_per_launch: int = 8  # src/wavefront.cpp:55

    # The reference's bounce loop is unbounded (raygen.cu:48-72); a static
    # cap keeps the truncated mass negligible for physical albedos.
    max_depth: int = 32

    primary_tmin: float = 0.01  # raygen.cu:54
    primary_tmax: float = 1e16  # raygen.cu:55
    shadow_tmin: float = 0.001  # closehit_radiance.cu:137
    shadow_tmax_eps: float = 0.01  # closehit_radiance.cu:138 (Ldist - eps)

    # constant ambient of the miss program (src/shader/test.cu:3-6)
    bg_radiance: tuple = (0.01, 0.01, 0.01)

    # rays per block (wave) or pool width cap (pool)
    ray_block: int = 1 << 16
    tri_chunk: int = 256

    # "wave" (per-block bounce loops) or "pool" (persistent ray pool)
    integrator: str = "wave"

    # pool only: a lane renders all samples of its pixel before flushing
    pool_pixel_major: bool = False
    # pool flush cadence in launches; 0 = auto
    flush_every: int = 0
    # pool retire stash: 1 on, 0 off, -1 auto
    pool_stash: int = -1

    # walk-pool only: rounds between phase boundaries (0 = auto)
    walk_phase_every: int = 0
    # walk-pool only: paths per lane (0 = auto)
    pool_paths: int = 0

    # pool only: re-sort live lanes by direction octant each iteration
    sort_rays: bool = False

    # 'uniform' (reference, closehit_radiance.cu:10-15) or 'power'
    light_sampler: str = "uniform"

    # stream offset XORed into every per-pixel tea() seed (rot_seed,
    # cuda/random.h:74-77); 0 reproduces the reference stream
    seed: int = 0

    # first-hit albedo / normal AOV buffers
    aov: bool = False

    # 'reference' (the shipped closest-hit, closehit_radiance.cu:95-152)
    # or 'physical'
    throughput_model: str = "reference"
