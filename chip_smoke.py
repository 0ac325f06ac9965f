#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (rendertoy3c_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from kernels/csrc, checks each against
its plain PyTorch version on the card, renders the Cornell main path, the
two .obj town paths and the fused pipeline's motion, sorted and
sample-major paths at full size through the user entry points, and prints
a JSON summary. Phases:

  1. card, power limit, torch/CUDA versions, kernel build time;
  2. K1/K2 (mt_closest, mt_any) against their plain versions and the brute
     tracer on 131072 Cornell rays: bit for bit against the plain versions,
     prims exact and t/u/v within 1e-6 against the brute tracer, the
     live-count skip;
  3. K4 (trace_shade_refill) against its plain version: teacher-forced for
     8 launches on one 256-lane block (deterministic claims), then one
     launch at the main path's pool width from a mid-render state (claims
     compared as a set keyed by pixel); its device time per launch there
     (device_ms, as phase 8's);
  4. the gate (bench.py:115-116) of kernels against plain versions at 96^2,
     2 spp, max_depth 6, ray_block 4096;
  5. the Cornell main path: 768^2, 8 spp, max_depth 16, ray_block 32768,
     pixel-major pool; 1 warm-up and 1 timed subframe with the kernels
     (TIMED, as for every main path below);
     Mray/s counted as radiance + shadow rays; every pixel finite; the
     kernels held to the plain versions on the middle sixteenth of the
     image (rows 360-408: one subframe each through render_pixels, means
     within 1%, the gate, with AOV the albedo and normal bands bit-equal;
     every main path below that has plain versions does the same, the
     trace-time instanced path on rows 376-392); then a profile of one
     more subframe (the idle share, against the untraced timed subframe;
     a phase fails if its profile shows no device time or misses one of
     its kernels). One main path per pool and kernel family is profiled:
     Cornell and every K4 path, Cornell sorted (K5), the static MT town,
     the 49k box field (walk pool), multi_instance_tracetime (the
     trace-time walk drivers), `--tracer residentwalk` (K8) and K7's path;
     the paths of phases 27, 30, 34 and 38 profile their warm-up subframe
     instead of one more. A traced subframe lasts ~3 untraced ones on the
     host-bound paths;
  6. the PNG of the kernel render;
  7. K1/K2 on the static and K3 (mt_closest_motion, mt_any_motion) on the
     2-key 16054-face town, against their plain versions and the brute
     tracer on 131072 rays (camera rays and one cosine bounce, uniform
     random times): bit for bit against the plain versions, prims and
     occlusion exact and t/u/v within 1e-6 against the brute tracer, the
     count skip on 128-ray tiles for K3; then against their plain versions
     again, bit for bit, timed and bounded, with the binned tiles per live
     ray (mt_bin, checked against bin_ref), on the main path's own inputs:
     those of pool iterations 32, 128, 224 and 320 of one subframe of each
     town
     (that subframe is phase 10's warm-up, as the subframes recorded in
     phases 12, 15 and 18 are the warm-ups of their paths in phases 14,
     17 and 20);
  8. K6 (external_shade) teacher-forced against its plain version at 32768
     lanes for 8 iterations on both towns: every output bit for bit; then
     bit for bit again on the main paths' inputs of phase 7, and on the
     first R - 37 and 20 of a launch's R lanes (a short last block, less
     than one 32-lane block), and its device time per launch there
     (device_ms: CUDA events around the launches queued behind a spin
     kernel);
  9. the gate of phase 4 on the external path, the 4294-face town, static
     and 2-key;
 10. both 16054-face towns at the main path's config: 1 warm-up (phase
     7's recorded subframe) and 1 timed subframe with the kernels, the
     band of phase 5 against the plain versions; Mray/s, launches per
     subframe, every pixel finite, and (the static town) the device idle
     share of one profiled subframe;
 11. K4's motion variant against its plain version on the 2-key Cornell
     box (the last block given a second key at +0.1 in x), as phase 3:
     stats and the time buffer exact over 8 launches of one block, then
     one launch at the pool width; timed and bounded per launch;
 12. K5 (trace_shade, the merged megakernel without the refill), static
     and motion, against its plain version on the inputs of pool
     iterations 32, 128, 224 and 320 of one subframe of its own main path
     (phase 14's sorted Cornell and 2-key sample-major Cornell); device
     time per launch as phase 8's (its wrapper's host time exceeds it),
     and bound;
 13. the gate of phase 4 on the 2-key Cornell box (pixel-major), Cornell
     sorted and sample-major, and the 4294-face town sorted and
     sample-major (external pipeline);
 14. three more main paths as phase 5: the 2-key
     Cornell box on the pixel-major pool (K4 motion), Cornell with
     sort_rays (K5) and the 2-key Cornell box sample-major (K5 motion);
 15. the textured kernels against their plain versions: textured K4 and
     K4 motion as phase 3 on the textured quad (builtin
     textured_quad_scene) and its 2-key variant (the floor given a second
     key at +0.1 in x); textured K5 and K5 motion as phase 12 on the
     inputs of their own main paths (phase 17) at pool iterations 16, 80,
     144 and 208 (the quad's paths end sooner); textured K6 as phase 8 on
     the textured static and 2-key towns and on their main paths' inputs;
     each timed and bounded with the texel reads and the fetch's
     operations added;
 16. the gate of phase 4 on the textured quad (repeat; CLAMP/MIRROR with
     uvs stretched to 2.5 uv - 0.75; a uv transform; a normal map) and on
     the textured 4294-face towns, static and 2-key;
 17. the textured main paths as phase 5: the
     textured quad pixel-major (textured K4) and sorted (textured K5), the
     2-key textured quad pixel-major (K4 motion) and sample-major (K5
     motion), and the textured 16054-face towns, static (K1/K2 + textured
     K6) and 2-key (K3 + textured K6), whose atlas must hold the town's
     two textures;
 18. the dispatch kernels (the four-type material dispatch; the power
     light pick) against their plain versions: K4 dispatch and K4 motion
     dispatch as phase 3 on the Cornell box with all four material types
     (scene/builtin.py material_cornell_box) and its 2-key variant, textured
     K4 dispatch on the principled, normal-mapped quad; K5 dispatch with
     the power pick as phase 12 on its main path's inputs (the material
     Cornell box sorted, power); K6 dispatch with the power pick, untextured
     and textured, as phase 8 on the principled 16054-face towns (BASELINE
     config 5's scene) and on their main paths' inputs (at pool iterations
     32, 112, 192 and 272: a principled town's sorted subframe runs 320);
     each on states
     whose live lanes hit every material type of the scene, timed and
     bounded with the dispatch's and the pick's operations added;
 19. the gate of phase 4 on the material Cornell box (uniform and power),
     its 2-key variant sample-major, the principled quad, and the
     principled 4294-face town (textured: power, pixel-major and sorted;
     untextured: power, sorted);
 20. the dispatch main paths as phase 5: the
     material Cornell box pixel-major (K4 dispatch) and sorted with the
     power pick (K5 dispatch), the 2-key material Cornell box (K4 motion
     dispatch), the principled quad (textured K4 dispatch), and the
     principled towns, power, sorted: textured, BASELINE config 5 at the MT
     band's top (K1/K2 + textured K6 dispatch), and untextured (K1/K2 + K6
     dispatch);
 21-23. the AOV kernels, gates and paths, the denoiser and the CLI;
 24. the hierwalk band (scenes of more than 16384 faces, the walk pool):
     bench.py's hierwalk gate (:124-158) on K9 (walk_rounds, the walk
     pool's rounds): 131072 camera rays from (0, 20, 45) on bench's 49k box
     field and camera plus bounce rays on the 50000-face static and 2-key
     towns (58054 faces), the K9-driven trace_closest_hier /
     trace_any_hier bit-equal to their plain versions and exact against the
     brute tracer; after phase 27, one K9 launch teacher-forced on the
     lane states recorded at 4 boundaries of each walk main path, every
     state column bit-equal, its device time per launch, walking lanes and
     bound (rows gathered x 512 B against the slab and MT operations);
 25. K6 on C-major misc (transposed) on the walk paths' recorded boundary
     inputs, in each variant they reach (untextured, textured, textured
     dispatch with the power pick, textured AOV), bit for bit (with the
     tail cases of phase 8), timed and bounded as phase 8;
 26. the gate of phase 4 on the walk pool over the 50000-face towns:
     static, 2-key, textured, principled with the power pick, and
     textured with AOV (all three buffers bit-equal);
 27. the walk main paths through make_render_fn with tune_config's pool
     (16384 lanes, flush 8): BASELINE config 1 (the untextured town at
     1920x1080), configs 2, 4 and 5 (the textured town, its 2-key form,
     the principled town with the power pick; sort_rays, which the walk
     pool ignores) and the 49k box field at 768^2, 8 spp, depth 16: 1
     warm-up and 1 timed subframe each, Mray/s, boundaries, K9 launches
     and walk rounds per subframe, rows gathered per ray, every pixel
     finite, the idle share of the 49k field's profiled warm-up; and one
     textured AOV subframe. No plain subframe runs at these sizes:
     the plain walk runs ~150 small torch ops per round, so the images are
     held to the plain versions by phases 24-26;
 28. trace-time instancing: bench.py's instanced gate (:192-220) on
     K9-inst (walk_rounds over an instanced table): 131072 camera rays of
     the 768^2 grid on bench's instance field at grid 8 (66 instances),
     the K9-inst-driven trace_closest_inst_hier / trace_any_inst_hier
     bit-equal to their plain versions and exact against the brute
     instanced tracer (0 prim, 0 instance, 0 occlusion mismatches); the
     2-key field at grid 8 on a forced fanout-32 table with random times
     likewise;
 29. the gate of phase 4 on the trace-time Cornell (K9-inst under the
     external pipeline, K6 with instance rows), a baked field at grid 6
     and the 578-instance 2-key field (K9-inst at fanout 32);
 30. bench's instanced main paths with tune_config's pool (bench.py
     :537-584): BASELINE config 3 `multi_instance_tlas` (baked by
     build_scene, K4) as phase 5; `multi_instance_tracetime` (1 warm-up, 1
     timed subframe, the band against the plain versions); the 578-
     instance fields `multi_instance_large` (baked world table, K9, 16384
     lanes) and `multi_instance_motion` (K9-inst, fanout 32, 8192 lanes)
     as phase 27; each with Mray/s, launches per subframe (K9-inst, K9 and
     K6 with instance rows must launch), every pixel finite, and
     `multi_instance_tracetime`'s idle share (the fields' kernels, K9,
     K9-inst and K6, are profiled by the 49k field's walk path and by
     `multi_instance_tracetime`'s drivers);
 31. K9-inst on the 2-key field's recorded states, K9-inst under the
     trace-time walk drivers on the states of 4 of their launches in
     multi_instance_tracetime's warm-up, and K9 on the baked field's, and
     K6 with instance rows on the fields' (C-major) and the trace-time
     path's (row-major) recorded inputs: bit for bit against their plain
     versions, timed and bounded as phases 24-25;
 32. the resident-table walk (K8: walk_closest, walk_any) on bench's 49k
     box field split-ordered at 256-face runs: 131072 camera rays from
     (0, 20, 45) and one cosine bounce from each hit, the single-pass
     form (output and cursor rows) bit-equal to one reference launch
     (walk_*_ref), the one-launch walk's hits and occlusion bit-equal to
     the reference's pass loop (plain=True), 0 prim and 0 occlusion
     mismatches against the brute tracer; the same with a forced
     multi-pass walk (t_rounds = 4);
 33. the gates of phase 4 on the general pool: K8 against the plain walk
     (sorted), the wave integrator against the pool over K8, and an
     emissive- and roughness-textured quad (the A22 scene) on the bare MT
     rung (K1/K2) against the plain MT tracer;
 34. `--tracer residentwalk`'s main path: the split-ordered box field
     through make_render_fn over make_walk_tracer at bench's cfg_sorted
     (768^2, 8 spp, depth 16, ray_block 32768, pixel-major, sorted): 1
     warm-up and 1 timed subframe, Mray/s, K8 launches per walk (1),
     rounds per block (mean and largest) and the share of blocks done in
     their first pass, every pixel finite, the band of phase 5 against
     the plain walk, the idle share of the profiled warm-up;
 35. K8 closest and any on the inputs of 4 closest and 4 shadow calls of
     that path's warm-up: the whole walk (one launch) bit for bit against
     its plain twin (rows, cursor rows, per-block counts) and its hits
     and occlusion against the reference's pass loop, the single-pass
     form against walk_*_ref; timed (device_ms) beside the twin and
     bounded by the slab and MT operations of every pass each block ran
     and the bytes moved (k8_work);
 36. the non-merged K5 (make_fused_shader(merged=False): trace_shade_hit,
     the K5 kernel with the closest hits given): within phases 12, 15, 18
     and 21, on the recorded inputs of every K5 variant, closest_raw (K1
     or K3) and then the non-merged K5 bit-equal to its plain version,
     its lanes against the merged K5's, timed and bounded; after phase
     12, one subframe each of Cornell sorted and the 2-key Cornell box
     sample-major through a fused pipeline with K5 split so
     (split_pipeline), with launches, bit-equal to the merged pipeline's
     subframe;
 37. K7 (trace_instanced, the static two-level sweep): closest and any
     bit-equal to the plain version on phase 28's 131072 rays of the
     grid-8 field (its brute hits reused) and on 131072 camera rays of the
     trace-time Cornell, at the full count and a count inside a tile; 0
     prim, 0 instance and 0 occlusion mismatches against the brute
     instanced tracer; timed (device_ms) and bounded (k7_work, both
     terms printed); the (ray, instance) pairs the reference's 256-ray
     vote and the per-ray cull admit and the real-face share of the
     tested mesh tiles;
 38. K7's path: multi_instance_tracetime (bench.py:576-584) through
     prepare_tracer_factory(kind="pallas") and make_render_fn_dist on a
     1 x 1 NCCL mesh at MAIN: the warm-up subframe bit-equal to
     make_render_fn's over the same pair; 1 timed subframe, Mray/s, K7
     launches, every pixel finite, the band of rows 376-392 against the
     plain K7, the idle share of the profiled warm-up (both K7
     instantiations must show);
 39. K7 closest and any on 4 recorded calls each of that path's warm-up:
     bit for bit, timed (device_ms) and bounded (both terms printed);
 40. the (2, 1) and (1, 2) meshes of that path at 192^2 by the per-rank
     function in one process: tile bit-equal to one device, spp by the
     reference's test_tile_spp_mesh_statistics rule;
 41. K4 and K5 on the multi-tile fused scene (the Cornell box, the
     textured quad or the material Cornell box with a 10 x 10 grid of
     small boxes on the floor: 1204-1236 faces, three 512-face tiles, so
     that the megakernels' sweeps vote on tile boxes), static, 2-key,
     textured, dispatch and AOV, against their plain versions: K4 as
     phase 3, K5 teacher-forced for 4 iterations at the pool width, bit
     for bit.

Each kernel's bound is the larger of the bytes it must move over 3.35 TB/s
and the operations its inputs need over the 67 TFLOP/s fp32 peak outside
the tensor cores (H100 SXM data sheet): for the MT sweeps, each ray's own
box tests and the triangle tests of the tiles whose boxes it hits itself
(closest rays bounded by their best hit so far, any-hit rays stopping at
their first hit), replayed with the plain per-tile results; for the
shading, its body per lane, with the texture work, the material dispatch
and the power pick where the variant runs them. A tile's test counts only
its real faces (the megakernels and K7 test no padding).

Phases 11-14, on the Cornell box, and the textured quad's, the material
Cornell box's and the principled quad's parts of phases 15-20 run after
phase 6 and before the towns, the textured towns' phase 15 right after
phase 8, their phases 16-17 after phase 10, the principled towns' phases
18-20 and the towns' phases 21-23 after them, then phases 24-27 (24's
gate, 26, 27, then 24's and 25's checks on 27's states), phases 28-31,
phases 32-35, and phases 37-40 last (phase 36's paths run after phase 12,
phase 41 after phase 14).
Any failed phase exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
MAIN = dict(width=768, height=768, samples_per_launch=8, max_depth=16,
            ray_block=32768, integrator="pool", pool_pixel_major=True)
GATE = dict(width=96, height=96, samples_per_launch=2, max_depth=6,
            ray_block=4096, integrator="pool", pool_pixel_major=True)
TOWN_FACES = 16000  # generate_town gives 16054 faces (16384 padded)
# timed subframes of every main path: 1 (bench.py's timed_c is 2) to keep
# the script inside its time limit on a slow host
TIMED = 1
GATE_TOWN_FACES = 4000  # 4294 faces
MT_SRC = "rendertoy3c_tpu_torch/kernels/csrc/mt_kernels.cu"
# the three launches of one K1/K2/K3 sweep (mt_kernels.cu)
MT_SYMBOLS = ("mt_bin_kernel", "mt_test_kernel", "mt_epilogue_kernel")
K4_SRC = "rendertoy3c_tpu_torch/kernels/csrc/megakernel.cuh"
K6_SRC = "rendertoy3c_tpu_torch/kernels/csrc/external.cu"
MEM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
FP32_OPS = 67e12  # H100 SXM fp32 operations/s outside the tensor cores
# operations counted from the CUDA sources, one per arithmetic operation,
# compare, select or intrinsic: one Moller-Trumbore test (mt_test_tri),
# the per-triangle lerp of a motion test (a lerped test is 81), one slab
# test (box_hit), shade_lane, and K4's epilogue
MT_TEST_OPS = 54
LERP_OPS = 27
BOX_OPS = 29
SHADE_OPS = 300
REFILL_OPS = 170
# the texture work of shade_lane (shade.cuh), counted as above: the uv
# interpolation, the uv transform, one tex_fetch (two wrap_axis, the
# addresses, four texels decoded and the bilinear combine) and the normal
# map around its fetch (Gram-Schmidt, two normalizations, the select)
UV_OPS = 13
UV_XFORM_OPS = 8
TEX_FETCH_OPS = 136
NMAP_OPS = 67
# the material dispatch of shade_lane (kDispatch), counted as above: the
# parameters and lobe flags, the local frame of wo, F0 and p_spec (~60),
# the dielectric (~46), the GGX half-vector draw (~36), two prin_eval (116
# each: the sampled and the NEE direction), the weights and selects (~40),
# the NEE term (~35), less the Lambertian weight and MIS it replaces (~17);
# every lane runs all of it. The power pick: one step of the upper-bound
# search over the CDF row (index, load, compare, two selects), ceil(log2(n
# + 1)) steps for n lights.
DISPATCH_OPS = 430
POWER_STEP_OPS = 5
# the AOV rows (kAov), counted as above: per lane 6 selects and 6 adds
# (aov_rows); K4's retire moves them into the stash and zeroes them (12
# selects more)
AOV_OPS = 12
AOV_STASH_OPS = 12
AOV = dict(aov=True)
# the main paths' timings by name (median Mray/s, idle share), for phase 23
PATHS = {}
# the non-merged K5's results by phase_k5's label (phase 36)
NON_MERGED = {}


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


def cuda_ms(calls) -> float:
    """Mean time per call in ms: one pair of CUDA events around the calls,
    run back to back after one untimed call of each kind."""
    import torch

    calls[0]()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for call in calls:
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / len(calls)


def bit_equal(a, b) -> bool:
    """Two float32 tensors equal bit for bit."""
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def bound(n_bytes: float, ops: float):
    """(least time in ms, what bounds it) on one H100 SXM."""
    t_bytes = n_bytes / MEM_BPS * 1e3
    t_ops = ops / FP32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mt_work(rays, count, table, any_hit: bool, time=None, want=None,
            tile=None):
    """(operations, table bytes read) that one K1/K2/K3 sweep over these
    rays needs, counted ray by ray in tile order: a ray tests the boxes of
    the super-tiles, and of the tiles of each super-tile whose box it hits
    itself, and the real faces of each tile whose box it hits itself (K4
    and K5's block vote lets a ray into every tile that any ray of its
    block hits, K1-K3 bin a ray into each tile its padded box admits at
    its tmax, unbounded by its hits, and test a tile's padding columns:
    this count charges none of it). A closest ray's bound shrinks with its
    best hit so far; an any-hit ray stops at its first hit; rays past the
    live count (in ray tiles of `tile`, by default the MT kernel's),
    outside `want` (a megakernel's lanes without a shadow ray) or with
    tmax <= tmin need nothing. A tile's real faces count their bytes once
    if any ray tests them."""
    import torch

    from rendertoy3c_tpu_torch.trace import mt

    motion = time is not None
    tris = table.tris0 if motion else table.tris
    n_tiles, _, ct = tris.shape
    tile_r = tile or (mt.MOTION_RAY_TILE if motion else mt.RAY_TILE)
    r = rays.shape[0]
    need = mt.live_rows(r, count, tile_r) & (rays[:, 7] > rays[:, 6])
    if want is not None:
        need &= want
    cols = tuple(rays[:, c:c + 1] for c in range(8))
    o, d, tmin = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.full_like(d, 1e30))
    best = rays[:, 7].clone()
    done = torch.zeros(r, dtype=torch.bool, device=rays.device)
    tests = torch.zeros(r, dtype=torch.int64, device=rays.device)
    boxes = torch.zeros(r, dtype=torch.int64, device=rays.device)
    staged = 0

    def own(box, among):
        """Rays of `among` (not yet done) whose own slab test passes."""
        among = among & ~done
        boxes.add_(among.to(torch.int64))
        t0, t1 = (box[0:3] - o) * inv, (box[3:6] - o) * inv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        tcur = rays[:, 7] if any_hit else best
        return among & ((box[0] <= box[3]) & (tn <= tf) & (tf >= tmin)
                        & (tn <= tcur))

    def visit(k, m):
        nonlocal staged
        idx = (m & ~done).nonzero()[:, 0]
        if idx.numel() == 0:
            return
        nf = min(ct, table.num_faces - k * ct)  # the tile's real faces
        staged += nf
        sub = tuple(c[idx] for c in cols)
        extra = (table.tris1[k][:, :nf], time[idx, None]) if motion else ()
        t, _, _, hit, _ = mt.mt_test(sub, tris[k][:, :nf], k * ct, *extra)
        if any_hit:
            anyh = hit.any(dim=1)
            tests[idx] += torch.where(anyh, hit.int().argmax(dim=1) + 1, nf)
            done[idx] = anyh
        else:
            tests[idx] += nf
            tc = torch.where(hit, t, torch.full_like(t, 1e30)).amin(dim=1)
            best[idx] = torch.minimum(best[idx], tc)

    if n_tiles == 1:
        visit(0, need)
    elif n_tiles <= 2 * mt.SUPER_TILE:
        for k in range(n_tiles):
            visit(k, own(table.aabb[k], need))
    else:
        for ks in range(-(-n_tiles // mt.SUPER_TILE)):
            ms = own(table.super_aabb[ks], need)
            for j in range(mt.SUPER_TILE):
                k = ks * mt.SUPER_TILE + j
                if k < n_tiles:
                    visit(k, own(table.aabb[k], ms))
    ops = (int(tests.sum()) * (MT_TEST_OPS + (LERP_OPS if motion else 0))
           + int(boxes.sum()) * BOX_OPS)
    table_bytes = (staged * 9 * 4 * (2 if motion else 1)
                   + 4 * (table.aabb.numel() + table.super_aabb.numel()))
    return ops, table_bytes


def mt_cost(rays, count, table, any_hit: bool, time=None):
    """(bytes, operations) of one K1/K2/K3 launch on these rays."""
    ops, table_bytes = mt_work(rays, count, table, any_hit, time)
    r = rays.shape[0]
    n_bytes = r * (32 + 16) + 4 + table_bytes + (0 if time is None else 4 * r)
    return n_bytes, ops


def mean_bound(costs):
    """bound() of the mean launch of a list of (bytes, operations)."""
    return bound(sum(c[0] for c in costs) / len(costs),
                 sum(c[1] for c in costs) / len(costs))


def camera_and_bounce_rays(scene, camera, n_cam, n_total, dev, rng,
                           times=None):
    """n_total rays: n_cam camera rays, one cosine bounce from each hit,
    then rays from random points in the scene's box to fill. `times` (for
    a motion scene) places the bounce origins at the camera rays' times."""
    import torch

    from rendertoy3c_tpu_torch.trace.intersect import trace_closest_bruteforce

    p = camera.params()
    xy = rng.uniform(-1, 1, (n_cam, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(p.eye, d.shape)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),  # noqa: E731
                                   device=dev)
    tc = None if times is None else to(times[:n_cam])
    hit = trace_closest_bruteforce(scene, to(o), to(d), 0.01, 1e16, tc)
    prim = hit.prim.cpu().numpy()
    ok = prim >= 0
    g = scene.geom
    n = np.cross(g.e1[0][prim[ok]], g.e2[0][prim[ok]])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n *= -np.sign(np.sum(n * d[ok], axis=1, keepdims=True))
    w = rng.normal(size=(int(ok.sum()), 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    bd = n + w
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bo = (o + hit.t.cpu().numpy()[:, None] * d)[ok]
    n_rand = n_total - n_cam - len(bo)
    v = g.v0[0][:scene.num_faces]
    ro = rng.uniform(v.min(axis=0), v.max(axis=0), (n_rand, 3))
    ro[:, 1] = np.abs(ro[:, 1])
    rd = rng.normal(size=(n_rand, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return to(np.concatenate([o, bo, ro])), to(np.concatenate([d, bd, rd]))


# ---------------------------------------------------------------- phase 2
def phase_mt(dev, scene, camera):
    import torch

    from rendertoy3c_tpu_torch.trace import mt
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    rng = np.random.default_rng(SEED)
    p = camera.params()
    n_cam, n_rand = 49152, 32768
    xy = rng.uniform(-1, 1, (n_cam, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(p.eye, d.shape)
    to = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),  # noqa: E731
                                   device=dev)
    hit = trace_closest_bruteforce(scene, to(o), to(d), 0.01, 1e16)
    prim = hit.prim.clamp(min=0).cpu().numpy()
    g = scene.geom
    n = np.cross(g.e1[0][prim], g.e2[0][prim])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n *= -np.sign(np.sum(n * d, axis=1, keepdims=True))
    w = rng.normal(size=(n_cam, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    bd = n + w
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bo = o + hit.t.cpu().numpy()[:, None] * d
    bo = np.where(hit.prim.cpu().numpy()[:, None] >= 0, bo, o)
    ro = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (n_rand, 3))
    rd = rng.normal(size=(n_rand, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o_all, d_all = to(np.concatenate([o, bo, ro])), to(np.concatenate([d, bd, rd]))
    r = o_all.shape[0]
    check(r == 131072, f"ray count {r}")
    soup = mt.build_tri_soup(scene.geom, dev, num_faces=scene.num_faces)

    results = {}
    for name, kern, ref, tmin, tmax in (
            ("mt_closest", mt.mt_closest, mt.closest_ref, 0.01, 1e16),
            ("mt_any", mt.mt_any, mt.any_ref, 0.001,
             to(rng.uniform(0.2, 3.0, r)))):
        rays, _ = mt.pack_rays(o_all, d_all, tmin, tmax)
        err = 0.0
        for count in (r, r - 1000):
            c = torch.tensor([count], dtype=torch.int32, device=dev)
            got = kern(rays, c, soup)
            want = ref(rays, c, soup)
            torch.cuda.synchronize()
            check(bit_equal(got, want),
                  f"{name}: not bit-equal to the plain version")
            err = max(err, (got - want).abs().max().item())
            if count < r:  # whole tiles past the count write the miss row
                tail = -(-count // 256) * 256
                miss = torch.zeros_like(got[tail:])
                if name == "mt_closest":
                    miss[:, 0] = rays[tail:, 7]
                    miss[:, 1] = -1.0
                check(torch.equal(got[tail:], miss),
                      f"{name}: tiles past count were not skipped")
        if name == "mt_closest":
            h = mt.trace_closest_mt(soup, o_all, d_all, 0.01, 1e16)
            b = trace_closest_bruteforce(scene, o_all, d_all, 0.01, 1e16)
            check(torch.equal(h.prim, b.prim), "mt_closest: prim != brute")
            for x, y in ((h.t, b.t), (h.u, b.u), (h.v, b.v)):
                check(bool(((x - y).abs() <= 1e-6 + 1e-6 * y.abs()).all()),
                      "mt_closest: t/u/v differ from brute")
        else:
            occ = mt.trace_any_mt(soup, o_all, d_all, 0.001, tmax)
            occ_b = trace_any_bruteforce(scene, o_all, d_all, 0.001, tmax)
            check(torch.equal(occ, occ_b), "mt_any: occlusion != brute")
        # timed at the pool width of the main path
        pool = MAIN["ray_block"]
        rp = rays[:pool].contiguous()
        cp = torch.tensor([pool], dtype=torch.int32, device=dev)
        ms = cuda_ms([lambda: kern(rp, cp, soup)] * 50)
        plain_ms = cuda_ms([lambda: ref(rp, cp, soup)] * 10)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        print(f"phase 2 {name} (Cornell): exact prims vs plain and brute on "
              f"{r} rays; max|d| {err:.3g}; {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms at {pool} rays")
    return results


# ---------------------------------------------------------------- phase 3
def _lane_state(pool, dev, motion=False, aov=False):
    """A pool before its first launch: [rays, misc, stash] and, for a
    motion pipeline, the time buffer (zero, as the render starts it); misc
    [P, 24] with the AOV rows."""
    import torch

    rays = torch.zeros((pool, 8), dtype=torch.float32, device=dev)
    misc = torch.zeros((pool, 24 if aov else 16), dtype=torch.float32,
                       device=dev)
    misc[:, 13] = -1.0
    stash = torch.zeros((pool, 16), dtype=torch.float32, device=dev)
    stash[:, 0] = -1.0
    time_ = [torch.zeros(pool, dtype=torch.float32, device=dev)] if motion \
        else []
    return [rays, misc, stash, *time_]


def _compare_lanes(got, want, claimed_as_set: bool):
    """(max float error, lanes that differ) between two launch outputs
    [rays, misc, stash (, time)]; seeds (misc col 0) compared by bits. With
    claimed_as_set, the rows of lanes whose pixel ids differ are paired by
    pixel, since which lane claims which pixel depends on block order."""
    import torch

    rk, mk, sk = got[:3]
    rr, mr, sr = want[:3]
    # want_shadow (misc 15) and the stash belong to the lane's finished
    # path, the rest of a claiming lane's row (its AOV accs and its next
    # time too) to its new pixel
    lane_k = torch.cat([sk, mk[:, 15:16]], dim=1)
    lane_r = torch.cat([sr, mr[:, 15:16]], dim=1)
    rows_k = torch.cat([rk, mk[:, :15], mk[:, 16:],
                        *(t[:, None] for t in got[3:])], 1)
    rows_r = torch.cat([rr, mr[:, :15], mr[:, 16:],
                        *(t[:, None] for t in want[3:])], 1)
    moved = mk[:, 13] != mr[:, 13]
    if claimed_as_set and bool(moved.any()):
        a = rows_k[moved][torch.argsort(mk[moved, 13])]
        b = rows_r[moved][torch.argsort(mr[moved, 13])]
        rows_k = torch.cat([rows_k[~moved], a])
        rows_r = torch.cat([rows_r[~moved], b])
    seed_k = rows_k[:, 8].contiguous().view(torch.int32)
    seed_r = rows_r[:, 8].contiguous().view(torch.int32)
    fk = torch.cat([rows_k[:, :8], rows_k[:, 9:]], dim=1)
    fr = torch.cat([rows_r[:, :8], rows_r[:, 9:]], dim=1)
    bad = ((fk - fr).abs() > 1e-5 + 1e-5 * fr.abs()).any(dim=1)
    bad |= seed_k != seed_r
    lane_bad = ((lane_k - lane_r).abs() > 1e-5 + 1e-5 * lane_r.abs()).any(1)
    err = max((fk - fr).abs().max().item(),
              (lane_k - lane_r).abs().max().item())
    return err, int(bad.sum().item()) + int(lane_bad.sum().item())


def texture_work(a, r, tex):
    """(operations, bytes) of the texture work of shade_lane on these lanes
    (a: their attribute rows, r: the plain shading body's results, tex: the
    pipeline's TexState, or None): every lane interpolates its uvs (and
    transforms them); a lane fetches where its texture id is >= 0, the
    normal map with its own work. The bytes: the distinct texels these
    fetches read, 4 bytes each, and the meta rows."""
    import torch

    from rendertoy3c_tpu_torch.scene.texture import bilinear_footprint

    if tex is None:
        return 0, 0
    tu, tv = r["tex_uv"]
    n = tu.shape[0]
    ops = n * (UV_OPS + (UV_XFORM_OPS if tex.uv_xform else 0))
    ids = [a[22]] + ([a[tex.nmap_base + 3]] if tex.normal_maps else [])
    texels = []
    for k, tid in enumerate(ids):
        on = tid >= 0
        ops += int(on.sum()) * (TEX_FETCH_OPS + (NMAP_OPS if k else 0))
        flats, _, _ = bilinear_footprint(tex.atlas, tid[on], tu[on], tv[on])
        texels += list(flats)
    uniq = torch.unique(torch.cat(texels)).numel() if texels else 0
    return ops, 4 * uniq + 4 * tex.atlas.meta.numel()


def material_ops(n, params_base: int, power: bool, num_lights: int) -> int:
    """The operations of n lanes' material dispatch (params_base > 0) and
    power pick."""
    return n * ((DISPATCH_OPS if params_base else 0)
                + (POWER_STEP_OPS * num_lights.bit_length() if power else 0))


def check_material_types(scene, prims, live, what: str) -> list:
    """Fail unless the live lanes' hits (prims [R] into `scene`'s faces)
    include every material type of the scene; returns the types."""
    prims = prims.to("cpu").numpy().astype(np.int64)
    on = live.to("cpu").numpy() & (prims >= 0)
    mats = np.asarray(scene.geom.mat_id)[prims[on]]
    seen = sorted(set(np.asarray(scene.materials.mtype)[mats].tolist()))
    want = sorted(set(np.asarray(scene.materials.mtype).tolist()))
    check(seen == want, f"{what}: live lanes hit material types {seen}, "
          f"the scene has {want}")
    return seen


def megakernel_work(rays, misc, count, time, tables, sc,
                    with_closest=True):
    """(operations, table bytes) of one megakernel launch (K4 or K5) on
    these lanes: the closest and the shadow sweep, counted by mt_work on
    256-ray tiles (the shadow rays, their wants and their times from the
    plain shading body), the shading body of every lane, its texture work
    (texture_work), and the AOV rows where sc.aov. with_closest=False:
    the non-merged K5, whose closest hits come in (no closest sweep)."""
    import torch

    from rendertoy3c_tpu_torch.trace import mt, shade

    table = tables.soup if tables.msoup is None else tables.msoup
    closest, occluded = shade._plain_sweeps(tables, count, time)
    closest_ops, closest_bytes = mt_work(rays, count, table, False, time,
                                         tile=mt.RAY_TILE)
    hit4 = closest(rays)
    a = tables.attr_t[:, torch.clamp(hit4[:, 1], min=0.0).to(torch.int64)]
    out = shade._shade_lanes(rays, hit4, misc, a, tables.lights_t, sc,
                             occluded, tables.tex)
    tex_ops, tex_bytes = texture_work(a, out, tables.tex)
    tex_ops += material_ops(rays.shape[0], tables.params_base, sc.power,
                            sc.num_lights)
    if sc.aov:
        tex_ops += rays.shape[0] * AOV_OPS
    shadow_ops, shadow_bytes = mt_work(
        out["shadow"], count, table, True,
        None if time is None else out["occl_time"],
        want=out["want_shadow"], tile=mt.RAY_TILE)
    # each table tile is read from memory once
    if not with_closest:
        closest_ops, closest_bytes = 0, 0
    table_bytes = max(closest_bytes, shadow_bytes) + 4 * (
        tables.attr_t.numel() + tables.lights_t.numel()) + tex_bytes
    return (closest_ops + shadow_ops + rays.shape[0] * SHADE_OPS + tex_ops,
            table_bytes)


def k4_bound(state, stats_in, tables, rc):
    """bound() of one K4 launch from this state [rays, misc, stash (,
    time)]: megakernel_work and the refill operations of every lane (with
    AOV, the stash moves of its rows); the lane state (misc 64 or 96 B) is
    read and written once, the time buffer too."""
    rays, misc = state[:2]
    time = state[3] if len(state) > 3 else None
    pool = rays.shape[0]
    ops, table_bytes = megakernel_work(rays, misc, stats_in[1:2], time,
                                       tables, rc)
    n_bytes = (pool * 2 * (32 + 4 * misc.shape[1] + 64
                           + (4 if time is not None else 0))
               + 2 * 16 + table_bytes + 4 * tables.jump_u32.numel())
    return bound(n_bytes, ops + pool * (REFILL_OPS
                                        + (AOV_STASH_OPS if rc.aov else 0)))


def phase_k4(dev, scene, camera, phase=3, label="K4", change=None):
    """The refill megakernel (the motion variant for a 2-key scene)
    against its plain version: one block teacher-forced for 8 launches,
    then one launch at the pool width from a mid-render state; timed and
    bounded per launch. MAIN with `change` applied (AOV: misc [P, 24]). A
    scene with a non-diffuse material (the dispatch variant) must have
    every material type among the live lanes' hits of that state."""
    import torch

    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.trace import shade

    cfg = RenderConfig(**dict(MAIN, **(change or {})))
    n_pix = cfg.width * cfg.height
    p = camera.params()
    scf = tuple(float(x) for x in np.concatenate(
        [p.eye, p.u, p.v, p.w]).astype(np.float32))
    pipe = shade.FusedPipeline(scene, cfg, dev)
    motion = pipe.motion
    kern = pipe.refill_shader(n_pix)
    ref = shade.FusedPipeline(scene, cfg, dev,
                              refill_fn=shade.trace_shade_refill_ref
                              ).refill_shader(n_pix)
    sub = 3

    def launch(fn, state, stats_in):
        out = [x.clone() for x in state]
        stats_out = torch.zeros(4, dtype=torch.int32, device=dev)
        fn(*out[:3], stats_in, stats_out, 0, sub, scf, *out[3:])
        return out, stats_out

    # (a) one block, teacher-forced for 8 launches
    state = _lane_state(256, dev, motion, cfg.aov)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    err_a, bad_a = 0.0, 0
    for step in range(8):
        got, st_k = launch(kern, state, stats)
        want, st_r = launch(ref, state, stats)
        torch.cuda.synchronize()
        check(torch.equal(st_k, st_r),
              f"{label} block step {step}: stats {st_k.tolist()} != "
              f"{st_r.tolist()}")
        if motion:
            check(torch.equal(got[3].view(torch.int32),
                              want[3].view(torch.int32)),
                  f"{label} block step {step}: the time buffer differs")
        e, b = _compare_lanes(got, want, claimed_as_set=False)
        err_a, bad_a = max(err_a, e), bad_a + b
        state, stats = want, st_r
    check(bad_a <= 0.01 * 8 * 256, f"{label} block: {bad_a} lanes differ")
    print(f"phase {phase} {label} one block x 8 launches: stats "
          f"{'and time buffer ' if motion else ''}exact, {bad_a} lanes "
          f"differ, max|d| {err_a:.3g}")

    # (b) full pool width from a mid-render state of the plain version
    pool = cfg.ray_block
    state = _lane_state(pool, dev, motion, cfg.aov)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(12):
        state, stats = launch(ref, state, stats)
    if cfg.aov:  # the stash holds retired lanes' guides
        aov = slice(shade.STASH_AOV, shade.STASH_AOV + 6)
        check(bool((state[2][:, aov] != 0).any()),
              f"{label} pool: no AOV row in the stash at launch 12")
    tables = kern.keywords["tables"]
    types = ""
    if tables.params_base:
        closest = shade._plain_sweeps(tables, stats[1:2],
                                      state[3] if motion else None)[0]
        seen = check_material_types(scene, closest(state[0])[:, 1],
                                    state[1][:, 9] > 0, label)
        types = f", live lanes hit material types {seen}"
    got, st_k = launch(kern, state, stats)
    want, st_r = launch(ref, state, stats)
    torch.cuda.synchronize()
    check(torch.equal(st_k, st_r),
          f"{label} pool: stats {st_k.tolist()} != {st_r.tolist()}")
    err_b, bad_b = _compare_lanes(got, want, claimed_as_set=True)
    check(bad_b <= 0.001 * pool, f"{label} pool: {bad_b} lanes differ")
    print(f"phase {phase} {label} {pool} lanes from launch 12: stats exact "
          f"{st_k.tolist()}, {bad_b} lanes differ, max|d| {err_b:.3g}"
          f"{types}")

    # each timed launch gets its own copy of the same input state
    stats_out = torch.zeros(4, dtype=torch.int32, device=dev)

    def calls(fn, n):
        copies = [[x.clone() for x in state] for _ in range(n)]
        return [functools.partial(fn, *c[:3], stats, stats_out, 0, sub, scf,
                                  *c[3:]) for c in copies]

    ms = device_ms(calls(kern, 41))
    plain_ms = cuda_ms(calls(ref, 6))
    bound_ms, bound_by = k4_bound(state, stats, kern.keywords["tables"],
                                  kern.keywords["rc"])
    print(f"phase {phase} {label} time per launch at {pool} lanes: "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"by {bound_by}")
    return dict(max_abs_err=max(err_a, err_b), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------- phase 4/5
def plain_tracer(scene, cfg, dev):
    """(scene, pipeline) as choose_tracer gives them, over the plain
    versions of the kernels."""
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace import mt, shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    scene, pipe = choose_tracer(scene, cfg, dev)
    if isinstance(pipe, walkpool.WalkPoolPipeline) and pipe.instanced:
        return scene, plain_walk_pipe(pipe)
    if isinstance(pipe, walkpool.WalkPoolPipeline):
        return walk_pipes(scene, cfg, dev)[::2]
    if isinstance(pipe, shade.ExternalPipeline) and pipe.instanced:
        from rendertoy3c_tpu_torch.trace.hier_instanced import \
            make_inst_hierwalk_tracer

        return scene, shade.ExternalPipeline(
            scene, cfg, make_inst_hierwalk_tracer(scene, dev, plain=True),
            dev, shade_fn=shade.external_shade_ref)
    if isinstance(pipe, shade.FusedPipeline):
        return scene, shade.FusedPipeline(
            scene, cfg, dev, refill_fn=shade.trace_shade_refill_ref,
            shade_fn=shade.trace_shade_ref)
    return scene, shade.ExternalPipeline(
        scene, cfg, mt.make_mt_tracer(scene, dev, plain=True), dev,
        shade_fn=shade.external_shade_ref)


def render(scene, camera, cfg_kw, dev, plain: bool, warmup: int, timed: int,
           tracer=None, warm=None):
    """Render through make_render_fn, the plain versions if `plain`, over
    `tracer` if given; `warm`: (step, film) after a warm-up subframe run
    elsewhere, which the timed subframes continue. Returns (film, Mray/s
    per timed subframe, launches, seconds per timed subframe, the step
    function)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn

    cfg = RenderConfig(**cfg_kw)
    if plain and tracer is None:
        scene, tracer = plain_tracer(scene, cfg, dev)
    cam = camera.params()
    if warm is not None:
        step, film = warm
    else:
        step = make_render_fn(scene, cfg, tracer=tracer, device=dev)
        film = film_create(cfg.height, cfg.width, device=dev, aov=cfg.aov)
    for _ in range(warmup):
        film, _ = step(cam, film)
    torch.cuda.synchronize()
    rates, secs, launches = [], [], 0
    for _ in range(timed):
        t0 = time.perf_counter()
        film, stats = step(cam, film)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rays = int(stats.radiance_rays) + int(stats.shadow_rays)
        rates.append(rays / dt / 1e6)
        secs.append(dt)
        launches += stats.pool_iters
    return film, rates, launches, secs, step


def gate_diff(a, b):
    diff = np.abs(a - b)
    return diff.mean(), int((diff.max(axis=-1) > 0.35).sum()), diff.max()


def gate(scene, camera, dev, what: str, phase: int, tracers=(None, None),
         **change):
    """The gate (bench.py:115-116) of kernels against plain versions on
    the GATE config with `change` applied, over `tracers` (kernel, plain)
    if given; with AOV, all three buffers of the (first and only) subframe
    bit-equal too."""
    import torch

    cfg_kw = dict(GATE, **change)
    f_k = render(scene, camera, cfg_kw, dev, False, 0, 1, tracers[0])[0]
    f_p = render(scene, camera, cfg_kw, dev, True, 0, 1, tracers[1])[0]
    mean_d, outl, max_d = gate_diff(f_k.accum.cpu().numpy(),
                                    f_p.accum.cpu().numpy())
    check(mean_d <= 2e-3 and outl <= 8 and max_d <= 8.0,
          f"gate ({what}) failed: mean|d| {mean_d:.3g}, {outl} outliers, "
          f"max|d| {max_d:.3g}")
    extra = ""
    if change.get("aov"):
        for name in ("accum", "albedo", "normal"):
            check(torch.equal(getattr(f_k, name).view(torch.int32),
                              getattr(f_p, name).view(torch.int32)),
                  f"gate ({what}): the {name} buffers are not bit-equal")
        extra = (f"; accum, albedo and normal bit-equal, albedo mean "
                 f"{float(f_k.albedo.mean()):.6f}")
    print(f"phase {phase} gate 96^2 2spp {what}, kernels vs plain: mean|d| "
          f"{mean_d:.3g}, outliers {outl}, max|d| {max_d:.3g}{extra}")


def kernel_symbol(key: str):
    """The port's kernel name in a profiler key ('void
    rt3c::mt_test_kernel<false, false>(...)' -> 'mt_test_kernel'), else
    None."""
    m = re.search(r"rt3c::(?:\w+::)*(\w+)", key)
    return m.group(1) if m else None


def device_rows(run):
    """(run()'s result, [(device us, kernel name, launches)] of the CUDA
    kernels that run() launches, from torch.profiler (CUDA activity only),
    largest first). The device events are summed by name straight from the
    profiler's raw results: key_averages() builds an event tree in Python,
    which took ~9 s per 1e5 events and made a traced town subframe last
    ~26 s; its sums are the same."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        row = sums.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / 1e3
        row[1] += 1
    return out, sorted(((us, key, n) for key, (us, n) in sums.items()),
                       reverse=True)


def device_ms(calls, warmup=None) -> float:
    """Mean device time per call in ms of calls whose kernels are shorter
    than their wrappers' host work (K4 on a short scene, K5, K6), where
    CUDA events around back-to-back calls would time the host. After one
    untimed call, a spin kernel (torch.cuda._sleep, 50 ms at first) holds
    the stream while the host queues the calls between two events, so the
    events time the kernels back to back, with the ~1 us between queued
    launches; the first event still pending once all calls are queued
    shows the spin outlasted the queueing (else it is lengthened and the
    calls timed again). torch.profiler recorded only some of these
    launches in some runs, so it is not used here."""
    import torch

    calls[0]()
    cycles = int(0.05 * 2e9)  # the spin counts SM clock cycles, ~2 GHz
    for _ in range(4):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for call in calls:
            call()
        held = not a.query()
        b.record()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / len(calls)
        cycles *= 4
    raise PhaseFailed("device_ms: the spin kernel never outlasted the "
                      "queueing of the calls")


def profile_subframe(step, film, camera, untraced_s: float, phase: int,
                     kernels, variants=()):
    """Device time by kernel over one more subframe (profile_report).
    Returns the idle share."""
    cam = camera.params()
    t0 = time.perf_counter()
    rows = device_rows(lambda: step(cam, film))[1]
    return profile_report(rows, time.perf_counter() - t0, untraced_s, phase,
                          kernels, variants)


def warm_up(run, traced: bool):
    """(run()'s result, seconds, device rows or None) of a main path's
    warm-up subframe, under torch.profiler if `traced` (device_rows; its
    rows go to profile_report once the timed subframes have run)."""
    import torch

    t0 = time.perf_counter()
    if traced:
        out, rows = device_rows(run)
    else:
        out, rows = run(), None
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, rows


def profile_report(rows, wall: float, untraced_s: float, phase: int,
                   kernels, variants=(), what="one subframe"):
    """Prints the device time by kernel of a profiled subframe (`rows` of
    device_rows, `wall` its traced seconds). The idle share is taken
    against the median untraced subframe, since tracing slows the host.
    Fails unless the profiler saw each of `kernels` (CUDA symbol names)
    launched, and each of `variants` (template arguments, e.g. "<true>")
    of them. Returns the idle share."""
    busy = sum(r[0] for r in rows) / 1e6
    check(busy > 0, f"phase {phase} profile: no device time recorded")
    idle = max(0.0, 1 - busy / untraced_s)
    print(f"phase {phase} profile of {what}: device busy {busy:.4f} "
          f"s; traced wall {wall:.4f} s; untraced median {untraced_s:.4f} "
          f"s; idle share {idle:.3f} of untraced")
    for dt, key, cnt in rows[:10]:
        print(f"  {dt / 1e3:10.3f} ms  x{cnt:<6d} {key[:70]}")
    for name in kernels:
        mine = [r for r in rows if kernel_symbol(r[1]) == name]
        check(bool(mine), f"phase {phase} profile: no launch of {name}")
        for dt, key, cnt in mine:
            print(f"  in path: {key[:50]} {dt / 1e3 / cnt:.4f} ms per launch "
                  f"x{cnt}")
        for v in variants:
            check(any(name + v in r[1] for r in mine),
                  f"phase {phase} profile: no launch of {name}{v}")
    return idle


BAND_ROWS = (360, 408)  # the middle sixteenth of a 768-row image
# the middle 16 rows: the band of the trace-time instanced path, whose
# plain walk runs half a second per row
NARROW_BAND = (376, 392)


def band_pair(name, scene, camera, cfg_kw, dev, rows=BAND_ROWS,
              tracers=None):
    """Kernels against plain versions on a band of the image (`rows`),
    one subframe each through render_pixels over choose_tracer's pipeline
    and its plain twin (or `tracers`, a (kernel, plain) pair over the
    scene as given), on the same streams: the band's means within 1%,
    the gate on it, with AOV the albedo and normal bands bit-equal.
    Returns (kernel mean, plain mean, seconds of each)."""
    import torch

    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import render_pixels
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    cfg = RenderConfig(**cfg_kw)
    lo, hi = rows
    pix = torch.arange(lo * cfg.width, hi * cfg.width, dtype=torch.int64)
    out, aovs, secs = [], [], []
    makes = (choose_tracer, plain_tracer) if tracers is None else [
        lambda *_, t=t: (scene, t) for t in tracers]
    for make in makes:
        ordered, tracer = make(scene, cfg, dev)
        t0 = time.perf_counter()
        rgb, aov = render_pixels(ordered, cfg, camera.params(), tracer, pix,
                                 0, device=dev)[:2]
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        out.append(rgb.reshape(hi - lo, cfg.width, 3).cpu().numpy())
        aovs.append(aov or ())
    for k, p in zip(*aovs):
        check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
              f"{name}: the band's AOV buffers differ")
    rel = abs(out[0].mean() - out[1].mean()) / out[1].mean()
    check(rel <= 0.01 and bool(np.isfinite(out[0]).all()),
          f"{name}: band mean {out[0].mean()} vs plain {out[1].mean()}")
    mean_d, outl, max_d = gate_diff(*out)
    check(mean_d <= 2e-3 and outl <= 8 and max_d <= 8.0,
          f"{name}: the band fails the gate: mean|d| {mean_d:.3g}, {outl} "
          f"outliers, max|d| {max_d:.3g}")
    print(f"  band rows {lo}-{hi} (one subframe, kernels {secs[0]:.3f} s, "
          f"plain {secs[1]:.3f} s): means {out[0].mean():.6f} and "
          f"{out[1].mean():.6f} (rel {rel:.3g}); mean|d| {mean_d:.3g}, "
          f"max|d| {max_d:.3g}" + (", AOV bands bit-equal" if aovs[0]
                                   else ""))
    return out[0].mean(), out[1].mean(), secs


def full_size(name, scene, camera, dev, smi, phase: int, counters, symbols,
              change=None, plain=True, timed=TIMED, warm=None,
              profile=True):
    """One main path at full size (MAIN with `change` applied): kernels (1
    warm-up and `timed` timed subframes) with the launch counters zeroed
    before the warm-up and read after the timed subframes (`warm`: the
    states of main_path_states, whose recorded subframe is the warm-up;
    its launches are added), then
    (plain=True) the kernels held to the plain versions on a band of the
    image (band_pair), and a profile of one more subframe that must see
    each CUDA kernel of `symbols` (profile=False: a path whose kernels
    and pool a profiled sibling path runs, idle share None). plain=False:
    the path's kernels and gate are held elsewhere. Records (median
    Mray/s, idle share) in PATHS[name];
    returns (kernel film, launches by kernel)."""
    import torch

    cfg_kw = dict(MAIN, **(change or {}))
    for fn in counters.values():
        fn.launches = 0
    film_k, rates_k, it_k, secs_k, step_k = render(
        scene, camera, cfg_kw, dev, False, 0 if warm else 1, timed,
        warm=warm and warm["warm"])
    launches = {n: fn.launches + (warm["launches"][n] if warm else 0)
                for n, fn in counters.items()}
    for n, cnt in launches.items():
        check(cnt > 0, f"{name}: the main path launched {n} no time")
    img_k = film_k.accum.cpu().numpy()
    check(bool(np.isfinite(img_k).all()), f"{name}: kernel image not finite")
    shape = (cfg_kw["height"], cfg_kw["width"], 3)
    check(img_k.shape == shape, f"{name}: image shape {img_k.shape}")
    if film_k.albedo is not None:
        for buf in (film_k.albedo, film_k.normal):
            check(bool(torch.isfinite(buf).all()) and buf.shape == shape,
                  f"{name}: AOV buffer not finite or of shape {buf.shape}")
    print(f"phase {phase} {name} 768^2 8spp depth 16 pool 32768 "
          f"{change or ''} on {smi}:")
    print(f"  kernels: Mray/s per subframe {rates_k}, median "
          f"{float(np.median(rates_k)):.6g}; s {secs_k}; "
          f"{it_k / timed:.1f} launches/subframe")
    if plain:
        band_pair(name, scene, camera, cfg_kw, dev)
    print(f"  image mean {img_k.mean():.6f}; launches {launches}"
          + (f"; albedo mean {float(film_k.albedo.mean()):.6f}"
             if film_k.albedo is not None else ""))
    idle = (profile_subframe(step_k, film_k, camera,
                             float(np.median(secs_k)), phase, symbols)
            if profile else None)
    PATHS[name] = (float(np.median(rates_k)), idle)
    return film_k, launches


# ---------------------------------------------------------------- phase 7
SNAPSHOTS = (32, 128, 224, 320)  # pool iterations of a town subframe
# of a textured quad subframe, whose open scene ends paths sooner (320
# iterations per sorted subframe on the card)
QUAD_SNAPSHOTS = (16, 80, 144, 208)
# of a principled town's sorted subframe (power pick), 320 iterations on
# the card
P_SNAPSHOTS = (32, 112, 192, 272)


def main_path_states(scene, camera, dev, change=None, snapshots=SNAPSHOTS):
    """The inputs of the closest tracer, K6 and the any-hit tracer at the
    pool iterations `snapshots` of one kernel subframe of a town's main
    path (MAIN with `change` applied; through make_render_fn with
    choose_tracer's pipeline, its calls recorded): {"closest": [(o, d,
    tmin, tmax, time, count)], "shade": [(rays, hit4, misc)], "any": [...as
    closest], "launches": {kernel: launches in that subframe}, "warm":
    (step, film after the subframe), which full_size's timed subframes
    continue}. The recording stays wrapped around the pipeline: past the
    snapshots it only counts calls."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import mt, shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    cfg = RenderConfig(**dict(MAIN, **(change or {})))
    scene, pipe = choose_tracer(scene, cfg, dev)
    states = {"closest": [], "shade": [], "any": []}
    seen = dict.fromkeys(states, 0)

    def record(kind, fn, n_args):
        def call(*args):
            if seen[kind] in snapshots:
                states[kind].append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args[:n_args]))
            seen[kind] += 1
            return fn(*args)
        return call

    pipe._closest = record("closest", pipe._closest, 6)
    pipe._any = record("any", pipe._any, 6)
    pipe.shade_fn = record("shade", pipe.shade_fn, 3)
    step = make_render_fn(scene, cfg, tracer=pipe, device=dev)
    counters = {n: getattr(mt, n) for n in (
        "mt_closest", "mt_any", "mt_closest_motion", "mt_any_motion")}
    counters["external_shade"] = shade.external_shade
    for fn in counters.values():
        fn.launches = 0
    film, _ = step(camera.params(), film_create(cfg.height, cfg.width,
                                                device=dev, aov=cfg.aov))
    torch.cuda.synchronize()
    check(all(len(v) == len(snapshots) for v in states.values()),
          f"main path: {seen} iterations, too few for the snapshots")
    states["launches"] = {n: fn.launches for n, fn in counters.items()}
    states["warm"] = (step, film)
    return states


def time_on_states(kern, ref, table, inputs, any_hit, motion):
    """An MT kernel on the main path's inputs [(o, d, tmin, tmax, time,
    count)], packed as the tracer packs them: checked bit for bit against
    its plain version, and its binning (mt_bin) against bin_ref's; then
    (ms, plain ms, bound ms, bound by) of the mean launch, the largest
    difference and the binned (ray, tile) pairs per live ray."""
    import torch

    from rendertoy3c_tpu_torch.trace import mt

    tile = mt.MOTION_RAY_TILE if motion else mt.RAY_TILE
    launches, err, pairs, live = [], 0.0, 0, 0
    for o, d, tmin, tmax, tm, count in inputs:
        rays, r = mt.pack_rays(o, d, tmin, tmax, tile)
        check(r == rays.shape[0], "a pool of whole ray tiles")
        a = (rays, *((tm.contiguous(),) if motion else ()), count.reshape(1),
             table)
        got, want = kern(*a), ref(*a)
        check(bit_equal(got, want),
              f"{kern.__name__} differs from its plain version on the main "
              "path's inputs")
        err = max(err, (got - want).abs().max().item())
        lists = mt.mt_bin(rays, a[-2], table)
        check(torch.equal(lists, mt.bin_ref(rays, a[-2], table).sum(
            dim=0, dtype=torch.int32)),
            f"{kern.__name__}: the binning differs from bin_ref's")
        pairs += int(lists.sum())
        live += int(mt.live_rows(r, a[-2], tile).sum())
        launches.append(a)
    ms = cuda_ms([functools.partial(kern, *a) for a in launches] * 12)
    plain_ms = cuda_ms([functools.partial(ref, *a) for a in launches])
    costs = [mt_cost(a[0], a[-2], table, any_hit, a[1] if motion else None)
             for a in launches]
    return (ms, plain_ms, *mean_bound(costs), err, pairs / max(live, 1))


def phase_town_mt(dev, towns, states):
    """K1/K2 on the static town (in its Morton face order) and K3 on the
    2-key town: plain versions and brute on 131072 rays; timed and bounded
    on the main path's own inputs (`states`, main_path_states)."""
    import torch

    from rendertoy3c_tpu_torch.trace import mt
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    results = {}
    n_total = 131072
    pool = MAIN["ray_block"]
    for motion in (False, True):
        scene, camera = towns[motion]
        rng = np.random.default_rng(SEED + 7 + int(motion))
        tm = rng.uniform(0, 1, n_total).astype(np.float32) if motion else None
        o, d = camera_and_bounce_rays(scene, camera, 65536, n_total, dev, rng,
                                      tm)
        tt = None if tm is None else torch.as_tensor(tm, device=dev)
        if motion:
            table = mt.build_motion_soup(scene.geom, dev,
                                         num_faces=scene.num_faces)
            cases = (("mt_closest_motion", mt.mt_closest_motion,
                      mt.closest_motion_ref, False),
                     ("mt_any_motion", mt.mt_any_motion, mt.any_motion_ref,
                      True))
            tile = mt.MOTION_RAY_TILE
        else:
            table = mt.build_tri_soup(scene.geom, dev,
                                      num_faces=scene.num_faces)
            cases = (("mt_closest", mt.mt_closest, mt.closest_ref, False),
                     ("mt_any", mt.mt_any, mt.any_ref, True))
            tile = mt.RAY_TILE
        t_any = torch.as_tensor(rng.uniform(0.5, 20.0, n_total)
                                .astype(np.float32), device=dev)
        for name, kern, ref, any_hit in cases:
            tmin, tmax = (0.001, t_any) if any_hit else (0.01, 1e16)
            rays, _ = mt.pack_rays(o, d, tmin, tmax, tile)
            args = (tt,) if motion else ()
            err = 0.0
            count = n_total - 1000
            check(not motion or -(-count // tile) * tile % 256 != 0,
                  "the count must end a 128-ray tile inside a 256-ray one")
            for c_val in (n_total, count):
                c = torch.tensor([c_val], dtype=torch.int32, device=dev)
                got = kern(rays, *args, c, table)
                want = ref(rays, *args, c, table)
                torch.cuda.synchronize()
                check(bit_equal(got, want),
                      f"{name}: not bit-equal to the plain version")
                err = max(err, (got - want).abs().max().item())
                if c_val < n_total:  # whole ray tiles past the count miss
                    tail = -(-c_val // tile) * tile
                    miss = torch.zeros_like(got[tail:])
                    if not any_hit:
                        miss[:, 0] = rays[tail:, 7]
                        miss[:, 1] = -1.0
                    check(torch.equal(got[tail:], miss),
                          f"{name}: tiles past count were not skipped")
                    check(torch.equal(got[c_val:tail], want[c_val:tail]),
                          f"{name}: the tile holding the count was skipped")
            if any_hit:
                trace = mt.trace_any_mt_motion if motion else mt.trace_any_mt
                occ = trace(table, o, d, 0.001, t_any, *args)
                occ_b = trace_any_bruteforce(scene, o, d, 0.001, t_any, tt)
                check(torch.equal(occ, occ_b), f"{name}: occlusion != brute")
                frac = float(occ.float().mean())
            else:
                trace = (mt.trace_closest_mt_motion if motion
                         else mt.trace_closest_mt)
                h = trace(table, o, d, 0.01, 1e16, *args)
                b = trace_closest_bruteforce(scene, o, d, 0.01, 1e16, tt)
                check(torch.equal(h.prim, b.prim), f"{name}: prim != brute")
                for x, y in ((h.t, b.t), (h.u, b.u), (h.v, b.v)):
                    check(bool(((x - y).abs() <= 1e-6 + 1e-6 * y.abs())
                               .all()), f"{name}: t/u/v differ from brute")
                frac = float((h.prim >= 0).float().mean())
            ms, plain_ms, bound_ms, bound_by, e, pairs = time_on_states(
                kern, ref, table, states[motion]["any" if any_hit
                                                 else "closest"],
                any_hit, motion)
            err = max(err, e)
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
            print(f"phase 7 {name} ({'2-key' if motion else 'static'} "
                  f"town, {scene.num_faces} faces): exact vs plain and brute "
                  f"on {n_total} rays (hit/occluded share {frac:.3f}) and vs "
                  f"plain on the main path's inputs at iterations "
                  f"{SNAPSHOTS}; max|d| {err:.3g}; there {ms:.4f} ms vs plain "
                  f"{plain_ms:.4f} ms per {pool}-ray launch; bound "
                  f"{bound_ms:.4f} ms by {bound_by}; binned {pairs:.3f} "
                  "tiles per live ray")
    return results


# ---------------------------------------------------------------- phase 8
def _fresh_lanes(camera, n, rng, dev):
    """A first-bounce pool state: camera rays, fresh paths, random seeds,
    90% of the lanes alive."""
    import torch

    p = camera.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = p.eye
    rays[:, 3:6] = d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((n, 16), np.float32)
    misc[:, 0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[:, 1:7] = 1.0
    misc[:, 9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[:, 13] = np.arange(n)
    misc[:, 14] = 1.0
    return (torch.as_tensor(rays, device=dev),
            torch.as_tensor(misc, device=dev))


def phase_k6(dev, towns, states, phase=8, label="K6", change=None,
             snapshots=SNAPSHOTS):
    """K6 teacher-forced against external_shade_ref for 8 iterations on
    each town of `towns` ({key: (scene, camera)}); then on the main paths'
    own inputs (`states`, {key: main_path_states at `snapshots`}),
    bit-equal, its device
    time and bound (with the texture work of a textured town,
    texture_work, the material dispatch and power pick, material_ops, and
    the AOV rows). MAIN with `change` applied; with AOV the teacher-forced
    lanes start with random AOV accs. With the dispatch variant, the live
    lanes' hits must include every material type of the scene."""
    import torch

    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    cfg = RenderConfig(**dict(MAIN, **(change or {})))
    pool = cfg.ray_block
    res = dict(max_abs_err=0.0)
    launches, costs = [], []
    for i, (key, (scene, camera)) in enumerate(towns.items()):
        motion = scene.num_keys == 2
        scene, pipe = choose_tracer(scene, cfg, dev)
        dispatch = pipe.tables.params_base > 0
        mw = 24 if cfg.aov else 16
        prims, lives = [], []
        rng = np.random.default_rng(SEED + 8 + i)

        def fresh():
            rays, misc = _fresh_lanes(camera, pool, rng, dev)
            if cfg.aov:
                aov = torch.as_tensor(rng.uniform(-1, 1, (pool, 6)).astype(
                    np.float32), device=dev)
                misc = torch.cat([misc, aov, torch.zeros_like(aov[:, :2])], 1)
            return rays, misc

        rays, misc = fresh()
        count = torch.tensor([pool], dtype=torch.int32, device=dev)
        deep = 0
        for it in range(8):
            tm = (torch.as_tensor(rng.uniform(0, 1, pool).astype(np.float32),
                                  device=dev) if motion else None)
            hit = pipe._closest(rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                                rays[:, 7], tm, count)
            hit4 = torch.stack([hit.t, hit.prim.to(torch.float32), hit.u,
                                hit.v], dim=1)
            got = shade.external_shade(rays, hit4, misc, pipe.tables,
                                       pipe.config)
            want = shade.external_shade_ref(rays, hit4, misc, pipe.tables,
                                            pipe.config)
            torch.cuda.synchronize()
            prims.append(hit4[:, 1])
            lives.append(misc[:, 9] > 0)
            for g, w, what in zip(got, want, ("rays", "misc", "shadow")):
                n_bad = int((g.view(torch.int32) != w.view(torch.int32))
                            .any(dim=1).sum())
                check(n_bad == 0, f"{label} iteration {it} ({what}): {n_bad} "
                      "lanes differ from the plain version")
            # the next state: the plain output, NEE added on unoccluded
            # lanes, dead lanes restarted as fresh camera paths
            r2, m2, sh = want
            occ = pipe._any(sh[:, 0:3], sh[:, 3:6], sh[:, 6], sh[:, 7],
                            sh[:, 8] if motion else None, count)
            nee = torch.where(occ[:, None], 0.0, m2[:, mw:mw + 3])
            misc = torch.cat([m2[:, :10], m2[:, 10:13] + nee, m2[:, 13:mw]],
                             dim=1)
            rays = r2
            deep = max(deep, int(misc[:, 8].max()))
            dead = misc[:, 9] <= 0
            fr, fm = fresh()
            rays = torch.where(dead[:, None], fr, rays)
            misc = torch.where(dead[:, None], fm, misc)
        print(f"phase {phase} {label} ({town_label(key)}): "
              f"{pool} lanes x 8 iterations bit-equal to the plain version "
              f"(paths up to depth {deep})")
        # the main path's own inputs: bit-equal again, then timed
        for rays, hit4, misc in states[key]["shade"]:
            a = (rays, hit4, misc, pipe.tables, pipe.config)
            got, want = shade.external_shade(*a), shade.external_shade_ref(*a)
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)),
                  f"{label} differs from its plain version on the main "
                  "path's inputs")
            launches.append(a)
            prims.append(hit4[:, 1])
            lives.append(misc[:, 9] > 0)
            prim = hit4[:, 1].clamp(min=0).to(torch.int64)
            uniq = torch.unique(prim).numel()
            attr = pipe.tables.attr[prim].T
            tex_ops, tex_bytes = texture_work(attr, shade._shade_lanes(
                rays, hit4, misc, attr, pipe.tables.lights_t, pipe.config,
                tex=pipe.tables.tex, params_base=pipe.tables.params_base),
                pipe.tables.tex)
            tex_ops += material_ops(pool, pipe.tables.params_base,
                                    pipe.config.power, pipe.config.num_lights)
            # rays, hit4, misc in; rays, misc + 8, shadow rays out
            costs.append((pool * (32 + 16 + 4 * mw + 32 + 4 * (mw + 8)
                                  + 4 * got[2].shape[1])
                          + uniq * 4 * attr.shape[0] + tex_bytes
                          + 4 * pipe.tables.lights_t.numel(),
                          pool * (SHADE_OPS + (AOV_OPS if cfg.aov else 0))
                          + tex_ops))
        if dispatch:
            seen = check_material_types(scene, torch.cat(prims),
                                        torch.cat(lives), label)
            print(f"phase {phase} {label} ({town_label(key)}): live lanes "
                  f"hit material types {seen}")
    k6_tails(label, launches[0], phase=phase)
    res["ms"] = device_ms([functools.partial(shade.external_shade, *a)
                           for a in launches] * 6)
    res["plain_ms"] = cuda_ms([functools.partial(shade.external_shade_ref, *a)
                               for a in launches])
    res["bound_ms"], res["bound_by"] = mean_bound(costs)
    print(f"phase {phase} {label} on the main paths' inputs (iterations "
          f"{snapshots} of {', '.join(map(town_label, towns))}, bit-equal "
          "to the plain version): "
          f"device time "
          f"{res['ms']:.4f} ms per {pool}-lane launch vs plain "
          f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}")
    return res


def k6_tails(label, a, kw=None, phase=8):
    """K6 on the first lanes of a recorded input `a` (rays, hit4, misc,
    tables, config; misc row-major, or C-major with kw's `transposed`):
    R - 37 lanes (not a multiple of the 32-lane block) and 20 (less than
    one block), bit for bit against the plain version."""
    import torch

    from rendertoy3c_tpu_torch.trace import shade

    kw = dict(kw or {})
    rays, hit4, misc, tables, config = a
    n = rays.shape[0]
    for r in (n - 37, 20):
        cut = dict(kw, inst=None if kw.get("inst") is None
                   else kw["inst"][:r].contiguous())
        m = (misc[:, :r] if kw.get("transposed") else misc[:r]).contiguous()
        b = (rays[:r].contiguous(), hit4[:r].contiguous(), m, tables,
             config)
        got = shade.external_shade(*b, **cut)
        want = shade.external_shade_ref(*b, **cut)
        check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                  for g, w in zip(got, want)),
              f"phase {phase} {label} differs from its plain version on "
              f"the first {r} lanes")
    print(f"phase {phase} {label}: {n - 37} and 20 lanes (a tail block, "
          "less than one block) bit-equal to the plain version")


def town_label(key) -> str:
    """A town's name in a phase line: its key, or for the keys False/True
    the static and the 2-key town."""
    return {False: "static town", True: "2-key town"}.get(key, key)


# ---------------------------------------------------------------- phase 11+
SORTED = dict(sort_rays=True)
SAMPLE_MAJOR = dict(pool_pixel_major=False)
POWER = dict(light_sampler="power")
SORTED_POWER = dict(sort_rays=True, light_sampler="power")
PT, TEX_PT = "principled town", "textured principled town"


def moving_cornell():
    """(scene, camera) of the 2-key Cornell box: the last block given a
    second key at +0.1 in x (36 faces)."""
    import dataclasses

    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, camera = cornell_box()
    v = meshes[-1].vertices
    meshes[-1] = dataclasses.replace(
        meshes[-1], vertices=np.concatenate([v, v + np.float32([0.1, 0, 0])]))
    return build_scene(meshes), camera


def material_cornell(motion=False):
    """(scene, camera) of the Cornell box with all four material types
    (scene/builtin.py material_cornell_box): a PRINCIPLED floor, a SPECULAR
    wall, a FRESNEL_TRANSMISSIVE tall block; motion: the short block given
    a second key at +0.1 in x."""
    from rendertoy3c_tpu_torch.scene.builtin import material_cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, camera = material_cornell_box(motion)
    return build_scene(meshes), camera


def textured_quad(variant="repeat", motion=False):
    """(scene, camera) of the builtin textured quad's `variant` (scene/
    builtin.py textured_quad_variant: "repeat", "clamp_mirror",
    "uv_transform", "normal_map", "principled"); motion: the floor given a
    second key at +0.1 in x (6 faces, 2 keys)."""
    from rendertoy3c_tpu_torch.scene.builtin import textured_quad_variant
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, textures, camera = textured_quad_variant(variant, motion)
    return build_scene(meshes, textures=textures), camera


def k5_states(scene, camera, dev, change, snapshots=SNAPSHOTS):
    """(pipeline, [(rays, misc, count, time)], snapshots, K5 launches in
    that subframe, warm): the inputs of K5 at the pool iterations
    `snapshots` of one kernel subframe of the main path with `change`
    (through make_render_fn with choose_tracer's pipeline); warm, that
    subframe as full_size's warm-up ({"warm": (step, film), "launches":
    {"trace_shade": n}})."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    cfg = RenderConfig(**dict(MAIN, **change))
    scene, pipe = choose_tracer(scene, cfg, dev)
    check(isinstance(pipe, shade.FusedPipeline), "K5 path: not fused")
    states, seen = [], [0]
    fn = pipe.shade_fn

    def call(rays, misc, count, tables, sc, time=None):
        if seen[0] in snapshots:
            states.append((rays.clone(), misc.clone(), count.clone(),
                           None if time is None else time.clone()))
        seen[0] += 1
        return fn(rays, misc, count, tables, sc, time)

    pipe.shade_fn = call
    step = make_render_fn(scene, cfg, tracer=pipe, device=dev)
    shade.trace_shade.launches = 0
    film, _ = step(camera.params(), film_create(cfg.height, cfg.width,
                                                device=dev, aov=cfg.aov))
    torch.cuda.synchronize()
    launches = shade.trace_shade.launches
    pipe.shade_fn = fn
    check(len(states) == len(snapshots) and launches > 0,
          f"K5 path: {seen[0]} iterations, too few for the snapshots")
    return pipe, states, snapshots, launches, dict(
        warm=(step, film), launches={"trace_shade": launches})


def phase_k5(dev, runs, phase=12):
    """K5 against trace_shade_ref on the recorded main-path inputs of each
    run ({label: (pipeline, states)}): lanes compared bit for bit (and
    within 1e-5 where not), device time per launch (device_ms), the
    plain version's time and the bound. Then the non-merged K5 (phase 36)
    on the same inputs: closest_raw (K1 or K3), then trace_shade_hit
    bit-equal to trace_shade_hit_ref, and its lanes against the merged
    K5's (reported: K3's 128-ray tiles may skip lanes past the count that
    the merged sweep's 256-ray tiles run); its device time per launch
    and the plain version's, under the merged bound less the closest
    sweep's operations (in NON_MERGED[label])."""
    import torch

    from rendertoy3c_tpu_torch.trace import shade

    results = {}
    for label, (pipe, states, snapshots, *_) in runs.items():
        launches, costs, err, n_diff, n_bad = [], [], 0.0, 0, 0
        prims, lives = [], []
        hit_launches, hit_costs, hit_bad, hit_vs_merged = [], [], 0, 0
        for rays, misc, count, tm in states:
            hit4 = pipe.closest_raw(rays, count, tm)
            h = (rays, hit4, misc, count, pipe.tables, pipe.config)
            got_h = shade.trace_shade_hit(*h)
            want_h = shade.trace_shade_hit_ref(*h)
            merged = shade.trace_shade(rays, misc, count, pipe.tables,
                                       pipe.config, tm)
            gh = torch.cat(got_h, 1).view(torch.int32)
            hit_bad += int((gh != torch.cat(want_h, 1).view(torch.int32))
                           .any(dim=1).sum())
            hit_vs_merged += int((gh != torch.cat(merged, 1).view(
                torch.int32)).any(dim=1).sum())
            hit_launches.append(h)
            ops, table_bytes = megakernel_work(rays, misc, count, tm,
                                               pipe.tables, pipe.config,
                                               with_closest=False)
            hit_costs.append((rays.shape[0] * (2 * (32 + 4 * misc.shape[1])
                                               + 16) + 4 + table_bytes, ops))
            if pipe.tables.params_base:
                prims.append(shade._plain_sweeps(pipe.tables, count, tm)[0](
                    rays)[:, 1])
                lives.append(misc[:, 9] > 0)
            a = (rays, misc, count, pipe.tables, pipe.config, tm)
            got = shade.trace_shade(*a)
            want = shade.trace_shade_ref(*a)
            torch.cuda.synchronize()
            gk, gr = torch.cat(got, 1), torch.cat(want, 1)
            n_diff += int((gk.view(torch.int32) != gr.view(torch.int32))
                          .any(dim=1).sum())
            seed_ok = torch.equal(got[1][:, 0].view(torch.int32),
                                  want[1][:, 0].view(torch.int32))
            d = (gk - gr).abs()
            n_bad += int((d > 1e-5 + 1e-5 * gr.abs()).any(dim=1).sum()) + (
                0 if seed_ok else int((got[1][:, 0].view(torch.int32)
                                       != want[1][:, 0].view(torch.int32))
                                      .sum()))
            err = max(err, d.max().item())
            launches.append(a)
            ops, table_bytes = megakernel_work(rays, misc, count, tm,
                                               pipe.tables, pipe.config)
            pool = rays.shape[0]
            costs.append((pool * 2 * (32 + 4 * misc.shape[1]) + 4
                          + table_bytes + (4 * pool if tm is not None else 0),
                          ops))
        pool = states[0][0].shape[0]
        check(n_bad <= 0.001 * pool * len(states),
              f"{label}: {n_bad} lanes differ from the plain version")
        types = ""
        if prims:
            seen = check_material_types(pipe.scene, torch.cat(prims),
                                        torch.cat(lives), label)
            types = f"; live lanes hit material types {seen}"
        ms = device_ms([functools.partial(shade.trace_shade, *a)
                        for a in launches] * 6)
        plain_ms = cuda_ms([functools.partial(shade.trace_shade_ref, *a)
                            for a in launches])
        bound_ms, bound_by = mean_bound(costs)
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase {phase} {label} on its main path's inputs (iterations "
              f"{snapshots}, {pool} lanes): {n_diff} lanes not bit-equal, "
              f"{n_bad} beyond 1e-5 or seed, max|d| {err:.3g}; device time "
              f"{ms:.4f} ms per launch vs plain {plain_ms:.4f} "
              f"ms; bound {bound_ms:.4f} ms by {bound_by}{types}")
        check(hit_bad == 0, f"{label}: the non-merged K5 differs from its "
              f"plain version on {hit_bad} lanes")
        h_ms = device_ms([functools.partial(shade.trace_shade_hit, *h)
                          for h in hit_launches] * 6)
        h_plain = cuda_ms([functools.partial(shade.trace_shade_hit_ref, *h)
                           for h in hit_launches])
        h_bound, h_by = mean_bound(hit_costs)
        NON_MERGED[label] = dict(max_abs_err=0.0, ms=h_ms, plain_ms=h_plain,
                                 bound_ms=h_bound, bound_by=h_by)
        print(f"phase 36 {label}, non-merged (closest_raw, then "
              f"trace_shade_hit) on the same inputs: bit-equal to its plain "
              f"version; {hit_vs_merged} lanes differ from the merged K5's; "
              f"device time {h_ms:.4f} ms per launch vs plain {h_plain:.4f} "
              f"ms; bound {h_bound:.4f} ms by {h_by}")
    return results


# ---------------------------------------------------------------- phase 41
MULTITILE_GRID = 10  # boxes a side: 1200 faces more, three 512-face tiles
MULTITILE_FORMS = ("static", "motion", "textured", "dispatch", "aov")


def multitile_scene(form):
    """(scene, camera) of the multi-tile fused scene in a form of
    MULTITILE_FORMS (tests/megakernel_util.py's `multitile`): the Cornell
    box (its 2-key form for "motion"; the normal-mapped textured quad for
    "textured"; the material Cornell box for "dispatch") with a 10 x 10
    grid of small boxes of seeded heights on its floor."""
    import dataclasses

    from rendertoy3c_tpu_torch.scene.builtin import box_mesh
    from rendertoy3c_tpu_torch.scene.material import Material
    from rendertoy3c_tpu_torch.scene.mesh import Mesh
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    if form == "textured":
        from rendertoy3c_tpu_torch.scene.builtin import textured_quad_variant

        meshes, textures, camera = textured_quad_variant("normal_map")
    elif form == "dispatch":
        from rendertoy3c_tpu_torch.scene.builtin import material_cornell_box

        (meshes, camera), textures = material_cornell_box(False), None
    else:
        from rendertoy3c_tpu_torch.scene.builtin import cornell_box

        (meshes, camera), textures = cornell_box(), None
    meshes = list(meshes)
    if form == "motion":
        v = meshes[-1].vertices
        meshes[-1] = dataclasses.replace(meshes[-1], vertices=np.concatenate(
            [v[:1], v[:1] + np.float32([0.1, 0, 0])]))
    rng = np.random.default_rng(5)
    step = 1.6 / MULTITILE_GRID
    verts, faces = [], []
    for i in range(MULTITILE_GRID):
        for k in range(MULTITILE_GRID):
            x0, z0 = -0.8 + i * step, -0.8 + k * step
            m = box_mesh([x0, 0.0, z0], [x0 + 0.6 * step,
                                        rng.uniform(0.05, 0.4),
                                        z0 + 0.6 * step], None)
            faces.append(m.indices + 8 * len(verts))
            verts.append(m.vertices[0])
    meshes.append(Mesh(vertices=np.concatenate(verts)[None],
                       indices=np.concatenate(faces).astype(np.int32),
                       material=Material(diffuse=(0.6, 0.6, 0.55))))
    kw = {} if textures is None else dict(textures=textures)
    return build_scene(meshes, **kw), camera


def phase_multitile(dev, phase=41):
    """K4 and K5 on the multi-tile fused scene, in each form, against
    their plain versions: K4 as phase 3 (one block teacher-forced for 8
    launches, then the pool width from launch 12, claims as a set; timed
    and bounded), K5 teacher-forced for 4 iterations at the pool width
    from camera-ray states, the live count the pool and 30000 in turn,
    every output bit for bit."""
    import torch

    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.trace import shade

    pool = MAIN["ray_block"]
    for form in MULTITILE_FORMS:
        scene, camera = multitile_scene(form)
        change = AOV if form == "aov" else {}
        cfg = RenderConfig(**dict(MAIN, pool_pixel_major=False, **change))
        pipe = shade.FusedPipeline(scene, cfg, dev)
        check(pipe.tables.soup.tris.shape[0] == 3
              and pipe.motion == (form == "motion"),
              f"multi-tile {form}: {pipe.tables.soup.tris.shape[0]} tiles")
        phase_k4(dev, scene, camera, phase, f"K4 multi-tile {form}", change)
        rng = np.random.default_rng(SEED + 41)
        gen = torch.Generator(device=dev).manual_seed(41)
        rays, misc = _fresh_lanes(camera, pool, rng, dev)
        if cfg.aov:
            misc = torch.cat([misc, torch.zeros((pool, 8), device=dev)], 1)
        n_diff = 0
        for it in range(4):
            count = torch.tensor([pool if it % 2 == 0 else 30000],
                                 dtype=torch.int32, device=dev)
            tm = (torch.rand(pool, device=dev, generator=gen) if pipe.motion
                  else None)
            a = (rays, misc, count, pipe.tables, pipe.config, tm)
            got, want = shade.trace_shade(*a), shade.trace_shade_ref(*a)
            n_diff += sum(int((g.view(torch.int32) != w.view(torch.int32))
                              .any(dim=1).sum()) for g, w in zip(got, want))
            rays, misc = want
        check(n_diff == 0, f"K5 multi-tile {form}: {n_diff} lanes differ "
              "from the plain version")
        print(f"phase {phase} K5 multi-tile {form} ({scene.num_faces} faces, "
              f"3 tiles): 4 iterations at {pool} lanes, bit-equal to the "
              "plain version")


# ---------------------------------------------------------------- phase 21+
# the AOV K5 paths' snapshots on the quads (sorted and sample-major
# subframes of the quads run 200-320 iterations)
AOV_QUAD_SNAPSHOTS = (16, 64, 112, 160)
FUSED_VARIANTS = ("", "_motion", "_textured", "_motion_textured",
                  "_dispatch", "_motion_dispatch", "_textured_dispatch",
                  "_motion_textured_dispatch")


def fused_variant_scene(variant):
    """(scene, camera) of a fused kernel variant ("_motion_textured" and
    so on): the Cornell box, the normal-mapped textured quad, the material
    Cornell box or the principled quad, 2-key with motion."""
    motion = "motion" in variant
    if "dispatch" in variant:
        if "textured" in variant:
            return textured_quad("principled", motion)
        return material_cornell(motion)
    if "textured" in variant:
        return textured_quad("normal_map", motion)
    if motion:
        return moving_cornell()
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, camera = cornell_box()
    return build_scene(meshes), camera


def k5_path(variant):
    """(schedule change, snapshots, name suffix) of a variant's K5 path:
    sample-major for motion, else sorted, with the power pick on the
    static dispatch variants (as phases 12, 15 and 18 run them)."""
    motion, dispatch = "motion" in variant, "dispatch" in variant
    change = (SAMPLE_MAJOR if motion else
              SORTED_POWER if dispatch else SORTED)
    snaps = AOV_QUAD_SNAPSHOTS if "textured" in variant else SNAPSHOTS
    return change, snaps, ("_power" if change is SORTED_POWER else "")


def path_launches(what, scene, camera, dev, change, counters, phase=21):
    """One kernel subframe of the main path (MAIN with `change`) through
    make_render_fn, the launch counters zeroed just before and read just
    after; fails unless each counter moved and the image is finite.
    Returns {counter: launches}."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn

    cfg = RenderConfig(**dict(MAIN, **change))
    step = make_render_fn(scene, cfg, device=dev)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    film, _ = step(camera.params(), film_create(cfg.height, cfg.width,
                                                device=dev, aov=cfg.aov))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    check(all(n > 0 for n in launches.values())
          and bool(torch.isfinite(film.accum).all()),
          f"{what}: launches {launches}, or the image is not finite")
    print(f"phase {phase} {what}: one 768^2 8 spp subframe in {dt:.3f} s, "
          f"launches {launches}")
    return launches


def kernel_entry(name, src, line, launches, res):
    """One entry of the "kernels" line."""
    return dict(name=name, route="cuda", source=src,
                replaces=f"rendertoy3c_tpu/trace/pallas_shade.py:{line}",
                launches=launches, **res, library_ms=None)


def phase_fused_aov(dev):
    """Phase 21 on the fused pipeline: K4 and K5 with aov=True in each of
    the 8 variants against their plain versions (K4 as phase 3, K5 as
    phase 12 on the inputs of the variant's own AOV path), each with the
    launches of one subframe of its path; then the non-AOV instantiations
    no main path ran before (K4 motion textured dispatch; K5 motion
    dispatch, textured dispatch, motion textured dispatch), timed and
    bounded the same way. Returns the entries of the "kernels" line."""
    from rendertoy3c_tpu_torch.trace import shade

    refill = {"trace_shade_refill": shade.trace_shade_refill}
    entries = []
    for v in FUSED_VARIANTS:
        scene, camera = fused_variant_scene(v)
        label = f"K4{v.replace('_', ' ')} AOV"
        res = phase_k4(dev, scene, camera, 21, label, AOV)
        n = path_launches(f"{label} path (pixel-major, aov)", scene, camera,
                          dev, AOV, refill)["trace_shade_refill"]
        entries.append(kernel_entry(f"trace_shade_refill{v}_aov", K4_SRC,
                                    1329, n, res))
        change, snaps, power = k5_path(v)
        label = f"K5{v.replace('_', ' ')}{power.replace('_', ', ')} AOV"
        run = k5_states(scene, camera, dev, dict(change, **AOV), snaps)
        res, = phase_k5(dev, {label: run}, 21).values()
        entries.append(kernel_entry(f"trace_shade{v}{power}_aov", K4_SRC,
                                    1230, run[3], res))
    # the non-AOV instantiations without a main path before
    scene, camera = fused_variant_scene("_motion_textured_dispatch")
    res = phase_k4(dev, scene, camera, 21, "K4 motion textured dispatch")
    n = path_launches("K4 motion textured dispatch path", scene, camera, dev,
                      {}, refill)["trace_shade_refill"]
    entries.append(kernel_entry("trace_shade_refill_motion_textured_dispatch",
                                K4_SRC, 1329, n, res))
    for v in ("_motion_dispatch", "_textured_dispatch",
              "_motion_textured_dispatch"):
        scene, camera = fused_variant_scene(v)
        change, snaps, power = k5_path(v)
        label = f"K5{v.replace('_', ' ')}{power.replace('_', ', ')}"
        run = k5_states(scene, camera, dev, change, snaps)
        res, = phase_k5(dev, {label: run}, 21).values()
        entries.append(kernel_entry(f"trace_shade{v}{power}", K4_SRC, 1230,
                                    run[3], res))
    return entries


def phase_denoise_and_cli(dev, film):
    """Phase 23's last part: atrous_denoise (3 iterations, 768^2) on the
    Cornell AOV film, guided as the CLI runs it and unguided, timed by CUDA
    events; then the CLI with --aov --denoise 3 -o out.exr at 768^2, whose
    three EXR files must carry the EXR magic and the size of a 768^2 float
    RGB image."""
    import struct

    import torch

    from rendertoy3c_tpu_torch.film.denoise import atrous_denoise
    from rendertoy3c_tpu_torch.film.image import write_exr

    alb = torch.clamp(film.albedo, min=1e-3)

    def guided():
        return atrous_denoise(film.accum / alb, normal=film.normal,
                              iterations=3) * alb

    def plain():
        return atrous_denoise(film.accum, iterations=3)

    h, w = MAIN["height"], MAIN["width"]
    out = guided()
    check(bool(torch.isfinite(out).all()) and out.shape == (h, w, 3),
          "denoiser: output not finite or of the wrong shape")
    ms_g = cuda_ms([guided] * 5)
    ms_p = cuda_ms([plain] * 5)
    print(f"phase 23 atrous_denoise 768^2, 3 iterations, on the device: "
          f"{ms_g:.3f} ms guided (albedo demodulation, normal guide), "
          f"{ms_p:.3f} ms unguided; mean before {float(film.accum.mean()):.6f}"
          f", after {float(out.mean()):.6f}")
    tmp = tempfile.mkdtemp(prefix="rt3c_aov_cli_")
    out_path = os.path.join(tmp, "out.exr")
    cmd = [sys.executable, "-m", "rendertoy3c_tpu_torch.app.cli", "--scene",
           "cornell", "--size", f"{w}x{h}", "--spp", "8", "--subframes", "2",
           "--aov", "--denoise", "3", "-o", out_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI --aov --denoise failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    ref = os.path.join(tmp, "zeros.exr")
    write_exr(ref, np.zeros((h, w, 3), np.float32))
    for name in ("out.exr", "out.albedo.exr", "out.normal.exr"):
        path = os.path.join(tmp, name)
        check(os.path.exists(path), f"CLI: {name} missing")
        with open(path, "rb") as f:
            magic = f.read(4)
        check(magic == struct.pack("<i", 20000630)
              and os.path.getsize(path) == os.path.getsize(ref),
              f"CLI: {name} is not a 768^2 float RGB EXR")
    print(f"phase 23 CLI --aov --denoise 3 -o out.exr at 768^2 (a process of "
          f"its own, {dt:.2f} s): {proc.stdout.strip()}; out.exr, "
          f"out.albedo.exr and out.normal.exr of {os.path.getsize(ref)} "
          "bytes each")
    return dict(guided_ms=ms_g, plain_ms=ms_p)


def phase_town_aov(dev, town, tex_town, p_towns):
    """Phase 21 on the external pipeline: K6 with aov=True in its 4
    variants as phase 8, on the main-path inputs of each variant's own AOV
    path (the static and the textured static town pixel-major, the
    principled towns with the power pick, sorted), whose recording
    subframe gives the launches. Returns the entries of the "kernels"
    line."""
    entries = []
    for key, pair, change, snaps, name, label in (
            ("static town", town, AOV, SNAPSHOTS, "external_shade_aov",
             "K6 AOV"),
            ("textured static town", tex_town, AOV, SNAPSHOTS,
             "external_shade_textured_aov", "K6 textured AOV"),
            (PT, p_towns[PT], dict(SORTED_POWER, **AOV), P_SNAPSHOTS,
             "external_shade_dispatch_power_aov", "K6 dispatch, power, AOV"),
            (TEX_PT, p_towns[TEX_PT], dict(SORTED_POWER, **AOV), P_SNAPSHOTS,
             "external_shade_textured_dispatch_power_aov",
             "K6 textured dispatch, power, AOV")):
        states = main_path_states(*pair, dev, change, snaps)
        res = phase_k6(dev, {key: pair}, {key: states}, 21, label, change,
                       snaps)
        entries.append(kernel_entry(name, K6_SRC, 1778,
                                    states["launches"]["external_shade"],
                                    res))
    return entries


def aov_pairs(dev, name, scene, camera, change, rounds: int, phase=23):
    """A path without and with AOV timed in turns (ABBA: off, on, on, off
    per round) after a warm-up subframe of each, each side on its own
    film, so that host drift falls on both alike: (median s off, median s
    on)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn

    sides = []
    for aov in (False, True):
        cfg = RenderConfig(**dict(MAIN, **change, aov=aov))
        step = make_render_fn(scene, cfg, device=dev)
        film = film_create(cfg.height, cfg.width, device=dev, aov=aov)
        film, _ = step(camera.params(), film)
        sides.append([step, film, []])
    torch.cuda.synchronize()
    for _ in range(rounds):
        for k in (0, 1, 1, 0):
            step, film, secs = sides[k]
            t0 = time.perf_counter()
            sides[k][1], _ = step(camera.params(), film)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    off, on = (float(np.median(side[2])) for side in sides)
    print(f"phase {phase} {name} without and with AOV in turns "
          f"({rounds} ABBA rounds): median subframe {off:.4f} s without, "
          f"{on:.4f} s with AOV ({on / off:.4f}x); s without "
          f"{[round(x, 4) for x in sides[0][2]]}, with "
          f"{[round(x, 4) for x in sides[1][2]]}")
    return off, on


def aov_path_report(name, base):
    """Phase 23's line of one AOV path beside the same path without AOV
    from this run."""
    (rate, idle), (rate0, idle0) = PATHS[name], PATHS[base]
    print(f"phase 23 {name}: {rate:.6g} Mray/s (idle {_share(idle)}) vs "
          f"{base} without AOV {rate0:.6g} Mray/s (idle {_share(idle0)}): "
          f"{rate / rate0:.4f}x")


def _share(idle) -> str:
    return "not profiled" if idle is None else f"{idle:.3f}"


# ---------------------------------------------------------------- phase 24+
# the hierwalk band: BASELINE configs 1, 2, 4 and 5 (bench.py:507-525) on
# bench's 50000-face town (generate_town gives 58054 faces) and bench's
# 49k box field (bench.py:224-250, :589-591)
WALK_FACES = 50000
GATE_RAYS = 131072
CONFIG1 = dict(width=1920, height=1080)
# boundaries of a walk path's warm-up subframe whose K9 states and K6
# inputs are recorded (a 768^2 town subframe runs ~340 boundaries)
WALK_SNAPSHOTS = (8, 40, 100, 200)
WALK_SRC = "rendertoy3c_tpu_torch/kernels/csrc/walk.cu"
WALK_REPLACES = "rendertoy3c_tpu/integrate/walkpool.py:363"
# K9's operations per walking lane-round beyond its row's tests, counted
# from walk.cu as the constants above: the launch, the cut, the level
# lookup, the stash or gate (WALK_ROUND_OPS), and per pending entry of
# each level the prune, write-back and argmin step (WALK_POP_OPS)
WALK_ROUND_OPS = 30
WALK_POP_OPS = 4
ROW_BYTES = 512
# K9-inst's operations beyond K9's, counted from walk.cu as above: the
# bf16 unpack of a 32-wide child's box (two integer ops per axis), the
# space switch at a static instance row (two 3 x 3 products and the
# translation, the selects and the restore) and at a 2-key row (the lerp of
# 12 entries, the cofactors, the determinant and its guarded reciprocal,
# the 9 scalings, the origin's offset and the two products)
UNPACK_OPS = 6
INST_ROW_OPS = 42
INST_ROW_MOTION_OPS = 125
# K6's instance rows (shade.cuh): the 18-row gather's selects, the normal's
# transform and second normalisation; under normal maps the tangent's
# transform
INST_SHADE_OPS = 45
INST_TANGENT_OPS = 15


def walk_scenes():
    """{name: (scene, camera)} of the walk band: the 50000-face towns (the
    untextured one of config 1; the textured ones of configs 2 and 4, 2-key
    for 4; the textured principled one of config 5) and the 49k box
    field."""
    from rendertoy3c_tpu_torch.scene.builtin import box_field
    from rendertoy3c_tpu_torch.scene.scene import build_scene
    from rendertoy3c_tpu_torch.scene.town import town_scene

    meshes, fcam = box_field()
    return {"town": town_scene(WALK_FACES),
            "textured town": town_scene(WALK_FACES, textured=True),
            "2-key textured town": town_scene(WALK_FACES, True,
                                              textured=True),
            "principled town": town_scene(WALK_FACES, textured=True,
                                          principled=True),
            "box field": (build_scene(meshes), fcam)}


def walk_pipes(scene, cfg, dev, ordered=None):
    """(ordered scene, kernel pipeline, plain pipeline) of the walk pool:
    the scene split-ordered as choose_tracer orders it (or `ordered`, that
    order made before), the plain pipeline over K9's and K6's plain
    versions."""
    import dataclasses

    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace import hierwalk, shade

    leaf = hierwalk.HIER_LEAF if scene.num_keys == 1 else \
        hierwalk.HIER_LEAF_MOTION
    scene = ordered or split_order_scene(scene, leaf=leaf)
    pipe = walkpool.make_walkpool_pipeline(scene, cfg, dev)
    return scene, pipe, plain_walk_pipe(pipe)


def plain_walk_pipe(pipe):
    """The walk pool pipeline over K9's (K9-inst's) and K6's plain
    versions."""
    import dataclasses

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace import shade

    return dataclasses.replace(
        pipe, walk_fn=functools.partial(walkpool.walk_rounds, plain=True),
        shade_fn=shade.external_shade_ref)


def phase_hier_gate(dev, scenes):
    """Phase 24: bench.py's hierwalk gate (:124-158) on K9: 131072 camera
    rays from (0, 20, 45) on the 49k box field, camera and bounce rays on
    the 50000-face static and 2-key towns (random times). The K9-driven
    trace_closest_hier / trace_any_hier against their plain versions (prims,
    occlusion, t, u, v bit-equal) and the brute tracer (prims and
    occlusion exact)."""
    import torch

    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.integrate.walkpool import walk_rounds
    from rendertoy3c_tpu_torch.scene.camera import Camera, camera_ray_dir
    from rendertoy3c_tpu_torch.trace import hierwalk
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    for k, name in enumerate(("box field", "town", "2-key textured town")):
        t0 = time.perf_counter()
        scene, camera = scenes[name]
        motion = scene.num_keys == 2
        leaf = hierwalk.HIER_LEAF_MOTION if motion else hierwalk.HIER_LEAF
        scene = split_order_scene(scene, leaf=leaf)
        tab = hierwalk.build_hier_table(scene.geom, scene.num_faces,
                                        num_keys=scene.num_keys, fanout=0,
                                        device=dev)
        rng = np.random.default_rng(SEED + 24 + k)
        tm = (torch.as_tensor(rng.uniform(0, 1, GATE_RAYS).astype(np.float32),
                              device=dev) if motion else None)
        if name == "box field":
            cam = Camera(eye=(0, 20, 45), lookat=(0, 0, 0), fov_y=50.0)
            scf = tuple(float(x) for x in np.concatenate(
                list(cam.params())).astype(np.float32))
            pix = torch.arange(GATE_RAYS, device=dev) % (768 * 768)
            zero = torch.zeros(GATE_RAYS, device=dev)
            d = torch.stack(camera_ray_dir(scf, pix, 768, 768, zero, zero), 1)
            o = torch.as_tensor(scf[:3], device=dev).expand(GATE_RAYS, 3)
            o = o.contiguous()
        else:
            o, d = camera_and_bounce_rays(
                scene, camera, GATE_RAYS // 2, GATE_RAYS, dev, rng,
                None if tm is None else tm.cpu().numpy())
        t_any = torch.as_tensor(rng.uniform(0.5, 60.0, GATE_RAYS)
                                .astype(np.float32), device=dev)
        walk_rounds.launches = 0
        got = hierwalk.trace_closest_hier(tab, o, d, 1e-2, 1e16, time=tm)
        occ = hierwalk.trace_any_hier(tab, o, d, 1e-3, t_any, time=tm)
        launches = walk_rounds.launches
        want = hierwalk.trace_closest_hier(tab, o, d, 1e-2, 1e16, time=tm,
                                           plain=True)
        occ_p = hierwalk.trace_any_hier(tab, o, d, 1e-3, t_any, time=tm,
                                        plain=True)
        for what, a, b in zip(("t", "prim", "u", "v"), got, want):
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"phase 24 {name}: K9's closest {what} differs from the "
                  "plain version")
        check(torch.equal(occ, occ_p), f"phase 24 {name}: K9's occlusion "
              "differs from the plain version")
        brute = trace_closest_bruteforce(scene, o, d, 1e-2, 1e16, tm)
        bad = int((brute.prim != got.prim).sum())
        check(bad == 0, f"phase 24 {name}: {bad} prim mismatches vs brute")
        occ_b = trace_any_bruteforce(scene, o, d, 1e-3, t_any, tm)
        bad_o = int((occ_b != occ).sum())
        check(bad_o == 0, f"phase 24 {name}: {bad_o} occlusion mismatches "
              "vs brute")
        print(f"phase 24 hierwalk gate, {name} ({scene.num_faces} faces, "
              f"{tab.table.shape[0]} rows = {tab.table.numel() * 4 / 1e6:.2f}"
              f" MB, fanout {tab.fanout}, {tab.n_levels} levels): {GATE_RAYS}"
              f" rays, K9 ({launches} launches) bit-equal to the plain "
              f"versions, 0 prim and 0 occlusion mismatches vs brute (hit "
              f"share {float((got.prim >= 0).float().mean()):.3f}, occluded "
              f"{float(occ.float().mean()):.3f}); "
              f"{time.perf_counter() - t0:.1f} s")


def walk_gate(scene, camera, dev, what, change, ordered=None):
    """The gate of phase 4 at 96^2 on the walk pool, kernels against plain
    versions, both over one split order (`ordered`, the scene's if given);
    with AOV all three buffers bit-equal. Returns the ordered scene."""
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig

    cfg_kw = dict(GATE, **change)
    ordered, pipe, plain = walk_pipes(scene, RenderConfig(**cfg_kw), dev,
                                      ordered)
    gate(ordered, camera, dev, what, 26, tracers=(pipe, plain), **change)
    return ordered


# the launch counters of the walk pool's kernels: (name, wrapper, count)
WALK_COUNTERS = (("walk_rounds", "walk_rounds", "launches"),
                 ("walk_rounds_inst", "walk_rounds", "inst_launches"),
                 ("external_shade", "external_shade", "launches"),
                 ("external_shade_inst", "external_shade", "inst_launches"))


def launch_counters():
    """{name: (wrapper, count attribute)} of WALK_COUNTERS."""
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace import shade

    fns = dict(walk_rounds=walkpool.walk_rounds,
               external_shade=shade.external_shade)
    return {n: (fns[f], a) for n, f, a in WALK_COUNTERS}


def walk_path(name, scene, camera, dev, smi, change, timed=TIMED, phase=27,
              need=("walk_rounds", "external_shade"), profile=True):
    """A walk-band main path through make_render_fn over choose_tracer's
    pipeline (with tune_config): 1 warm-up subframe, during which K9's
    (K9-inst's) states and K6's inputs at WALK_SNAPSHOTS boundaries are
    recorded, profiled (its idle share against the untraced timed
    subframes), then `timed` subframes with the launch counters zeroed
    just before (timed=0: the warm-up subframe only, its launches
    counted, no profile; profile=False: no profile, as full_size).
    Fails unless every
    counter of `need` (WALK_COUNTERS' names) is above 0. Returns
    {launches, states, shade, pipe, film}."""
    import dataclasses

    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer, tune_config

    cfg = tune_config(scene, RenderConfig(**dict(MAIN, **change)), dev)
    t0 = time.perf_counter()
    scene, pipe = choose_tracer(scene, cfg, dev)
    order_s = time.perf_counter() - t0
    rec = dict(on=True, boundary=0, states=[], shade=[], state=None)

    def walk_fn(s, tab, motion, k):
        if rec["on"] and rec["boundary"] in WALK_SNAPSHOTS:
            rec["states"].append(s.clone())
        rec["boundary"] += 1
        rec["state"] = s
        walkpool.walk_rounds(s, tab, motion, k)

    def shade_fn(rays, hit4, misc, tables, config, transposed, inst=None):
        if rec["on"] and rec["boundary"] in WALK_SNAPSHOTS:
            rec["shade"].append((rays.clone(), hit4.clone(), misc.clone(),
                                 None if inst is None else inst.clone()))
        return shade.external_shade(rays, hit4, misc, tables, config,
                                    transposed=transposed, inst=inst)

    pipe = dataclasses.replace(pipe, walk_fn=walk_fn, shade_fn=shade_fn)
    step = make_render_fn(scene, cfg, tracer=pipe, device=dev)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=dev)
    counters = launch_counters()

    def zero():
        rec["boundary"] = 0
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}

    zero()
    (film, stats), warm_s, prof = warm_up(lambda: step(cam, film),
                                          profile and timed > 0)
    rec["on"] = False
    check(len(rec["states"]) == len(WALK_SNAPSHOTS),
          f"{name}: {rec['boundary']} boundaries, too few for the snapshots")
    launches = read()
    lines = [f"phase {phase} {name} {cfg.width}x{cfg.height} 8spp depth 16 "
             f"pool {cfg.ray_block} flush {cfg.flush_every} "
             f"({scene.num_faces} faces in split order, {pipe.n_levels} "
             f"levels, fanout {pipe.fanout}; ordered and tabled in "
             f"{order_s:.2f} s) on {smi}: warm-up {warm_s:.3f} s"
             + (" (traced)" if prof else "")]
    if timed:
        zero()
        rates, secs, per = [], [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            film, stats = step(cam, film)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rays = int(stats.radiance_rays) + int(stats.shadow_rays)
            rows = int(rec["state"].rows)  # the subframe's own state
            rates.append(rays / dt / 1e6)
            secs.append(dt)
            per.append(dict(rays=rays, walk_rounds=stats.walk_rounds,
                            rows_per_ray=rows / rays))
        launches = read()
        walk = launches["walk_rounds"] + launches["walk_rounds_inst"]
        shades = launches["external_shade"] + launches["external_shade_inst"]
        lines.append(
            f"  Mray/s per subframe {rates}, median "
            f"{float(np.median(rates)):.6g}; s {secs}; per subframe: "
            f"{walk / timed:.1f} boundaries (K9 launches), "
            f"{shades / timed:.1f} K6 launches, walk rounds "
            f"{[p['walk_rounds'] for p in per]}, rows gathered per ray "
            f"{[round(p['rows_per_ray'], 3) for p in per]}, rays "
            f"{[p['rays'] for p in per]}")
    for n in need:
        check(launches[n] > 0, f"{name}: the main path launched {n} no time")
    img = film.accum
    check(bool(torch.isfinite(img).all())
          and tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"{name}: image not finite or of shape {tuple(img.shape)}")
    lines.append(f"  image mean {float(img.mean()):.6f}; launches "
                 f"{launches}")
    print("\n".join(lines))
    if timed:
        idle = profile_report(
            prof, warm_s, float(np.median(secs)), phase,
            ("walk_kernel", "external_shade_kernel"),
            what="the warm-up subframe") if profile else None
        PATHS[name] = (float(np.median(rates)), idle)
    return dict(launches=launches, states=rec["states"], shade=rec["shade"],
                pipe=dataclasses.replace(pipe, walk_fn=walkpool.walk_rounds,
                                         shade_fn=shade.external_shade),
                film=film)


def k9_work(s, pipe, rounds):
    """(bytes, operations, rows) of one K9 or K9-inst launch of `rounds`
    rounds from state s, counted round by round on a clone run by the
    plain version. Operations: the walking lanes' leaf tests (MT, with the
    2-key lerp of a flat table's leaves), slab tests (with the bf16 unpack
    at fanout 32) or instance-row space switches, every lane's pop over
    its pending entries and the round's own operations. Bytes: each table
    row the launch reaches read once (512 B; the lane-rounds that gather
    the same row again are served by L2, which holds the whole table),
    and the state read and written once. rows: the walking lane-rounds."""
    import torch

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.trace.hier_instanced import InstHierTable
    from rendertoy3c_tpu_torch.trace.hierwalk import _L_TYPE

    s = s.clone()
    tab = pipe.table
    inst = isinstance(tab, InstHierTable)
    leaf_motion = pipe.motion and not inst
    cap = 7 if leaf_motion else 14
    leaf_ops = cap * (MT_TEST_OPS + (LERP_OPS if leaf_motion else 0))
    box_ops = BOX_OPS + (UNPACK_OPS if tab.fanout == 32 else 0)
    inst_ops = INST_ROW_MOTION_OPS if pipe.motion else INST_ROW_OPS
    w = s.cur.shape[0]
    rows = leaves = insts = 0
    reached = torch.zeros(tab.table.shape[0], dtype=torch.bool,
                          device=s.cur.device)
    for _ in range(rounds):
        walkpool._launch_ref(s, inst)
        walking = s.cur >= 0
        typ = tab.table[s.cur.clamp(min=0).long(), _L_TYPE]
        is_inst = walking & (typ > 1.5)
        rows += int(walking.sum())
        reached[s.cur[walking].long()] = True
        leaves += int((walking & (typ > 0.5) & ~is_inst).sum())
        insts += int(is_inst.sum())
        if inst:
            walkpool._walk_round_inst(tab, s, pipe.motion)
        else:
            walkpool._walk_round(tab, s, pipe.motion)
        walkpool._stash_and_gate_ref(s)
    ops = (leaves * leaf_ops + insts * inst_ops
           + (rows - leaves - insts) * tab.fanout * box_ops
           + rounds * w * (WALK_ROUND_OPS
                           + tab.n_levels * tab.fanout * WALK_POP_OPS))
    state = sum(t.numel() * t.element_size() for _, t in s.tensors())
    return int(reached.sum()) * ROW_BYTES + 2 * state, ops, rows


def phase_k9(dev, paths, label="K9", phase=24):
    """Phase 24 (31 for K9-inst) on the main paths' states: one launch
    teacher-forced on each state recorded at WALK_SNAPSHOTS boundaries of
    each walk path against its plain version (every state column
    bit-equal), then the kernel's device time per launch on fresh clones
    of those states, the plain version's, the walking lanes and the
    bound."""
    import torch

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig

    calls, plain_calls, costs, walking = [], [], [], []
    warm = None
    for name, res in paths.items():
        pipe = res["pipe"]
        k = walkpool.phase_rounds(
            RenderConfig(), pipe.n_levels,
            spacewalk=pipe.instanced and not pipe.inst_stride)
        for s in res["states"]:
            got, want = s.clone(), s.clone()
            walkpool.walk_rounds(got, pipe.table, pipe.motion, k)
            walkpool.walk_rounds(want, pipe.table, pipe.motion, k,
                                 plain=True)
            for (col, a), (_, b) in zip(got.tensors(), want.tensors()):
                check(torch.equal(a.reshape(-1).view(torch.uint8),
                                  b.reshape(-1).view(torch.uint8)),
                      f"phase {phase} {label} ({name}): state column {col} "
                      "differs from the plain version")
            if warm is None:
                warm = functools.partial(walkpool.walk_rounds, s.clone(),
                                         pipe.table, pipe.motion, k)
            n_bytes, ops, rows = k9_work(s, pipe, k)
            costs.append((n_bytes, ops))
            walking.append(rows / k)
            for _ in range(6):
                c = s.clone()
                calls.append(functools.partial(walkpool.walk_rounds, c,
                                               pipe.table, pipe.motion, k))
            c = s.clone()
            plain_calls.append(functools.partial(
                walkpool.walk_rounds, c, pipe.table, pipe.motion, k,
                plain=True))
        print(f"phase {phase} {label} ({name}): one launch of {k} rounds on "
              f"the states at boundaries {WALK_SNAPSHOTS}, every state "
              "column bit-equal to the plain version")
    res = dict(max_abs_err=0.0, ms=device_ms(calls, warmup=warm),
               plain_ms=cuda_ms(plain_calls))
    res["bound_ms"], res["bound_by"] = mean_bound(costs)
    pool = next(iter(paths.values()))["states"][0].cur.shape[0]
    mb = ", ".join(f"{p['pipe'].table.table.numel() * 4 / 1e6:.2f}"
                   for p in paths.values())
    print(f"phase {phase} {label} on the main paths' states: device time "
          f"{res['ms']:.4f} ms per launch vs plain {res['plain_ms']:.4f} ms; "
          f"walking lanes per round {np.mean(walking):.1f} of {pool}; bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
          f"({k9_bound_terms(costs)}; the tables, {mb} MB)")
    return res


def k9_bound_terms(costs):
    """The two terms of K9's bound for the phase lines."""
    n_bytes = float(np.mean([c[0] for c in costs]))
    ops = float(np.mean([c[1] for c in costs]))
    return (f"the reached rows and the state, {n_bytes / 1e6:.3f} MB, over "
            f"3.35 TB/s: {n_bytes / MEM_BPS * 1e3:.4f} ms; the slab, MT, "
            f"space switch and pop operations, {ops / 1e6:.2f} M, over 67 "
            f"TFLOP/s: {ops / FP32_OPS * 1e3:.4f} ms")


def phase_k9_drivers(dev, walks, phase=31):
    """Phase 31: K9-inst under the trace-time walk drivers
    (trace_closest_inst_hier / trace_any_inst_hier, bare walks of 16
    rounds a launch under multi_instance_tracetime's external pipeline) on
    the states recorded at DRIVER_SNAPSHOTS launches: each launch bit-equal
    to its plain version, then its device time, the plain version's, the
    walking lanes and the bound of these launches' own rows and
    operations (k9_work)."""
    import types

    import torch

    from rendertoy3c_tpu_torch.integrate import walkpool

    calls, plain_calls, costs, walking = [], [], [], []
    for s, tab, motion, k in walks:
        got, want = s.clone(), s.clone()
        walkpool.walk_rounds(got, tab, motion, k)
        walkpool.walk_rounds(want, tab, motion, k, plain=True)
        for (col, a), (_, b) in zip(got.tensors(), want.tensors()):
            check(torch.equal(a.reshape(-1).view(torch.uint8),
                              b.reshape(-1).view(torch.uint8)),
                  f"phase {phase} K9-inst (trace-time drivers): state "
                  f"column {col} differs from the plain version")
        n_bytes, ops, rows = k9_work(
            s, types.SimpleNamespace(table=tab, motion=motion), k)
        costs.append((n_bytes, ops))
        walking.append(rows / k)
        calls += [functools.partial(walkpool.walk_rounds, s.clone(), tab,
                                    motion, k) for _ in range(6)]
        plain_calls.append(functools.partial(
            walkpool.walk_rounds, s.clone(), tab, motion, k, plain=True))
    res = dict(max_abs_err=0.0, ms=device_ms(calls),
               plain_ms=cuda_ms(plain_calls))
    res["bound_ms"], res["bound_by"] = mean_bound(costs)
    print(f"phase {phase} K9-inst (trace-time drivers) on the states of "
          f"launches {DRIVER_SNAPSHOTS} of the warm-up, every state column "
          f"bit-equal to the plain version: device time {res['ms']:.4f} ms "
          f"per {walks[0][3]}-round launch of {walks[0][0].cur.shape[0]} "
          f"lanes vs plain {res['plain_ms']:.4f} ms; walking lanes per "
          f"round {np.mean(walking):.1f}; bound {res['bound_ms']:.4f} ms "
          f"by {res['bound_by']} ({k9_bound_terms(costs)})")
    return res


def phase_k6t(dev, label, paths, phase=25):
    """Phase 25 (31 with instance rows): K6 on the walk paths' recorded
    boundary inputs (C-major misc), or on an external pipeline's
    (row-major, with the flag `row_major` in the path's result), bit for
    bit against its plain version, timed and bounded as phase 8."""
    import torch

    from rendertoy3c_tpu_torch.trace import shade

    launches, costs = [], []
    for name, res in paths.items():
        tables, config = res["tables"], res["config"]
        transposed = not res.get("row_major")
        mw = 24 if config.aov else 16
        for rays, hit4, misc, inst in res["shade"]:
            a = (rays, hit4, misc, tables, config)
            kw = dict(transposed=transposed, inst=inst)
            got = shade.external_shade(*a, **kw)
            want = shade.external_shade_ref(*a, **kw)
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)),
                  f"phase {phase} {label} ({name}) differs from its plain "
                  "version")
            launches.append((a, kw))
            pool = rays.shape[0]
            prim = hit4[:, 1].clamp(min=0).to(torch.int64)
            attr = tables.attr[prim].T
            it = (None if inst is None
                  else shade.gather_inst_rows(tables.inst_rows, inst))
            tex_ops, tex_bytes = texture_work(attr, shade._shade_lanes(
                rays, hit4, misc.T if transposed else misc, attr,
                tables.lights_t, config, tex=tables.tex,
                params_base=tables.params_base, it=it), tables.tex)
            tex_ops += material_ops(pool, tables.params_base, config.power,
                                    config.num_lights)
            inst_bytes = inst_ops = 0
            if inst is not None:
                inst_bytes = 4 * pool + 72 * int(torch.unique(inst).numel())
                inst_ops = pool * (INST_SHADE_OPS + (
                    INST_TANGENT_OPS if tables.tex is not None
                    and tables.tex.normal_maps else 0))
            costs.append((pool * (32 + 16 + 4 * mw + 32 + 4 * (mw + 8)
                                  + 4 * got[2].shape[1])
                          + torch.unique(prim).numel() * 4 * attr.shape[0]
                          + tex_bytes + inst_bytes
                          + 4 * tables.lights_t.numel(),
                          pool * (SHADE_OPS + (AOV_OPS if config.aov else 0))
                          + tex_ops + inst_ops))
    k6_tails(label, *launches[0], phase=phase)
    res = dict(max_abs_err=0.0)
    res["ms"] = device_ms([functools.partial(shade.external_shade, *a, **kw)
                           for a, kw in launches] * 6)
    res["plain_ms"] = cuda_ms([functools.partial(shade.external_shade_ref,
                                                 *a, **kw)
                               for a, kw in launches])
    res["bound_ms"], res["bound_by"] = mean_bound(costs)
    print(f"phase {phase} {label} on the recorded inputs of "
          f"{', '.join(paths)}, bit-equal to the plain version: device time "
          f"{res['ms']:.4f} ms per {launches[0][0][0].shape[0]}-lane launch "
          f"vs plain {res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} "
          f"ms by {res['bound_by']}")
    return res


def walk_band(dev, smi, t_start):
    """Phases 24-27 on the hierwalk band. Returns the entries of the
    "kernels" line: K9 and K6 on C-major misc in its four variants."""
    t0 = time.perf_counter()
    scenes = walk_scenes()
    print(f"phase 24 walk scenes generated and loaded in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} {s.num_faces} faces" for n, (s, _) in
                      scenes.items()))
    phase_hier_gate(dev, scenes)
    print(f"phase 24 gate done; {time.perf_counter() - t_start:.1f} s since "
          "the start")

    # ---- phase 26: the 96^2 gates on the 50000-face towns
    ordered = {}
    for what, key, change in (
            ("static", "town", {}),
            ("2-key", "2-key textured town", {}),
            ("textured", "textured town", {}),
            ("principled, power", "principled town", POWER),
            ("textured, aov", "textured town", AOV)):
        ordered[key] = walk_gate(*scenes[key], dev, f"{what} town (walk "
                                 "pool)", change, ordered.get(key))
    print(f"phase 26 done; {time.perf_counter() - t_start:.1f} s since the "
          "start")

    # ---- phase 27: the main paths
    paths = {
        "config 1 town 1080p": walk_path(
            "config 1 town 1080p", *scenes["town"], dev, smi, CONFIG1,
            profile=False),
        "config 2 textured town": walk_path(
            "config 2 textured town", *scenes["textured town"], dev, smi,
            SORTED, profile=False),
        "config 4 2-key textured town": walk_path(
            "config 4 2-key textured town", *scenes["2-key textured town"],
            dev, smi, SORTED, profile=False),
        "config 5 principled town": walk_path(
            "config 5 principled town", *scenes["principled town"], dev,
            smi, SORTED_POWER, profile=False),
        "49k box field": walk_path(
            "49k box field", *scenes["box field"], dev, smi, SORTED),
    }
    aov_path = walk_path("textured town aov", *scenes["textured town"], dev,
                         smi, AOV, timed=0)
    print(f"phase 27 done; {time.perf_counter() - t_start:.1f} s since the "
          "start")

    # ---- phases 24-25 on the main paths' recorded states
    k9 = phase_k9(dev, paths)
    entries = [dict(name="walk_rounds", route="cuda", source=WALK_SRC,
                    replaces=WALK_REPLACES,
                    launches=sum(p["launches"]["walk_rounds"]
                                 for p in paths.values()),
                    **k9, library_ms=None)]
    for name, label, keys in (
            ("external_shade_transposed", "K6 transposed",
             ("config 1 town 1080p", "49k box field")),
            ("external_shade_transposed_textured", "K6 transposed textured",
             ("config 2 textured town", "config 4 2-key textured town")),
            ("external_shade_transposed_textured_dispatch_power",
             "K6 transposed textured dispatch, power",
             ("config 5 principled town",)),
            ("external_shade_transposed_textured_aov",
             "K6 transposed textured AOV", ("textured town aov",))):
        group = {k: aov_path if k == "textured town aov" else paths[k]
                 for k in keys}
        res = phase_k6t(dev, label, {k: dict(
            v, tables=v["pipe"].shade_tables, config=v["pipe"].shade_config)
            for k, v in group.items()})
        entries.append(kernel_entry(
            name, K6_SRC, 1778, sum(p["launches"]["external_shade"]
                                    for p in group.values()), res))
    print(f"phases 24-27 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")
    return entries


# ---------------------------------------------------------------- phase 28+
# trace-time instancing: bench's instanced gate (bench.py:192-220) and its
# four instanced configurations (:537-584): BASELINE config 3
# (multi_instance_tlas, baked by build_scene, K4), multi_instance_tracetime
# (the instanced walk under the external pipeline), multi_instance_large
# (578 instances of the 972-face tower on the baked world table, K9) and
# multi_instance_motion (its 2-key form on the instanced table at fanout
# 32, K9-inst); K6 with instance rows on all but config 3
INST_GATE_GRID = 8
INST_REPLACES = "rendertoy3c_tpu/integrate/walkpool.py:456"
# pool iterations of the trace-time path's warm-up subframe whose K6
# inputs are recorded
EXT_SNAPSHOTS = (32, 200, 600, 1000)
# K9-inst launches of the trace-time walk drivers (hier_instanced.py
# trace_closest_inst_hier / trace_any_inst_hier, ~2 a pool iteration) in
# that warm-up whose states are recorded
DRIVER_SNAPSHOTS = (40, 400, 1200, 2400)


def inst_scenes():
    """{name: (scene, camera)} of bench's instanced configurations."""
    from rendertoy3c_tpu_torch.scene.builtin import (instance_field,
                                                      multi_instance_cornell)
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, inst, cam = multi_instance_cornell()
    large = instance_field(False)
    motion = instance_field(True)
    return {"multi_instance_tlas": (build_scene(meshes, instances=inst), cam),
            "multi_instance_tracetime": (build_instanced_scene(meshes, inst),
                                         cam),
            "multi_instance_large": (build_instanced_scene(*large[:2]),
                                     large[2]),
            "multi_instance_motion": (build_instanced_scene(*motion[:2]),
                                      motion[2])}


def phase_inst_gate(dev):
    """Phase 28: bench's instanced gate (bench.py:192-220): 131072 camera
    rays of the 768^2 grid on bench's instance field at grid 8 (66
    instances); the K9-inst-driven trace_closest_inst_hier and
    trace_any_inst_hier (random tmax) bit-equal to their plain versions
    and exact against the brute instanced tracer: 0 prim, 0 instance and 0
    occlusion mismatches. Then the 2-key field at grid 8 on a forced
    fanout-32 table with random times likewise: bit-equal to the plain
    versions and 0 mismatches against the brute tracer. Returns the static
    field's scene, rays and brute hits for phase 37."""
    import torch

    from rendertoy3c_tpu_torch.integrate.walkpool import walk_rounds
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.camera import camera_ray_dir
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.trace import hier_instanced as hi
    from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer

    for k, (what, motion, fanout) in enumerate((
            ("static", False, None), ("2-key, fanout 32", True, 32))):
        t0 = time.perf_counter()
        meshes, inst, cam = instance_field(motion, INST_GATE_GRID)
        scene = hi.split_order_instanced(build_instanced_scene(meshes, inst))
        tab = hi.build_inst_hier_table(scene, fanout=fanout, device=dev)
        scf = tuple(float(x) for x in np.concatenate(
            list(cam.params())).astype(np.float32))
        pix = torch.arange(GATE_RAYS, device=dev) % (768 * 768)
        zero = torch.zeros(GATE_RAYS, device=dev)
        d = torch.stack(camera_ray_dir(scf, pix, 768, 768, zero, zero), 1)
        o = torch.as_tensor(scf[:3], device=dev).expand(GATE_RAYS, 3)
        o = o.contiguous()
        rng = np.random.default_rng(SEED + 28 + k)
        tm = (torch.as_tensor(rng.uniform(0, 1, GATE_RAYS).astype(np.float32),
                              device=dev) if motion else None)
        t_any = torch.as_tensor(rng.uniform(0.5, 60.0, GATE_RAYS)
                                .astype(np.float32), device=dev)
        walk_rounds.inst_launches = 0
        got = hi.trace_closest_inst_hier(tab, o, d, 1e-2, 1e16, time=tm)
        occ = hi.trace_any_inst_hier(tab, o, d, 1e-3, t_any, time=tm)
        launches = walk_rounds.inst_launches
        want = hi.trace_closest_inst_hier(tab, o, d, 1e-2, 1e16, time=tm,
                                          plain=True)
        occ_p = hi.trace_any_inst_hier(tab, o, d, 1e-3, t_any, time=tm,
                                       plain=True)
        for col, a, b in zip(("t", "prim", "u", "v", "inst"), got, want):
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"phase 28 {what}: K9-inst's closest {col} differs from "
                  "the plain version")
        check(torch.equal(occ, occ_p), f"phase 28 {what}: K9-inst's "
              "occlusion differs from the plain version")
        closest, any_hit = make_instanced_tracer(scene, dev)
        brute = closest(o, d, 1e-2, 1e16, tm)
        brute_occ = any_hit(o, d, 1e-3, t_any, tm)
        bad = [int((brute.prim != got.prim).sum()),
               int((brute.inst != got.inst).sum()),
               int((brute_occ != occ).sum())]
        check(max(bad) == 0, f"phase 28 {what}: {bad} prim, instance and "
              "occlusion mismatches vs brute")
        print(f"phase 28 instanced gate, {what} field at grid "
              f"{INST_GATE_GRID} ({scene.num_instances} instances, "
              f"{tab.table.shape[0]} rows, fanout {tab.fanout}, "
              f"{tab.n_levels} levels): {GATE_RAYS} rays, K9-inst "
              f"({launches} launches) bit-equal to the plain versions, "
              f"{bad[0]} prim, {bad[1]} instance and {bad[2]} occlusion "
              f"mismatches vs brute (hit share "
              f"{float((got.prim >= 0).float().mean()):.3f}, occluded "
              f"{float(occ.float().mean()):.3f}); "
              f"{time.perf_counter() - t0:.1f} s")
        if not motion:
            field_in = dict(scene=scene, o=o, d=d, t_any=t_any, brute=brute,
                            occ=brute_occ)
    return field_in


def inst_gates(dev, scenes):
    """Phase 29: the gate of phase 4 at 96^2, kernels against plain
    versions, on the trace-time Cornell (K9-inst under the external
    pipeline, K6 with instance rows), a baked field at grid 6 (K9, K6
    with instance rows; the bake forced below its face threshold) and the
    578-instance 2-key field (K9-inst at fanout 32)."""
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.walkpool import \
        make_inst_walkpool_pipeline
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer
    from rendertoy3c_tpu_torch.trace.hier_instanced import \
        split_order_instanced

    cfg = RenderConfig(**GATE)
    for what, key in (("trace-time Cornell", "multi_instance_tracetime"),
                      ("2-key 578-instance field", "multi_instance_motion")):
        scene, camera = scenes[key]
        ordered, pipe = choose_tracer(scene, cfg, dev)
        plain = plain_tracer(scene, cfg, dev)[1]
        gate(ordered, camera, dev, what, 29, tracers=(pipe, plain))
    meshes, inst, camera = instance_field(False, 6)
    ordered = split_order_instanced(build_instanced_scene(meshes, inst))
    pipe = make_inst_walkpool_pipeline(ordered, cfg, dev, bake=True)
    gate(ordered, camera, dev, "baked field at grid 6", 29,
         tracers=(pipe, plain_walk_pipe(pipe)))


def tracetime_path(name, scene, camera, dev, smi, timed=TIMED,
                   phase=30):
    """multi_instance_tracetime through make_render_fn over choose_tracer's
    external pipeline (with tune_config): 1 warm-up subframe, profiled,
    during which K6's inputs at EXT_SNAPSHOTS pool iterations and the
    walk drivers' K9-inst states at DRIVER_SNAPSHOTS launches are
    recorded, `timed` subframes with the launch counters zeroed just
    before (K9-inst and K6 with instance rows must launch), the warm-up's
    idle share against them, then the band of phase 5 (NARROW_BAND)
    against the plain versions. Returns {launches, shade, walks, tables,
    config, row_major}."""
    import dataclasses

    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer, tune_config
    from rendertoy3c_tpu_torch.trace.hier_instanced import \
        make_inst_hierwalk_tracer

    cfg = tune_config(scene, RenderConfig(**MAIN), dev)
    ordered, chosen = choose_tracer(scene, cfg, dev)
    check(isinstance(chosen, shade.ExternalPipeline) and chosen.instanced,
          f"{name}: choose_tracer gave {type(chosen).__name__}")
    rec = dict(on=True, it=0, shade=[], walk_it=0, walks=[])

    def walk_fn(s, tab, motion, rounds, plain=False):
        if rec["on"] and rec["walk_it"] in DRIVER_SNAPSHOTS:
            rec["walks"].append((s.clone(), tab, motion, rounds))
        rec["walk_it"] += 1
        walkpool.walk_rounds(s, tab, motion, rounds, plain=plain)

    def shade_fn(rays, hit4, misc, tables, config, inst=None):
        if rec["on"] and rec["it"] in EXT_SNAPSHOTS:
            rec["shade"].append((rays.clone(), hit4.clone(), misc.clone(),
                                 inst.clone()))
        rec["it"] += 1
        return shade.external_shade(rays, hit4, misc, tables, config,
                                    inst=inst)

    # choose_tracer's pipeline, its drivers' launches and K6's routed
    # through the recording functions
    pipe = shade.ExternalPipeline(
        ordered, cfg, make_inst_hierwalk_tracer(ordered, dev,
                                                walk_fn=walk_fn),
        dev, shade_fn=shade_fn)
    step = make_render_fn(ordered, cfg, tracer=pipe, device=dev)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=dev)
    counters = launch_counters()
    (film, _), warm_s, prof = warm_up(lambda: step(cam, film), True)
    rec["on"] = False
    check(len(rec["shade"]) == len(EXT_SNAPSHOTS),
          f"{name}: {rec['it']} pool iterations, too few for the snapshots")
    check(len(rec["walks"]) == len(DRIVER_SNAPSHOTS),
          f"{name}: {rec['walk_it']} walk launches, too few for the "
          "snapshots")
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    rates, secs, iters = [], [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        film, stats = step(cam, film)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append((int(stats.radiance_rays) + int(stats.shadow_rays))
                     / dt / 1e6)
        secs.append(dt)
        iters.append(stats.pool_iters)
    launches = {n: getattr(fn, attr) for n, (fn, attr) in counters.items()}
    for n in ("walk_rounds_inst", "external_shade_inst"):
        check(launches[n] > 0, f"{name}: the main path launched {n} no time")
    img = film.accum
    check(bool(torch.isfinite(img).all())
          and tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"{name}: image not finite or of shape {tuple(img.shape)}")
    print(f"phase {phase} {name} 768^2 8spp depth 16 pool {cfg.ray_block} "
          f"flush {cfg.flush_every} sort {cfg.sort_rays} ({ordered.num_faces}"
          f" stored faces, {ordered.num_instances} instances) on {smi}: "
          f"warm-up {warm_s:.3f} s (traced)\n  Mray/s per subframe "
          f"{rates}, median {float(np.median(rates)):.6g}; s {secs}; pool "
          f"iterations {iters}; per subframe "
          f"{launches['walk_rounds_inst'] / timed:.1f}"
          f" K9-inst and {launches['external_shade_inst'] / timed:.1f} K6 "
          f"launches; image mean {float(img.mean()):.6f}; launches "
          f"{launches}")
    idle = profile_report(prof, warm_s, float(np.median(secs)), phase,
                          ("walk_kernel", "external_shade_kernel"),
                          what="the warm-up subframe")
    band_pair(name, scene, camera, dataclasses.asdict(cfg), dev, NARROW_BAND)
    PATHS[name] = (float(np.median(rates)), idle)
    return dict(launches=launches, shade=rec["shade"], walks=rec["walks"],
                tables=pipe.tables, config=pipe.config, row_major=True)


def inst_band(dev, smi, t_start):
    """Phases 28-31 on trace-time instancing. Returns (the entries of the
    "kernels" line: K9-inst and K6 with instance rows, C-major and
    row-major; phase 28's static field inputs; the scenes)."""
    from rendertoy3c_tpu_torch.trace import shade

    t0 = time.perf_counter()
    scenes = inst_scenes()
    print(f"phase 28 instanced scenes built in {time.perf_counter() - t0:.2f}"
          " s: " + ", ".join(
              f"{n} {s.num_faces} faces" + (
                  f", {s.num_instances} instances"
                  if hasattr(s, "num_instances") else "")
              for n, (s, _) in scenes.items()))
    field_in = phase_inst_gate(dev)
    inst_gates(dev, scenes)
    print(f"phases 28-29 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")

    # ---- phase 30: the main paths
    full_size("multi_instance_tlas", *scenes["multi_instance_tlas"], dev,
              smi, 30, {"trace_shade_refill": shade.trace_shade_refill},
              ("refill_kernel",))
    paths = {
        "multi_instance_tracetime": tracetime_path(
            "multi_instance_tracetime", *scenes["multi_instance_tracetime"],
            dev, smi),
        "multi_instance_large": walk_path(
            "multi_instance_large", *scenes["multi_instance_large"], dev,
            smi, {}, phase=30, need=("walk_rounds", "external_shade_inst"),
            profile=False),
        "multi_instance_motion": walk_path(
            "multi_instance_motion", *scenes["multi_instance_motion"], dev,
            smi, {}, phase=30,
            need=("walk_rounds_inst", "external_shade_inst"),
            profile=False),
    }
    print(f"phase 30 done; {time.perf_counter() - t_start:.1f} s since the "
          "start")

    # ---- phase 31: the kernels on the main paths' recorded inputs
    k9i = phase_k9(dev, {"multi_instance_motion":
                         paths["multi_instance_motion"]}, "K9-inst", 31)
    drivers = phase_k9_drivers(dev, paths["multi_instance_tracetime"]["walks"])
    phase_k9(dev, {"multi_instance_large": paths["multi_instance_large"]},
             "K9 (baked world table)", 31)
    tracetime = paths["multi_instance_tracetime"]["launches"]
    entries = [dict(name="walk_rounds_inst", route="cuda", source=WALK_SRC,
                    replaces=INST_REPLACES,
                    launches=sum(p["launches"]["walk_rounds_inst"]
                                 for k, p in paths.items()
                                 if k != "multi_instance_tracetime"),
                    **k9i, library_ms=None),
               dict(name="walk_rounds_inst_tracetime", route="cuda",
                    source=WALK_SRC, replaces=INST_REPLACES,
                    launches=tracetime["walk_rounds_inst"], **drivers,
                    library_ms=None)]
    fields = {k: dict(v, tables=v["pipe"].shade_tables,
                      config=v["pipe"].shade_config)
              for k, v in paths.items() if k != "multi_instance_tracetime"}
    for name, label, group in (
            ("external_shade_inst_transposed", "K6 instance rows, C-major",
             fields),
            ("external_shade_inst", "K6 instance rows, row-major",
             {"multi_instance_tracetime":
              paths["multi_instance_tracetime"]})):
        res = phase_k6t(dev, label, group, phase=31)
        entries.append(kernel_entry(
            name, K6_SRC, 1778, sum(p["launches"]["external_shade_inst"]
                                    for p in group.values()), res))
    print(f"phases 28-31 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")
    return entries, field_in, scenes


# ---------------------------------------------------------------- phase 32+
# the resident-table walk (K8) under the general pool: `--tracer
# residentwalk` on bench's 49k box field (bench.py:224-250, 587-591) at
# bench's cfg_sorted (:514), the scene split-ordered at 256-face runs as
# the reference's CLI orders it (app/cli.py:339-343)
RW_SRC = "rendertoy3c_tpu_torch/kernels/csrc/resident_walk.cu"
RW_REPLACES = "rendertoy3c_tpu/trace/pallas_walk.py:338"
# K8's operations, counted from resident_walk.cu: a slab test of one (ray,
# leaf box) pair (3 x (2 subtractions, 2 products, min, max), 4 min/max,
# the 3 comparisons, the clamp and the row minimum), and one
# Moller-Trumbore test of a (ray, face) pair with its selects
RW_SLAB_OPS = 30
RW_MT_OPS = 45
# every this many closest (shadow) calls of the main path's warm-up, its
# inputs are recorded; 4 of them, spread over the subframe, are timed
RW_RECORD_EVERY = 10


def resident_scene():
    """(split-ordered scene, camera) of bench's 49k box field."""
    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.scene.builtin import box_field
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    meshes, camera = box_field()
    return split_order_scene(build_scene(meshes)), camera


def resident_tracers(scene, dev):
    """(K8's tracer, its plain twin), each over its own walk table; the
    first records each walk's per-block (passes, rounds) counts in the
    lists `kern[0].passes` (closest, any)."""
    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    passes = ([], [])
    kern = rw.make_walk_tracer(scene, dev, passes=passes)
    kern[0].passes = passes
    plain = rw.make_walk_tracer(scene, dev, plain=True)
    return kern, plain


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def phase_k8_gate(dev, scene, camera, tab):
    """Phase 32: the K8 gate. 131072 rays on the 49k field: camera rays
    from (0, 20, 45) (the 768^2 grid's first 65536 pixels) and one cosine
    bounce from each hit, filled with random rays. K8's single-pass form
    (output rows and cursor rows) bit-equal to one reference launch
    (walk_*_ref); the one-launch walk's hits and occlusion bit-equal to
    the reference's pass loop (plain=True); 0 prim and 0 occlusion
    mismatches against the brute tracer; a forced multi-pass walk
    (t_rounds = 4) likewise."""
    import torch

    from rendertoy3c_tpu_torch.trace import residentwalk as rw
    from rendertoy3c_tpu_torch.trace.intersect import (
        trace_any_bruteforce, trace_closest_bruteforce)

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 32)
    o, d = camera_and_bounce_rays(scene, camera, GATE_RAYS // 2, GATE_RAYS,
                                  dev, rng)
    t_any = torch.as_tensor(rng.uniform(0.5, 60.0, GATE_RAYS)
                            .astype(np.float32), device=dev)
    brute = trace_closest_bruteforce(scene, o, d, 1e-2, 1e16)
    occ_b = trace_any_bruteforce(scene, o, d, 1e-3, t_any)
    lines = []
    for t_rounds in (rw.T_ROUNDS, 4):
        rays, _ = rw._pack(o, d, 1e-2, 1e16, rw.RT)
        rays_a, _ = rw._pack(o, d, 1e-3, t_any, rw.RT)
        count = torch.tensor([GATE_RAYS], dtype=torch.int32, device=dev)
        er, ir = rw._start(rays, rw.RT)
        for name, kern, ref, r in (("closest", rw.walk_closest,
                                    rw.walk_closest_ref, rays),
                                   ("any", rw.walk_any, rw.walk_any_ref,
                                    rays_a)):
            out_k, cur_k, _ = kern(count, er, ir, r, tab, rw.RT, t_rounds)
            out_p, cur_p = ref(count, er, ir, r, tab, rw.RT, t_rounds)
            check(_bits_equal(out_k, out_p) and _bits_equal(cur_k, cur_p),
                  f"phase 32: K8 {name} (T = {t_rounds}) differs from its "
                  "plain version on the first pass")
        passes = []
        got = rw.trace_closest_walk(tab, o, d, 1e-2, 1e16, t_rounds=t_rounds,
                                    passes=passes)
        want = rw.trace_closest_walk(tab, o, d, 1e-2, 1e16,
                                     t_rounds=t_rounds,
                                     plain=True)
        for what, a, b in zip(("t", "prim", "u", "v"), got, want):
            check(_bits_equal(a, b), f"phase 32: K8's closest {what} (T = "
                  f"{t_rounds}) differs from the plain version")
        occ = rw.trace_any_walk(tab, o, d, 1e-3, t_any, t_rounds=t_rounds,
                                passes=passes)
        check(torch.equal(occ, rw.trace_any_walk(
            tab, o, d, 1e-3, t_any, t_rounds=t_rounds, plain=True)),
            f"phase 32: K8's occlusion (T = {t_rounds}) differs from the "
            "plain version")
        bad = int((brute.prim != got.prim).sum())
        bad_o = int((occ_b != occ).sum())
        check(bad == 0 and bad_o == 0, f"phase 32: T = {t_rounds}: {bad} "
              f"prim and {bad_o} occlusion mismatches vs brute")
        most = [int(c[:, 0].max()) for c in passes]
        check(t_rounds == rw.T_ROUNDS or most[0] > 1,
              f"phase 32: the forced walk ran {most} passes at most")
        lines.append(f"T = {t_rounds}: passes of a block at most: closest "
                     f"{most[0]}, any {most[1]}")
    print(f"phase 32 K8 gate, box field ({scene.num_faces} faces, "
          f"{tab.n_leaves} leaves of 128, rows "
          f"{tab.rows.numel() * 4 / 1e6:.2f} MB): {GATE_RAYS} rays, K8 "
          f"closest and any bit-equal to the plain versions (single "
          f"pass: output and cursor rows; the one-launch walk's hits and "
          f"occlusion against the pass loop), 0 "
          f"prim and 0 occlusion mismatches vs brute (hit share "
          f"{float((got.prim >= 0).float().mean()):.3f}, occluded "
          f"{float(occ.float().mean()):.3f}); {'; '.join(lines)}; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_resident_gates(dev, scene, camera, tracers):
    """Phase 33: the 96^2 gates. The general pool over K8 against its
    plain version (sorted, as the main path); the wave integrator against
    the general pool over K8; the A22 scene (the textured quad's floor
    PRINCIPLED, emissive and its texture as its emissive and roughness
    maps) on the bare MT rung (K1/K2) against the plain MT tracer."""
    import dataclasses

    from rendertoy3c_tpu_torch.scene.builtin import textured_quad_variant
    from rendertoy3c_tpu_torch.scene.material import MaterialType
    from rendertoy3c_tpu_torch.scene.scene import build_scene
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer
    from rendertoy3c_tpu_torch.trace.mt import make_mt_tracer

    gate(scene, camera, dev, "box field, residentwalk (general pool, "
         "sorted)", 33, tracers=tracers, **SORTED)
    f_w = render(scene, camera, dict(GATE, integrator="wave"), dev, False,
                 0, 1, tracers[0])[0].accum.cpu().numpy()
    f_p = render(scene, camera, GATE, dev, False, 0, 1,
                 tracers[0])[0].accum.cpu().numpy()
    mean_d, outl, max_d = gate_diff(f_w, f_p)
    check(mean_d <= 2e-3 and outl <= 8 and max_d <= 8.0,
          f"phase 33: the wave integrator fails the gate against the pool: "
          f"mean|d| {mean_d:.3g}, {outl} outliers, max|d| {max_d:.3g}")
    print(f"phase 33 gate 96^2 2spp box field, residentwalk, wave "
          f"integrator vs general pool: mean|d| {mean_d:.3g}, outliers "
          f"{outl}, max|d| {max_d:.3g}")
    meshes, textures, qcam = textured_quad_variant("repeat")
    meshes[0].material = dataclasses.replace(
        meshes[0].material, material_type=MaterialType.PRINCIPLED,
        roughness=0.5, emissive=(2.0, 2.0, 2.0), emissive_texture_id=0,
        roughness_texture_id=0)
    quad = build_scene(meshes, textures=textures)
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig

    ordered, tracer = choose_tracer(quad, RenderConfig(**GATE), dev)
    check(isinstance(tracer, tuple), "phase 33: the emissive-textured quad "
          f"took {type(tracer).__name__}, not the bare MT tracer")
    gate(ordered, qcam, dev, "emissive- and roughness-textured quad (A22, "
         "bare MT tracer, general pool)", 33,
         tracers=(tracer, make_mt_tracer(ordered, dev, plain=True)))


def resident_path(scene, camera, dev, smi, tracers, timed=TIMED,
                  phase=34):
    """Phase 34: `--tracer residentwalk` on the 49k field through
    make_render_fn at cfg_sorted: 1 warm-up subframe, during which the
    walk's inputs of every RW_RECORD_EVERY-th closest and shadow call are
    recorded by a wrapper around make_walk_tracer's pair, then `timed`
    subframes of the pair itself with K8's counters zeroed just before
    and read just after; Mray/s, K8 launches per walk (one), the rounds
    per block (mean and largest, over the blocks that ran one) and the
    share of those done in their first pass, from the per-block counts
    the kernel writes; every pixel finite; the band of phase 5 against
    the plain walk; the idle share of the warm-up subframe, profiled.
    Returns {launches, closest, any} (the recorded inputs: (rays, count)
    each)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    name = "49k box field, residentwalk"
    cfg_kw = dict(MAIN, **SORTED)
    cfg = RenderConfig(**cfg_kw)
    kern = tracers[0]
    tab = kern[0].table
    passes = kern[0].passes
    rec = dict(closest=[], any=[], calls=[0, 0])

    def recording(i, what):
        def walk(o, d, tmin, tmax, time=None, count=None):
            rec["calls"][i] += 1
            if rec["calls"][i] % RW_RECORD_EVERY == 0:
                rays, _ = rw._pack(o, d, tmin, tmax, rw.RT)
                c = rw._count(count, o.shape[0], dev)
                rec[what].append((rays, c.clone()))
            return kern[i](o, d, tmin, tmax, time, count=count)
        return walk

    warm = make_render_fn(scene, cfg, tracer=(recording(0, "closest"),
                                              recording(1, "any")),
                          device=dev)
    step = make_render_fn(scene, cfg, tracer=kern, device=dev)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=dev)
    (film, _), warm_s, prof = warm_up(lambda: warm(cam, film), True)
    warm_calls = list(rec["calls"])
    check(len(rec["closest"]) >= 4 and len(rec["any"]) >= 4,
          f"{name}: {warm_calls} calls, too few to record")
    rw.walk_closest.launches = 0
    rw.walk_any.launches = 0
    for p in passes:
        p.clear()
    rates, secs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        film, stats = step(cam, film)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append((int(stats.radiance_rays) + int(stats.shadow_rays))
                     / dt / 1e6)
        secs.append(dt)
    launches = {"resident_walk_closest": rw.walk_closest.launches,
                "resident_walk_any": rw.walk_any.launches}
    for n, cnt in launches.items():
        check(cnt > 0, f"{name}: the main path launched {n} no time")
    img = film.accum
    check(bool(torch.isfinite(img).all())
          and tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"{name}: image not finite or of shape {tuple(img.shape)}")
    walks = [len(p) for p in passes]
    check(launches["resident_walk_closest"] == walks[0]
          and launches["resident_walk_any"] == walks[1],
          f"{name}: {launches} K8 launches for {walks} walks")
    blocks = []
    for kind, p in zip(("closest", "any"), passes):
        cnt = torch.cat(p)
        ran = cnt[cnt[:, 1] > 0]
        blocks.append(
            f"{kind}: rounds per block mean "
            f"{float(ran[:, 1].float().mean()):.3f}, largest "
            f"{int(ran[:, 1].max())}, done in pass 1 "
            f"{float((ran[:, 0] == 1).float().mean()):.4f} of the "
            f"{ran.shape[0] / len(p):.1f} blocks per walk that ran a round "
            f"(passes at most {int(ran[:, 0].max())})")
    print(f"phase {phase} {name} ({scene.num_faces} faces, "
          f"{tab.n_leaves} leaves) {cfg.width}x{cfg.height} "
          f"{cfg.samples_per_launch}spp depth {cfg.max_depth} pool "
          f"{cfg.ray_block} sorted on {smi}: warm-up {warm_s:.3f} s "
          f"(traced), "
          f"{warm_calls[0]} closest and "
          f"{warm_calls[1]} shadow calls")
    print(f"  Mray/s per subframe {rates}, median "
          f"{float(np.median(rates)):.6g}; s {secs}; per subframe: K8 "
          f"launches {launches['resident_walk_closest'] / timed:.1f} closest"
          f" + {launches['resident_walk_any'] / timed:.1f} any over "
          f"{walks[0] / timed:.1f} closest and {walks[1] / timed:.1f} shadow "
          f"walks (1 launch per walk); image mean {float(img.mean()):.6f}; "
          f"launches {launches}")
    print(f"  K8 blocks per walk, {'; '.join(blocks)}")
    idle = profile_report(prof, warm_s, float(np.median(secs)), phase,
                          ("resident_walk_kernel",),
                          what="the warm-up subframe")
    band_pair(name, scene, camera, cfg_kw, dev, tracers=tracers)
    PATHS[name] = (float(np.median(rates)), idle)
    return dict(launches=launches, closest=rec["closest"], any=rec["any"],
                table=tab)


def k8_work(stats, counts, rays, count, tab):
    """(bytes, operations) of one K8 walk from the first cursor: the slab
    tests of each live block's rays against every leaf box, once for each
    pass the block ran (counts [B, 2]: passes, rounds), the MT tests the
    walk needs (the plain twin's count in `stats`: closest, every ray of a
    block against every face of each round it ran; any, each ray
    unoccluded when a round starts against the faces up to its first
    hit), the rays, leaf rows and boxes read once, the output, cursor and
    count rows written once."""
    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    b = rays.shape[0] // rw.RT
    live_blocks = min(b, -(-int(count[0]) // rw.RT))
    block_passes = int(counts[:live_blocks, 0].sum())
    ops = (block_passes * rw.RT * tab.n_leaves * RW_SLAB_OPS
           + int(stats[0]) * RW_MT_OPS)
    n_bytes = (rays.numel() * 4 + tab.rows.numel() * 4
               + tab.aabb_lanes.numel() * 4 + b * 8 + rays.shape[0] * 16
               + b * 32 + b * 8)
    return n_bytes, ops


def phase_k8_timed(dev, path, phase=35):
    """Phase 35: K8 closest and any on the main path's recorded inputs (4
    calls spread over the warm-up subframe): the whole walk (one launch
    with the pass cap) bit for bit against its plain twin
    (walk_*_blocks_ref: output rows, cursor rows, per-block counts), its
    hits and occlusion against the reference's pass loop (plain=True),
    the single-pass form against walk_*_ref; the walk timed behind a spin
    kernel (device_ms), the twin by CUDA events; bounded by k8_work.
    Returns {walk name: result fields}."""
    import torch

    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    tab = path["table"]
    cap = rw.pass_cap(tab, rw.T_ROUNDS)
    out = {}
    for name, kern, twin, ref, trace in (
            ("closest", rw.walk_closest, rw.walk_closest_blocks_ref,
             rw.walk_closest_ref, rw.trace_closest_walk),
            ("any", rw.walk_any, rw.walk_any_blocks_ref, rw.walk_any_ref,
             rw.trace_any_walk)):
        # 4 calls spread over those with a live lane
        recs = [r for r in path[name] if int(r[1][0]) > 0]
        check(len(recs) >= 4, f"phase {phase}: {len(recs)} recorded {name} "
              "calls with a live lane")
        pick = [recs[int(i)] for i in np.linspace(0, len(recs) - 1, 4)]
        calls_k, calls_p, works, rounds = [], [], [], []
        for rays, count in pick:
            er, ir = rw._start(rays, rw.RT)
            a = (count, er, ir, rays, tab, rw.RT, rw.T_ROUNDS, cap)
            got = kern(*a)
            stats = []
            want = twin(*a, stats=stats)
            check(all(_bits_equal(g, w) for g, w in zip(got, want)),
                  f"phase {phase}: K8 {name}'s walk differs from its plain "
                  "twin on the main path's inputs")
            one_k = kern(*a[:7])
            one_p = ref(*a[:7])
            check(_bits_equal(one_k[0], one_p[0])
                  and _bits_equal(one_k[1], one_p[1]),
                  f"phase {phase}: K8 {name}'s single pass differs from "
                  f"walk_{name}_ref on the main path's inputs")
            g, w = (trace(tab, rays[:, 0:3], rays[:, 3:6], rays[:, 6],
                          rays[:, 7], count=count, plain=p)
                    for p in (False, True))
            pairs = zip(g[:4], w[:4]) if name == "closest" else [(g, w)]
            check(all(_bits_equal(x.float(), y.float()) for x, y in pairs),
                  f"phase {phase}: K8 {name}'s hits differ from the "
                  "reference's pass loop on the main path's inputs")
            works.append(k8_work(stats, got[2], rays, count, tab))
            rounds.append(got[2][:, 1])
            calls_k.append(lambda k=kern, a=a: k(*a))
            calls_p.append(lambda r=twin, a=a: r(*a))
        ms = device_ms(calls_k)
        plain_ms = cuda_ms(calls_p)
        bound_ms, bound_by = bound(
            float(np.mean([w[0] for w in works])),
            float(np.mean([w[1] for w in works])))
        r_all = torch.cat(rounds)
        print(f"phase {phase} K8 {name} on the main path's inputs ("
              f"{[int(c[1][0]) for c in pick]} live of "
              f"{pick[0][0].shape[0]} rays): the walk bit-equal to its "
              f"plain twin and to the pass loop, the single pass to "
              f"walk_{name}_ref; {ms:.4f} ms per walk, one launch (twin "
              f"{plain_ms:.3f} ms), bound {bound_ms:.4f} ms by {bound_by} "
              f"({bound_ms / ms:.1%}); rounds per block mean "
              f"{float(r_all.float().mean()):.3f}, largest "
              f"{int(r_all.max())}")
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return out


def resident_band(dev, smi, t_start):
    """Phases 32-35 on the resident-table walk. Returns the entries of the
    "kernels" line: K8 closest and any."""
    t0 = time.perf_counter()
    scene, camera = resident_scene()
    tracers = resident_tracers(scene, dev)
    tab = tracers[0][0].table
    print(f"phase 32 box field split-ordered at 256-face runs and tabled in "
          f"{time.perf_counter() - t0:.2f} s: {scene.num_faces} faces")
    phase_k8_gate(dev, scene, camera, tab)
    phase_resident_gates(dev, scene, camera, tracers)
    print(f"phases 32-33 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")
    path = resident_path(scene, camera, dev, smi, tracers)
    res = phase_k8_timed(dev, path)
    print(f"phases 32-35 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")
    return [dict(name=f"resident_walk_{n}", route="cuda", source=RW_SRC,
                 replaces=RW_REPLACES,
                 launches=path["launches"][f"resident_walk_{n}"], **res[n],
                 library_ms=None) for n in ("closest", "any")]


# ---------------------------------------------------------------- phase 36+
# the non-merged K5 (make_fused_shader(merged=False), pallas_shade.py:1230)
# on the fused pipeline with K5 split (split_pipeline): closest_raw (K1, or
# K3 for 2 keys) and then trace_shade_hit
SPLIT_PATHS = (("cornell sorted, non-merged", False, SORTED),
               ("2-key cornell sample-major, non-merged", True, SAMPLE_MAJOR))


def split_pipeline(scene, cfg, dev):
    """A FusedPipeline whose trace_shade runs closest_raw and then the
    non-merged K5, as the reference's make_fused_shader(merged=False)
    splits the megakernel."""
    from rendertoy3c_tpu_torch.trace import shade

    class SplitPipeline(shade.FusedPipeline):
        def trace_shade(self, rays, misc, count, time=None):
            hit4 = self.closest_raw(rays, count, time)
            return shade.trace_shade_hit(rays, hit4, misc, count,
                                         self.tables, self.config)

    return SplitPipeline(scene, cfg, dev)


def phase_split_paths(dev, scene, camera, m_scene, m_camera):
    """Phase 36's main paths: one 768^2 8 spp subframe each of the Cornell
    box sorted (K1 + the non-merged K5) and the 2-key Cornell box
    sample-major (K3 + the non-merged motion K5) through make_render_fn
    over split_pipeline, the launch counters zeroed just before and read
    just after (the non-merged K5 and K1 or K3 must launch, the merged K5
    not); each film bit-equal to one subframe of the merged pipeline.
    Returns {name: (non-merged K5 launches, closest launches)}."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import mt, shade

    out = {}
    for name, motion, change in SPLIT_PATHS:
        s, c = (m_scene, m_camera) if motion else (scene, camera)
        cfg = RenderConfig(**dict(MAIN, **change))
        films, secs = [], []
        closest = mt.mt_closest_motion if motion else mt.mt_closest
        for make in (shade.FusedPipeline, split_pipeline):
            step = make_render_fn(s, cfg, tracer=make(s, cfg, dev),
                                  device=dev)
            for fn in (shade.trace_shade, shade.trace_shade_hit, closest):
                fn.launches = 0
            t0 = time.perf_counter()
            film, _ = step(c.params(),
                           film_create(cfg.height, cfg.width, device=dev))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            films.append(film.accum)
        n_hit, n_closest = shade.trace_shade_hit.launches, closest.launches
        check(n_hit > 0 and n_closest == n_hit
              and shade.trace_shade.launches == 0,
              f"{name}: {n_hit} non-merged K5 and {n_closest} closest "
              f"launches, {shade.trace_shade.launches} merged")
        check(bool(torch.isfinite(films[1]).all()), f"{name}: not finite")
        same = torch.equal(films[0].view(torch.int32),
                           films[1].view(torch.int32))
        check(same, f"{name}: the split subframe differs from the merged "
              "pipeline's")
        print(f"phase 36 {name}: one subframe in {secs[1]:.3f} s (merged "
              f"{secs[0]:.3f} s), {n_hit} non-merged K5 and {n_closest} "
              f"{closest.__name__} launches; the film bit-equal to the "
              f"merged pipeline's; image mean {float(films[1].mean()):.6f}")
        out[name] = (n_hit, n_closest)
    return out


# trace-time instancing on K7 (trace/instanced_mt.py, the reference's
# trace/pallas_instanced.py): bench's multi_instance_tracetime (bench.py
# :576-584) through the reference's parallel/dist.py route,
# prepare_tracer_factory(kind="pallas") and make_render_fn_dist, on a 1 x 1
# NCCL mesh
K7_SRC = "rendertoy3c_tpu_torch/kernels/csrc/instanced_mt.cu"
K7_REPLACES = "rendertoy3c_tpu/trace/pallas_instanced.py:244"
# K7's operations, counted from instanced_mt.cu as the constants above: a
# slab test of one (ray, instance box) pair (6 subtractions, 6 products,
# 10 min/max, 4 comparisons; the box's padding is not needed work), the
# object-space transform of one ray (15 products and 12 sums), one
# Moller-Trumbore test with the best hit's compare and selects
K7_BOX_OPS = 26
K7_XFORM_OPS = 27
K7_MT_OPS = MT_TEST_OPS + 3
# every this many closest (shadow) calls of the K7 path's warm-up, its
# inputs are recorded; 4 of them are timed
K7_RECORD_EVERY = 100


def k7_work(rays, count, soup, any_hit: bool):
    """(operations, bytes, stats) that one K7 launch on these rays needs,
    counted ray by ray by the plain version (trace_instanced_ref's
    `stats`): every live ray tests every instance box; a ray that its
    padded box test admits (bounded by its best t so far, closest, or its
    tmax, any-hit) is transformed and tests the instance's mesh tiles up
    to each tile's real faces (closest: every real face; any-hit: up to
    its first hit). The rays and the outputs count once, the instance
    table, the padded boxes and the tile face counts once, each real face
    of a tile once if any ray tests it."""
    from rendertoy3c_tpu_torch.trace import instanced_mt as im

    st = {}
    im.trace_instanced_ref(rays, count, soup, any_hit, st)
    ops = (st["live"] * soup.table.shape[0] * K7_BOX_OPS
           + st["pairs"] * K7_XFORM_OPS + st["tests"] * K7_MT_OPS)
    n_bytes = (rays.shape[0] * 64 + 4 + 4 * (soup.table.numel()
                                            + soup.cull.numel()
                                            + soup.inst_tiles.numel()
                                            + soup.tile_faces.numel())
               + st["faces_read"] * 9 * 4)
    return ops, n_bytes, st


def k7_terms(costs) -> str:
    """Both terms of the bound of the mean launch of (bytes, operations)
    pairs."""
    n_bytes = sum(c[0] for c in costs) / len(costs)
    ops = sum(c[1] for c in costs) / len(costs)
    return (f"{n_bytes / 1e6:.4f} MB, {n_bytes / MEM_BPS * 1e3:.5f} ms; "
            f"{ops / 1e6:.3f} M operations, {ops / FP32_OPS * 1e3:.5f} ms")


def k7_cull_line(st) -> str:
    """The (ray, instance) pairs the reference's 256-ray vote and the
    per-ray cull admit, and the real-face share of the tested tiles."""
    return (f"pairs: vote {st['vote_pairs']}, cull {st['pairs']} "
            f"({st['vote_pairs'] / max(st['live'], 1):.3f} and "
            f"{st['pairs'] / max(st['live'], 1):.3f} per live ray); real "
            f"faces {100 * st['real_faces'] / max(128 * st['visits'], 1):.2f}"
            f"% of the tested tiles' stored faces")


def phase_k7_gate(dev, field_in, scenes):
    """Phase 37: K7 (trace_instanced, closest and any) against its plain
    version and the brute instanced tracer: on phase 28's 131072 camera
    rays of bench's instance field at grid 8 (66 instances), reusing phase
    28's brute closest hits and occlusion (which K9-inst matched), and on
    131072 camera rays spread over the 768^2 image of the trace-time
    Cornell (15 instances) with random tmax in [0.1, 4] for the shadow
    test; raw outputs bit-equal at the full count and at a count inside a
    ray tile, 0 prim, 0 instance and 0 occlusion mismatches; K7's time on
    these rays (device_ms), the plain version's, the bound (k7_work) with
    both terms, the (ray, instance) pairs the vote and the cull admit and
    the real-face share of the tested tiles. Returns {scene name: (scene,
    soup)}."""
    import torch

    from rendertoy3c_tpu_torch.scene.camera import camera_ray_dir
    from rendertoy3c_tpu_torch.trace import instanced_mt as im
    from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
    from rendertoy3c_tpu_torch.trace.mt import pack_rays

    scene, cam = scenes["multi_instance_tracetime"]
    scf = tuple(float(x) for x in np.concatenate(
        list(cam.params())).astype(np.float32))
    pix = torch.arange(GATE_RAYS, device=dev) * (768 * 768) // GATE_RAYS
    zero = torch.zeros(GATE_RAYS, device=dev)
    d = torch.stack(camera_ray_dir(scf, pix, 768, 768, zero, zero), 1)
    o = torch.as_tensor(scf[:3], device=dev).expand(GATE_RAYS, 3)
    o = o.contiguous()
    rng = np.random.default_rng(SEED + 37)
    t_any = torch.as_tensor(rng.uniform(0.1, 4.0, GATE_RAYS)
                            .astype(np.float32), device=dev)
    closest, any_hit = make_instanced_tracer(scene, dev)
    cornell_in = dict(scene=scene, o=o, d=d, t_any=t_any,
                      brute=closest(o, d, 1e-2, 1e16),
                      occ=any_hit(o, d, 1e-3, t_any))
    out = {}
    for name, g in (("instance field at grid 8", field_in),
                    ("trace-time Cornell", cornell_in)):
        t0 = time.perf_counter()
        soup = im.build_instanced_soup(g["scene"], dev)
        k_closest, k_any = im.make_instanced_mt_tracer(g["scene"], dev)
        res = {}
        for any_hit, tmin, tmax in ((False, 1e-2, 1e16),
                                    (True, 1e-3, g["t_any"])):
            rays, r = pack_rays(g["o"], g["d"], tmin, tmax)
            for n in (r, r - 1000):
                count = torch.tensor([n], dtype=torch.int32, device=dev)
                got = im.trace_instanced(rays, count, soup, any_hit)
                want = im.trace_instanced_ref(rays, count, soup, any_hit)
                check(torch.equal(got.view(torch.int32),
                                  want.view(torch.int32)),
                      f"phase 37 {name}: K7 {'any' if any_hit else 'closest'}"
                      f" differs from its plain version (count {n})")
            count = torch.tensor([r], dtype=torch.int32, device=dev)
            ms = device_ms([functools.partial(im.trace_instanced, rays,
                                              count, soup, any_hit)] * 10)
            plain_ms = cuda_ms([functools.partial(
                im.trace_instanced_ref, rays, count, soup, any_hit)])
            ops, n_bytes, st = k7_work(rays, count, soup, any_hit)
            res[any_hit] = (ms, plain_ms, *bound(n_bytes, ops))
            print(f"phase 37 {name}, K7 {'any' if any_hit else 'closest'}: "
                  f"{k7_cull_line(st)}; bound terms "
                  f"{k7_terms([(n_bytes, ops)])}")
        h = k_closest(g["o"], g["d"], 1e-2, 1e16)
        occ = k_any(g["o"], g["d"], 1e-3, g["t_any"])
        bad = [int((h.prim != g["brute"].prim).sum()),
               int((h.inst != g["brute"].inst).sum()),
               int((occ != g["occ"]).sum())]
        check(max(bad) == 0, f"phase 37 {name}: {bad} prim, instance and "
              "occlusion mismatches vs brute")
        print(f"phase 37 K7 gate, {name} ({g['scene'].num_instances} "
              f"instances, {soup.tris.shape[0]} mesh tiles): {GATE_RAYS} "
              f"rays, closest and any bit-equal to the plain version (count "
              f"R and R - 1000), {bad[0]} prim, {bad[1]} instance and "
              f"{bad[2]} occlusion mismatches vs brute (hit share "
              f"{float((h.prim >= 0).float().mean()):.3f}, occluded "
              f"{float(occ.float().mean()):.3f}); closest {res[False][0]:.4f}"
              f" ms (plain {res[False][1]:.3f}, bound {res[False][2]:.4f} by "
              f"{res[False][3]}), any {res[True][0]:.4f} ms (plain "
              f"{res[True][1]:.3f}, bound {res[True][2]:.4f} by "
              f"{res[True][3]}); {time.perf_counter() - t0:.1f} s")
        out[name] = (g["scene"], soup)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def k7_path(scene, camera, dev, smi, timed=TIMED, phase=38):
    """Phase 38: multi_instance_tracetime (bench.py:576-584: 15 instances,
    1920 effective faces) through the reference's distributed route at
    bench's config (MAIN, untuned: prepare_tracer_factory applies no
    tune_config): an NCCL process group of world size 1 (init_multihost
    at a free localhost port), make_mesh(1, 1), prepare_tracer_factory
    (kind="pallas": K7's pair under the general pool) and
    make_render_fn_dist. The warm-up subframe records the inputs of every
    K7_RECORD_EVERY-th closest and shadow call and must be bit-equal to
    one subframe of make_render_fn over the same pair; it is profiled
    (both K7 instantiations must show; its idle share against the timed
    subframes); then `timed` subframes with the launch counters zeroed
    just before and read just after (K7 closest and any must launch),
    Mray/s, every pixel finite, the band of phase 5 (NARROW_BAND) against
    the plain K7. Returns
    {launches, calls, pair, scene}."""
    import dataclasses

    import torch
    import torch.distributed as tdist

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.parallel.dist import (film_create_sharded,
                                                     make_mesh,
                                                     make_render_fn_dist,
                                                     prepare_tracer_factory)
    from rendertoy3c_tpu_torch.parallel.multihost import init_multihost
    from rendertoy3c_tpu_torch.trace import instanced_mt as im

    name = "multi_instance_tracetime (K7, 1 x 1 mesh)"
    cfg = RenderConfig(**MAIN)
    init_multihost(f"localhost:{_free_port()}", 1, 0, device=dev)
    try:
        check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1,
              f"{name}: process group {tdist.get_backend()}, world "
              f"{tdist.get_world_size()}")
        mesh = make_mesh(1, 1, device=dev)
        ordered, factory = prepare_tracer_factory(scene, cfg, kind="pallas",
                                                  device=mesh.device)
        pair = factory(ordered, None, cfg)
        check(isinstance(pair, tuple) and hasattr(pair[0], "soup"),
              f"{name}: prepare_tracer_factory gave {type(pair).__name__}")
        rec = dict(on=True, n=[0, 0], calls=([], []))

        def recorder(k):
            def call(o, d, tmin, tmax, time=None, count=None):
                if rec["on"] and rec["n"][k] % K7_RECORD_EVERY == 0:
                    rec["calls"][k].append(tuple(
                        x.clone() if isinstance(x, torch.Tensor) else x
                        for x in (o, d, tmin, tmax, count)))
                rec["n"][k] += 1
                return pair[k](o, d, tmin, tmax, time, count=count)
            return call

        step, _ = make_render_fn_dist(
            ordered, cfg, mesh,
            tracer_factory=lambda *_: (recorder(0), recorder(1)))
        cam = camera.params()
        film = film_create_sharded(cfg, mesh)
        (film, _), warm_s, prof = warm_up(lambda: step(cam, film), True)
        rec["on"] = False
        warm = film.accum.clone()
        ref = make_render_fn(ordered, cfg, tracer=pair, device=dev)(
            cam, film_create(cfg.height, cfg.width, device=dev))[0]
        check(torch.equal(warm.view(torch.int32),
                          ref.accum.view(torch.int32)),
              f"{name}: the 1 x 1 mesh's subframe differs from "
              "make_render_fn's")
        check(min(len(c) for c in rec["calls"]) >= 4,
              f"{name}: {rec['n']} calls, too few to record")
        im.trace_instanced.launches = im.trace_instanced.any_launches = 0
        rates, secs = [], []
        for _ in range(timed):
            t0 = time.perf_counter()
            film, stats = step(cam, film)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates.append((int(stats.radiance_rays) + int(stats.shadow_rays))
                         / dt / 1e6)
            secs.append(dt)
        launches = {"instanced_mt": im.trace_instanced.launches,
                    "instanced_mt_any": im.trace_instanced.any_launches}
        check(min(launches.values()) > 0,
              f"{name}: the main path launched K7 no time: {launches}")
        img = film.accum
        check(bool(torch.isfinite(img).all())
              and tuple(img.shape) == (cfg.height, cfg.width, 3),
              f"{name}: image not finite or of shape {tuple(img.shape)}")
        print(f"phase {phase} {name} 768^2 8spp depth 16 pool "
              f"{cfg.ray_block} ({ordered.num_faces} stored faces, "
              f"{ordered.num_instances} instances) on {smi}: warm-up "
              f"{warm_s:.3f} s (traced), bit-equal to make_render_fn's "
              f"subframe\n  Mray/s per subframe {rates}, median "
              f"{float(np.median(rates)):.6g}; s {secs}; per subframe "
              f"{launches['instanced_mt'] / timed:.1f} K7 closest and "
              f"{launches['instanced_mt_any'] / timed:.1f} K7 any launches;"
              f" image mean {float(img.mean()):.6f}")
        idle = profile_report(prof, warm_s, float(np.median(secs)), phase,
                              ("instanced_mt_kernel",),
                              variants=("<false>", "<true>"),
                              what="the warm-up subframe")
        plain = im.make_instanced_mt_tracer(ordered, dev, plain=True)
        band_pair(name, ordered, camera, dataclasses.asdict(cfg), dev,
                  NARROW_BAND, tracers=(pair, plain))
        PATHS[name] = (float(np.median(rates)), idle)
    finally:
        tdist.destroy_process_group()
    return dict(launches=launches, calls=rec["calls"], pair=pair,
                scene=ordered)


def phase_k7_timed(dev, path, phase=39):
    """Phase 39: K7 closest and any on the inputs of 4 closest and 4
    shadow calls of the K7 path's warm-up: bit for bit against the plain
    version, device time per launch (device_ms), the plain version's, the
    bound (k7_work). Returns {name: result}."""
    import torch

    from rendertoy3c_tpu_torch.trace import instanced_mt as im
    from rendertoy3c_tpu_torch.trace.mt import _count_tensor, pack_rays

    soup = path["pair"][0].soup
    out = {}
    for k, name in enumerate(("instanced_mt", "instanced_mt_any")):
        any_hit = k == 1
        # the calls of at least half a pool of live lanes (the subframe's
        # tail traces few), 4 of them spread over the warm-up
        calls = [c for c in path["calls"][k]
                 if int(c[4]) >= c[0].shape[0] // 2]
        check(len(calls) >= 4, f"phase {phase} {name}: {len(calls)} "
              "recorded calls of half a pool")
        picks = [calls[int(j)] for j in
                 np.linspace(0, len(calls) - 1, 4).round()]
        launches, costs, lanes = [], [], []
        for o, d, tmin, tmax, count in picks:
            rays, r = pack_rays(o, d, tmin, tmax)
            c = _count_tensor(count, r, rays.device)
            got = im.trace_instanced(rays, c, soup, any_hit)
            want = im.trace_instanced_ref(rays, c, soup, any_hit)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"phase {phase} {name}: differs from its plain version on "
                  "a recorded call")
            launches.append((rays, c, soup, any_hit))
            ops, n_bytes, st = k7_work(rays, c, soup, any_hit)
            costs.append((n_bytes, ops))
            lanes.append(int(c))
        ms = device_ms([functools.partial(im.trace_instanced, *a)
                        for a in launches] * 4)
        plain_ms = cuda_ms([functools.partial(im.trace_instanced_ref, *a)
                            for a in launches])
        bound_ms, bound_by = mean_bound(costs)
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase {phase} {name} on 4 recorded calls of the K7 path's "
              f"warm-up (live counts {lanes} of "
              f"{launches[0][0].shape[0]}): bit-equal to the plain version;"
              f" device time {ms:.4f} ms per launch vs plain {plain_ms:.4f} "
              f"ms; bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.2f}% of the kernel's time; terms "
              f"{k7_terms(costs)}); the last call's {k7_cull_line(st)}")
    return out


def phase_decompositions(dev, path, camera, phase=40):
    """Phase 40: the (2, 1) and (1, 2) meshes of the K7 path at 192^2, by
    the per-rank function in one process (render_mesh_in_process, each
    rank's render_shard and the collectives' arithmetic) over the path's
    K7 pair: the tile decomposition bit-equal to one subframe of
    make_render_fn with the same ray counts; the spp decomposition by the
    reference's test_tile_spp_mesh_statistics rule (finite, rays counted,
    the mean within 5% of one device's)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.parallel.dist import render_mesh_in_process

    cfg = RenderConfig(**dict(MAIN, width=192, height=192))
    cam = camera.params()
    scene, pair = path["scene"], path["pair"]
    one, stats = make_render_fn(scene, cfg, tracer=pair, device=dev)(
        cam, film_create(cfg.height, cfg.width, device=dev))
    one = one.accum
    rgb, _, rad, shad, _ = render_mesh_in_process(scene, cfg, 2, 1, pair,
                                                  cam, 0, dev)
    check(torch.equal(rgb.view(torch.int32), one.view(torch.int32))
          and rad == int(stats.radiance_rays)
          and shad == int(stats.shadow_rays),
          f"phase {phase}: the (2, 1) mesh differs from one device "
          f"({rad} vs {int(stats.radiance_rays)} radiance rays)")
    spp, _, rad2, shad2, _ = render_mesh_in_process(scene, cfg, 1, 2, pair,
                                                    cam, 0, dev)
    a, b = float(spp.mean()), float(one.mean())
    check(bool(torch.isfinite(spp).all()) and rad2 > 0 and shad2 > 0
          and abs(a - b) < 0.05 * max(b, 1e-6),
          f"phase {phase}: the (1, 2) mesh's mean {a} vs one device's {b}")
    print(f"phase {phase} K7 path at 192^2 by the per-rank function: (2, 1)"
          f" bit-equal to one device, {rad} radiance and {shad} shadow rays "
          f"as one device's; (1, 2) mean {a:.6f} vs {b:.6f} (rel "
          f"{abs(a - b) / b:.4f}), {rad2} radiance rays")


def k7_band(dev, smi, t_start, field_in, scenes):
    """Phases 37-40 on K7. Returns the entries of the "kernels" line: K7
    closest and any."""
    phase_k7_gate(dev, field_in, scenes)
    print(f"phase 37 done; {time.perf_counter() - t_start:.1f} s since the "
          "start")
    scene, camera = scenes["multi_instance_tracetime"]
    path = k7_path(scene, camera, dev, smi)
    res = phase_k7_timed(dev, path)
    phase_decompositions(dev, path, camera)
    print(f"phases 37-40 done; {time.perf_counter() - t_start:.1f} s since "
          "the start")
    return [dict(name=n, route="cuda", source=K7_SRC, replaces=K7_REPLACES,
                 launches=path["launches"][n], **res[n], library_ms=None)
            for n in ("instanced_mt", "instanced_mt_any")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from rendertoy3c_tpu_torch.kernels import build as kbuild
        from rendertoy3c_tpu_torch.film.image import write_png
        from rendertoy3c_tpu_torch.film.tonemap import make_color
        from rendertoy3c_tpu_torch.scene.builtin import cornell_box
        from rendertoy3c_tpu_torch.scene.scene import build_scene
        from rendertoy3c_tpu_torch.scene.town import town_scene
        from rendertoy3c_tpu_torch.trace import mt, shade
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    try:
        # ---- phase 1: card and build
        print(f"phase 1 card: {smi}")
        print(f"phase 1 torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}, device {name}")
        t0 = time.perf_counter()
        lib_path, nvcc_s = kbuild.build()
        kbuild.library()
        print(f"phase 1 kernels built for sm_90a in {nvcc_s:.2f} s (nvcc), "
              f"{time.perf_counter() - t0:.2f} s with load: {lib_path}")
        log = (lib_path.parent / "build.log").read_text()
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())

        meshes, camera = cornell_box()
        scene = build_scene(meshes)

        # ---- phase 2: K1/K2 on Cornell
        phase_mt(dev, scene, camera)

        # ---- phase 3: K4
        k4 = phase_k4(dev, scene, camera)

        # ---- phase 4: the gate at 96^2
        gate(scene, camera, dev, "Cornell", 4)

        # ---- phase 5: the Cornell main path
        film_k, launches_c = full_size(
            "cornell", scene, camera, dev, smi, 5,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))

        # ---- phase 6: PNG
        out_dir = tempfile.mkdtemp(prefix="rt3c_smoke_")
        png = os.path.join(out_dir, "cornell_768.png")
        write_png(png, np.ascontiguousarray(
            make_color(film_k.accum, alpha=False).cpu().numpy()[::-1]))
        print(f"phase 6 wrote {png}")

        # ---- phase 11: K4's motion variant
        m_scene, m_camera = moving_cornell()
        check(m_scene.num_keys == 2 and m_scene.num_faces == 36,
              f"2-key Cornell: {m_scene.num_faces} faces, "
              f"{m_scene.num_keys} keys")
        k4m = phase_k4(dev, m_scene, m_camera, 11, "K4 motion")

        # ---- phase 12: K5 static and motion on their paths' inputs
        # (their recorded subframes are phase 14's warm-ups)
        k5_runs = [k5_states(scene, camera, dev, SORTED),
                   k5_states(m_scene, m_camera, dev, SAMPLE_MAJOR)]
        k5s, k5m = phase_k5(dev, dict(zip(
            ("K5 (Cornell sorted)", "K5 motion (2-key Cornell sample-major)"),
            k5_runs))).values()
        split = phase_split_paths(dev, scene, camera, m_scene, m_camera)

        # ---- phase 13: the gates of the new schedules
        gate(m_scene, m_camera, dev, "2-key Cornell", 13)
        gate(scene, camera, dev, "Cornell sorted", 13, **SORTED)
        gate(scene, camera, dev, "Cornell sample-major", 13, **SAMPLE_MAJOR)
        s, c = town_scene(GATE_TOWN_FACES, False)
        gate(s, c, dev, f"town ({s.num_faces} faces) sorted", 13, **SORTED)
        gate(s, c, dev, f"town ({s.num_faces} faces) sample-major", 13,
             **SAMPLE_MAJOR)

        # ---- phase 14: the new paths at full size
        launches_km = full_size(
            "2-key cornell", m_scene, m_camera, dev, smi, 14,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        launches_k5 = full_size(
            "cornell sorted", scene, camera, dev, smi, 14,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SORTED, warm=k5_runs[0][4])[1]
        launches_k5m = full_size(
            "2-key cornell sample-major", m_scene, m_camera, dev, smi, 14,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SAMPLE_MAJOR, warm=k5_runs[1][4], profile=False)[1]
        print(f"phase 14 done; {time.perf_counter() - t_start:.1f} s since "
              "the start")

        # ---- phase 41: K4 and K5 on the multi-tile fused scene
        t0 = time.perf_counter()
        phase_multitile(dev)
        print(f"phase 41 done in {time.perf_counter() - t0:.1f} s")

        # ---- phases 15-17 on the textured quad, static and 2-key
        tq, tq_cam = textured_quad()
        tqm, tqm_cam = textured_quad(motion=True)
        check(shade.texture_state(tq) == "diffuse" and tqm.num_keys == 2,
              "textured quad: not textured or not 2-key")
        k4t = phase_k4(dev, tq, tq_cam, 15, "K4 textured")
        k4mt = phase_k4(dev, tqm, tqm_cam, 15, "K4 motion textured")
        k5t_runs = [k5_states(tq, tq_cam, dev, SORTED, QUAD_SNAPSHOTS),
                    k5_states(tqm, tqm_cam, dev, SAMPLE_MAJOR,
                              QUAD_SNAPSHOTS)]
        k5t, k5mt = phase_k5(dev, dict(zip(
            ("K5 textured (textured quad sorted)",
             "K5 motion textured (2-key textured quad sample-major)"),
            k5t_runs)), 15).values()
        for variant in ("repeat", "clamp_mirror", "uv_transform",
                        "normal_map"):
            gate(*textured_quad(variant), dev, f"textured quad {variant}", 16)
        launches_k4t = full_size(
            "textured quad", tq, tq_cam, dev, smi, 17,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        launches_k4mt = full_size(
            "2-key textured quad", tqm, tqm_cam, dev, smi, 17,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        launches_k5t = full_size(
            "textured quad sorted", tq, tq_cam, dev, smi, 17,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SORTED, warm=k5t_runs[0][4], profile=False)[1]
        launches_k5mt = full_size(
            "2-key textured quad sample-major", tqm, tqm_cam, dev, smi, 17,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SAMPLE_MAJOR, warm=k5t_runs[1][4], profile=False)[1]
        print(f"phase 17 (textured quad) done; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

        # ---- phases 18-20 on the material Cornell box and the principled
        # quad: the dispatch variants of K4 and K5
        mc, mc_cam = material_cornell()
        mcm, mcm_cam = material_cornell(motion=True)
        pq, pq_cam = textured_quad("principled")
        check(sorted(set(mc.materials.mtype.tolist())) == [0, 1, 2, 3]
              and mcm.num_keys == 2 and not pq.all_diffuse
              and shade.texture_state(pq) == "diffuse" and pq.any_normal_map,
              "material Cornell box or principled quad malformed")
        k4d = phase_k4(dev, mc, mc_cam, 18, "K4 dispatch")
        k4md = phase_k4(dev, mcm, mcm_cam, 18, "K4 motion dispatch")
        k4td = phase_k4(dev, pq, pq_cam, 18, "K4 textured dispatch")
        k5d_run = k5_states(mc, mc_cam, dev, SORTED_POWER)
        k5d, = phase_k5(dev, {
            "K5 dispatch, power (material Cornell sorted, power)": k5d_run},
            18).values()
        gate(mc, mc_cam, dev, "material Cornell", 19)
        gate(mc, mc_cam, dev, "material Cornell, power", 19, **POWER)
        gate(mcm, mcm_cam, dev, "2-key material Cornell sample-major", 19,
             **SAMPLE_MAJOR)
        gate(pq, pq_cam, dev, "principled quad", 19)
        launches_k4d = full_size(
            "material cornell", mc, mc_cam, dev, smi, 20,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        launches_k5d = full_size(
            "material cornell sorted power", mc, mc_cam, dev, smi, 20,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SORTED_POWER, warm=k5d_run[4], profile=False)[1]
        launches_k4md = full_size(
            "2-key material cornell", mcm, mcm_cam, dev, smi, 20,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        launches_k4td = full_size(
            "principled quad", pq, pq_cam, dev, smi, 20,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",))[1]
        print(f"phase 20 (material Cornell, principled quad) done; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

        # ---- phases 21-23 on the fused pipeline: the AOV kernels, gates
        # and main paths, the denoiser and the CLI
        t0 = time.perf_counter()
        aov_entries = phase_fused_aov(dev)
        print(f"phase 21 (fused) done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gate(scene, camera, dev, "Cornell, aov", 22, **AOV)
        gate(scene, camera, dev, "Cornell sorted, aov", 22, **SORTED, **AOV)
        gate(*textured_quad("normal_map"), dev,
             "textured quad normal_map, aov", 22, **AOV)
        print(f"phase 22 (fused) done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        film_aov, launches_k4a = full_size(
            "cornell aov", scene, camera, dev, smi, 23,
            {"trace_shade_refill": shade.trace_shade_refill},
            ("refill_kernel",), AOV)
        launches_k5a = full_size(
            "cornell sorted aov", scene, camera, dev, smi, 23,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            dict(SORTED, **AOV), profile=False)[1]
        aov_path_report("cornell aov", "cornell")
        aov_path_report("cornell sorted aov", "cornell sorted")
        aov_pairs(dev, "cornell", scene, camera, {}, 4)
        phase_denoise_and_cli(dev, film_aov)
        del film_aov
        print(f"phase 23 (fused) done in {time.perf_counter() - t0:.1f} s; "
              f"{time.perf_counter() - t_start:.1f} s since the start")

        # ---- phase 7: K1/K2 and K3 on the 16054-face towns
        t0 = time.perf_counter()
        towns = {k: town_scene(TOWN_FACES, k) for k in (False, True)}
        for k, (s, _) in towns.items():
            check(s.num_faces == 16054 and s.num_keys == (2 if k else 1),
                  f"town: {s.num_faces} faces, {s.num_keys} keys")
        print(f"phase 7 towns generated and loaded in "
              f"{time.perf_counter() - t0:.2f} s: {towns[False][0].num_faces}"
              f" faces, {towns[False][0].num_lights} lights")
        t0 = time.perf_counter()
        states = {k: main_path_states(*towns[k], dev) for k in towns}
        print(f"phase 7 main-path inputs at iterations {SNAPSHOTS} of one "
              f"subframe of each town recorded in "
              f"{time.perf_counter() - t0:.2f} s")
        mt_res = phase_town_mt(dev, {
            False: (mt_scene_order(towns[False][0], dev), towns[False][1]),
            True: towns[True]}, states)

        # ---- phase 8: K6
        k6 = phase_k6(dev, towns, states)

        # ---- phase 15 on the textured towns: textured K6
        t0 = time.perf_counter()
        tex_towns = {k: town_scene(TOWN_FACES, k, textured=True)
                     for k in (False, True)}
        for k, (s, _) in tex_towns.items():
            check(s.num_faces == 16054 and s.num_keys == (2 if k else 1),
                  f"textured town: {s.num_faces} faces, {s.num_keys} keys")
            tids = sorted({int(t) for t in s.materials.diffuse_tex})
            check(shade.texture_state(s) == "diffuse"
                  and s.atlas.meta.shape[0] == 2 and tids == [-1, 0, 1],
                  f"textured town: atlas of {s.atlas.meta.shape[0]} "
                  f"textures, diffuse texture ids {tids}")
        tex_states = {k: main_path_states(*tex_towns[k], dev)
                      for k in tex_towns}
        print(f"phase 15 textured towns loaded (atlas "
              f"{tex_towns[False][0].atlas.data.shape[:2]}, 2 textures) and "
              f"their main-path inputs recorded in "
              f"{time.perf_counter() - t0:.2f} s")
        k6t = phase_k6(dev, tex_towns, tex_states, 15, "K6 textured")

        # ---- phase 9: the gate on the 4294-face town
        for k in (False, True):
            s, c = town_scene(GATE_TOWN_FACES, k)
            gate(s, c, dev, f"{'2-key' if k else 'static'} town "
                 f"({s.num_faces} faces)", 9)

        # ---- phase 10: the towns at full size
        launches_s = full_size(
            "static town", *towns[False], dev, smi, 10,
            {"mt_closest": mt.mt_closest, "mt_any": mt.mt_any,
             "external_shade": shade.external_shade},
            (*MT_SYMBOLS, "external_shade_kernel"),
            warm=states[False])[1]
        launches_m = full_size(
            "2-key town", *towns[True], dev, smi, 10,
            {"mt_closest_motion": mt.mt_closest_motion,
             "mt_any_motion": mt.mt_any_motion,
             "external_shade": shade.external_shade},
            (*MT_SYMBOLS, "external_shade_kernel"),
            warm=states[True], profile=False)[1]
        print(f"phase 10 done; {time.perf_counter() - t_start:.1f} s since "
              "the start")

        # ---- phases 16-17 on the textured towns
        for k in (False, True):
            s, c = town_scene(GATE_TOWN_FACES, k, textured=True)
            gate(s, c, dev, f"textured {'2-key' if k else 'static'} town "
                 f"({s.num_faces} faces)", 16)
        launches_st = full_size(
            "textured static town", *tex_towns[False], dev, smi, 17,
            {"mt_closest": mt.mt_closest, "mt_any": mt.mt_any,
             "external_shade": shade.external_shade},
            (*MT_SYMBOLS, "external_shade_kernel"),
            warm=tex_states[False], profile=False)[1]
        launches_mt = full_size(
            "textured 2-key town", *tex_towns[True], dev, smi, 17,
            {"mt_closest_motion": mt.mt_closest_motion,
             "mt_any_motion": mt.mt_any_motion,
             "external_shade": shade.external_shade},
            (*MT_SYMBOLS, "external_shade_kernel"),
            warm=tex_states[True], profile=False)[1]
        print(f"phase 17 done; {time.perf_counter() - t_start:.1f} s since "
              "the start")

        # ---- phases 18-20 on the principled towns (BASELINE config 5,
        # bench.py:517-520): K6's dispatch variants with the power pick
        t0 = time.perf_counter()
        p_towns = {k: town_scene(TOWN_FACES, textured=k == TEX_PT,
                                 principled=True) for k in (PT, TEX_PT)}
        for k, (s, _) in p_towns.items():
            mats = s.materials
            emissive = mats.emission.max(axis=1) > 0
            check(s.num_faces == 16054 and s.num_lights == 6
                  and (mats.mtype[~emissive] == 3).all()
                  and (shade.texture_state(s) == "diffuse") == (k == TEX_PT),
                  f"{k}: {s.num_faces} faces, {s.num_lights} lights, "
                  f"material types {mats.mtype.tolist()}")
        p_states = {k: main_path_states(*p_towns[k], dev, SORTED_POWER,
                                        P_SNAPSHOTS) for k in p_towns}
        print(f"phase 18 principled towns loaded (6 lights, every "
              f"non-emissive material PRINCIPLED) and their main-path inputs "
              f"recorded in {time.perf_counter() - t0:.2f} s")
        k6d, k6td = (phase_k6(dev, {k: p_towns[k]}, {k: p_states[k]}, 18,
                              label, POWER, P_SNAPSHOTS)
                     for k, label in ((PT, "K6 dispatch"),
                                      (TEX_PT, "K6 textured dispatch")))
        for textured in (True, False):
            s, c = town_scene(GATE_TOWN_FACES, textured=textured,
                              principled=True)
            what = f"{'textured ' if textured else ''}principled town " \
                f"({s.num_faces} faces), power"
            if textured:
                gate(s, c, dev, what, 19, **POWER)
            gate(s, c, dev, what + ", sorted", 19, **SORTED_POWER)
        town_kernels = {"mt_closest": mt.mt_closest, "mt_any": mt.mt_any,
                        "external_shade": shade.external_shade}
        launches_ptt = full_size(
            "principled town", *p_towns[TEX_PT], dev, smi, 20, town_kernels,
            (*MT_SYMBOLS, "external_shade_kernel"), SORTED_POWER,
            warm=p_states[TEX_PT], profile=False)[1]
        launches_pt = full_size(
            "untextured principled town", *p_towns[PT], dev, smi, 20,
            town_kernels, (*MT_SYMBOLS, "external_shade_kernel"),
            SORTED_POWER, warm=p_states[PT],
            profile=False)[1]
        print(f"phase 20 done; {time.perf_counter() - t_start:.1f} s since "
              "the start")

        # ---- phases 21-23 on the external pipeline: K6 AOV, the town's
        # AOV gate and BASELINE config 2's textured town with AOV
        t0 = time.perf_counter()
        aov_entries += phase_town_aov(dev, towns[False], tex_towns[False],
                                      p_towns)
        s, c = town_scene(GATE_TOWN_FACES, textured=True)
        gate(s, c, dev, f"textured town ({s.num_faces} faces) sorted, aov",
             22, **SORTED, **AOV)
        launches_ta = full_size(
            "textured town aov", *tex_towns[False], dev, smi, 23,
            town_kernels, (*MT_SYMBOLS, "external_shade_kernel"), AOV,
            plain=False, profile=False)[1]
        aov_path_report("textured town aov", "textured static town")
        print(f"phases 21-23 (towns) done in {time.perf_counter() - t0:.1f} "
              f"s; {time.perf_counter() - t_start:.1f} s since the start")

        # ---- phases 24-27: the hierwalk band
        walk_entries = walk_band(dev, smi, t_start)

        # ---- phases 28-31: trace-time instancing
        inst_entries, field_in, i_scenes = inst_band(dev, smi, t_start)

        # ---- phases 32-35: the resident-table walk (K8)
        rw_entries = resident_band(dev, smi, t_start)

        # ---- phases 37-40: K7 through the distributed route
        k7_entries = k7_band(dev, smi, t_start, field_in, i_scenes)

    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    mt_replaces = "rendertoy3c_tpu/trace/pallas_mt.py:"
    shade_replaces = "rendertoy3c_tpu/trace/pallas_shade.py:"
    kernels = [dict(name=n, route="cuda", source=K4_SRC,
                    replaces=f"{shade_replaces}{line}", launches=count,
                    **res, library_ms=None)
               for n, line, count, res in (
                   ("trace_shade_refill", 1329,
                    launches_c["trace_shade_refill"], k4),
                   ("trace_shade_refill_motion", 1329,
                    launches_km["trace_shade_refill"], k4m),
                   ("trace_shade", 1230, launches_k5["trace_shade"], k5s),
                   ("trace_shade_motion", 1230, launches_k5m["trace_shade"],
                    k5m))]
    for n, line in (("mt_closest", 353), ("mt_any", 353),
                    ("mt_closest_motion", 643), ("mt_any_motion", 643)):
        path_launches = launches_m if "motion" in n else launches_s
        kernels.append(dict(name=n, route="cuda", source=MT_SRC,
                            replaces=f"{mt_replaces}{line}",
                            launches=path_launches[n], **mt_res[n],
                            library_ms=None))
    kernels.append(dict(
        name="external_shade", route="cuda", source=K6_SRC,
        replaces="rendertoy3c_tpu/trace/pallas_shade.py:1778",
        launches=launches_s["external_shade"] + launches_m["external_shade"],
        **k6, library_ms=None))
    # the textured variants (textured=True of the same pallas_calls)
    kernels += [dict(name=n, route="cuda", source=src,
                     replaces=f"{shade_replaces}{line}", launches=count,
                     **res, library_ms=None)
                for n, src, line, count, res in (
                    ("trace_shade_refill_textured", K4_SRC, 1329,
                     launches_k4t["trace_shade_refill"], k4t),
                    ("trace_shade_refill_motion_textured", K4_SRC, 1329,
                     launches_k4mt["trace_shade_refill"], k4mt),
                    ("trace_shade_textured", K4_SRC, 1230,
                     launches_k5t["trace_shade"], k5t),
                    ("trace_shade_motion_textured", K4_SRC, 1230,
                     launches_k5mt["trace_shade"], k5mt),
                    ("external_shade_textured", K6_SRC, 1778,
                     launches_st["external_shade"]
                     + launches_mt["external_shade"], k6t))]
    # the dispatch variants (dispatch=True, power_cdf= of the same
    # pallas_calls)
    kernels += [dict(name=n, route="cuda", source=src,
                     replaces=f"{shade_replaces}{line}", launches=count,
                     **res, library_ms=None)
                for n, src, line, count, res in (
                    ("trace_shade_refill_dispatch", K4_SRC, 1329,
                     launches_k4d["trace_shade_refill"], k4d),
                    ("trace_shade_refill_motion_dispatch", K4_SRC, 1329,
                     launches_k4md["trace_shade_refill"], k4md),
                    ("trace_shade_refill_textured_dispatch", K4_SRC, 1329,
                     launches_k4td["trace_shade_refill"], k4td),
                    ("trace_shade_dispatch_power", K4_SRC, 1230,
                     launches_k5d["trace_shade"], k5d),
                    ("external_shade_dispatch_power", K6_SRC, 1778,
                     launches_pt["external_shade"], k6d),
                    ("external_shade_textured_dispatch_power", K6_SRC, 1778,
                     launches_ptt["external_shade"], k6td))]
    # the AOV instantiations (aov=True of the same pallas_calls) and the
    # dispatch instantiations timed since; the three with a phase 23 main
    # path take its launches
    for e in aov_entries:
        e["launches"] = {
            "trace_shade_refill_aov": launches_k4a["trace_shade_refill"],
            "trace_shade_aov": launches_k5a["trace_shade"],
            "external_shade_textured_aov": launches_ta["external_shade"],
        }.get(e["name"], e["launches"])
    kernels += aov_entries
    kernels += walk_entries
    kernels += inst_entries
    kernels += rw_entries
    kernels += k7_entries
    # the non-merged K5 (phase 36): its launches on the split paths
    kernels += [kernel_entry(n, K4_SRC, 1230, split[path][0],
                             NON_MERGED[label])
                for n, path, label in (
                    ("trace_shade_hit", SPLIT_PATHS[0][0],
                     "K5 (Cornell sorted)"),
                    ("trace_shade_hit_motion", SPLIT_PATHS[1][0],
                     "K5 motion (2-key Cornell sample-major)"))]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def mt_scene_order(scene, dev):
    """The static scene in the face order its pipeline traces (the Morton
    order choose_tracer applies)."""
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    return choose_tracer(scene, RenderConfig(**MAIN), dev)[0]


if __name__ == "__main__":
    sys.exit(main())
