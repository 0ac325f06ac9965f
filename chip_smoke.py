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
     tracer on 131072 Cornell rays: prims and occlusion exact, t/u/v
     within 1e-6, the live-count skip;
  3. K4 (trace_shade_refill) against its plain version: teacher-forced for
     8 launches on one 256-lane block (deterministic claims), then one
     launch at the main path's pool width from a mid-render state (claims
     compared as a set keyed by pixel); its device time per launch there
     (device_ms, as phase 8's);
  4. the gate (bench.py:115-116) of kernels against plain versions at 96^2,
     2 spp, max_depth 6, ray_block 4096;
  5. the Cornell main path: 768^2, 8 spp, max_depth 16, ray_block 32768,
     pixel-major pool; 1 warm-up and 4 timed subframes with the kernels
     and with the plain versions; Mray/s counted as radiance + shadow rays;
     the kernel image's mean within 1% of the plain image's, the first
     subframes through the gate, every pixel finite; then a profile of one
     more subframe;
  6. the PNG of the kernel render;
  7. K1/K2 on the static and K3 (mt_closest_motion, mt_any_motion) on the
     2-key 16054-face town, against their plain versions and the brute
     tracer on 131072 rays (camera rays and one cosine bounce, uniform
     random times): prims and occlusion exact, t/u/v within 1e-6, the
     count skip on 128-ray tiles for K3; then against their plain versions
     again, timed and bounded, on the main path's own inputs: those of
     pool iterations 32, 128, 224 and 320 of one subframe of each town;
  8. K6 (external_shade) teacher-forced against its plain version at 32768
     lanes for 8 iterations on both towns: every output bit for bit; then
     bit for bit again on the main paths' inputs of phase 7, and its
     device time per launch there (device_ms: CUDA events around the
     launches queued behind a spin kernel);
  9. the gate of phase 4 on the external path, the 4294-face town, static
     and 2-key;
 10. both 16054-face towns at the main path's config: 1 warm-up and 4
     timed subframes with the kernels, 1 with the plain versions; Mray/s,
     launches per subframe, image means within 1%, the first subframes
     through the gate, every pixel finite, and the device idle share of
     one profiled subframe (a phase fails if its profile shows no device
     time or misses one of its kernels);
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
 14. three more main paths as phase 5, 1 plain subframe each: the 2-key
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
 17. the textured main paths as phase 5, 1 plain subframe each: the
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
 20. the dispatch main paths as phase 5, 1 plain subframe each: the
     material Cornell box pixel-major (K4 dispatch) and sorted with the
     power pick (K5 dispatch), the 2-key material Cornell box (K4 motion
     dispatch), the principled quad (textured K4 dispatch), and the
     principled towns, power, sorted: textured, BASELINE config 5 at the MT
     band's top (K1/K2 + textured K6 dispatch), and untextured (K1/K2 + K6
     dispatch).

Each kernel's bound is the larger of the bytes it must move over 3.35 TB/s
and the operations its inputs need over the 67 TFLOP/s fp32 peak outside
the tensor cores (H100 SXM data sheet): for the MT sweeps, each ray's own
box tests and the triangle tests of the tiles whose boxes it hits itself
(closest rays bounded by their best hit so far, any-hit rays stopping at
their first hit), replayed with the plain per-tile results; for the
shading, its body per lane, with the texture work, the material dispatch
and the power pick where the variant runs them.

Phases 11-14, on the Cornell box, and the textured quad's, the material
Cornell box's and the principled quad's parts of phases 15-20 run after
phase 6 and before the towns, the textured towns' phase 15 right after
phase 8, their phases 16-17 after phase 10, and the principled towns'
phases 18-20 last.
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
GATE_TOWN_FACES = 4000  # 4294 faces
MT_SRC = "rendertoy3c_tpu_torch/kernels/csrc/mt_kernels.cu"
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
    itself, and the triangles of each tile whose box it hits itself (the
    kernel's block vote lets a ray into every tile that any ray of its
    block hits, which this count does not charge). A closest ray's bound
    shrinks with its best hit so far; an any-hit ray stops at its first
    hit; rays past the live count (in ray tiles of `tile`, by default the
    MT kernel's), outside `want` (a megakernel's lanes without a shadow
    ray) or with tmax <= tmin need nothing. A tile's bytes count once if
    any ray tests it."""
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
        staged += 1
        sub = tuple(c[idx] for c in cols)
        extra = (table.tris1[k], time[idx, None]) if motion else ()
        t, _, _, hit, _ = mt.mt_test(sub, tris[k], k * ct, *extra)
        if any_hit:
            anyh = hit.any(dim=1)
            tests[idx] += torch.where(anyh, hit.int().argmax(dim=1) + 1, ct)
            done[idx] = anyh
        else:
            tests[idx] += ct
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
    table_bytes = (staged * 9 * ct * 4 * (2 if motion else 1)
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
            exact_col = 1 if name == "mt_closest" else 0  # prim / occluded
            check(torch.equal(got[:, exact_col], want[:, exact_col]),
                  f"{name}: prim/occlusion differs from the plain version")
            diff = (got - want).abs()
            check(bool((diff <= 1e-6 + 1e-6 * want.abs()).all()),
                  f"{name}: t/u/v differ from the plain version by "
                  f"{diff.max().item()}")
            err = max(err, diff.max().item())
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


def megakernel_work(rays, misc, count, time, tables, sc):
    """(operations, table bytes) of one megakernel launch (K4 or K5) on
    these lanes: the closest and the shadow sweep, counted by mt_work on
    256-ray tiles (the shadow rays, their wants and their times from the
    plain shading body), the shading body of every lane, its texture work
    (texture_work), and the AOV rows where sc.aov."""
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
    from rendertoy3c_tpu_torch.trace import mt, shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    scene, pipe = choose_tracer(scene, cfg, dev)
    if isinstance(pipe, shade.FusedPipeline):
        return scene, shade.FusedPipeline(
            scene, cfg, dev, refill_fn=shade.trace_shade_refill_ref,
            shade_fn=shade.trace_shade_ref)
    return scene, shade.ExternalPipeline(
        scene, cfg, mt.make_mt_tracer(scene, dev, plain=True), dev,
        shade_fn=shade.external_shade_ref)


def render(scene, camera, cfg_kw, dev, plain: bool, warmup: int, timed: int):
    """Render through make_render_fn, the plain versions if `plain`.
    Returns (film, Mray/s per timed subframe, launches, seconds per timed
    subframe, the step function, the film's buffers after the first
    subframe: [accum] and with AOV the albedo and normal buffers)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn

    cfg = RenderConfig(**cfg_kw)
    tracer = None
    if plain:
        scene, tracer = plain_tracer(scene, cfg, dev)
    step = make_render_fn(scene, cfg, tracer=tracer, device=dev)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=dev, aov=cfg.aov)

    def buffers(film):
        return [b.clone() for b in (film.accum, film.albedo, film.normal)
                if b is not None]

    first = None
    for _ in range(warmup):
        film, _ = step(cam, film)
        first = buffers(film) if first is None else first
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
        first = buffers(film) if first is None else first
    return film, rates, launches, secs, step, first


def gate_diff(a, b):
    diff = np.abs(a - b)
    return diff.mean(), int((diff.max(axis=-1) > 0.35).sum()), diff.max()


def gate(scene, camera, dev, what: str, phase: int, **change):
    """The gate (bench.py:115-116) of kernels against plain versions on
    the GATE config with `change` applied; with AOV, all three buffers of
    the (first and only) subframe bit-equal too."""
    import torch

    cfg_kw = dict(GATE, **change)
    f_k = render(scene, camera, cfg_kw, dev, False, 0, 1)[0]
    f_p = render(scene, camera, cfg_kw, dev, True, 0, 1)[0]
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
    rt3c::mt_kernel<false>(...)' -> 'mt_kernel'), else None."""
    m = re.search(r"rt3c::(\w+)", key)
    return m.group(1) if m else None


def device_rows(run):
    """[(device us, kernel name, launches)] of the CUDA kernels that
    run() launches, from torch.profiler (CUDA activity only), largest
    first. The device events are summed by name straight from the
    profiler's raw results: key_averages() builds an event tree in Python,
    which took ~9 s per 1e5 events and made a traced town subframe last
    ~26 s; its sums are the same."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        row = sums.setdefault(e.name(), [0.0, 0])
        row[0] += e.duration_ns() / 1e3
        row[1] += 1
    return sorted(((us, key, n) for key, (us, n) in sums.items()),
                  reverse=True)


def device_ms(calls) -> float:
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
                     kernels):
    """Device time by kernel over one subframe. The idle share is taken
    against the median untraced subframe, since tracing slows the host.
    Fails unless the profiler saw each of `kernels` (CUDA symbol names)
    launched. Returns the idle share."""
    cam = camera.params()
    t0 = time.perf_counter()
    rows = device_rows(lambda: step(cam, film))
    wall = time.perf_counter() - t0
    busy = sum(r[0] for r in rows) / 1e6
    check(busy > 0, f"phase {phase} profile: no device time recorded")
    idle = max(0.0, 1 - busy / untraced_s)
    print(f"phase {phase} profile of one subframe: device busy {busy:.4f} "
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
    return idle


def full_size(name, scene, camera, dev, smi, phase: int, counters, symbols,
              change=None, n_plain=1):
    """One main path at full size (MAIN with `change` applied): kernels (1
    warm-up, 4 timed) with the launch counters zeroed just before and read
    just after, then the plain versions (n_plain subframes, the last 4 of
    them timed), means compared, a profile that must see each CUDA kernel
    of `symbols`. With AOV the first subframes' albedo and normal buffers
    must be bit-equal too. n_plain=0 renders no plain subframe: the path's
    kernels and gate are held elsewhere. Records (median Mray/s, idle
    share) in PATHS[name]; returns (kernel film, launches by kernel)."""
    import torch

    cfg_kw = dict(MAIN, **(change or {}))
    for fn in counters.values():
        fn.launches = 0
    film_k, rates_k, it_k, secs_k, step_k, first_k = render(
        scene, camera, cfg_kw, dev, False, 1, 4)
    launches = {n: fn.launches for n, fn in counters.items()}
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
          f"{it_k / 4:.1f} launches/subframe")
    if n_plain:
        plain_timed = min(n_plain, 4)
        film_p, rates_p, _, secs_p, _, first_p = render(
            scene, camera, cfg_kw, dev, True, n_plain - plain_timed,
            plain_timed)
        img_p = film_p.accum.cpu().numpy()
        rel = abs(img_k.mean() - img_p.mean()) / img_p.mean()
        check(rel <= 0.01, f"{name}: image mean {img_k.mean()} vs plain "
              f"{img_p.mean()} ({rel:.3%})")
        # the first subframes: the same estimator on the same streams
        mean_d, outl, max_d = gate_diff(first_k[0].cpu().numpy(),
                                        first_p[0].cpu().numpy())
        check(mean_d <= 2e-3 and outl <= 8 and max_d <= 8.0,
              f"{name}: first subframe fails the gate: mean|d| {mean_d:.3g}, "
              f"{outl} outliers, max|d| {max_d:.3g}")
        for k, p in zip(first_k[1:], first_p[1:]):
            check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
                  f"{name}: the first subframes' AOV buffers differ")
        print(f"  plain:   Mray/s per subframe {rates_p}, median "
              f"{float(np.median(rates_p)):.6g}; s {secs_p}")
        print(f"  image mean kernels {img_k.mean():.6f}, plain "
              f"{img_p.mean():.6f} (rel {rel:.3g}) over 5 and {n_plain} "
              f"subframes; first subframe kernels vs plain: mean|d| "
              f"{mean_d:.3g}, max|d| {max_d:.3g}"
              f"{', AOV buffers bit-equal' if len(first_k) > 1 else ''}")
    print(f"  image mean {img_k.mean():.6f}; launches {launches}"
          + (f"; albedo mean {float(film_k.albedo.mean()):.6f}"
             if film_k.albedo is not None else ""))
    idle = profile_subframe(step_k, film_k, camera, float(np.median(secs_k)),
                            phase, symbols)
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
    closest], "launches": {kernel: launches in that subframe}}."""
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
    step(camera.params(), film_create(cfg.height, cfg.width, device=dev,
                                      aov=cfg.aov))
    torch.cuda.synchronize()
    check(all(len(v) == len(snapshots) for v in states.values()),
          f"main path: {seen} iterations, too few for the snapshots")
    states["launches"] = {n: fn.launches for n, fn in counters.items()}
    return states


def time_on_states(kern, ref, table, inputs, any_hit, motion):
    """An MT kernel on the main path's inputs [(o, d, tmin, tmax, time,
    count)], packed as the tracer packs them: checked against its plain
    version (prim/occlusion exact, t/u/v within 1e-6), then (ms, plain ms,
    bound ms, bound by) of the mean launch and the largest difference."""
    import torch

    from rendertoy3c_tpu_torch.trace import mt

    tile = mt.MOTION_RAY_TILE if motion else mt.RAY_TILE
    launches, err = [], 0.0
    for o, d, tmin, tmax, tm, count in inputs:
        rays, r = mt.pack_rays(o, d, tmin, tmax, tile)
        check(r == rays.shape[0], "a pool of whole ray tiles")
        a = (rays, *((tm.contiguous(),) if motion else ()), count.reshape(1),
             table)
        got, want = kern(*a), ref(*a)
        col = 0 if any_hit else 1
        diff = (got - want).abs()
        check(torch.equal(got[:, col], want[:, col])
              and bool((diff <= 1e-6 + 1e-6 * want.abs()).all()),
              f"{kern.__name__} differs from its plain version on the main "
              "path's inputs")
        err = max(err, diff.max().item())
        launches.append(a)
    ms = cuda_ms([functools.partial(kern, *a) for a in launches] * 12)
    plain_ms = cuda_ms([functools.partial(ref, *a) for a in launches])
    costs = [mt_cost(a[0], a[-2], table, any_hit, a[1] if motion else None)
             for a in launches]
    return (ms, plain_ms, *mean_bound(costs), err)


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
                col = 0 if any_hit else 1
                check(torch.equal(got[:, col], want[:, col]),
                      f"{name}: prim/occlusion differs from the plain version")
                diff = (got - want).abs()
                check(bool((diff <= 1e-6 + 1e-6 * want.abs()).all()),
                      f"{name}: t/u/v differ from the plain version by "
                      f"{diff.max().item()}")
                err = max(err, diff.max().item())
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
            ms, plain_ms, bound_ms, bound_by, e = time_on_states(
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
                  f"{bound_ms:.4f} ms by {bound_by}")
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
    that subframe): the inputs of K5 at the pool iterations `snapshots` of
    one kernel subframe of the main path with `change` (through
    make_render_fn with choose_tracer's pipeline)."""
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
    step(camera.params(), film_create(cfg.height, cfg.width, device=dev,
                                      aov=cfg.aov))
    torch.cuda.synchronize()
    launches = shade.trace_shade.launches
    pipe.shade_fn = fn
    check(len(states) == len(snapshots) and launches > 0,
          f"K5 path: {seen[0]} iterations, too few for the snapshots")
    return pipe, states, snapshots, launches


def phase_k5(dev, runs, phase=12):
    """K5 against trace_shade_ref on the recorded main-path inputs of each
    run ({label: (pipeline, states)}): lanes compared bit for bit (and
    within 1e-5 where not), device time per launch (device_ms), the
    plain version's time and the bound."""
    import torch

    from rendertoy3c_tpu_torch.trace import shade

    results = {}
    for label, (pipe, states, snapshots, _) in runs.items():
        launches, costs, err, n_diff, n_bad = [], [], 0.0, 0, 0
        prims, lives = [], []
        for rays, misc, count, tm in states:
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
    return results


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
    print(f"phase 23 {name}: {rate:.6g} Mray/s (idle {idle:.3f}) vs "
          f"{base} without AOV {rate0:.6g} Mray/s (idle {idle0:.3f}): "
          f"{rate / rate0:.4f}x")


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
            ("refill_kernel",), n_plain=5)

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
        k5 = phase_k5(dev, {
            "K5 (Cornell sorted)": k5_states(scene, camera, dev, SORTED),
            "K5 motion (2-key Cornell sample-major)": k5_states(
                m_scene, m_camera, dev, SAMPLE_MAJOR)})
        k5s, k5m = k5.values()

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
            SORTED)[1]
        launches_k5m = full_size(
            "2-key cornell sample-major", m_scene, m_camera, dev, smi, 14,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SAMPLE_MAJOR)[1]
        print(f"phase 14 done; {time.perf_counter() - t_start:.1f} s since "
              "the start")

        # ---- phases 15-17 on the textured quad, static and 2-key
        tq, tq_cam = textured_quad()
        tqm, tqm_cam = textured_quad(motion=True)
        check(shade.texture_state(tq) == "diffuse" and tqm.num_keys == 2,
              "textured quad: not textured or not 2-key")
        k4t = phase_k4(dev, tq, tq_cam, 15, "K4 textured")
        k4mt = phase_k4(dev, tqm, tqm_cam, 15, "K4 motion textured")
        k5t, k5mt = phase_k5(dev, {
            "K5 textured (textured quad sorted)": k5_states(
                tq, tq_cam, dev, SORTED, QUAD_SNAPSHOTS),
            "K5 motion textured (2-key textured quad sample-major)":
                k5_states(tqm, tqm_cam, dev, SAMPLE_MAJOR, QUAD_SNAPSHOTS)},
            15).values()
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
            SORTED)[1]
        launches_k5mt = full_size(
            "2-key textured quad sample-major", tqm, tqm_cam, dev, smi, 17,
            {"trace_shade": shade.trace_shade}, ("trace_shade_kernel",),
            SAMPLE_MAJOR)[1]
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
        k5d, = phase_k5(dev, {
            "K5 dispatch, power (material Cornell sorted, power)": k5_states(
                mc, mc_cam, dev, SORTED_POWER)}, 18).values()
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
            SORTED_POWER)[1]
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
            dict(SORTED, **AOV))[1]
        aov_path_report("cornell aov", "cornell")
        aov_path_report("cornell sorted aov", "cornell sorted")
        aov_pairs(dev, "cornell", scene, camera, {}, 4)
        aov_pairs(dev, "cornell sorted", scene, camera, SORTED, 1)
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
            ("mt_kernel", "external_shade_kernel"))[1]
        launches_m = full_size(
            "2-key town", *towns[True], dev, smi, 10,
            {"mt_closest_motion": mt.mt_closest_motion,
             "mt_any_motion": mt.mt_any_motion,
             "external_shade": shade.external_shade},
            ("mt_motion_kernel", "external_shade_kernel"))[1]
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
            ("mt_kernel", "external_shade_kernel"))[1]
        launches_mt = full_size(
            "textured 2-key town", *tex_towns[True], dev, smi, 17,
            {"mt_closest_motion": mt.mt_closest_motion,
             "mt_any_motion": mt.mt_any_motion,
             "external_shade": shade.external_shade},
            ("mt_motion_kernel", "external_shade_kernel"))[1]
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
            ("mt_kernel", "external_shade_kernel"), SORTED_POWER)[1]
        launches_pt = full_size(
            "untextured principled town", *p_towns[PT], dev, smi, 20,
            town_kernels, ("mt_kernel", "external_shade_kernel"),
            SORTED_POWER)[1]
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
            town_kernels, ("mt_kernel", "external_shade_kernel"), AOV,
            n_plain=0)[1]
        aov_path_report("textured town aov", "textured static town")
        print(f"phases 21-23 (towns) done in {time.perf_counter() - t0:.1f} "
              f"s; {time.perf_counter() - t_start:.1f} s since the start")

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
