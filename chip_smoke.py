#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (rendertoy3c_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from kernels/csrc, checks each against
its plain PyTorch version on the card, renders the Cornell main path at
full size through the user entry points, and prints a JSON summary. Phases:

  1. card, power limit, torch/CUDA versions, kernel build time;
  2. K1/K2 (mt_closest, mt_any) against their plain versions and the brute
     tracer on 131072 rays: prims and occlusion exact, t/u/v within 1e-6,
     the live-count skip; timed at the pool width of the main path;
  3. K4 (trace_shade_refill) against its plain version: teacher-forced for
     8 launches on one 256-lane block (deterministic claims), then one
     launch at the main path's pool width from a mid-render state (claims
     compared as a set keyed by pixel); timed per launch;
  4. the gate (bench.py:115-116) of kernels against plain versions at 96^2,
     2 spp, max_depth 6, ray_block 4096;
  5. the main path: Cornell 768^2, 8 spp, max_depth 16, ray_block 32768,
     pixel-major pool; 1 warm-up and 4 timed subframes with the kernels and
     with the plain versions; Mray/s counted as radiance + shadow rays; the
     kernel image's mean within 1% of the plain image's, every pixel
     finite; then a profile of one more subframe;
  6. the PNG of the kernel render.

Any failed phase exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import functools
import json
import os
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
MT_SRC = "rendertoy3c_tpu_torch/kernels/csrc/mt_kernels.cu"
K4_SRC = "rendertoy3c_tpu_torch/kernels/csrc/megakernel.cu"


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
        print(f"phase 2 {name}: exact prims vs plain and brute on {r} rays; "
              f"max|d| {err:.3g}; {ms:.4f} ms vs plain {plain_ms:.4f} ms "
              f"at {pool} rays")
    return results


# ---------------------------------------------------------------- phase 3
def _lane_state(pool, dev):
    import torch

    rays = torch.zeros((pool, 8), dtype=torch.float32, device=dev)
    misc = torch.zeros((pool, 16), dtype=torch.float32, device=dev)
    misc[:, 13] = -1.0
    stash = torch.zeros((pool, 16), dtype=torch.float32, device=dev)
    stash[:, 0] = -1.0
    return [rays, misc, stash]


def _compare_lanes(got, want, claimed_as_set: bool):
    """(max float error, lanes that differ) between two launch outputs
    [rays, misc, stash]; seeds (misc col 0) compared by bits. With
    claimed_as_set, the rows of lanes whose pixel ids differ are paired by
    pixel, since which lane claims which pixel depends on block order."""
    import torch

    rk, mk, sk = got
    rr, mr, sr = want
    # want_shadow (misc 15) and the stash belong to the lane's finished
    # path, the rest of a claiming lane's row to its new pixel
    lane_k = torch.cat([sk, mk[:, 15:16]], dim=1)
    lane_r = torch.cat([sr, mr[:, 15:16]], dim=1)
    rows_k = torch.cat([rk, mk[:, :15]], dim=1)
    rows_r = torch.cat([rr, mr[:, :15]], dim=1)
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


def phase_k4(dev, scene, camera):
    import torch

    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.trace import shade

    cfg = RenderConfig(**MAIN)
    n_pix = cfg.width * cfg.height
    p = camera.params()
    scf = tuple(float(x) for x in np.concatenate(
        [p.eye, p.u, p.v, p.w]).astype(np.float32))
    kern = shade.FusedPipeline(scene, cfg, dev).refill_shader(n_pix, True)
    ref = shade.FusedPipeline(scene, cfg, dev,
                              refill_fn=shade.trace_shade_refill_ref
                              ).refill_shader(n_pix, True)
    sub = 3

    def launch(fn, state, stats_in):
        out = [x.clone() for x in state]
        stats_out = torch.zeros(4, dtype=torch.int32, device=dev)
        fn(*out, stats_in, stats_out, 0, sub, scf)
        return out, stats_out

    # (a) one block, teacher-forced for 8 launches
    state = _lane_state(256, dev)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    err_a, bad_a = 0.0, 0
    for step in range(8):
        got, st_k = launch(kern, state, stats)
        want, st_r = launch(ref, state, stats)
        torch.cuda.synchronize()
        check(torch.equal(st_k, st_r),
              f"K4 block step {step}: stats {st_k.tolist()} != "
              f"{st_r.tolist()}")
        e, b = _compare_lanes(got, want, claimed_as_set=False)
        err_a, bad_a = max(err_a, e), bad_a + b
        state, stats = want, st_r
    check(bad_a <= 0.01 * 8 * 256, f"K4 block: {bad_a} lanes differ")
    print(f"phase 3 K4 one block x 8 launches: stats exact, {bad_a} lanes "
          f"differ, max|d| {err_a:.3g}")

    # (b) full pool width from a mid-render state of the plain version
    pool = cfg.ray_block
    state = _lane_state(pool, dev)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(12):
        state, stats = launch(ref, state, stats)
    got, st_k = launch(kern, state, stats)
    want, st_r = launch(ref, state, stats)
    torch.cuda.synchronize()
    check(torch.equal(st_k, st_r),
          f"K4 pool: stats {st_k.tolist()} != {st_r.tolist()}")
    err_b, bad_b = _compare_lanes(got, want, claimed_as_set=True)
    check(bad_b <= 0.001 * pool, f"K4 pool: {bad_b} lanes differ")
    print(f"phase 3 K4 {pool} lanes from launch 12: stats exact "
          f"{st_k.tolist()}, {bad_b} lanes differ, max|d| {err_b:.3g}")

    # each timed launch gets its own copy of the same input state
    stats_out = torch.zeros(4, dtype=torch.int32, device=dev)

    def calls(fn, n):
        return [functools.partial(fn, *[x.clone() for x in state], stats,
                                  stats_out, 0, sub, scf) for _ in range(n)]

    ms = cuda_ms(calls(kern, 41))
    plain_ms = cuda_ms(calls(ref, 6))
    print(f"phase 3 K4 time per launch at {pool} lanes: {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms")
    return dict(max_abs_err=max(err_a, err_b), ms=ms, plain_ms=plain_ms)


# ---------------------------------------------------------------- phase 4/5
def render(scene, camera, cfg_kw, dev, plain: bool, warmup: int, timed: int):
    """Render through make_render_fn, the plain versions if `plain`.
    Returns (film, Mray/s per timed subframe, launches, seconds per timed
    subframe, the step function)."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade

    cfg = RenderConfig(**cfg_kw)
    tracer = (shade.FusedPipeline(scene, cfg, dev,
                                  refill_fn=shade.trace_shade_refill_ref)
              if plain else None)
    step = make_render_fn(scene, cfg, tracer=tracer, device=dev)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=dev)
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


def profile_subframe(step, film, camera, untraced_s: float):
    """Device time by kernel over one subframe (torch.profiler, CUDA
    activity only). The idle share is taken against the median untraced
    subframe, since tracing slows the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cam = camera.params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(cam, film)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        rows.append((dt, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"phase 5 profile of one subframe: device busy {busy:.4f} s; "
          f"traced wall {wall:.4f} s; untraced median {untraced_s:.4f} s; "
          f"idle share {max(0.0, 1 - busy / untraced_s):.3f} of untraced")
    for dt, key, cnt in rows[:8]:
        print(f"  {dt / 1e3:10.3f} ms  x{cnt:<6d} {key[:70]}")


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
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.strip())

        meshes, camera = cornell_box()
        scene = build_scene(meshes)

        # ---- phase 2: K1/K2
        mt_res = phase_mt(dev, scene, camera)

        # ---- phase 3: K4
        k4 = phase_k4(dev, scene, camera)

        # ---- phase 4: the gate at 96^2
        f_k, _, _, _, _ = render(scene, camera, GATE, dev, False, 0, 1)
        f_p, _, _, _, _ = render(scene, camera, GATE, dev, True, 0, 1)
        mean_d, outl, max_d = gate_diff(f_k.accum.cpu().numpy(),
                                        f_p.accum.cpu().numpy())
        check(mean_d <= 2e-3 and outl <= 8 and max_d <= 8.0,
              f"gate failed: mean|d| {mean_d:.3g}, {outl} outliers, "
              f"max|d| {max_d:.3g}")
        print(f"phase 4 gate 96^2 2spp kernels vs plain: mean|d| "
              f"{mean_d:.3g}, outliers {outl}, max|d| {max_d:.3g}")

        # ---- phase 5: the main path
        shade.trace_shade_refill.launches = 0
        mt.mt_closest.launches = 0
        mt.mt_any.launches = 0
        film_k, rates_k, it_k, secs_k, step_k = render(
            scene, camera, MAIN, dev, False, 1, 4)
        launches = {"trace_shade_refill": shade.trace_shade_refill.launches,
                    "mt_closest": mt.mt_closest.launches,
                    "mt_any": mt.mt_any.launches}
        check(launches["trace_shade_refill"] > 0,
              "main path launched trace_shade_refill no time")
        film_p, rates_p, _, secs_p, _ = render(scene, camera, MAIN, dev,
                                               True, 1, 4)
        img_k = film_k.accum.cpu().numpy()
        img_p = film_p.accum.cpu().numpy()
        check(bool(np.isfinite(img_k).all()), "kernel image not finite")
        check(img_k.shape == (768, 768, 3), f"image shape {img_k.shape}")
        rel = abs(img_k.mean() - img_p.mean()) / img_p.mean()
        check(rel <= 0.01, f"image mean {img_k.mean()} vs plain "
              f"{img_p.mean()} ({rel:.3%})")
        print(f"phase 5 main path 768^2 8spp depth 16 pool 32768 on {smi}:")
        print(f"  kernels: Mray/s per subframe {rates_k}, median "
              f"{float(np.median(rates_k)):.6g}; s {secs_k}; "
              f"{it_k / 4:.1f} launches/subframe")
        print(f"  plain:   Mray/s per subframe {rates_p}, median "
              f"{float(np.median(rates_p)):.6g}; s {secs_p}")
        print(f"  image mean kernels {img_k.mean():.6f}, plain "
              f"{img_p.mean():.6f} (rel {rel:.3g}); launches {launches}")
        try:  # informational: the render phases above decide the result
            profile_subframe(step_k, film_k, camera,
                             float(np.median(secs_k)))
        except Exception as e:  # noqa: BLE001
            print(f"phase 5 profile: not measured ({type(e).__name__}: {e})")

        # ---- phase 6: PNG
        out_dir = tempfile.mkdtemp(prefix="rt3c_smoke_")
        png = os.path.join(out_dir, "cornell_768.png")
        write_png(png, np.ascontiguousarray(
            make_color(film_k.accum, alpha=False).cpu().numpy()[::-1]))
        print(f"phase 6 wrote {png}")
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    kernels = [dict(name="trace_shade_refill", route="cuda", source=K4_SRC,
                    replaces="rendertoy3c_tpu/trace/pallas_shade.py:1329",
                    launches=launches["trace_shade_refill"], **k4)]
    checks = [
        dict(name=n, route="cuda", source=MT_SRC,
             replaces="rendertoy3c_tpu/trace/pallas_mt.py:353",
             launches_in_main_path=launches[n],
             inlined_in="trace_shade_refill (csrc/mt.cuh)", **mt_res[n])
        for n in ("mt_closest", "mt_any")]
    print(json.dumps({"kernel_checks": checks}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
