"""Times one workload of checkouts of the port in turns (the roots in
order, then reversed: A, B, B, A for two), each turn a process of its own
on the first CUDA card. Prints the card's name and power limit, one JSON
line per turn, then the mean of each number per checkout and whether the
checkouts' outputs agree (exit 1 if they do not).

    python rendertoy3c_tpu_torch/tools/ab.py WORKLOAD ROOT [ROOT ...]

Workloads:

  mt-sweep       the plain MT sweeps (`closest_ref`, `any_ref`): one
                 plain 768^2 8-spp depth-16 subframe (pool 32768) of the
                 16054-face static town, every sweep call in it timed on
                 the host clock between two synchronizes (the plain sweep
                 waits on the card once per tile anyway); the outputs
                 agree when the images' accum sums are equal.
  resident-walk  whole resident-table walks (K8, `--tracer
                 residentwalk`): bench's 49k box field, split-ordered as
                 the CLI orders it, one 768^2 8-spp depth-16 subframe of
                 the general pool (pool 32768, sorted: bench's
                 cfg_sorted) through make_walk_tracer's pair, recording
                 the inputs of every 10th closest and shadow call; then 4
                 of each, spread over the subframe, each walk
                 (trace_closest_walk / trace_any_walk) run 3 times: K8
                 launches per walk and the host ms per walk between two
                 synchronizes; and its K8 launch (walk_closest / walk_any
                 on the walk's packed rays, to the pass cap) run 3 times
                 as walk-round's: device ms per walk; the outputs agree
                 when every walk's output bits hash alike.
  walk-round     the walk pool's rounds (K9, K9-inst): the pool states at
                 boundaries 8, 40, 100 and 200 of one 768^2 8-spp
                 depth-16 subframe of the 50000-face town (K9) and of the
                 2-key 578-instance field (`multi_instance_motion`,
                 K9-inst), each with tune_config's pool; then each
                 recorded launch (16 and 20 rounds) run 3 times, each from
                 a clone of its state: device ms per launch (`_queued_ms`:
                 CUDA events around the 3 launches queued behind a spin
                 kernel), the
                 walking lane-rounds per launch (the `rows` count) and the
                 host ms per launch between two synchronizes; the outputs
                 agree when every state column's bits hash alike.
  instanced-mt   K7 (`trace_instanced`, closest and any) on the K7 path's
                 inputs: one 768^2 8-spp depth-16 subframe (pool 32768)
                 of the trace-time Cornell (`multi_instance_tracetime`)
                 through make_instanced_mt_tracer's pair under the general
                 pool, recording every 100th closest and shadow call, 4 of
                 each with at least half a pool live, spread over the
                 subframe; and 131072 camera rays of the 768^2 image of
                 the static instance field at grid 8, split-ordered
                 (closest at tmax 1e16, any at seeded tmax in [0.5, 60]):
                 `field` the first 131072 pixels, phase 37's rays (the
                 image's bottom rows, every ray on the floor), and
                 `field_spread` pixels spread over the image, which enter
                 the 972-face towers.
                 Each launch run 3 times: device ms per launch
                 (`_queued_ms`); the outputs agree when every launch's
                 output bits hash alike on its rays that start within
                 FAR of the origin (the shadow rays of lanes that missed
                 start at o + 1e16 d; the pool reads none of their
                 occlusion, and there the vote's answer and the per-ray
                 cull's differ: instanced_mt.cu's source note).
  megakernel     K4 (`trace_shade_refill`) and K5 (`trace_shade`) on their
                 paths' inputs: one 768^2 8-spp depth-16 subframe (pool
                 32768) of each of MEGA_PATHS through choose_tracer's
                 fused pipeline (K4: Cornell pixel-major, the 2-key
                 Cornell box, the textured quad, the material Cornell
                 box, Cornell with AOV; K5: Cornell sorted, the 2-key
                 Cornell box sample-major), recording every 40th call, 4
                 of each path with at least half the pool live (and, for
                 K4, a pool's worth of pixels left to claim), spread over
                 the subframe; every turn times the first turn's picks
                 (which lane claims which pixel depends on block order,
                 and so does the state a K4 subframe reaches). Each
                 launch run 3 times, each from a clone of its state:
                 device ms per launch (`_queued_ms`); the outputs agree
                 when their digests do, K4's taken with the lanes that
                 claimed a pixel sorted by pixel (`_k4_digest`).
  external-shade K6 (`external_shade`) on its paths' inputs: one subframe
                 of each of K6_PATHS through choose_tracer's pipeline (with
                 tune_config), K6's inputs recorded at its pool
                 iterations or walk boundaries as chip_smoke.py's
                 phases 8, 15, 18, 21, 25 and 31 record them: the 16054-
                 face MT towns (static, with AOV, textured, principled and
                 textured principled with the power pick; row-major misc,
                 32768 lanes), the walk pool on the 50000-face towns
                 (config 1 at 1920x1080, the textured town sorted and
                 with AOV, the textured principled town sorted with the
                 power pick; C-major misc) and on the 578-instance field
                 (`multi_instance_large`, C-major instance rows), and
                 `multi_instance_tracetime` (row-major instance rows);
                 every turn times the first turn's inputs and tables
                 (saved as plain tensors, rebuilt into each checkout's
                 own ExternalTables). Each launch run 3 times: device ms
                 per launch (`_queued_ms`); the outputs agree when their
                 digests do.
"""
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

MAIN = dict(width=768, height=768, samples_per_launch=8, max_depth=16,
            ray_block=32768, integrator="pool", pool_pixel_major=True)
TOWN_FACES = 16000  # generate_town gives 16054 faces
RECORD_EVERY = 10
PICKS = 4
REPEATS = 3


def mt_sweep() -> dict:
    """One plain town subframe, its sweep calls timed."""
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.town import town_scene
    from rendertoy3c_tpu_torch.trace import mt, shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    dev = torch.device("cuda")
    times = {"closest": [], "any": []}

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    mt.closest_ref = timed("closest", mt.closest_ref)
    mt.any_ref = timed("any", mt.any_ref)
    scene, camera = town_scene(TOWN_FACES)
    cfg = RenderConfig(**MAIN)
    scene, _ = choose_tracer(scene, cfg, dev)
    tracer = shade.ExternalPipeline(
        scene, cfg, mt.make_mt_tracer(scene, dev, plain=True), dev,
        shade_fn=shade.external_shade_ref)
    step = make_render_fn(scene, cfg, tracer=tracer, device=dev)
    film = film_create(cfg.height, cfg.width, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, stats = step(camera.params(), film)
    torch.cuda.synchronize()
    accum = float(film.accum.double().sum())
    out = dict(subframe_s=time.perf_counter() - t0,
               launches=int(stats.pool_iters), accum_sum=accum,
               identity=accum)
    for kind, ms in times.items():
        out[kind] = dict(calls=len(ms), mean_ms=statistics.fmean(ms),
                         median_ms=statistics.median(ms))
    out["means"] = {f"{k}_mean_ms": out[k]["mean_ms"] for k in times}
    return out


def _digest(tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in (t for t in tensors if t is not None):
        h.update(t.contiguous().view(torch.int32 if t.dtype != torch.bool
                                     else torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _queued_ms(calls) -> float:
    """Mean device ms per call of `calls` (a list of fresh calls each
    time), queued behind a spin kernel between two CUDA events so that the
    events time the kernels back to back and not the host's launch work
    (chip_smoke.py's device_ms); the spin lengthens until it outlasts the
    queueing."""
    import torch

    cycles = int(0.05 * 2e9)  # the spin counts SM clock cycles, ~2 GHz
    for _ in range(4):
        queue = calls()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for call in queue:
            call()
        held = not a.query()
        b.record()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / len(queue)
        cycles *= 4
    raise RuntimeError("the spin kernel never outlasted the queueing")


def resident_walk() -> dict:
    """One recorded subframe, then the timed walks."""
    import numpy as np
    import torch

    from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.builtin import box_field
    from rendertoy3c_tpu_torch.scene.scene import build_scene
    from rendertoy3c_tpu_torch.trace import residentwalk as rw

    dev = torch.device("cuda")
    meshes, camera = box_field()
    scene = split_order_scene(build_scene(meshes))
    closest, any_hit = rw.make_walk_tracer(scene, dev)
    tab = closest.table
    rec = {"closest": [], "any": []}
    calls = {"closest": 0, "any": 0}

    def recording(kind, fn):
        def walk(o, d, tmin, tmax, time=None, count=None):
            calls[kind] += 1
            if calls[kind] % RECORD_EVERY == 0:
                c = (count.clone() if isinstance(count, torch.Tensor)
                     else count)
                tm = (tmax.clone() if isinstance(tmax, torch.Tensor)
                      else tmax)
                rec[kind].append((o.clone(), d.clone(), tmin, tm, c))
            return fn(o, d, tmin, tmax, time, count=count)
        return walk

    cfg = RenderConfig(**MAIN, sort_rays=True)
    step = make_render_fn(scene, cfg, tracer=(
        recording("closest", closest), recording("any", any_hit)),
        device=dev)
    film = film_create(cfg.height, cfg.width, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, stats = step(camera.params(), film)
    torch.cuda.synchronize()
    out = dict(subframe_s=time.perf_counter() - t0,
               accum_sum=float(film.accum.double().sum()), calls=calls)
    for kind, trace, counter in (
            ("closest", rw.trace_closest_walk, rw.walk_closest),
            ("any", rw.trace_any_walk, rw.walk_any)):
        live = [r for r in rec[kind] if int(r[4]) > 0]
        pick = [live[int(i)] for i in np.linspace(0, len(live) - 1, PICKS)]
        rows = []
        for o, d, tmin, tmax, count in pick:
            res = trace(tab, o, d, tmin, tmax, count=count)
            bits = _digest(list(res) if kind == "closest" else [res])
            before = counter.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPEATS):
                trace(tab, o, d, tmin, tmax, count=count)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / REPEATS
            launches = (counter.launches - before) / REPEATS
            rays, r = rw._pack(o, d, tmin, tmax, rw.RT)
            er, ir = rw._start(rays, rw.RT)
            a = (rw._count(count, r, dev), er, ir, rays, tab, rw.RT,
                 rw.T_ROUNDS, rw.pass_cap(tab, rw.T_ROUNDS))
            ms = _queued_ms(lambda: [functools.partial(counter, *a)
                                     for _ in range(REPEATS)])
            rows.append(dict(count=int(count), device_ms=ms,
                             launches=launches, host_ms=host_ms, bits=bits))
        out[kind] = dict(
            walks=rows,
            device_ms=statistics.fmean(r["device_ms"] for r in rows),
            launches=statistics.fmean(r["launches"] for r in rows),
            host_ms=statistics.fmean(r["host_ms"] for r in rows))
    out["identity"] = [[w["bits"] for w in out[k]["walks"]]
                       for k in ("closest", "any")]
    out["means"] = {f"{k}_{m}": out[k][m] for k in ("closest", "any")
                    for m in ("device_ms", "launches", "host_ms")}
    return out


WALK_FACES = 50000  # bench's _town_scene(50000)
WALK_SNAPSHOTS = (8, 40, 100, 200)


def _walk_states(scene, camera, dev):
    """(pipeline, pool states at WALK_SNAPSHOTS boundaries, accum sum,
    seconds) of one tune_config subframe of the walk pool on `scene`."""
    import dataclasses

    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer, tune_config

    cfg = tune_config(scene, RenderConfig(**MAIN), dev)
    scene, pipe = choose_tracer(scene, cfg, dev)
    states, seen = [], [0]

    def walk_fn(s, tab, motion, k):
        if seen[0] in WALK_SNAPSHOTS:
            states.append(s.clone())
        seen[0] += 1
        walkpool.walk_rounds(s, tab, motion, k)

    step = make_render_fn(scene, cfg, tracer=dataclasses.replace(
        pipe, walk_fn=walk_fn), device=dev)
    film = film_create(cfg.height, cfg.width, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, _ = step(camera.params(), film)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if len(states) != len(WALK_SNAPSHOTS):
        raise RuntimeError(f"{seen[0]} boundaries, too few for the "
                           "snapshots")
    return pipe, states, float(film.accum.double().sum()), secs


def walk_round() -> dict:
    """The recorded K9 and K9-inst launches, each timed 3 times."""
    import torch

    from rendertoy3c_tpu_torch.integrate import walkpool
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.town import town_scene

    dev = torch.device("cuda")
    field = instance_field(True)
    scenes = {"k9": town_scene(WALK_FACES),
              "k9_inst": (build_instanced_scene(*field[:2]), field[2])}
    out = dict(identity=[], accum_sum={}, means={}, subframe_s=0.0)
    for kind, (scene, camera) in scenes.items():
        pipe, states, out["accum_sum"][kind], secs = _walk_states(
            scene, camera, dev)
        out["subframe_s"] += secs
        k = walkpool.phase_rounds(
            RenderConfig(), pipe.n_levels,
            spacewalk=pipe.instanced and not pipe.inst_stride)
        launches = []
        for s in states:
            done = []

            def calls(s=s):
                done[:] = [s.clone() for _ in range(REPEATS)]
                return [functools.partial(walkpool.walk_rounds, c,
                                          pipe.table, pipe.motion, k)
                        for c in done]

            ms = _queued_ms(calls)
            # wseg: an input only, absent from checkouts before N-key motion
            out["identity"].append(_digest(t for n, t in done[0].tensors()
                                           if n != "wseg"))
            rows = int(done[0].rows) - int(s.rows)
            clones = [s.clone() for _ in range(REPEATS)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for c in clones:
                walkpool.walk_rounds(c, pipe.table, pipe.motion, k)
            torch.cuda.synchronize()
            launches.append(dict(
                device_ms=ms, rows=rows,
                host_ms=(time.perf_counter() - t1) * 1e3 / REPEATS))
        out[kind] = dict(rounds=k, pool=states[0].cur.shape[0],
                         launches=launches)
        for m in ("device_ms", "rows", "host_ms"):
            out["means"][f"{kind}_{m}"] = statistics.fmean(
                x[m] for x in launches)
    return out


K7_RECORD_EVERY = 100  # chip_smoke.py's
FIELD_RAYS = 131072  # chip_smoke.py's GATE_RAYS
FIELD_GRID = 8  # chip_smoke.py's INST_GATE_GRID
FAR = 1e6  # rays starting farther from the origin are not compared


def _k7_inputs(dev, cfg_kw=MAIN, field_rays=FIELD_RAYS,
               every=K7_RECORD_EVERY):
    """({(where, kind): [(rays, count)]}, {where: soup}, the subframe's
    accum sum, its seconds): PICKS of the K7 path's recorded calls of each
    kind (one subframe at `cfg_kw`, every `every`-th call recorded) and
    the grid-8 field's `field_rays` camera rays, with each scene's soup."""
    import numpy as np
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.builtin import (instance_field,
                                                      multi_instance_cornell)
    from rendertoy3c_tpu_torch.scene.camera import camera_ray_dir
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.trace import instanced_mt as im
    from rendertoy3c_tpu_torch.trace.hier_instanced import \
        split_order_instanced
    from rendertoy3c_tpu_torch.trace.mt import _count_tensor, pack_rays

    meshes, inst, camera = multi_instance_cornell()
    scene = build_instanced_scene(meshes, inst)
    pair = im.make_instanced_mt_tracer(scene, dev)
    rec = {"closest": [], "any": []}
    seen = {"closest": 0, "any": 0}

    def recording(kind, fn):
        def call(o, d, tmin, tmax, time=None, count=None):
            if seen[kind] % every == 0:
                rays, r = pack_rays(o, d, tmin, tmax)
                rec[kind].append((rays, _count_tensor(count, r, dev)))
            seen[kind] += 1
            return fn(o, d, tmin, tmax, time, count=count)
        return call

    cfg = RenderConfig(**cfg_kw)
    step = make_render_fn(scene, cfg, tracer=(
        recording("closest", pair[0]), recording("any", pair[1])),
        device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    film = film_create(cfg.height, cfg.width, device=dev)
    sync()
    t0 = time.perf_counter()
    film, _ = step(camera.params(), film)
    sync()
    secs = time.perf_counter() - t0
    out = {}
    for kind, calls in rec.items():
        calls = [c for c in calls if int(c[1]) >= c[0].shape[0] // 2]
        out[("path", kind)] = [calls[int(j)] for j in np.linspace(
            0, len(calls) - 1, PICKS).round()]
    meshes, inst, cam = instance_field(False, FIELD_GRID)
    field = split_order_instanced(build_instanced_scene(meshes, inst))
    scf = tuple(float(x) for x in np.concatenate(
        list(cam.params())).astype(np.float32))
    zero = torch.zeros(field_rays, device=dev)
    o = torch.as_tensor(scf[:3], device=dev).expand(field_rays, 3)
    t_any = torch.as_tensor(np.random.default_rng(28).uniform(
        0.5, 60.0, field_rays).astype(np.float32), device=dev)
    # the first pixels (phase 37's rays: the image's bottom rows, all on
    # the floor) and pixels spread over the image (the towers too)
    ramp = torch.arange(field_rays, device=dev)
    for where, pix in (("field", ramp % (768 * 768)),
                       ("field_spread", ramp * (768 * 768) // field_rays)):
        d = torch.stack(camera_ray_dir(scf, pix, 768, 768, zero, zero), 1)
        for kind, tmin, tmax in (("closest", 1e-2, 1e16),
                                 ("any", 1e-3, t_any)):
            rays, r = pack_rays(o.contiguous(), d, tmin, tmax)
            out[(where, kind)] = [(rays, _count_tensor(None, r, dev))]
    field_soup = im.build_instanced_soup(field, dev)
    soups = {"path": pair[0].soup, "field": field_soup,
             "field_spread": field_soup}
    return out, soups, float(film.accum.double().sum()), secs


def instanced_mt() -> dict:
    """The recorded K7 launches and the field's, each timed 3 times."""
    import torch

    from rendertoy3c_tpu_torch.trace import instanced_mt as im

    dev = torch.device("cuda")
    inputs, soups, accum, secs = _k7_inputs(dev)
    out = dict(identity=[], means={}, subframe_s=secs, accum_sum=accum)
    for (where, kind), launches in inputs.items():
        rows = []
        for rays, count in launches:
            args = (rays, count, soups[where], kind == "any")
            done = []

            def calls(args=args):
                return [functools.partial(
                    lambda *a: done.append(im.trace_instanced(*a)), *args)
                    for _ in range(REPEATS)]

            near = rays[:, 0:3].abs().amax(dim=1) < FAR
            rows.append(dict(count=int(count), device_ms=_queued_ms(calls),
                             far=int((~near).sum())))
            out["identity"].append(_digest([done[-1][near]]))
        out[f"{where}_{kind}"] = rows
        out["means"][f"{where}_{kind}_device_ms"] = statistics.fmean(
            x["device_ms"] for x in rows)
    return out


MEGA_RECORD_EVERY = 40
# (name, scene, schedule change): the megakernel paths, K4 then K5
MEGA_PATHS = (
    ("k4", "cornell", {}),
    ("k4_motion", "moving_cornell", {}),
    ("k4_textured", "textured_quad", {}),
    ("k4_dispatch", "material_cornell", {}),
    ("k4_aov", "cornell", {"aov": True}),
    ("k5", "cornell", {"sort_rays": True}),
    ("k5_motion", "moving_cornell", {"pool_pixel_major": False}),
)


def _mega_scene(name):
    """(scene, camera) of a megakernel path's scene: the Cornell box, its
    2-key form (the last block given a second key at +0.1 in x), the
    textured quad or the Cornell box with all four material types."""
    import dataclasses

    import numpy as np

    from rendertoy3c_tpu_torch.scene.builtin import (cornell_box,
                                                      material_cornell_box,
                                                      textured_quad_variant)
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    if name == "textured_quad":
        meshes, textures, camera = textured_quad_variant("repeat")
        return build_scene(meshes, textures=textures), camera
    if name == "material_cornell":
        meshes, camera = material_cornell_box(False)
        return build_scene(meshes), camera
    meshes, camera = cornell_box()
    if name == "moving_cornell":
        v = meshes[-1].vertices
        meshes[-1] = dataclasses.replace(meshes[-1], vertices=np.concatenate(
            [v, v + np.float32([0.1, 0, 0])]))
    return build_scene(meshes), camera


def _mega_inputs(dev, cfg_kw=MAIN, every=MEGA_RECORD_EVERY):
    """({path: (launch, [inputs])}, {path: accum sum}, seconds): one
    subframe at `cfg_kw` of each of MEGA_PATHS through make_render_fn with
    choose_tracer's pipeline, every `every`-th K4 or K5 call recorded, and
    PICKS of them spread over the subframe, each with at least half the
    pool live (a K4 launch also with a pool's worth of pixels left to
    claim, so that every idle lane claims one). `launch(inputs)` runs one
    recorded call on fresh copies of its state and returns the outputs'
    digest (`_k4_digest` for K4)."""
    import numpy as np
    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out, sums, secs = {}, {}, 0.0
    for name, scene_name, change in MEGA_PATHS:
        scene, camera = _mega_scene(scene_name)
        cfg = RenderConfig(**dict(cfg_kw, **change))
        scene, pipe = choose_tracer(scene, cfg, dev)
        if not isinstance(pipe, shade.FusedPipeline):
            raise RuntimeError(f"{name}: not the fused pipeline")
        pool = cfg.ray_block
        rec, seen = [], [0]
        k4 = name.startswith("k4")
        fn = pipe.refill_fn if k4 else pipe.shade_fn

        def recording(*args, **kw):
            if seen[0] % every == 0:
                rec.append((tuple(a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args), kw))
            seen[0] += 1
            return fn(*args, **kw)

        if k4:
            pipe.refill_fn = recording
        else:
            pipe.shade_fn = recording
        step = make_render_fn(scene, cfg, tracer=pipe, device=dev)
        film = film_create(cfg.height, cfg.width, device=dev, aov=cfg.aov)
        sync()
        t0 = time.perf_counter()
        film, _ = step(camera.params(), film)
        sync()
        secs += time.perf_counter() - t0
        sums[name] = float(film.accum.double().sum())
        if k4:  # args: rays, misc, stash, stats_in, stats_out, ...
            ok = [r for r in rec if int(r[0][3][2]) >= pool // 2
                  and int(r[0][3][0]) + pool <= r[1]["rc"].n_pix]
        else:  # args: rays, misc, count, tables, sc, time
            ok = [r for r in rec if int(r[0][2]) >= pool // 2]
        if len(ok) < PICKS:
            raise RuntimeError(f"{name}: {seen[0]} calls, {len(ok)} "
                               "recorded with half the pool live")
        pick = [ok[int(j)] for j in np.linspace(0, len(ok) - 1,
                                                PICKS).round()]
        out[name] = (functools.partial(_mega_launch, fn, k4), pick)
    return out, sums, secs


def _mega_launch(fn, k4: bool, inputs, copies: int = 1):
    """(calls, digest): `copies` calls of the recorded K4 or K5 call
    `inputs`, each on its own copy of the state, and digest() of the first
    call's outputs once it has run."""
    import torch

    args, kw = inputs
    states = [[x.clone() if isinstance(x, torch.Tensor) else x
               for x in args] for _ in range(copies)]
    results = []
    for a in states:
        if k4:
            a[4].zero_()  # stats_out

    def run(a):
        results.append(fn(*a, **kw))

    def digest():
        if k4:  # K4 works in place
            return _k4_digest(args, states[0])
        return _digest(list(results[0]))

    return [functools.partial(run, a) for a in states], digest


def _k4_digest(before, after) -> str:
    """The digest of one K4 call's outputs that does not depend on which
    lane claimed which pixel (chip_smoke.py's _compare_lanes with
    claimed_as_set): the stats, each lane's stash and want_shadow (misc
    15) in lane order, the rest of the rows of lanes that claimed no pixel
    in lane order, and those of lanes that claimed one sorted by pixel."""
    import torch

    rays, misc, stash = after[:3]
    time = after[8] if len(after) > 8 and after[8] is not None else None
    rows = torch.cat([rays, misc[:, :15], misc[:, 16:]]
                     + ([time[:, None]] if time is not None else []), dim=1)
    pix = misc[:, 13]
    claimed = (pix != before[1][:, 13]) & (pix >= 0)
    order = torch.argsort(pix[claimed])
    return _digest([after[4], stash, misc[:, 15].contiguous(),
                    rows[~claimed], rows[claimed][order]])


def _shared_picks(inputs, path: str):
    """The first turn's picks: saves the state tensors of `inputs`'
    picks to `path`, or, when the file is there, puts its tensors in
    their place. K4's claims depend on block order, so the states that two
    runs of a subframe reach differ, and only the same inputs give
    outputs that can agree."""
    import torch

    if not os.path.exists(path):
        torch.save({name: [[a if isinstance(a, torch.Tensor) else None
                            for a in args] for args, _ in picks]
                    for name, (_, picks) in inputs.items()}, path)
        return inputs
    saved = torch.load(path)
    return {name: (launch, [
        (tuple(a if s is None else s for a, s in zip(args, saved[name][i])),
         kw) for i, (args, kw) in enumerate(picks)])
        for name, (launch, picks) in inputs.items()}


def megakernel(shared: str) -> dict:
    """The recorded K4 and K5 launches of MEGA_PATHS, each timed 3
    times, on the inputs of the run's first turn."""
    import torch

    dev = torch.device("cuda")
    inputs, sums, secs = _mega_inputs(dev)
    inputs = _shared_picks(inputs, os.path.join(shared, "megakernel.pt"))
    out = dict(identity=[], means={}, subframe_s=secs, accum_sum=sums)
    for name, (launch, picks) in inputs.items():
        rows = []
        for inp in picks:
            digests = []

            def calls(inp=inp):
                c, d = launch(inp, REPEATS)
                digests[:] = [d]
                return c

            ms = _queued_ms(calls)
            out["identity"].append(digests[0]())
            rows.append(dict(device_ms=ms))
        out[name] = rows
        out["means"][f"{name}_device_ms"] = statistics.fmean(
            x["device_ms"] for x in rows)
    return out


# (name, scene, schedule change, pipeline kind, recorded K6 calls): K6's
# paths; "mt" the external pipeline over K1-K3 at MAIN, "walk" the walk
# pool and "tracetime" the instanced external pipeline, both at
# tune_config's pool
K6_PATHS = (
    ("town", "town", {}, "mt", (32, 128, 224, 320)),
    ("town_aov", "town", {"aov": True}, "mt", (32, 128, 224, 320)),
    ("tex_town", "tex_town", {}, "mt", (32, 128, 224, 320)),
    ("prin_town", "prin_town", {"sort_rays": True,
                                "light_sampler": "power"}, "mt",
     (32, 112, 192, 272)),
    ("tex_prin_town", "tex_prin_town", {"sort_rays": True,
                                        "light_sampler": "power"}, "mt",
     (32, 112, 192, 272)),
    ("walk_config1", "walk_town", {"width": 1920, "height": 1080}, "walk",
     WALK_SNAPSHOTS),
    ("walk_tex", "walk_tex_town", {"sort_rays": True}, "walk",
     WALK_SNAPSHOTS),
    ("walk_tex_prin", "walk_tex_prin_town", {"sort_rays": True,
                                             "light_sampler": "power"},
     "walk", WALK_SNAPSHOTS),
    ("walk_tex_aov", "walk_tex_town", {"aov": True}, "walk", WALK_SNAPSHOTS),
    ("inst_field", "inst_field", {}, "walk", WALK_SNAPSHOTS),
    ("tracetime", "tracetime", {}, "tracetime", (32, 200, 600, 1000)),
)


def _k6_scene(name):
    """(scene, camera) of a K6 path's scene."""
    from rendertoy3c_tpu_torch.scene.builtin import (instance_field,
                                                      multi_instance_cornell)
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.town import town_scene

    if name == "inst_field":
        meshes, inst, camera = instance_field(False)
        return build_instanced_scene(meshes, inst), camera
    if name == "tracetime":
        meshes, inst, camera = multi_instance_cornell()
        return build_instanced_scene(meshes, inst), camera
    faces = WALK_FACES if name.startswith("walk") else TOWN_FACES
    return town_scene(faces, textured="tex" in name,
                      principled="prin" in name)


def _k6_record(dev, name, scene, camera, change, kind, snapshots,
               cfg_kw=MAIN):
    """{tables, config, transposed, picks}: one subframe of a K6 path (at
    `cfg_kw` with `change` applied) with K6's inputs at `snapshots`
    recorded, and its tables as plain tensors."""
    import dataclasses

    import torch

    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.trace import shade
    from rendertoy3c_tpu_torch.trace.auto import choose_tracer, tune_config

    cfg = RenderConfig(**dict(cfg_kw, **change))
    if kind != "mt":
        cfg = tune_config(scene, cfg, dev)
    scene, pipe = choose_tracer(scene, cfg, dev)
    picks, seen = [], [0]

    def record(rays, hit4, misc, tables, config, transposed=False,
               inst=None):
        if seen[0] in snapshots:
            picks.append((rays.clone(), hit4.clone(), misc.clone(),
                          None if inst is None else inst.clone()))
        seen[0] += 1
        return shade.external_shade(rays, hit4, misc, tables, config,
                                    transposed=transposed, inst=inst)

    if kind == "walk":
        pipe = dataclasses.replace(pipe, shade_fn=record)
        tables, config = pipe.shade_tables, pipe.shade_config
    else:
        if not isinstance(pipe, shade.ExternalPipeline):
            raise RuntimeError(f"{name}: not the external pipeline")
        pipe.shade_fn = record
        tables, config = pipe.tables, pipe.config
    step = make_render_fn(scene, cfg, tracer=pipe, device=dev)
    film = film_create(cfg.height, cfg.width, device=dev, aov=cfg.aov)
    step(camera.params(), film)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if len(picks) != len(snapshots):
        raise RuntimeError(f"{name}: {seen[0]} K6 calls, too few for the "
                           "snapshots")
    tex = tables.tex
    return dict(
        attr=tables.attr, lights_t=tables.lights_t,
        tex=None if tex is None else (tex.atlas.data, tex.atlas.meta,
                                      tex.uv_xform, tex.normal_maps),
        params_base=tables.params_base, inst_rows=tables.inst_rows,
        config=dataclasses.asdict(config), transposed=kind == "walk",
        picks=picks)


def _k6_inputs(dev, path: str) -> dict:
    """{name: recorded path} of K6_PATHS, from the file `path` where a
    turn saved them, else recorded (and saved there)."""
    import torch

    if os.path.exists(path):
        return torch.load(path)
    scenes, out = {}, {}
    for name, scene_name, change, kind, snaps in K6_PATHS:
        if scene_name not in scenes:
            scenes = {scene_name: _k6_scene(scene_name)}  # one at a time
        out[name] = _k6_record(dev, name, *scenes[scene_name], change, kind,
                               snaps)
    torch.save(out, path)
    return out


def _k6_tables(rec):
    """(ExternalTables, ShadeConfig) of a recorded path, in this
    checkout's own classes."""
    from rendertoy3c_tpu_torch.scene.texture import TextureAtlas
    from rendertoy3c_tpu_torch.trace import shade

    tex = rec["tex"]
    tables = shade.ExternalTables(
        attr=rec["attr"], lights_t=rec["lights_t"],
        tex=None if tex is None else shade.TexState(
            TextureAtlas(data=tex[0], meta=tex[1]), tex[2], tex[3]),
        params_base=rec["params_base"], inst_rows=rec["inst_rows"])
    config = rec["config"]
    return tables, shade.ShadeConfig(**dict(config, bg=tuple(config["bg"])))


def external_shade(shared: str) -> dict:
    """The recorded K6 launches of K6_PATHS, each timed 3 times, on the
    inputs of the run's first turn."""
    import torch

    from rendertoy3c_tpu_torch.trace import shade

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    inputs = _k6_inputs(dev, os.path.join(shared, "external_shade.pt"))
    out = dict(identity=[], means={}, subframe_s=time.perf_counter() - t0)
    for name, rec in inputs.items():
        tables, config = _k6_tables(rec)
        rows = []
        for rays, hit4, misc, inst in rec["picks"]:
            kw = dict(transposed=rec["transposed"], inst=inst)
            done = []

            def calls(a=(rays, hit4, misc, tables, config), kw=kw):
                return [functools.partial(
                    lambda *x, **k: done.append(shade.external_shade(*x,
                                                                     **k)),
                    *a, **kw) for _ in range(REPEATS)]

            ms = _queued_ms(calls)
            out["identity"].append(_digest(list(done[-1])))
            rows.append(dict(lanes=rays.shape[0], device_ms=ms))
        out[name] = rows
        out["means"][f"{name}_device_ms"] = statistics.fmean(
            x["device_ms"] for x in rows)
    return out


# each returns its turn's numbers: "means" (averaged per checkout),
# "subframe_s", and "identity" (equal across checkouts whose outputs agree)
WORKLOADS = {"mt-sweep": mt_sweep, "resident-walk": resident_walk,
             "walk-round": walk_round, "instanced-mt": instanced_mt,
             "megakernel": megakernel, "external-shade": external_shade}
# the workloads whose turns time the launch inputs the first turn recorded
SHARED_INPUTS = {"megakernel", "external-shade"}


def turn(workload: str, root: str, shared: str) -> dict:
    """One turn of `workload` with the package under `root`; `shared` is
    a directory the turns of one run share."""
    sys.path.insert(0, os.path.abspath(root))
    fn = WORKLOADS[workload]
    return dict(root=root, **(fn(shared) if workload in SHARED_INPUTS
                              else fn()))


def summary(roots, runs) -> dict:
    """The mean of each turn number per checkout, and whether every turn's
    outputs agree."""
    means = {}
    for root in roots:
        mine = [r for r in runs if r["root"] == root]
        means[root] = {k: statistics.fmean(r["means"][k] for r in mine)
                       for k in mine[0]["means"]}
        means[root]["subframe_s"] = statistics.fmean(
            r["subframe_s"] for r in mine)
    same = len({json.dumps(r["identity"]) for r in runs}) == 1
    return dict(mean_per_checkout=means, same_outputs=same)


def main() -> int:
    if sys.argv[1] == "--turn":
        print(json.dumps(turn(*sys.argv[2:5])), flush=True)
        return 0
    workload, roots = sys.argv[1], sys.argv[2:]
    if workload not in WORKLOADS or not roots:
        sys.stderr.write(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as shared:
        for root in roots + roots[::-1]:
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--turn", workload, root, shared],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode:
                sys.stderr.write(res.stderr)
                return res.returncode
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    result = summary(roots, runs)
    print(json.dumps(result))
    return 0 if result["same_outputs"] else 1


if __name__ == "__main__":
    sys.exit(main())
