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
"""
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
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
            out["identity"].append(_digest(t for _, t in done[0].tensors()))
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


# each returns its turn's numbers: "means" (averaged per checkout),
# "subframe_s", and "identity" (equal across checkouts whose outputs agree)
WORKLOADS = {"mt-sweep": mt_sweep, "resident-walk": resident_walk,
             "walk-round": walk_round}


def turn(workload: str, root: str) -> dict:
    """One turn of `workload` with the package under `root`."""
    sys.path.insert(0, os.path.abspath(root))
    return dict(root=root, **WORKLOADS[workload]())


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
        print(json.dumps(turn(sys.argv[2], sys.argv[3])), flush=True)
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
    for root in roots + roots[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", workload, root],
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
