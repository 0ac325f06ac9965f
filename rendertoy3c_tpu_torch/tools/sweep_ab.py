"""Times the plain MT sweeps (`closest_ref`, `any_ref`) of two checkouts
of the port in turns A, B, B, A, each turn a process of its own on the
first CUDA card: one plain 768^2 8-spp depth-16 subframe (pool 32768) of
the 16054-face static town, with every sweep call in it timed on the
host clock between two synchronizes (the plain sweep waits on the card
once per tile anyway). Prints one JSON line per turn, then the mean per
checkout, after the card's name and power limit. The two checkouts must
render the same image (accum sums equal).

    python rendertoy3c_tpu_torch/tools/sweep_ab.py A_ROOT B_ROOT
"""
import json
import os
import statistics
import subprocess
import sys
import time

TOWN_FACES = 16000  # generate_town gives 16054 faces
MAIN = dict(width=768, height=768, samples_per_launch=8, max_depth=16,
            ray_block=32768, integrator="pool", pool_pixel_major=True)


def turn(root: str) -> dict:
    """One plain subframe with the package under `root`."""
    sys.path.insert(0, os.path.abspath(root))
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
    out = dict(root=root, subframe_s=time.perf_counter() - t0,
               launches=int(stats.pool_iters),
               accum_sum=float(film.accum.double().sum()))
    for kind, ms in times.items():
        out[kind] = dict(calls=len(ms), mean_ms=statistics.fmean(ms),
                         median_ms=statistics.median(ms))
    return out


def main() -> int:
    if sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return 0
    a, b = sys.argv[1:3]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for root in (a, b, b, a):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root], capture_output=True,
                             text=True, timeout=600)
        if res.returncode:
            sys.stderr.write(res.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for root in (a, b):
        mine = [r for r in runs if r["root"] == root]
        summary[root] = {k: statistics.fmean(r[k]["mean_ms"] for r in mine)
                         for k in ("closest", "any")}
        summary[root]["subframe_s"] = statistics.fmean(
            r["subframe_s"] for r in mine)
    same = len({r["accum_sum"] for r in runs}) == 1
    print(json.dumps(dict(mean_per_launch=summary, same_image=same)))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
