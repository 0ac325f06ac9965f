"""Renders over a (tile, spp) mesh of processes and holds the result to
the same work done in one process.

Starts TILE x SPP worker processes on this host, one per GPU (or on the
CPU with --device cpu: gloo), joined at a free localhost port by
`init_multihost`; each renders --subframes subframes through
`make_render_fn_multihost` and the image is gathered by
`assemble_film`. Process 0 then renders the same subframes in-process
(`render_mesh_in_process` over the same tracer) and on one device
(`make_render_fn`), and checks:

  * the mesh's image bit-equal to the in-process one, and its summed
    radiance and shadow rays equal (this holds the step's collectives to
    their in-process arithmetic);
  * with SPP = 1, the image bit-equal to one device's and the ray counts
    equal; with SPP > 1, every pixel finite and the mean within 5% of one
    device's (the reference's test_tile_spp_mesh_statistics rule).

Prints one JSON line (the checks, the ray counts, the means and each
rank-0 subframe's seconds) and exits 1 if a check fails or a worker does
not finish within --timeout seconds.

    python -m rendertoy3c_tpu_torch.tools.mesh_check --mesh-shape 2x2 \\
        [--device cuda|cpu] [--scene cornell|tracetime] [--kind auto]

`tracetime` is bench's multi_instance_tracetime (15 instances); with
--kind pallas it renders through K7. --out DIR keeps the gathered image
(img.npy) and the result (result.json) there.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mesh-shape", required=True, help="TILExSPP")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--scene", default="cornell",
                   choices=("cornell", "tracetime"))
    p.add_argument("--kind", default="auto",
                   help="prepare_tracer_factory's kind")
    p.add_argument("--size", default="32x32", help="WxH")
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--subframes", type=int, default=2)
    p.add_argument("--max-depth", type=int, default=3)
    p.add_argument("--ray-block", type=int, default=256)
    p.add_argument("--timeout", type=float, default=240.0)
    p.add_argument("--out", default=None)
    # a worker's own arguments
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _shape(args) -> tuple[int, int]:
    n_tile, n_spp = (int(x) for x in args.mesh_shape.lower().split("x"))
    return n_tile, n_spp


def _scene(args):
    """(scene, camera, RenderConfig) of the arguments."""
    from ..integrate.config import RenderConfig
    from ..scene.builtin import cornell_box, multi_instance_cornell
    from ..scene.instanced import build_instanced_scene
    from ..scene.scene import build_scene

    w, h = (int(x) for x in args.size.lower().split("x"))
    if args.scene == "cornell":
        meshes, camera = cornell_box()
        scene = build_scene(meshes)
    else:
        meshes, inst, camera = multi_instance_cornell()
        scene = build_instanced_scene(meshes, inst)
    camera.aspect_ratio = w / h
    cfg = RenderConfig(width=w, height=h, samples_per_launch=args.spp,
                       max_depth=args.max_depth, ray_block=args.ray_block,
                       integrator="pool", pool_pixel_major=True)
    return scene, camera, cfg


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _in_process(args, scene, camera, cfg, device) -> dict:
    """Process 0's references: the mesh's work in this process and one
    device's render over the same tracer, each --subframes subframes.
    Returns their films and ray counts."""
    import dataclasses

    from ..film.film import film_accumulate, film_create
    from ..integrate.path import make_render_fn
    from ..parallel.dist import prepare_tracer_factory, render_mesh_in_process

    n_tile, n_spp = _shape(args)
    scene, factory = prepare_tracer_factory(scene, cfg, kind=args.kind,
                                            device=device)
    cfg_local = dataclasses.replace(
        cfg, samples_per_launch=cfg.samples_per_launch // n_spp)
    tracer = factory(scene, None, cfg_local)
    cam = camera.params()
    film = film_create(cfg.height, cfg.width, device=device)
    rays = [0, 0]
    for k in range(args.subframes):
        rgb, _, n_rad, n_shad, _ = render_mesh_in_process(
            scene, cfg, n_tile, n_spp, tracer, cam, k, device)
        film = film_accumulate(film, rgb)
        rays = [rays[0] + n_rad, rays[1] + n_shad]
    step = make_render_fn(scene, cfg, tracer=factory(scene, None, cfg),
                          device=device)
    one = film_create(cfg.height, cfg.width, device=device)
    one_rays = [0, 0]
    for _ in range(args.subframes):
        one, stats = step(cam, one)
        one_rays = [one_rays[0] + int(stats.radiance_rays),
                    one_rays[1] + int(stats.shadow_rays)]
    return dict(in_process=film.accum, in_process_rays=rays,
                one=one.accum, one_rays=one_rays)


def worker(args) -> int:
    """One rank: join the group, render, gather; process 0 checks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..parallel.multihost import (assemble_film, init_multihost,
                                      make_render_fn_multihost)

    if args.device == "cpu":
        torch.set_num_threads(1)
    n_tile, n_spp = _shape(args)
    init_multihost(f"127.0.0.1:{args.port}", n_tile * n_spp, args.rank,
                   device=args.device)
    try:
        scene, camera, cfg = _scene(args)
        step, mesh, film = make_render_fn_multihost(
            scene, cfg, n_spp=n_spp, tracer_kind=args.kind,
            device=args.device)
        if mesh.shape != {"tile": n_tile, "spp": n_spp}:
            raise RuntimeError(f"mesh {mesh.shape}, wanted {n_tile}x{n_spp}")
        cam = camera.params()
        rays, secs = [0, 0], []
        for _ in range(args.subframes):
            t0 = time.perf_counter()
            film, stats = step(cam, film)
            _sync(mesh.device)
            secs.append(time.perf_counter() - t0)
            rays = [rays[0] + int(stats.radiance_rays),
                    rays[1] + int(stats.shadow_rays)]
        img = assemble_film(film.accum, mesh)
    finally:
        dist.destroy_process_group()
    if args.rank != 0:
        return 0
    ref = _in_process(args, scene, camera, cfg, mesh.device)

    def bits(x):
        return x.contiguous().view(torch.int32)

    mean, one_mean = float(img.mean()), float(ref["one"].mean())
    checks = {
        "finite": bool(torch.isfinite(img).all()),
        "bit_equal_in_process": bool(torch.equal(bits(img),
                                                 bits(ref["in_process"]))),
        "rays_equal_in_process": rays == ref["in_process_rays"],
    }
    if n_spp == 1:
        checks["bit_equal_one_device"] = bool(torch.equal(bits(img),
                                                          bits(ref["one"])))
        checks["rays_equal_one_device"] = rays == ref["one_rays"]
    else:
        checks["mean_within_5pct"] = abs(mean - one_mean) < 0.05 * max(
            one_mean, 1e-6)
    result = dict(mesh=[n_tile, n_spp], device=args.device,
                  backend="nccl" if args.device == "cuda" else "gloo",
                  scene=args.scene, kind=args.kind, size=args.size,
                  spp=args.spp, subframes=args.subframes, checks=checks,
                  ok=all(checks.values()), rays=rays,
                  in_process_rays=ref["in_process_rays"],
                  one_device_rays=ref["one_rays"], mean=mean,
                  one_device_mean=one_mean, rank0_subframe_s=secs)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f)
    np.save(os.path.join(args.out, "img.npy"), img.cpu().numpy())
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv: list) -> int:
    """Start the ranks with the arguments `argv`, wait for them, print
    process 0's result."""
    n_tile, n_spp = _shape(args)
    world = n_tile * n_spp
    if args.device == "cuda":
        import torch

        from ..kernels import build as kbuild

        if torch.cuda.device_count() < world:
            print(f"a {n_tile}x{n_spp} mesh needs {world} GPUs; "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        kbuild.library()  # one build for every rank
    out = args.out or tempfile.mkdtemp(prefix="mesh_check_")
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        cmd = [sys.executable, "-m", "rendertoy3c_tpu_torch.tools.mesh_check",
               *argv, "--rank", str(rank), "--port", str(port)]
        if args.out is None:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    deadline = time.monotonic() + args.timeout
    for rank, proc in enumerate(procs):
        try:
            logs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(proc.communicate()[0])
            print(f"rank {rank} did not finish in {args.timeout} s",
                  file=sys.stderr)
            failed = True
            break
        if proc.returncode != 0:
            failed = True
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            print(f"rank {rank} exited {proc.returncode}:\n{log[-3000:]}",
                  file=sys.stderr)
    if failed:
        return 1
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    print(json.dumps(result))
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    return launch(args, argv) if args.rank is None else worker(args)


if __name__ == "__main__":
    sys.exit(main())
