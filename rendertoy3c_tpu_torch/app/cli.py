"""Command-line renderer of the port.

Port of the path-render subset of rendertoy3c_tpu/app/cli.py:

  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --size 768x768 \\
      --spp 8 --subframes 4 -o out.png --device cuda
  python -m rendertoy3c_tpu_torch.app.cli --scene a.obj b.obj \\
      --eye 38,26,46 --lookat 0,1.5,0 --fov 42 -o out.png --device cuda
  python -m rendertoy3c_tpu_torch.app.cli --scene k0.obj k1.obj k0.obj \\
      -o out.png --device cuda
  python -m rendertoy3c_tpu_torch.app.cli --scene x.glb \\
      --anim-times 0,0.5,1 -o out.png --device cuda
  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --env sky.exr \\
      --env-scale 1 --throughput physical -o out.png --device cuda

`--scene` takes the builtin Cornell box, the builtin textured quad
(`textured`), .obj files, where N files are N motion keyframes (the
reference loader's rule), with the textures their .mtl files name, or
one .gltf/.glb file (io/gltf.py), whose animation clip `--animation`
(default 0) is sampled at each time stamp of `--anim-times T0,T1,...`,
one motion keyframe a stamp (none: the static pose), as the reference's
CLI does (:89-94, :180-190). The .obj camera defaults to the reference
app's framing, eye (5,5,5) toward (0,1,0) at fov 45 (rendertoy3c_tpu/
app/cli.py:192-197), a glTF scene's to its first camera or that framing;
`--eye --lookat --fov` override it. The glTF point lights are loaded
and not used: the path renderer has none (the reference hands them only
to its direct renderer).
`--tracer` picks the tracer as the reference's CLI does (:303-349):
`auto` (default) tunes the pool for the card and takes trace/auto.py's
ladder, which sends a scene of more than 2 keys to the stacked hierwalk
(K9 with segment offsets) past 16384 faces and to the brute tracer below.
Here the port departs from the reference's CLI, which sends every scene
of more than 2 keys to the brute tracer (:286-300), a route its own note
(integrate/path.py:1474-1478) says faults on ~50k faces; `--tracer brute`
takes it. `pallas` the fused pipeline where it shades the scene, else the
bare MT tracer (K1/K2, K3), on the Morton order past 512 static faces;
`hierwalk` the bare hierarchical walk (K9) on the SAH split order;
`residentwalk` the resident-table block walk (K8) on the split order at
256-face runs; `brute` the brute tracer. A bare tracer renders under the
general pool or, with `--integrator wave`, the wave integrator
(integrate/path.py). `leafwalk` and `bvh` are not ported (ROADMAP A17,
A24) and exit with an error naming the item.
It renders on the pool (pixel-major) or the wave integrator
(`--integrator`) with the reference CLI's names and
defaults for --max-depth (32), --seed (0), --ray-block (65536),
--flush-every (0 = auto), --light-sampler (uniform or power),
--throughput (reference or physical), --env IMG and --env-scale S (a
lat-long environment map, .exr, .ppm or any image read_image reads,
times S, which the miss lanes sample instead of the constant ambient, as
the reference CLI's :85-88, :271-278), --aov (the
first-hit albedo and normal guide buffers) and --denoise N (N a-trous
iterations before saving, guided by the AOV buffers when --aov is on), and
writes the image in the format its extension names, as the reference's
CLI does (:467-520): linear float OpenEXR for .exr, binary PPM for .ppm,
PNG otherwise. With --aov the guides go beside it as
<stem>.albedo<ext> and <stem>.normal<ext>.

`--mesh-shape TILExSPP` renders over the (tile, spp) mesh of
parallel/dist.py (the reference CLI's :361-377). The port runs one process
per GPU, so the mesh counts processes: launch one copy of the CLI per GPU
with `--num-hosts N` (N = TILE x SPP processes in all), `--host-id 0..N-1`
and the same `--coordinator host:port` (the process group's rendezvous,
where process 0 listens), e.g. on one host with two GPUs:

  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --mesh-shape 2x1 \
      --num-hosts 2 --host-id 0 --coordinator localhost:29511 -o out.png &
  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --mesh-shape 2x1 \
      --num-hosts 2 --host-id 1 --coordinator localhost:29511 -o out.png

Each process renders its band of rows on its GPU (NCCL; gloo with
`--device cpu`); process 0 gathers the bands and writes the image.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..film.denoise import atrous_denoise
from ..film.film import Film, film_create
from ..film.image import write_exr, write_png, write_ppm
from ..film.tonemap import make_color
from ..integrate.config import RenderConfig
from ..integrate.path import make_render_fn
from ..scene.builtin import cornell_box, textured_quad_scene
from ..scene.camera import Camera
from ..scene.scene import build_scene
from ..trace.auto import tune_config

TRACERS = ("auto", "pallas", "hierwalk", "leafwalk", "residentwalk", "bvh",
           "brute")


def _vec3(s: str):
    parts = [float(x) for x in s.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError("expected x,y,z")
    return tuple(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rendertoy3c_tpu_torch",
                                description="Progressive Monte-Carlo path "
                                "tracer (PyTorch + CUDA port)")
    p.add_argument("--scene", nargs="+", required=True,
                   help="cornell, textured, .obj path(s): N files = N "
                   "motion keyframes, or one .gltf/.glb file")
    p.add_argument("--anim-times", default=None, metavar="T0[,T1,...]",
                   help="glTF animation time stamps (seconds); each becomes "
                   "one motion keyframe")
    p.add_argument("--animation", type=int, default=0,
                   help="glTF animation clip index for --anim-times")
    p.add_argument("--size", default="768x768", help="WxH")
    p.add_argument("--spp", type=int, default=8, help="samples per launch")
    p.add_argument("--subframes", type=int, default=16,
                   help="progressive launches to accumulate")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--eye", type=_vec3, default=None)
    p.add_argument("--lookat", type=_vec3, default=None)
    p.add_argument("--fov", type=float, default=None,
                   help="vertical fov, degrees")
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tracer", choices=TRACERS, default="auto",
                   help="auto = the tracer ladder (trace/auto.py); pallas, "
                   "hierwalk, residentwalk, brute = that bare tracer (or "
                   "the fused pipeline for pallas)")
    p.add_argument("--integrator", choices=["pool", "wave"], default="pool",
                   help="path-tracer schedule: the persistent ray pool or "
                   "the per-block waves")
    p.add_argument("--ray-block", type=int, default=1 << 16)
    p.add_argument("--flush-every", type=int, default=0,
                   help="pool framebuffer flush cadence, 0 = auto by "
                   "frame and pool size")
    p.add_argument("--light-sampler", choices=["uniform", "power"],
                   default="uniform")
    p.add_argument("--throughput", choices=["reference", "physical"],
                   default="reference",
                   help="the closest-hit throughput model: the shipped "
                   "shader's (reference) or the physical one")
    p.add_argument("--env", default=None, metavar="IMG",
                   help="lat-long environment map (.exr/.png/.ppm) used by "
                        "the miss program instead of the constant ambient")
    p.add_argument("--env-scale", type=float, default=1.0)
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N a-trous denoiser iterations before saving "
                        "(uses the AOV guide buffers when --aov is on)")
    p.add_argument("--aov", action="store_true",
                   help="also accumulate first-hit albedo/normal AOVs; "
                        "written as <output>.albedo/.normal and used as "
                        "denoiser guides")
    p.add_argument("--mesh-shape", default=None,
                   help="TILExSPP process mesh, e.g. 2x2 (default: one "
                        "process); one process per GPU, TILE x SPP "
                        "processes in all (--num-hosts)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="the job's process count, one process per GPU: "
                        "launch one copy of this CLI per GPU with "
                        "--host-id 0..N-1")
    p.add_argument("--host-id", type=int, default=0,
                   help="this process's id (rank) in the job")
    p.add_argument("--coordinator", default="localhost:29511",
                   help="host:port of the process group's rendezvous "
                        "(process 0 listens there)")
    return p


def load_scene(names, anim_times=None, animation: int = 0):
    """(meshes, textures, camera) of a builtin scene, of .obj keyframes or
    of a glTF file sampled at `anim_times` ("T0,T1,..." or None)
    (rendertoy3c_tpu/app/cli.py:157-198)."""
    if names == ["cornell"]:
        meshes, camera = cornell_box()
        return meshes, [], camera
    if names == ["textured"]:
        return textured_quad_scene()
    default_camera = Camera(eye=(5.0, 5.0, 5.0), lookat=(0.0, 1.0, 0.0),
                            fov_y=45.0)
    if len(names) == 1 and names[0].endswith((".gltf", ".glb")):
        from ..io.gltf import load_gltf

        times = (tuple(float(x) for x in anim_times.split(","))
                 if anim_times else None)
        meshes, textures, cameras, _ = load_gltf(names[0], times=times,
                                                 animation=animation)
        return meshes, textures, cameras[0] if cameras else default_camera
    if not all(n.endswith(".obj") for n in names):
        raise SystemExit(f"--scene: expected cornell, textured, .obj "
                         f"files or one .gltf/.glb file, got {names}")
    from ..io.obj import load_obj

    meshes, textures = load_obj(names)
    return meshes, textures, default_camera


def pick_tracer(kind: str, scene, cfg, device):
    """(scene, tracer) of a --tracer other than auto (the reference CLI's
    :303-349): the scene in the face order the tracer's tables take."""
    from ..accel.lbvh import morton_order_scene, split_order_scene

    if kind in ("leafwalk", "bvh"):
        item = "A17" if kind == "leafwalk" else "A24"
        raise SystemExit(f"--tracer {kind} is not ported yet (ROADMAP "
                         f"{item})")
    if kind == "brute":
        from ..trace.intersect import make_bruteforce_tracer

        return scene, make_bruteforce_tracer(scene, chunk=cfg.tri_chunk)
    if kind == "hierwalk":
        from ..trace.hierwalk import (HIER_LEAF, HIER_LEAF_MOTION,
                                      make_hierwalk_tracer)

        leaf = HIER_LEAF if scene.num_keys == 1 else HIER_LEAF_MOTION
        scene = split_order_scene(scene, leaf=leaf)
        return scene, make_hierwalk_tracer(scene, device)
    if kind == "residentwalk":
        from ..trace.residentwalk import make_walk_tracer

        scene = split_order_scene(scene)
        return scene, make_walk_tracer(scene, device)
    from ..trace.mt import make_mt_tracer
    from ..trace.shade import FusedPipeline, fused_unsupported

    if scene.num_faces > 512 and scene.num_keys == 1:
        scene = morton_order_scene(scene)
    if (cfg.integrator == "pool" and cfg.ray_block % 256 == 0
            and fused_unsupported(scene, cfg) is None):
        return scene, FusedPipeline(scene, cfg, device)
    return scene, make_mt_tracer(scene, device)


def denoised(film, iterations: int):
    """The film's radiance after `iterations` a-trous passes on its device
    (none: the accum itself). With the AOV buffers, the filter runs on the
    radiance divided by max(albedo, 1e-3) with the normal buffer as a
    guide, and the albedo multiplies back (the reference CLI's :470-483)."""
    if not iterations:
        return film.accum
    if film.albedo is None:
        return atrous_denoise(film.accum, iterations=iterations)
    alb = torch.clamp(film.albedo, min=1e-3)
    return atrous_denoise(film.accum / alb, normal=film.normal,
                          iterations=iterations) * alb


def write_by_extension(path: str, buf: torch.Tensor) -> None:
    """Write a linear [H, W, 3] film buffer (row 0 is the image bottom) in
    the format of `path`'s extension: float OpenEXR for .exr, else through
    make_color on the buffer's device to 8 bits, P6 PPM for .ppm and PNG
    otherwise."""
    top_first = torch.flip(buf, dims=(0,))
    if path.endswith(".exr"):
        write_exr(path, top_first.to(torch.float32).cpu().numpy())
        return
    img = make_color(top_first, alpha=False).cpu().numpy()
    (write_ppm if path.endswith(".ppm") else write_png)(path, img)


def save(out: str, radiance, film) -> None:
    """Write the radiance and, where the film has them, the AOV guides as
    <stem>.albedo<ext> and <stem>.normal<ext>: raw floats in EXR, else the
    normal mapped to n * 0.5 + 0.5 (the reference CLI's :485-520)."""
    if film.albedo is not None:
        stem, ext = os.path.splitext(out)
        for name, buf in (("albedo", film.albedo), ("normal", film.normal)):
            path = f"{stem}.{name}{ext or '.png'}"
            if name == "normal" and not path.endswith(".exr"):
                buf = buf * 0.5 + 0.5  # [-1, 1] to the display range
            write_by_extension(path, buf)
    write_by_extension(out, radiance)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        w, h = (int(x) for x in args.size.lower().split("x"))
    except ValueError:
        print(f"bad --size {args.size!r}, expected WxH", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    mesh = None
    if args.mesh_shape:
        from ..parallel.dist import make_mesh

        try:
            n_tile, n_spp = (int(x) for x in
                             args.mesh_shape.lower().split("x"))
        except ValueError:
            print(f"bad --mesh-shape {args.mesh_shape!r}, expected TILExSPP",
                  file=sys.stderr)
            return 2
        if n_tile * n_spp != args.num_hosts:
            print(f"--mesh-shape {args.mesh_shape} needs {n_tile * n_spp} "
                  f"processes (--num-hosts), one per GPU; got "
                  f"{args.num_hosts}", file=sys.stderr)
            return 2
        if args.num_hosts > 1:
            from ..parallel.multihost import init_multihost

            init_multihost(args.coordinator, args.num_hosts, args.host_id,
                           device=device)
        mesh = make_mesh(n_tile, n_spp, device=device)
        device = mesh.device
    try:
        return _render(args, w, h, device, mesh)
    finally:
        if mesh is not None and mesh.world > 1:
            torch.distributed.destroy_process_group()


def _render(args, w: int, h: int, device, mesh) -> int:
    """Load, render and save, on one device or as one rank of `mesh`."""
    cfg = RenderConfig(width=w, height=h, samples_per_launch=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       ray_block=args.ray_block, integrator=args.integrator,
                       pool_pixel_major=args.integrator == "pool",
                       flush_every=args.flush_every,
                       light_sampler=args.light_sampler,
                       throughput_model=args.throughput, aov=args.aov)
    meshes, textures, camera = load_scene(args.scene, args.anim_times,
                                          args.animation)
    if args.eye:
        camera.eye = args.eye
    if args.lookat:
        camera.lookat = args.lookat
    if args.fov:
        camera.fov_y = args.fov
    camera.aspect_ratio = w / h
    env_map = None
    if args.env:
        from ..film.image import load_image
        from ..scene.envmap import build_env_map

        env_map = build_env_map(load_image(args.env), scale=args.env_scale,
                                device=device)
    scene = build_scene(meshes, textures=textures or None, env_map=env_map)
    tracer = None
    if args.tracer == "auto":
        # the walk band's pool width and cadence on the card (as the
        # reference's CLI applies them on its accelerator), then the ladder
        cfg = tune_config(scene, cfg, device)
    else:
        scene, tracer = pick_tracer(args.tracer, scene, cfg, device)
    cam = camera.params()
    if mesh is not None:
        from ..parallel.dist import (film_create_sharded, make_render_fn_dist,
                                     prepare_tracer_factory)

        if tracer is None:
            # the ladder, with each spp rank's pipeline at its share
            scene, factory = prepare_tracer_factory(scene, cfg,
                                                    device=device)
        else:
            factory = lambda *_: tracer  # noqa: E731
        step, _ = make_render_fn_dist(scene, cfg, mesh,
                                      tracer_factory=factory)
        film = film_create_sharded(cfg, mesh)
    else:
        step = (make_render_fn(scene, cfg, device=device) if tracer is None
                else make_render_fn(scene, cfg, tracer=tracer, device=device))
        film = film_create(h, w, device=device, aov=cfg.aov)
    rays = 0
    t0 = time.perf_counter()
    for _ in range(args.subframes):
        film, stats = step(cam, film)
        rays += int(stats.radiance_rays) + int(stats.shadow_rays)
    dt = time.perf_counter() - t0
    if mesh is not None:
        from ..parallel.multihost import assemble_film

        # every rank takes part in the gathers; process 0 writes
        film = Film(accum=assemble_film(film.accum, mesh),
                    subframe_index=film.subframe_index,
                    **{k: assemble_film(getattr(film, k), mesh)
                       for k in ("albedo", "normal")
                       if getattr(film, k) is not None})
        if mesh.rank != 0:
            return 0
    save(args.output, denoised(film, args.denoise), film)
    print(f"wrote {args.output}: {w}x{h}, {args.subframes * args.spp} spp, "
          f"{rays / 1e6:.1f} Mrays in {dt:.2f}s on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
