"""Command-line renderer of the port.

Port of the path-render subset of rendertoy3c_tpu/app/cli.py:

  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --size 768x768 \\
      --spp 8 --subframes 4 -o out.png --device cuda
  python -m rendertoy3c_tpu_torch.app.cli --scene a.obj b.obj \\
      --eye 38,26,46 --lookat 0,1.5,0 --fov 42 -o out.png --device cuda

`--scene` takes the builtin Cornell box, the builtin textured quad
(`textured`), or .obj files, where N files are N motion keyframes (the
reference loader's rule), with the textures their .mtl files name. The
.obj camera defaults to the reference app's framing, eye (5,5,5) toward
(0,1,0) at fov 45 (rendertoy3c_tpu/app/cli.py:192-197); `--eye --lookat
--fov` override it.
It renders on the pixel-major pool with the reference CLI's names and
defaults for --max-depth (32), --seed (0), --ray-block (65536),
--flush-every (0 = auto) and --light-sampler (uniform or power), and
writes a PNG.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..film.film import film_create
from ..film.image import write_png
from ..film.tonemap import make_color
from ..integrate.config import RenderConfig
from ..integrate.path import make_render_fn
from ..scene.builtin import cornell_box, textured_quad_scene
from ..scene.camera import Camera
from ..scene.scene import build_scene


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
                   help="cornell, textured, or .obj path(s): N files = N "
                   "motion keyframes")
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
    p.add_argument("--ray-block", type=int, default=1 << 16)
    p.add_argument("--flush-every", type=int, default=0,
                   help="pool framebuffer flush cadence, 0 = auto by "
                   "frame and pool size")
    p.add_argument("--light-sampler", choices=["uniform", "power"],
                   default="uniform")
    return p


def load_scene(names):
    """(meshes, textures, camera) of a builtin scene or of .obj keyframes
    (rendertoy3c_tpu/app/cli.py:157-198)."""
    if names == ["cornell"]:
        meshes, camera = cornell_box()
        return meshes, [], camera
    if names == ["textured"]:
        return textured_quad_scene()
    if not all(n.endswith(".obj") for n in names):
        raise SystemExit(f"--scene: expected cornell, textured or .obj "
                         f"files, got {names}")
    from ..io.obj import load_obj

    meshes, textures = load_obj(names)
    return meshes, textures, Camera(eye=(5.0, 5.0, 5.0),
                                    lookat=(0.0, 1.0, 0.0), fov_y=45.0)


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
    cfg = RenderConfig(width=w, height=h, samples_per_launch=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       ray_block=args.ray_block, integrator="pool",
                       pool_pixel_major=True, flush_every=args.flush_every,
                       light_sampler=args.light_sampler)
    meshes, textures, camera = load_scene(args.scene)
    if args.eye:
        camera.eye = args.eye
    if args.lookat:
        camera.lookat = args.lookat
    if args.fov:
        camera.fov_y = args.fov
    camera.aspect_ratio = w / h
    step = make_render_fn(build_scene(meshes, textures=textures or None),
                          cfg, device=device)
    cam = camera.params()
    film = film_create(h, w, device=device)
    rays = 0
    t0 = time.perf_counter()
    for _ in range(args.subframes):
        film, stats = step(cam, film)
        rays += int(stats.radiance_rays) + int(stats.shadow_rays)
    dt = time.perf_counter() - t0
    img = make_color(film.accum, alpha=False).cpu().numpy()[::-1]
    write_png(args.output, np.ascontiguousarray(img))  # row 0 = bottom
    print(f"wrote {args.output}: {w}x{h}, {args.subframes * args.spp} spp, "
          f"{rays / 1e6:.1f} Mrays in {dt:.2f}s on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
