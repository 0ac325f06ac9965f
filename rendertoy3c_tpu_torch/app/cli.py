"""Command-line renderer of the port.

Port of the path-render subset of rendertoy3c_tpu/app/cli.py:

  python -m rendertoy3c_tpu_torch.app.cli --scene cornell --size 768x768 \\
      --spp 8 --subframes 4 -o out.png --device cuda

It renders the builtin Cornell box with the main path's pool settings
(pixel-major pool, max_depth 16, ray_block 32768) and writes a PNG.
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
from ..scene.builtin import cornell_box
from ..scene.scene import build_scene


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rendertoy3c_tpu_torch",
                                description="Progressive Monte-Carlo path "
                                "tracer (PyTorch + CUDA port)")
    p.add_argument("--scene", choices=["cornell"], required=True)
    p.add_argument("--size", default="768x768", help="WxH")
    p.add_argument("--spp", type=int, default=8, help="samples per launch")
    p.add_argument("--subframes", type=int, default=16,
                   help="progressive launches to accumulate")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


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
                       max_depth=16, ray_block=32768, integrator="pool",
                       pool_pixel_major=True)
    meshes, camera = cornell_box()
    camera.aspect_ratio = w / h
    step = make_render_fn(build_scene(meshes), cfg, device=device)
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
