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
--flush-every (0 = auto), --light-sampler (uniform or power), --aov (the
first-hit albedo and normal guide buffers) and --denoise N (N a-trous
iterations before saving, guided by the AOV buffers when --aov is on), and
writes the image in the format its extension names, as the reference's
CLI does (:467-520): linear float OpenEXR for .exr, binary PPM for .ppm,
PNG otherwise. With --aov the guides go beside it as
<stem>.albedo<ext> and <stem>.normal<ext>.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..film.denoise import atrous_denoise
from ..film.film import film_create
from ..film.image import write_exr, write_png, write_ppm
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
    p.add_argument("--denoise", type=int, default=0, metavar="N",
                   help="apply N a-trous denoiser iterations before saving "
                        "(uses the AOV guide buffers when --aov is on)")
    p.add_argument("--aov", action="store_true",
                   help="also accumulate first-hit albedo/normal AOVs; "
                        "written as <output>.albedo/.normal and used as "
                        "denoiser guides")
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
    cfg = RenderConfig(width=w, height=h, samples_per_launch=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       ray_block=args.ray_block, integrator="pool",
                       pool_pixel_major=True, flush_every=args.flush_every,
                       light_sampler=args.light_sampler, aov=args.aov)
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
    film = film_create(h, w, device=device, aov=cfg.aov)
    rays = 0
    t0 = time.perf_counter()
    for _ in range(args.subframes):
        film, stats = step(cam, film)
        rays += int(stats.radiance_rays) + int(stats.shadow_rays)
    dt = time.perf_counter() - t0
    save(args.output, denoised(film, args.denoise), film)
    print(f"wrote {args.output}: {w}x{h}, {args.subframes * args.spp} spp, "
          f"{rays / 1e6:.1f} Mrays in {dt:.2f}s on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
