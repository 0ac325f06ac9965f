"""The a-trous denoiser (film/denoise.py) against the reference's, and the
CLI's --aov --denoise.

`atrous_denoise` against rendertoy3c_tpu/film/denoise.py on random buffers
(a 24x20 image, values in [0, 2)): without guides, with the normal guide
(unit normals near +z), with the normal and position guides, at 1, 2 and 3 iterations, within
atol 1e-5 (the two take the same operations in the same order; the
exponentials and divisions of the two libraries may differ in the last
bit). The mirrors of tests/test_viewer_denoise.py: noise reduced and a hard
edge kept; finite output with guides. The CLI: `--aov --denoise 2` on the
CPU at 20^2 writes out.png, out.albedo.png and out.normal.png (as
tests/test_aov.py:85-98), and with `-o out.exr` three EXR files whose
guides are the film's buffers as raw floats; the denoised image is the
reference CLI's recipe (albedo demodulation, the normal buffer as a
guide) applied to the film.
"""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.film.denoise import atrous_denoise as j_atrous
from rendertoy3c_tpu_torch.film.denoise import atrous_denoise
from torch_port_util import cornell_pair  # noqa: F401 (sets the threads)


@pytest.mark.parametrize("iterations", [1, 2, 3])
@pytest.mark.parametrize("guides", ["none", "normal", "normal_position"])
def test_atrous_matches_reference(guides, iterations):
    rng = np.random.default_rng(iterations * 7 + len(guides))
    h, w = 24, 20
    rgb = rng.uniform(0, 2, (h, w, 3)).astype(np.float32)
    # guides close enough between neighbours that their weights matter
    normal = (np.float32([0, 0, 1])
              + 0.15 * rng.normal(size=(h, w, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    position = rng.uniform(0, 0.5, (h, w, 3)).astype(np.float32)
    kw = {}
    if guides != "none":
        kw["normal"] = normal
    if guides == "normal_position":
        kw["position"] = position
    got = atrous_denoise(torch.as_tensor(rgb), iterations=iterations,
                         **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = j_atrous(jnp.asarray(rgb), iterations=iterations,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert not np.allclose(got.numpy(), rgb, atol=1e-2)  # it filtered


def test_denoiser_reduces_noise_preserves_edges():
    rng = np.random.default_rng(0)
    h, w = 48, 48
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2:] = 1.0  # hard vertical edge
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = atrous_denoise(torch.as_tensor(noisy), iterations=3).numpy()
    mse_in = ((noisy - clean)[:, : w // 2 - 4] ** 2).mean()
    mse_out = ((out - clean)[:, : w // 2 - 4] ** 2).mean()
    assert mse_out < 0.4 * mse_in
    assert out[:, : w // 2 - 4].mean() < 0.3
    assert out[:, w // 2 + 4:].mean() > 0.7


def test_denoiser_with_guides():
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    n = torch.as_tensor(np.tile([0.0, 0.0, 1.0], (16, 16, 1)).astype(
        np.float32))
    out = atrous_denoise(img, normal=n, position=img, iterations=2)
    assert torch.isfinite(out).all()


ARGS = ["--scene", "cornell", "--size", "20x20", "--spp", "1",
        "--subframes", "2", "--max-depth", "3", "--ray-block", "512",
        "--aov", "--denoise", "2", "--device", "cpu"]


def test_aov_cli_writes_guides_and_denoises(tmp_path):
    from rendertoy3c_tpu_torch.app.cli import main

    out = str(tmp_path / "out.png")
    assert main(ARGS + ["-o", out]) == 0
    for name in ("out.png", "out.albedo.png", "out.normal.png"):
        assert os.path.getsize(tmp_path / name) > 100, name


def _read_exr(path):
    """[H, W, 3] float32 of an uncompressed scanline EXR as write_exr lays
    it out (channels B, G, R per scanline)."""
    data = open(path, "rb").read()
    assert struct.unpack_from("<i", data)[0] == 20000630
    w, h = 20, 20
    first = len(data) - h * (8 + 12 * w)  # the scanline chunks end the file
    out = np.empty((h, w, 3), np.float32)
    for y in range(h):
        row = np.frombuffer(data, np.float32, 3 * w, first + y * (8 + 12 * w)
                            + 8)
        out[y] = row.reshape(3, w)[::-1].T  # B, G, R -> R, G, B
    return out


def test_aov_cli_exr_holds_the_film(tmp_path):
    """-o out.exr: the radiance is the film denoised by the reference CLI's
    recipe, and the guides are the film's buffers, each flipped to
    top-first."""
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    out = str(tmp_path / "out.exr")
    assert cli.main(ARGS + ["-o", out]) == 0
    meshes, cam = cornell_box()
    cfg = RenderConfig(width=20, height=20, samples_per_launch=1,
                       max_depth=3, ray_block=512, integrator="pool",
                       pool_pixel_major=True, aov=True)
    step = make_render_fn(build_scene(meshes), cfg, device="cpu")
    film = film_create(20, 20, device="cpu", aov=True)
    for _ in range(2):
        film, _ = step(cam.params(), film)
    alb = torch.clamp(film.albedo, min=1e-3)
    want = atrous_denoise(film.accum / alb, normal=film.normal,
                          iterations=2) * alb
    for name, buf in (("out.exr", want), ("out.albedo.exr", film.albedo),
                      ("out.normal.exr", film.normal)):
        path = str(tmp_path / name)
        assert os.path.getsize(path) > 20 * 20 * 12
        np.testing.assert_array_equal(_read_exr(path),
                                      buf.numpy()[::-1], err_msg=name)
    assert (film.albedo.numpy().sum(axis=-1) > 0).mean() > 0.9
