"""Whole renders with the material dispatch and the power light pick
through the port's choose_tracer against the reference's render over its
own pipeline (Pallas in interpret mode).

Fused pipeline: the Cornell box with all four material types
(scene/builtin.py material_cornell_box), uniform and power pick,
pixel-major (K4 dispatch), sorted and sample-major (K5 dispatch), and its
2-key variant sample-major; the principled, normal-mapped textured quad. By
the `_match` rule of tests/test_fused.py: >98% of pixels within rtol =
atol = 3e-5, means within rtol 2e-3, ray counts within 1% + 8, pool
iterations equal.

External pipeline: the principled 4294-face town (BASELINE config 5's
scene: textured, power pick, sorted), by the strict rule of
tests/test_external.py: >98% of pixels within 3e-5, means within 5e-3, ray
counts within 2% + 16, pool iterations equal.

The CLI's --light-sampler power: its image equals the same render through
make_render_fn."""
import numpy as np
import pytest

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu.trace.pallas_shade import (fused_shade_eligible,
                                                make_fused_pipeline)
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from test_torch_textured_render import KW, SCHEDULES, _assert_match, _subframe
from torch_port_util import (j_town_scene, material_cornell_pair,
                             textured_quad_pair)


def _fused_match(scenes, kw):
    js, ts, _, tcam = scenes
    assert fused_shade_eligible(js, JConfig(**kw))
    j_pipe = make_fused_pipeline(js, JConfig(**kw), interpret=True)
    got, want, pipe = _subframe(js, j_pipe, ts, tcam, kw)
    assert isinstance(pipe, shade.FusedPipeline)
    assert pipe.tables.params_base > 0
    assert pipe.config.power == (kw.get("light_sampler") == "power")
    _assert_match(got, want, 2e-3, 0.01, 8)
    return pipe


@pytest.mark.parametrize("sampler, motion, schedule", [
    ("uniform", False, "pixel_major"), ("power", False, "pixel_major"),
    ("uniform", False, "sorted"), ("power", False, "sorted"),
    ("uniform", False, "sample_major"), ("power", False, "sample_major"),
    ("power", True, "sample_major")])
def test_material_cornell_matches_reference(sampler, motion, schedule):
    kw = dict(KW, light_sampler=sampler, **SCHEDULES[schedule])
    pipe = _fused_match(material_cornell_pair(motion), kw)
    assert pipe.motion == motion


def test_principled_quad_matches_reference():
    pipe = _fused_match(textured_quad_pair("principled"), KW)
    assert pipe.tables.tex is not None and pipe.tables.tex.normal_maps


def test_principled_town_matches_reference(tmp_path):
    """BASELINE config 5 (bench.py:517-520) at 4294 faces and 16^2."""
    js, _ = j_town_scene(4000, False, tmp_path, textured=True,
                         principled=True)
    ts, cam = town_scene(4000, textured=True, principled=True)
    kw = dict(KW, light_sampler="power", sort_rays=True)
    js, j_pipe = j_choose_tracer(js, JConfig(**kw), on_tpu=True)
    assert type(j_pipe).__name__ == "ExternalPipeline"
    got, want, pipe = _subframe(js, j_pipe, ts, cam, kw)
    assert isinstance(pipe, shade.ExternalPipeline)
    assert pipe.tables.params_base > 0 and pipe.tables.tex is not None
    assert pipe.config.power
    _assert_match(got, want, 5e-3, 0.02, 16)


def test_cli_light_sampler_power_matches_render(monkeypatch, tmp_path):
    """--scene cornell --light-sampler power --device cpu: the image the
    CLI writes is the one make_render_fn renders under that config."""
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.film.film import film_create
    from rendertoy3c_tpu_torch.film.tonemap import make_color
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    written, configs = [], []
    real = cli.make_render_fn

    def render_fn(scene, cfg, device):
        configs.append(cfg)
        return real(scene, cfg, device=device)

    monkeypatch.setattr(cli, "make_render_fn", render_fn)
    monkeypatch.setattr(cli, "write_png",
                        lambda path, img: written.append(img))
    assert cli.main(["--scene", "cornell", "--size", "16x16", "--spp", "2",
                     "--subframes", "2", "--max-depth", "4", "--ray-block",
                     "256", "--light-sampler", "power", "--device", "cpu",
                     "-o", str(tmp_path / "p.png")]) == 0
    cfg, = configs
    assert cfg == RenderConfig(width=16, height=16, samples_per_launch=2,
                               max_depth=4, ray_block=256, integrator="pool",
                               pool_pixel_major=True, light_sampler="power")
    meshes, camera = cornell_box()
    step = make_render_fn(build_scene(meshes), cfg, device="cpu")
    film = film_create(16, 16, device="cpu")
    for _ in range(2):
        film, _ = step(camera.params(), film)
    want = make_color(film.accum, alpha=False).numpy()[::-1]
    np.testing.assert_array_equal(written[0], want)
