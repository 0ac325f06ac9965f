"""The port's whole slice against the reference: renders, film, tonemap,
PNG bytes, the slice gate and the CLI."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.film.film import film_accumulate as j_accumulate
from rendertoy3c_tpu.film.film import film_create as j_film_create
from rendertoy3c_tpu.film.image import write_png as j_write_png
from rendertoy3c_tpu.film.tonemap import aces_tonemap as j_aces
from rendertoy3c_tpu.film.tonemap import make_color as j_make_color
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace.intersect import make_bruteforce_tracer
from rendertoy3c_tpu.trace.pallas_shade import make_fused_pipeline
from rendertoy3c_tpu_torch.film.film import film_accumulate, film_create
from rendertoy3c_tpu_torch.film.image import write_png
from rendertoy3c_tpu_torch.film.tonemap import aces_tonemap, make_color
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.integrate.walkpool import WalkPoolPipeline
from rendertoy3c_tpu_torch.scene.builtin import cornell_box
from rendertoy3c_tpu_torch.scene.material import Material, MaterialType
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import box_grid_meshes, cornell_pair


def _cfg(**kw):
    base = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
                ray_block=256, integrator="pool", pool_pixel_major=True)
    base.update(kw)
    return base


def gate(a, b):
    """bench.py:115-116: mean|d| <= 2e-3, <= 8 pixels above 0.35, max <= 8."""
    diff = np.abs(a - b)
    outliers = int((diff.max(axis=-1) > 0.35).sum())
    return diff.mean() <= 2e-3 and outliers <= 8 and diff.max() <= 8.0


def test_render_matches_reference_fused_pipeline():
    """tests/test_fused.py `_match` rule: >98% of pixels at rtol = atol =
    3e-5, means within 2e-3, ray counts within 1% + 8."""
    _match_fused(*cornell_pair(), _cfg())


def _match_fused(js, ts, jcam, tcam, kw):
    """The render of the port against the reference's fused pipeline by
    the `_match` rule."""
    f_ref, s_ref = j_render_frame(
        js, jcam.params(), JConfig(**kw), subframes=1,
        tracer=make_fused_pipeline(js, JConfig(**kw), interpret=True))
    f, s = render_frame(ts, tcam.params(), RenderConfig(**kw), subframes=1,
                        device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=2e-3)
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= 0.01 * int(want) + 8


def test_render_passes_gate_against_reference_brute_pool():
    js, ts, jcam, tcam = cornell_pair()
    kw = _cfg(width=32, height=32, max_depth=6, ray_block=2048)
    f_ref, _ = j_render_frame(js, jcam.params(), JConfig(**kw), subframes=1,
                              tracer=make_bruteforce_tracer(js))
    f, _ = render_frame(ts, tcam.params(), RenderConfig(**kw), subframes=1,
                        device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert gate(a, b), (np.abs(a - b).mean(), np.abs(a - b).max())
    assert 0.5 < a.mean() < 0.9 and np.isfinite(a).all()


def test_film_accumulate_matches_reference():
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 3, (3, 4, 5, 3)).astype(np.float32)
    jf = j_film_create(4, 5)
    tf = film_create(4, 5, device="cpu")
    for fr in frames:
        jf = j_accumulate(jf, jnp.asarray(fr))
        tf = film_accumulate(tf, torch.as_tensor(fr))
    np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                               rtol=1e-6, atol=1e-7)
    assert tf.subframe_index == int(jf.subframe_index) == 3


def test_make_color_and_png_bytes_match_reference(tmp_path):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.1, 1.2, (4096, 3)),
                        rng.exponential(0.3, (4096, 3))]).astype(np.float32)
    for alpha in (True, False):
        got = make_color(torch.as_tensor(x), alpha=alpha).numpy()
        want = np.asarray(j_make_color(jnp.asarray(x), alpha=alpha))
        assert (got.astype(int) - want.astype(int) != 0).mean() < 1e-3
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_allclose(aces_tonemap(torch.as_tensor(x)).numpy(),
                               np.asarray(j_aces(jnp.asarray(x))), rtol=1e-6)
    img = np.asarray(j_make_color(jnp.asarray(x[:64 * 32].reshape(64, 32, 3)),
                                  alpha=False))
    write_png(tmp_path / "port.png", img)
    j_write_png(str(tmp_path / "ref.png"), img)
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "ref.png").read_bytes()


def _textured_scene():
    meshes, _ = cornell_box()
    meshes[0].material = Material(diffuse_texture_id=0)
    checker = np.full((8, 8, 4), 255, np.uint8)
    checker[::2, ::2, :3] = 40
    return build_scene(meshes, textures=[checker])


def _mirror_pair():
    """cornell_pair() with the red wall a SPECULAR mirror."""
    from rendertoy3c_tpu.scene.builtin import cornell_box as j_cornell_box
    from rendertoy3c_tpu.scene.material import Material as JMaterial
    from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene

    jm, jcam = j_cornell_box()
    tm, tcam = cornell_box()
    jm[3].material = JMaterial(material_type=MaterialType.SPECULAR)
    tm[3].material = Material(material_type=MaterialType.SPECULAR)
    return j_build_scene(jm), build_scene(tm), jcam, tcam


def _motion_scene():
    meshes, _ = cornell_box()
    m = meshes[6]
    meshes[6] = type(m)(vertices=np.stack([m.vertices[0], m.vertices[0] + 0.1]),
                        indices=m.indices, material=m.material)
    return build_scene(meshes)


def _big_scene():
    from rendertoy3c_tpu_torch.scene.builtin import box_mesh
    from rendertoy3c_tpu_torch.scene.mesh import Mesh

    light = cornell_box()[0][5]
    return build_scene(box_grid_meshes(Material, Mesh, box_mesh, n=38)
                       + [light])


PORTED = ("A8", "A11")  # sorted and sample-major pools, fused motion
# A12's material dispatch and power pick, and A13's AOV: rendered against
# the reference
RENDERED = ("mirror", "power", "aov")
# A6, the wave integrator: rendered over the bare MT tracer against the
# reference's wave integrator over its brute tracer
WAVE = ("wave",)


@pytest.mark.parametrize("case, item", [
    ("textured", "A12"), ("mirror", "A12"), ("motion", "A11"),
    # scenes past 2048 faces: the external pipeline (A16) renders up to
    # 16384, the hierwalk band (A17/A18) beyond
    pytest.param("big", "A17/A18", id="big-A16"),
    ("power", "A12"), ("aov", "A13"), ("wave", "A6"),
    ("sample_major", "A8"),
])
def test_outside_the_slice_raises_naming_the_roadmap_item(case, item):
    """Cases of a ported ROADMAP item (PORTED) now take the fused pipeline:
    the 2-key Cornell box its motion variant, the sample-major pool K5, and
    a diffuse texture (A12's textures) the textured megakernel; a mirror
    wall (A12's dispatch), the power pick and AOV (A13) render as the
    reference does (`_match_fused`); a scene of more than 16384 faces
    takes the walk pool (A17/A18); the wave integrator (A6) takes the bare
    MT tracer and renders as the reference's wave integrator, by the
    gate."""
    if case in WAVE:
        js, ts, jcam, tcam = cornell_pair()
        kw = _cfg(integrator="wave")
        _, tracer = choose_tracer(ts, RenderConfig(**kw), "cpu")
        assert isinstance(tracer, tuple) and len(tracer) == 2
        f_ref, _ = j_render_frame(js, jcam.params(), JConfig(**kw),
                                  subframes=1,
                                  tracer=make_bruteforce_tracer(js))
        f, _ = render_frame(ts, tcam.params(), RenderConfig(**kw),
                            subframes=1, device="cpu")
        a, b = f.accum.numpy(), np.asarray(f_ref.accum)
        assert gate(a, b), (np.abs(a - b).mean(), np.abs(a - b).max())
        return
    if case in RENDERED:
        kw = _cfg(**{"power": dict(light_sampler="power"),
                     "aov": dict(aov=True)}.get(case, {}))
        _match_fused(*(_mirror_pair() if case == "mirror" else
                       cornell_pair()), kw)
        return
    scene = build_scene(cornell_box()[0])
    cfg = RenderConfig(**_cfg())
    if case in ("textured", "motion", "big"):
        scene = {"textured": _textured_scene, "motion": _motion_scene,
                 "big": _big_scene}[case]()
    else:
        change = {"wave": dict(integrator="wave"),
                  "sample_major": dict(pool_pixel_major=False)}[case]
        cfg = dataclasses.replace(cfg, **change)
    if case == "big":
        ordered, pipe = choose_tracer(scene, cfg, "cpu")
        assert isinstance(pipe, WalkPoolPipeline)
        assert pipe.num_faces == ordered.num_faces > 16384
        return
    if item in PORTED or case == "textured":
        _, pipe = choose_tracer(scene, cfg, "cpu")
        assert isinstance(pipe, shade.FusedPipeline)
        assert pipe.motion == (case == "motion")
        assert (pipe.tables.tex is not None) == (case == "textured")
        return
    with pytest.raises(NotImplementedError, match=item):
        choose_tracer(scene, cfg, "cpu")
    assert shade.fused_unsupported(build_scene(cornell_box()[0]),
                                   RenderConfig(**_cfg())) is None


def test_cli_writes_png(tmp_path):
    from rendertoy3c_tpu_torch.app import cli

    out = tmp_path / "c.png"
    assert cli.main(["--scene", "cornell", "--size", "16x16", "--spp", "1",
                     "--subframes", "1", "-o", str(out), "--device",
                     "cpu"]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("extra", [
    [], ["--max-depth", "7", "--seed", "11", "--ray-block", "4096",
         "--flush-every", "24"]], ids=["defaults", "given"])
def test_cli_config_matches_reference_cli(monkeypatch, tmp_path, extra):
    """The RenderConfig fields the reference CLI takes from its arguments
    (rendertoy3c_tpu/app/cli.py:244-251) have its names and defaults."""
    from rendertoy3c_tpu.app.cli import build_parser as j_build_parser
    from rendertoy3c_tpu_torch.app import cli

    seen = []

    class Stop(Exception):
        pass

    def fake_render_fn(scene, cfg, device):
        seen.append(cfg)
        raise Stop

    monkeypatch.setattr(cli, "make_render_fn", fake_render_fn)
    argv = ["--scene", "cornell", "--size", "16x16", "--device", "cpu",
            "-o", str(tmp_path / "x.png"), *extra]
    with pytest.raises(Stop):
        cli.main(argv)
    want = j_build_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")])
    cfg = seen[0]
    assert (cfg.max_depth, cfg.seed, cfg.ray_block, cfg.flush_every) == (
        want.max_depth, want.seed, want.ray_block, want.flush_every)
    assert cfg.pool_pixel_major and cfg.integrator == "pool"
