"""The external pipeline of the 2049-16384-face band against the reference.

K6's plain version (external_shade_ref) is teacher-forced against the
reference's external shade kernel (make_external_shader, Pallas interpret
mode) for 8 iterations at pool 512 on the static and the 2-key 4294-face
town: both get the same lanes and closest hits at every step, and lanes
that died restart as fresh camera paths. Integer columns (seed bits,
depth, alive, pixel, sample, want_shadow) exact and float columns within
rtol = atol = 3e-5, each on at least 98% of the lanes that were alive
(last-ulp differences of sqrt/cos between XLA and torch may flip one
lane's Russian roulette); and textured K6 the same way on the textured
town, the reference fed the pre-sampled texel block as its
ExternalPipeline.trace_shade builds it (pallas_shade.py:1877-1882). The
whole slice renders against the
reference's render_frame over its own choose_tracer(on_tpu=True) pipeline
by the strict rule of tests/test_external.py:35-55, and out-of-slice
scenes and configs raise NotImplementedError naming their ROADMAP item."""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import morton_order_scene as j_morton_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu.trace.pallas_shade import make_external_shader
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.io.genassets import generate_town
from rendertoy3c_tpu_torch.io.obj import load_obj
from rendertoy3c_tpu_torch.scene.builtin import box_mesh, cornell_box, quad
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.scene.material import Material, MaterialType
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import box_grid_meshes, j_town_scene

FACES = 4000  # 4294 faces: inside the 2049-16384 band
POOL = 512
KW = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
          ray_block=256, integrator="pool", pool_pixel_major=True)
INT_COLS = [0, 8, 9, 13, 14, 15]  # seed bits, depth, alive, pixel, samp, shadow
FLOAT_COLS = [c for c in range(24) if c not in INT_COLS]


@pytest.fixture(scope="module")
def towns(tmp_path_factory):
    """{two_key: (reference scene, port scene, port camera)}, in the face
    order of the loaded files."""
    out = {}
    for two_key in (False, True):
        js, _ = j_town_scene(FACES, two_key,
                             tmp_path_factory.mktemp(f"town{int(two_key)}"))
        ts, cam = town_scene(FACES, two_key)
        out[two_key] = (js, ts, cam)
    return out


def _lane_state(cam, n, rng):
    """A first-bounce pool state: camera rays, fresh paths, random seeds,
    90% of the lanes alive."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = p.eye
    rays[:, 3:6] = d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((n, 16), np.float32)
    misc[:, 0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[:, 1:7] = 1.0
    misc[:, 9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[:, 13] = np.arange(n)
    misc[:, 14] = 1.0
    return rays, misc


def _lanes_agree(got, want, cols, exact):
    if exact:
        ok = got[:, cols].view(np.uint32) == want[:, cols].view(np.uint32)
    else:
        ok = np.isclose(got[:, cols], want[:, cols], rtol=3e-5, atol=3e-5)
    return ok.all(axis=1)


@pytest.fixture(scope="module")
def textured_towns(tmp_path_factory):
    """As `towns`, with the town's checker and brick textures."""
    out = {}
    for two_key in (False, True):
        js, _ = j_town_scene(FACES, two_key, tmp_path_factory.mktemp(
            f"tex{int(two_key)}"), textured=True)
        ts, cam = town_scene(FACES, two_key, textured=True)
        out[two_key] = (js, ts, cam)
    return out


@pytest.mark.parametrize("two_key", [False, True])
def test_external_shade_ref_matches_reference_kernel(towns, two_key):
    _teacher_force(towns[two_key], two_key)


@pytest.mark.parametrize("two_key", [False, True])
def test_textured_external_shade_ref_matches_reference_kernel(
        textured_towns, two_key):
    _teacher_force(textured_towns[two_key], two_key)


def _teacher_force(scenes, two_key, kw=KW):
    js, ts, cam = scenes
    ts, pipe = choose_tracer(ts, RenderConfig(**kw), "cpu")
    if not two_key:
        js = j_morton_order(js)
    assert isinstance(pipe, shade.ExternalPipeline)
    assert pipe.motion == two_key
    j_shade, attr_rows, presample = make_external_shader(
        js, JConfig(**kw), motion=two_key, interpret=True)
    assert (presample is None) == (pipe.tables.tex is None)
    attr_rows = np.asarray(attr_rows)
    np.testing.assert_array_equal(pipe.tables.attr.numpy(), attr_rows)
    rng = np.random.default_rng(17 + int(two_key))
    rays, misc = _lane_state(cam, POOL, rng)
    count = torch.tensor([POOL], dtype=torch.int32)
    alive_lanes = []
    for _ in range(8):
        time = (torch.as_tensor(rng.uniform(0, 1, POOL).astype(np.float32))
                if two_key else None)
        rt, mt_ = torch.as_tensor(rays), torch.as_tensor(misc)
        hit = pipe._closest(rt[:, 0:3], rt[:, 3:6], rt[:, 6], rt[:, 7], time,
                            count)
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        hit8 = np.concatenate([hit4.numpy(), np.zeros((POOL, 4), np.float32)],
                              axis=1)
        attr_t = attr_rows[np.maximum(hit.prim.numpy(), 0)]
        if presample is not None:  # the texel rows ride the gathered block
            attr_t = np.concatenate([attr_t, np.asarray(presample(
                jnp.asarray(attr_t), jnp.asarray(hit.u.numpy()),
                jnp.asarray(hit.v.numpy())))], axis=1)
        attr_t = attr_t.T
        want = [np.array(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(hit8), jnp.asarray(misc),
            jnp.asarray(attr_t), POOL)]
        got = [x.numpy() for x in shade.external_shade_ref(
            rt, hit4, mt_, pipe.tables, pipe.config)]
        assert [g.shape for g in got] == [w.shape for w in want]
        alive = misc[:, 9] > 0
        alive_lanes.append(int(alive.sum()))
        ok_int = _lanes_agree(got[1], want[1], INT_COLS, exact=True)
        ok_float = (_lanes_agree(got[1], want[1], FLOAT_COLS, exact=False)
                    & _lanes_agree(got[0], want[0], list(range(8)), False)
                    & _lanes_agree(got[2], want[2],
                                   list(range(want[2].shape[1])), False))
        assert ok_int[alive].mean() >= 0.98
        assert ok_float[alive].mean() >= 0.98
        # the next state: the reference's, its NEE added where the shadow
        # ray is unoccluded, as ExternalPipeline.trace_shade does
        sh = torch.as_tensor(want[2])
        occ = pipe._any(sh[:, 0:3], sh[:, 3:6], sh[:, 6], sh[:, 7],
                        sh[:, 8] if two_key else None, count).numpy()
        rays = want[0]
        misc = want[1][:, :16].copy()
        misc[:, 10:13] += np.where(occ[:, None], 0.0, want[1][:, 16:19])
        dead = misc[:, 9] <= 0
        fresh = _lane_state(cam, POOL, rng)
        rays[dead], misc[dead] = fresh[0][dead], fresh[1][dead]
    assert min(alive_lanes) > POOL // 2
    assert (misc[:, 8] >= 3).any()  # some paths went several bounces deep


@pytest.mark.parametrize("pool_stash", [-1, 1])
@pytest.mark.parametrize("two_key", [False, True])
def test_render_matches_reference_external_pipeline(towns, two_key,
                                                    pool_stash):
    """tests/test_external.py `_match`, strict: >98% of pixels at rtol =
    atol = 3e-5, means within 5e-3, ray counts within 2% + 16. pool_stash
    -1 (auto: off for the external pipeline) and 1 (the stash branch)."""
    _match_external(*towns[two_key], dict(KW, pool_stash=pool_stash))


def _match_external(js, ts, cam, kw):
    """The port's render against the reference's over its own
    ExternalPipeline by the strict rule."""
    jcfg = JConfig(**kw)
    j_scene, j_pipe = j_choose_tracer(js, jcfg, on_tpu=True)
    assert type(j_pipe).__name__ == "ExternalPipeline"
    f_ref, s_ref = j_render_frame(j_scene, cam.params(), jcfg, subframes=1,
                                  tracer=j_pipe)
    f, s = render_frame(ts, cam.params(), RenderConfig(**kw), subframes=1,
                        device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=5e-3)
    assert np.isfinite(a).all() and a.mean() > 0.05
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= 0.02 * int(want) + 16


def test_pool_stash_option_renders_the_same_image(towns):
    """cfg.pool_stash=1 takes the stash branch of the XLA-refill loop; the
    per-pixel streams and so the image do not change."""
    _, ts, cam = towns[True]
    films = [render_frame(ts, cam.params(),
                          RenderConfig(**KW, pool_stash=stash), device="cpu")
             for stash in (-1, 1)]
    np.testing.assert_allclose(films[0][0].accum.numpy(),
                               films[1][0].accum.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert int(films[0][1].radiance_rays) == int(films[1][1].radiance_rays)


def _lit_box_grid(n, pkg="torch"):
    """n * n boxes under a lamp, built by the port ("torch") or the
    reference ("jax")."""
    if pkg == "torch":
        mat, mesh, box, quad_fn = Material, Mesh, box_mesh, quad
    else:
        from rendertoy3c_tpu.scene.builtin import box_mesh as mesh_fn
        from rendertoy3c_tpu.scene.builtin import quad as quad_fn
        from rendertoy3c_tpu.scene.material import Material as mat
        from rendertoy3c_tpu.scene.mesh import Mesh as mesh
        box = mesh_fn
    lv, lf = quad_fn([0, 8, 0], [0, 8, n], [n, 8, n], [n, 8, 0])
    return box_grid_meshes(mat, mesh, box, n=n) + [
        mesh(vertices=lv[None], indices=lf,
             material=mat(emissive=(30.0, 30.0, 30.0)))]


def _principled_grid_pair():
    """(reference scene, port scene, camera): 2354 faces, the boxes
    PRINCIPLED."""
    from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene

    scenes = []
    for pkg, build in (("jax", j_build_scene), ("torch", build_scene)):
        meshes = _lit_box_grid(14, pkg)
        meshes[0].material = dataclasses.replace(
            meshes[0].material, material_type=MaterialType.PRINCIPLED,
            roughness=0.3, metallic=0.5)
        scenes.append(build(meshes))
    return (*scenes, Camera(eye=(7.0, 12.0, 24.0), lookat=(7.0, 0.0, 7.0),
                            fov_y=50.0))


def _three_key_town(tmp_path):
    paths, _ = generate_town(str(tmp_path), faces_target=FACES,
                             two_key=True)
    meshes, _ = load_obj([paths[0], paths[1], paths[0]])
    for m in meshes:
        m.material = dataclasses.replace(
            m.material, diffuse_texture_id=-1, emissive_texture_id=-1,
            roughness_texture_id=-1, normal_texture_id=-1)
    return build_scene(meshes)


def _textured_town(tmp_path):
    paths, _ = generate_town(str(tmp_path), faces_target=FACES)
    meshes, textures = load_obj(paths)
    return build_scene(meshes, textures=textures)


def _moving_cornell():
    meshes, _ = cornell_box()
    v = meshes[-1].vertices
    meshes[-1] = dataclasses.replace(
        meshes[-1], vertices=np.concatenate([v, v + [0.1, 0.0, 0.0]]))
    return build_scene(meshes)


@pytest.mark.parametrize("case, item", [
    ("17k_faces", "A17/A18"),
    ("three_keys", "A5"),
    ("textured_obj", "A12"),
    ("two_key_cornell", "A11"),
    ("principled", "A12"),
    ("power_sampler", "A12"),
    ("aov", "A13"),
    ("sorted", "A8"),
    ("sample_major", "A8"),
])
def test_out_of_slice_raises_naming_roadmap_item(towns, tmp_path, case,
                                                 item):
    """Cases of a ported ROADMAP item now render: the 2-key Cornell box
    through the fused pipeline's motion variant (A11), the town's sorted and
    sample-major pools through the external pipeline (A8), the textured
    town through the external pipeline's textured K6 (A12's textures), and
    a principled scene, the power pick (A12's dispatch and power sampler)
    and AOV (A13) as the reference renders them (`_match_external`)."""
    if case == "principled":
        _match_external(*_principled_grid_pair(), KW)
        return
    if case in ("power_sampler", "aov"):
        _match_external(*towns[False], dict(KW, **{
            "power_sampler": dict(light_sampler="power"),
            "aov": dict(aov=True)}[case]))
        return
    scene, cfg = towns[False][1], RenderConfig(**KW)
    if case == "17k_faces":
        scene = build_scene(_lit_box_grid(38))
        assert scene.num_faces > shade.EXTERNAL_MAX_FACES
    elif case == "three_keys":
        scene = _three_key_town(tmp_path)
        assert scene.num_keys == 3
    elif case == "textured_obj":
        scene = _textured_town(tmp_path)
        assert scene.textured
    elif case == "two_key_cornell":
        scene = _moving_cornell()
        assert scene.num_keys == 2 and scene.num_faces <= shade.MAX_FACES
    else:
        change = {"sorted": dict(sort_rays=True),
                  "sample_major": dict(pool_pixel_major=False)}[case]
        cfg = dataclasses.replace(cfg, **change)
    if item in ("A8", "A11") or case == "textured_obj":
        _, pipe = choose_tracer(scene, cfg, "cpu")
        want = shade.FusedPipeline if item == "A11" else shade.ExternalPipeline
        assert isinstance(pipe, want)
        assert pipe.motion == (item == "A11")
        assert (pipe.tables.tex is not None) == (case == "textured_obj")
        return
    with pytest.raises(NotImplementedError, match=item):
        choose_tracer(scene, cfg, "cpu")


def test_cli_renders_obj_keyframes(tmp_path):
    """--scene a.obj b.obj: two files are two motion keys. The generated
    town renders with its textures, and without its map_Kd lines."""
    from rendertoy3c_tpu_torch.app import cli

    paths, _ = generate_town(str(tmp_path / "tex"), faces_target=FACES,
                             two_key=True)
    args = ["--size", "16x16", "--spp", "1", "--subframes", "1", "--eye",
            "38,26,46", "--lookat", "0,1.5,0", "--fov", "42", "--device",
            "cpu", "-o"]
    assert cli.main(["--scene", *paths, *args, str(tmp_path / "t.png")]) == 0
    assert (tmp_path / "t.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    plain = tmp_path / "plain"
    shutil.copytree(tmp_path / "tex", plain)
    mtl = plain / f"town{FACES // 1000}k.mtl"
    mtl.write_text("".join(line for line in mtl.read_text().splitlines(True)
                           if not line.startswith("map_")))
    out = tmp_path / "town.png"
    keys = [str(plain / os.path.basename(p)) for p in paths]
    assert cli.main(["--scene", *keys, *args, str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
