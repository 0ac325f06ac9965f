"""The port's glTF loader (io/gltf.py) against the reference's: the scenes
of tests/test_gltf.py (written by its own helpers) and chip_smoke.py's
Cornell .glb, loaded by both packages: meshes at every key, materials
field by field, texture bytes and wraps, cameras and point lights equal,
and the scenes' tables array-equal; CUBICSPLINE, slerp and STEP
channels; the A21 refusals; textures without Pillow; whole renders of the
animated Cornell .glb at 2 and 3 keys against the reference's; the CLI's
glTF route."""
from __future__ import annotations

import base64
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from chip_smoke import cornell_glb
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.io.gltf import load_gltf as j_load_gltf
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.io.gltf import load_gltf
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from test_gltf import _buffer_gltf, _quad_gltf, _skinned_gltf, _tiny_png_uri

torch.set_num_threads(1)


def _edit(path, fn):
    j = json.loads(open(path).read())
    fn(j)
    open(path, "w").write(json.dumps(j))
    return path


def _node_transform(tmp_path):
    def move(j):
        j["nodes"][0]["translation"] = [5.0, 0.0, 0.0]
        j["nodes"][0]["scale"] = [2.0, 2.0, 2.0]
        j["nodes"][0]["rotation"] = [0.0, 0.3826834, 0.0, 0.9238795]
    return _edit(_quad_gltf(tmp_path), move)


def _sampler_wraps(tmp_path):
    def wraps(j):
        j["images"] = [{"uri": _tiny_png_uri()}]
        j["samplers"] = [{"wrapS": 33071, "wrapT": 33648}, {}]
        j["textures"] = [{"source": 0, "sampler": 0},
                         {"source": 0, "sampler": 1}]
        pbr = j["materials"][0]["pbrMetallicRoughness"]
        pbr["baseColorTexture"] = {"index": 0}
        j["materials"][0]["emissiveTexture"] = {"index": 1}
    return _edit(_quad_gltf(tmp_path), wraps)


def _khr_materials(tmp_path):
    def khr(j):
        j["materials"][0]["emissiveFactor"] = [0.2, 0.1, 0.0]
        j["materials"][0]["extensions"] = {
            "KHR_materials_emissive_strength": {"emissiveStrength": 5.0},
            "KHR_materials_ior": {"ior": 1.8}}
        j["materials"].append({
            "pbrMetallicRoughness": {"baseColorFactor": [1, 1, 1, 1]},
            "extensions": {"KHR_materials_transmission": {
                "transmissionFactor": 0.9}}})
        j["meshes"][0]["primitives"].append(
            dict(j["meshes"][0]["primitives"][0], material=1))
    return _edit(_quad_gltf(tmp_path), khr)


def _interp(tmp_path, interpolation):
    """tests/test_gltf.py:366-403's animated triangle under LINEAR or
    STEP."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    j = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
         "nodes": [{"mesh": 0}],
         "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                     "indices": 1}]}],
         "animations": [{"samplers": [{"input": 2, "output": 3,
                                       "interpolation": interpolation}],
                         "channels": [{"sampler": 0, "target": {
                             "node": 0, "path": "translation"}}]}],
         "accessors": [
             {"bufferView": 0, "componentType": 5126, "count": 3,
              "type": "VEC3"},
             {"bufferView": 1, "componentType": 5123, "count": 3,
              "type": "SCALAR"},
             {"bufferView": 2, "componentType": 5126, "count": 2,
              "type": "SCALAR"},
             {"bufferView": 3, "componentType": 5126, "count": 2,
              "type": "VEC3"}]}
    return _buffer_gltf(tmp_path, j, [
        pos, idx, np.array([0.0, 1.0], np.float32),
        np.array([[0, 0, 0], [4, 0, 0]], np.float32)])


def _cubic(tmp_path):
    """Three nodes animated by one clip: a CUBICSPLINE translation, a
    LINEAR rotation (slerp, with a sign flip on the shortest path) and a
    STEP scale."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    nrm = np.array([[0, 0, 1]] * 3, np.float32)
    idx = np.array([0, 1, 2], np.uint16)
    t = np.array([0.0, 1.0, 2.0], np.float32)
    cubic = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0],
                      [0.5, 1, 0], [1, 1, 0], [0, 2, 0],
                      [0, 0, 1], [2, 0.5, 0], [0, 0, 0]], np.float32)
    rot = np.array([[0, 0, 0, 1], [0, 0.7071068, 0, 0.7071068],
                    [0, -0.9238795, 0, -0.3826834]], np.float32)
    scale = np.array([[1, 1, 1], [2, 1, 1], [1, 3, 1]], np.float32)
    prim = {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}
    j = {"asset": {"version": "2.0"}, "scene": 0,
         "scenes": [{"nodes": [0, 1, 2]}],
         "nodes": [{"mesh": 0}, {"mesh": 0, "translation": [3, 0, 0]},
                   {"mesh": 0, "translation": [-3, 0, 0]}],
         "meshes": [{"primitives": [prim]}],
         "animations": [{
             "samplers": [
                 {"input": 3, "output": 4, "interpolation": "CUBICSPLINE"},
                 {"input": 3, "output": 5, "interpolation": "LINEAR"},
                 {"input": 3, "output": 6, "interpolation": "STEP"}],
             "channels": [
                 {"sampler": 0, "target": {"node": 0,
                                           "path": "translation"}},
                 {"sampler": 1, "target": {"node": 1, "path": "rotation"}},
                 {"sampler": 2, "target": {"node": 2, "path": "scale"}}]}],
         "accessors": [
             {"bufferView": 0, "componentType": 5126, "count": 3,
              "type": "VEC3"},
             {"bufferView": 1, "componentType": 5126, "count": 3,
              "type": "VEC3"},
             {"bufferView": 2, "componentType": 5123, "count": 3,
              "type": "SCALAR"},
             {"bufferView": 3, "componentType": 5126, "count": 3,
              "type": "SCALAR"},
             {"bufferView": 4, "componentType": 5126, "count": 9,
              "type": "VEC3"},
             {"bufferView": 5, "componentType": 5126, "count": 3,
              "type": "VEC4"},
             {"bufferView": 6, "componentType": 5126, "count": 3,
              "type": "VEC3"}]}
    return _buffer_gltf(tmp_path, j, [pos, nrm, idx, t, cubic, rot, scale])


def _cornell(tmp_path):
    path = str(tmp_path / "cornell.glb")
    cornell_glb(path)
    return path


# (scene writer, load_gltf times)
CASES = {
    "quad_gltf": (lambda p: _quad_gltf(p), None),
    "quad_glb": (lambda p: _quad_gltf(p, glb=True), None),
    "node_transform": (_node_transform, None),
    "sampler_wraps": (_sampler_wraps, None),
    "khr_materials": (_khr_materials, None),
    "skin_rest": (_skinned_gltf, None),
    "skin_animated": (_skinned_gltf, (0.0, 1.0)),
    "skin_3_keys": (_skinned_gltf, (0.0, 0.5, 1.0)),
    "linear": (lambda p: _interp(p, "LINEAR"), (0.5, 2.0)),
    "step": (lambda p: _interp(p, "STEP"), (0.5,)),
    "cubic_slerp_step": (_cubic, (0.0, 0.25, 0.5, 1.5, 2.5)),
    "cornell_glb": (_cornell, None),
    "cornell_glb_3_keys": (_cornell, (0.0, 0.5, 1.0)),
}


def assert_loads_equal(got, want):
    """(meshes, textures, cameras, lights) of the port against the
    reference's."""
    (tm, ttex, tcam, tl), (jm, jtex, jcam, jl) = got, want
    assert len(tm) == len(jm) and len(ttex) == len(jtex)
    for m, j in zip(tm, jm):
        for k in ("vertices", "indices", "normals", "texcoords"):
            a, b = getattr(m, k), getattr(j, k)
            assert (a is None) == (b is None), k
            if a is not None:
                assert a.dtype == np.asarray(b).dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        for f in dataclasses.fields(m.material):
            assert getattr(m.material, f.name) == \
                getattr(j.material, f.name), f.name
    for a, b in zip(ttex, jtex):
        assert a.data.dtype == np.uint8 and a.data.shape == b.data.shape
        assert a.data.tobytes() == b.data.tobytes()
        assert (a.wrap_s, a.wrap_t) == (b.wrap_s, b.wrap_t)
    assert len(tcam) == len(jcam)
    for a, b in zip(tcam, jcam):
        for k in ("eye", "lookat", "up", "fov_y", "aspect_ratio"):
            assert getattr(a, k) == getattr(b, k), k
    assert [dataclasses.asdict(x) for x in tl] == \
        [dataclasses.asdict(x) for x in jl]


def assert_scenes_equal(ts, js):
    for tnt, jnt in ((ts.geom, js.geom), (ts.materials, js.materials),
                     (ts.lights, js.lights), (ts.atlas, js.atlas)):
        for k in tnt._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tnt, k)),
                                          np.asarray(getattr(jnt, k)),
                                          err_msg=k)
    assert (ts.num_keys, ts.num_faces, ts.num_lights) == (
        js.num_keys, js.num_faces, js.num_lights)


@pytest.mark.parametrize("case", list(CASES))
def test_gltf_scenes_load_as_reference(tmp_path, case):
    write, times = CASES[case]
    path = write(tmp_path)
    got = load_gltf(path, times=times)
    want = j_load_gltf(path, times=times)
    assert_loads_equal(got, want)
    assert got[0] and got[0][0].num_keys == (len(times) if times else 1)
    assert_scenes_equal(build_scene(got[0], textures=got[1] or None),
                        j_build_scene(want[0], textures=want[1] or None))


def test_gltf_animation_samples(tmp_path):
    """The samplers' values the reference's test checks: LINEAR halfway
    and clamped, STEP held, skinning's top vertices following joint 1."""
    v = load_gltf(_interp(tmp_path, "LINEAR"), times=(0.5, 2.0))[0][0]
    np.testing.assert_allclose(v.vertices[:, 0], [[2, 0, 0], [4, 0, 0]],
                               atol=1e-6)
    v = load_gltf(_interp(tmp_path, "STEP"), times=(0.5,))[0][0]
    np.testing.assert_allclose(v.vertices[0, 0], [0, 0, 0], atol=1e-6)
    m = load_gltf(_skinned_gltf(tmp_path), times=(0.0, 1.0))[0][0]
    np.testing.assert_allclose(m.vertices[1], [[0, 0, 0], [1, 0, 0],
                                               [0, 2, 0], [1, 2, 0]],
                               atol=1e-6)


@pytest.mark.parametrize("case", ["mask", "blend", "texcoord_1"])
def test_gltf_refusals_name_a21(tmp_path, case):
    def edit(j):
        mat = j["materials"][0]
        if case == "texcoord_1":
            j["images"] = [{"uri": _tiny_png_uri()}]
            j["textures"] = [{"source": 0}]
            mat["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": 0, "texCoord": 1}
        else:
            mat["alphaMode"] = case.upper()
    path = _edit(_quad_gltf(tmp_path), edit)
    with pytest.raises(NotImplementedError, match="A21"):
        load_gltf(path)


def test_png_texture_loads_without_pillow(tmp_path, monkeypatch):
    """With Pillow hidden, the embedded PNG decodes through the port's own
    decoder to the bytes the reference gets from Pillow; an image that
    no decoder reads raises ValueError naming it."""
    path = _sampler_wraps(tmp_path)
    want = j_load_gltf(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = load_gltf(path)
    assert_loads_equal(got, want)
    bad = _edit(path, lambda j: j["images"][0].update(
        uri="data:image/jpeg;base64," + base64.b64encode(b"no image")
        .decode()))
    with pytest.raises(ValueError, match="image 0"):
        load_gltf(bad)


@pytest.mark.parametrize("times", [(0.0, 1.0), (0.0, 0.5, 1.0)],
                         ids=["2_keys", "3_keys"])
def test_animated_cornell_glb_renders_as_reference(tmp_path, times):
    """The animated Cornell .glb through each package's route: 2 keys the
    fused pipeline (K4's motion textured dispatch variant, the reference
    in interpret mode), 3 keys the brute tracer under the general pool;
    by the strict rule of tests/test_torch_external.py `_match_external`."""
    path = _cornell(tmp_path)
    tm, ttex, tcams, _ = load_gltf(path, times=times)
    jm, jtex, jcams, _ = j_load_gltf(path, times=times)
    ts = build_scene(tm, textures=ttex)
    js = j_build_scene(jm, textures=jtex)
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=256, integrator="pool", pool_pixel_major=True)
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    _, pipe = choose_tracer(ts, cfg, "cpu")
    j_tracer = None
    if len(times) == 2:
        assert isinstance(pipe, shade.FusedPipeline) and pipe.motion
        assert pipe.tables.tex is not None and pipe.tables.params_base > 0
        js, j_tracer = j_choose_tracer(js, jcfg, on_tpu=True)
    else:
        assert isinstance(pipe, tuple)
    f, s = render_frame(ts, tcams[0].params(), cfg, device="cpu")
    f_ref, s_ref = j_render_frame(js, jcams[0].params(), jcfg,
                                  tracer=j_tracer)
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    assert np.isclose(a, b, rtol=3e-5, atol=3e-5).mean() > 0.98
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=5e-3)
    assert np.isfinite(a).all() and a.mean() > 0.05
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= 0.02 * int(want) + 16


def test_cli_renders_an_animated_gltf(tmp_path):
    """--scene x.gltf --anim-times 0,0.5,1: three keys, the glTF's own
    camera; and the .glb without --anim-times."""
    from rendertoy3c_tpu_torch.app import cli

    gltf = tmp_path / "c.gltf"
    glb = _cornell(tmp_path)
    # the .glb's JSON and BIN chunk as a .gltf with a data URI buffer
    data = open(glb, "rb").read()
    jlen = int.from_bytes(data[12:16], "little")
    doc = json.loads(data[20:20 + jlen])
    blob = data[20 + jlen + 8:]
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    gltf.write_text(json.dumps(doc))
    for scene, extra in ((str(gltf), ["--anim-times", "0,0.5,1"]),
                         (glb, [])):
        out = tmp_path / f"out{len(extra)}.png"
        assert cli.main(["--scene", scene, *extra, "--size", "12x12",
                         "--spp", "1", "--subframes", "1", "--max-depth",
                         "3", "--device", "cpu", "-o", str(out)]) == 0
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    meshes, _, camera = cli.load_scene([str(gltf)], "0,0.5,1")
    assert meshes[0].num_keys == 3
    np.testing.assert_allclose(camera.eye, (0.0, 1.0, 3.4), rtol=1e-6)
    np.testing.assert_allclose(camera.lookat, (0.0, 1.0, 2.4), rtol=1e-6)
