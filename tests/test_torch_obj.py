"""The port's .obj asset path against the reference (tolerance: none): the
generated town's files byte for byte, the parsed materials and loaded
meshes, the built scene, its Morton face order, and the Morton reorder
that choose_tracer applies to static scenes of more than 512 faces before
it picks a pipeline (rendertoy3c_tpu/trace/auto.py:183-188)."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest

from rendertoy3c_tpu.accel.lbvh import morton_order_scene as j_morton_order
from rendertoy3c_tpu.accel.morton import morton3d_np as j_morton3d
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.io.genassets import generate_town as j_generate_town
from rendertoy3c_tpu.io.obj import load_obj as j_load_obj
from rendertoy3c_tpu.io.obj import parse_mtl as j_parse_mtl
from rendertoy3c_tpu.scene.builtin import box_mesh as j_box_mesh
from rendertoy3c_tpu.scene.builtin import quad as j_quad
from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.auto import choose_tracer as j_choose_tracer
from rendertoy3c_tpu_torch.accel.lbvh import morton_order_scene
from rendertoy3c_tpu_torch.accel.morton import morton3d_np
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.io.genassets import generate_town
from rendertoy3c_tpu_torch.io.obj import load_obj, parse_mtl
from rendertoy3c_tpu_torch.scene.builtin import box_mesh, quad
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.auto import choose_tracer
from torch_port_util import box_grid_meshes, j_town_scene

FACES = 4000  # the town generator gives 4294 faces
_LAMP = ([0, 8, 0], [0, 8, 8], [8, 8, 8], [8, 8, 0])
j_lamp, lamp = j_quad(*_LAMP), quad(*_LAMP)
CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=256, integrator="pool", pool_pixel_major=True)


@pytest.fixture(scope="module")
def town_files(tmp_path_factory):
    """{two_key: (reference dir, reference paths, port dir, port paths)}."""
    out = {}
    for two_key in (False, True):
        jd = tmp_path_factory.mktemp(f"ref_{int(two_key)}")
        td = tmp_path_factory.mktemp(f"port_{int(two_key)}")
        jp, jcam = j_generate_town(str(jd), faces_target=FACES,
                                   two_key=two_key)
        tp, tcam = generate_town(str(td), faces_target=FACES,
                                 two_key=two_key)
        assert jcam == tcam
        out[two_key] = (jd, jp, td, tp)
    return out


def _assert_scenes_equal(js, ts):
    for jnt, tnt in ((js.geom, ts.geom), (js.materials, ts.materials),
                     (js.lights, ts.lights)):
        for k in tnt._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tnt, k)),
                                          np.asarray(getattr(jnt, k)),
                                          err_msg=k)
    assert (ts.num_keys, ts.num_faces, ts.num_lights, ts.num_materials) == (
        js.num_keys, js.num_faces, js.num_lights, js.num_materials)


@pytest.mark.parametrize("two_key", [False, True])
def test_generate_town_writes_the_reference_files(town_files, two_key):
    jd, jp, td, tp = town_files[two_key]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert [os.path.basename(p) for p in jp] == \
        [os.path.basename(p) for p in tp]
    assert len(tp) == (2 if two_key else 1)
    for name in names:  # .obj keyframes, .mtl and the two .png textures
        assert filecmp.cmp(jd / name, td / name, shallow=False), name


def test_parse_mtl_matches_reference(town_files):
    jd, _, td, _ = town_files[False]
    want = j_parse_mtl(str(jd / f"town{FACES // 1000}k.mtl"))
    got = parse_mtl(str(td / f"town{FACES // 1000}k.mtl"))
    assert list(got) == list(want)
    for name in want:
        for f in dataclasses.fields(got[name]):
            assert getattr(got[name], f.name) == getattr(want[name], f.name), \
                (name, f.name)


@pytest.mark.parametrize("two_key", [False, True])
def test_load_obj_meshes_match_reference(town_files, two_key):
    _, jp, _, tp = town_files[two_key]
    jm, jtex = j_load_obj(jp)
    tm, ttex = load_obj(tp)
    assert len(tm) == len(jm) == 8
    assert len(ttex) == len(jtex)
    for a, b in zip(ttex, jtex):
        np.testing.assert_array_equal(a, b)
    for m, j in zip(tm, jm):
        assert m.num_keys == j.vertices.shape[0] == (2 if two_key else 1)
        for k in ("vertices", "indices", "normals", "texcoords"):
            got, want = getattr(m, k), getattr(j, k)
            assert (got is None) == (want is None), k
            if got is not None:
                assert got.dtype == np.asarray(want).dtype, k
                np.testing.assert_array_equal(got, want, err_msg=k)
        for f in dataclasses.fields(m.material):
            assert getattr(m.material, f.name) == \
                getattr(j.material, f.name), f.name


@pytest.mark.parametrize("two_key", [False, True])
def test_town_scene_and_morton_order_match_reference(tmp_path, two_key):
    js, jcam = j_town_scene(FACES, two_key, tmp_path / "ref")
    ts, tcam = town_scene(FACES, two_key)
    assert ts.num_faces == 4294 and ts.num_keys == (2 if two_key else 1)
    assert ts.num_lights == 6 and ts.all_diffuse and not ts.textured
    _assert_scenes_equal(js, ts)
    _assert_scenes_equal(j_morton_order(js), morton_order_scene(ts))
    for a, b in zip(tcam.params(), jcam.params()):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_morton_codes_match_reference():
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-0.1, 1.1, (4096, 3)),
                          [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1]]])
    np.testing.assert_array_equal(morton3d_np(pts), j_morton3d(pts))


def _step0_pair(name, tmp_path):
    """(reference scene, port scene) of the step-0 repair cases."""
    if name == "box_grid_770":  # 513-2048 faces: the fused pipeline
        return tuple(
            build(box_grid_meshes(mat, mesh, box) + [mesh(
                vertices=lv[None], indices=lf,
                material=mat(emissive=(30.0, 30.0, 30.0)))])
            for build, mat, mesh, box, (lv, lf) in (
                (j_build_scene, JMaterial, JMesh, j_box_mesh, j_lamp),
                (build_scene, Material, Mesh, box_mesh, lamp)))
    two_key = name == "town_2key"
    return (j_town_scene(FACES, two_key, tmp_path)[0],
            town_scene(FACES, two_key)[0])


@pytest.mark.parametrize("name", ["box_grid_770", "town", "town_2key"])
def test_choose_tracer_orders_faces_like_reference(tmp_path, name):
    """Static scenes of more than 512 faces are Morton-ordered before the
    pipeline is built; 2-key scenes keep their order."""
    js, ts = _step0_pair(name, tmp_path)
    j_scene, j_pipe = j_choose_tracer(js, JConfig(**CFG), on_tpu=True)
    t_scene, t_pipe = choose_tracer(ts, RenderConfig(**CFG), "cpu")
    _assert_scenes_equal(j_scene, t_scene)
    reordered = not np.array_equal(np.asarray(t_scene.geom.v0),
                                   ts.geom.v0)
    assert reordered == (name != "town_2key")
    want = (shade.FusedPipeline if name == "box_grid_770"
            else shade.ExternalPipeline)
    assert type(t_pipe) is want
    assert type(j_pipe).__name__ == want.__name__
