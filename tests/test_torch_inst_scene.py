"""Instanced scenes in the port: build_scene's baked instances and
build_instanced_scene's two-level tables are array-equal to the
reference's (tolerance: none), the builtin scenes equal bench.py's, and
what the port refuses (a 3-key instance, ROADMAP C1; vertex motion under
matrix motion) raises ValueError."""
import numpy as np
import pytest

from inst_util import j_field, ref_config3
from rendertoy3c_tpu.scene.builtin import cornell_box as j_cornell_box
from rendertoy3c_tpu.scene.builtin import \
    instanced_cornell as j_instanced_cornell
from rendertoy3c_tpu.scene.instanced import \
    build_instanced_scene as j_build_instanced
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import Instance as JInstance
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.pallas_shade import build_shade_tables as j_tables
from rendertoy3c_tpu_torch.scene import builtin
from rendertoy3c_tpu_torch.scene.instanced import (INST_FACE_ALIGN,
                                                   build_instanced_scene)
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import Instance, build_scene
from rendertoy3c_tpu_torch.trace.shade import build_shade_tables


def _eq(got, want, what=""):
    for k in got._fields:
        w = getattr(want, k)
        if w is None:
            continue
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(w), err_msg=f"{what}{k}")


def _tri(mesh_cls):
    return mesh_cls(vertices=np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                                      np.float32), indices=[[0, 1, 2]])


def _shifted(instance_cls):
    t = np.zeros((1, 3, 4), np.float32)
    t[0, :, :3] = np.eye(3)
    t[0, :, 3] = [5, 0, 0]
    return [instance_cls(mesh_index=0), instance_cls(mesh_index=1,
                                                     transforms=t)]


def _sheared(cornell_fn, instance_cls):
    """tests/test_walkpool.py:317-336: the Cornell shell and three sheared
    instances of its floor."""
    meshes, cam = cornell_fn(with_blocks=False)
    inst = [instance_cls(mesh_index=i) for i in range(len(meshes))]
    for k, (gx, gz) in enumerate(((-0.5, 0.0), (0.4, -0.3), (0.1, 0.5))):
        t = np.zeros((3, 4), np.float32)
        t[0, 0] = 0.3
        t[1, 1] = 0.2 + 0.1 * k
        t[2, 2] = 0.25
        t[0, 1] = 0.1
        t[:, 3] = (gx, 0.15, gz)
        inst.append(instance_cls(mesh_index=0, transforms=t))
    return meshes, inst


def _last_keys(insts, instance_cls, keys):
    """`insts` with its last instance's transforms replaced by `keys`."""
    return insts[:-1] + [instance_cls(mesh_index=insts[-1].mesh_index,
                                      transforms=keys)]


def _pair(name):
    """(reference (meshes, instances), port (meshes, instances)), the
    reference's built by its own functions or copies of its tests'."""
    if name == "shifted":  # tests/test_scene.py:48
        return ([_tri(JMesh)] * 2, _shifted(JInstance)), (
            [_tri(Mesh)] * 2, _shifted(Instance))
    if name == "config3":
        return ref_config3()[:2], builtin.multi_instance_cornell()[:2]
    if name == "instanced_cornell":
        return j_instanced_cornell()[:2], builtin.instanced_cornell()[:2]
    assert name == "sheared"
    return (_sheared(j_cornell_box, JInstance),
            _sheared(builtin.cornell_box, Instance))


@pytest.mark.parametrize("name", ["shifted", "config3", "instanced_cornell",
                                  "sheared"])
def test_baked_scene_array_equal(name):
    (jm, ji), (tm, ti) = _pair(name)
    js, ts = j_build_scene(jm, instances=ji), build_scene(tm, instances=ti)
    _eq(ts.geom, js.geom, "geom.")
    _eq(ts.materials, js.materials, "materials.")
    _eq(ts.lights, js.lights, "lights.")
    assert (ts.num_keys, ts.num_faces, ts.num_lights) == (
        js.num_keys, js.num_faces, js.num_lights)
    if name == "shifted":
        np.testing.assert_allclose(ts.geom.v0[0, 1], [5, 0, 0])


def test_baked_2key_instances_array_equal():
    """A 2-key instance bakes to 2-key world vertices; static meshes and
    instances clamp to their last key (instanced_cornell, its last block
    given a second key)."""
    keys = np.zeros((2, 3, 4), np.float32)
    keys[:, :, :3] = np.eye(3)
    keys[1, :, 3] = (0.1, 0.05, -0.2)
    (jm, ji), (tm, ti) = _pair("instanced_cornell")
    js = j_build_scene(jm, instances=_last_keys(ji, JInstance, keys))
    ts = build_scene(tm, instances=_last_keys(ti, Instance, keys))
    assert ts.num_keys == js.num_keys == 2
    _eq(ts.geom, js.geom, "geom.")
    _eq(ts.lights, js.lights, "lights.")


@pytest.mark.parametrize("name", ["config3", "instanced_cornell", "sheared",
                                  "field", "field_2key"])
def test_instanced_scene_array_equal(name):
    if name.startswith("field"):  # bench.py's field at grid 4
        motion = name == "field_2key"
        js = j_field(motion, 4)[0]
        ts = build_instanced_scene(*builtin.instance_field(motion, 4)[:2])
    else:
        (jm, ji), (tm, ti) = _pair(name)
        js, ts = j_build_instanced(jm, ji), build_instanced_scene(tm, ti)
    _eq(ts.geom, js.geom, "geom.")
    _eq(ts.instances, js.instances, "instances.")
    _eq(ts.materials, js.materials, "materials.")
    _eq(ts.lights, js.lights, "lights.")
    assert ts.mesh_ranges == js.mesh_ranges
    assert ts.instance_mesh == js.instance_mesh
    assert (ts.num_keys, ts.num_faces, ts.num_instances, ts.num_lights) == (
        js.num_keys, js.num_faces, js.num_instances, js.num_lights)
    assert all(c % INST_FACE_ALIGN == 0 for _, c in ts.mesh_ranges)
    jat, _ = j_tables(js)
    tat, _ = build_shade_tables(ts)
    np.testing.assert_array_equal(tat, np.asarray(jat))


def test_builtin_field_equals_bench():
    """scene/builtin.py instance_field is bench.py's _instance_field_scene
    (:253-304), static and 2-key, its camera too, at grid 6 and 24 (578
    instances). multi_instance_cornell is held to bench.py:563-572 by the
    config3 cases above."""
    for motion, grid in ((False, 6), (True, 6), (False, 24)):
        js, jcam = j_field(motion, grid)
        meshes, inst, cam = builtin.instance_field(motion, grid)
        ts = build_instanced_scene(meshes, inst)
        _eq(ts.geom, js.geom, "geom.")
        _eq(ts.instances, js.instances, "instances.")
        assert ts.instance_mesh == js.instance_mesh
        assert (tuple(cam.eye), tuple(cam.lookat), cam.fov_y) == (
            tuple(jcam.eye), tuple(jcam.lookat), jcam.fov_y)
    assert ts.num_instances == 578


def test_three_key_instance_raises_c1():
    """The reference stores keys 0-1 of a 3-key track and reports 3
    (scene/instanced.py:184-194); the port refuses it (ROADMAP C1)."""
    keys = np.zeros((3, 3, 4), np.float32)
    keys[:, :, :3] = np.eye(3)
    keys[:, 0, 3] = (0.0, 0.5, 1.0)
    (jm, ji), (tm, ti) = _pair("instanced_cornell")
    js = j_build_instanced(jm, _last_keys(ji, JInstance, keys))
    assert js.num_keys == 3
    assert np.asarray(js.instances.m).shape[1] == 2  # key 2 is lost
    with pytest.raises(ValueError, match="C1"):
        build_instanced_scene(tm, _last_keys(ti, Instance, keys))


def test_vertex_and_matrix_motion_raises():
    tri = _tri(Mesh)
    tri.vertices = np.concatenate([tri.vertices, tri.vertices + 0.1])
    t = np.zeros((2, 3, 4), np.float32)
    t[:, :, :3] = np.eye(3)
    with pytest.raises(ValueError, match="not linear in t"):
        build_scene([tri], instances=[Instance(mesh_index=0, transforms=t)])
    with pytest.raises(ValueError, match="static meshes"):
        build_instanced_scene([tri], [Instance(mesh_index=0)])
