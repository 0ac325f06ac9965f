"""Port scene, soup and shade tables are array-equal to the reference's
(tolerance: none)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.scene.builtin import box_mesh as j_box_mesh
from rendertoy3c_tpu.scene.light import pick_light_uniform as j_pick
from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_shade import build_shade_tables as j_tables
from rendertoy3c_tpu_torch.scene.builtin import box_mesh
from rendertoy3c_tpu_torch.scene.light import pick_light_uniform
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace.mt import build_tri_soup
from rendertoy3c_tpu_torch.trace.shade import build_shade_tables
from torch_port_util import box_grid_meshes, cornell_pair, to_port_scene


def _scenes(name):
    if name == "cornell":
        js, ts, _, _ = cornell_pair()
        return js, ts
    js = j_build_scene(box_grid_meshes(JMaterial, JMesh, j_box_mesh))
    ts = build_scene(box_grid_meshes(Material, Mesh, box_mesh))
    return js, ts


def _assert_tables_equal(jnt, tnt):
    for k in tnt._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tnt, k)),
                                      np.asarray(getattr(jnt, k)), err_msg=k)


@pytest.mark.parametrize("name", ["cornell", "box_grid"])
def test_build_scene_array_equal(name):
    js, ts = _scenes(name)
    _assert_tables_equal(js.geom, ts.geom)
    _assert_tables_equal(js.materials, ts.materials)
    _assert_tables_equal(js.lights, ts.lights)
    assert (ts.num_keys, ts.num_faces, ts.num_lights, ts.num_materials) == (
        js.num_keys, js.num_faces, js.num_lights, js.num_materials)
    assert ts.all_diffuse == js.all_diffuse
    assert ts.geom.mat_id.shape[0] % 512 == 0


@pytest.mark.parametrize("name", ["cornell", "box_grid"])
def test_tri_soup_array_equal(name):
    js, ts = _scenes(name)
    j = j_soup(js.geom, num_faces=js.num_faces)
    soup = build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    np.testing.assert_array_equal(soup.tris.numpy(), np.asarray(j.tris))
    np.testing.assert_array_equal(soup.aabb.numpy(), np.asarray(j.aabb))
    np.testing.assert_array_equal(soup.super_aabb.numpy(),
                                  np.asarray(j.super_aabb))
    assert soup.num_faces == j.num_faces
    if name == "box_grid":
        assert soup.tris.shape[0] > 1 and soup.tris.shape[2] == 512


@pytest.mark.parametrize("name", ["cornell", "box_grid"])
def test_shade_tables_array_equal(name):
    js, ts = _scenes(name)
    tris = build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces).tris
    f_limit = tris.shape[0] * tris.shape[2]
    ja, jl = j_tables(js, f_limit=f_limit)
    ta, tl = build_shade_tables(ts, f_limit=f_limit)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tl, np.asarray(jl))


def test_scene_from_numpy_round_trips_the_reference_scene():
    js, ts, jcam, tcam = cornell_pair()
    carried = to_port_scene(js)
    _assert_tables_equal(js.geom, carried.geom)
    _assert_tables_equal(ts.materials, carried.materials)
    _assert_tables_equal(ts.lights, carried.lights)
    assert (carried.num_faces, carried.num_lights, carried.num_keys) == (
        js.num_faces, js.num_lights, js.num_keys)
    for a, b in zip(build_shade_tables(carried), build_shade_tables(ts)):
        np.testing.assert_array_equal(a, b)


def test_camera_params_equal():
    _, _, jcam, tcam = cornell_pair()
    for a, b in zip(tcam.params(), jcam.params()):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("num_lights", [1, 2, 3, 7])
def test_uniform_light_pick_matches_reference_and_clamps(num_lights):
    u = np.concatenate([np.random.default_rng(num_lights).random(4096),
                        [0.0, 1.0 - 2.0 ** -24, 1.0]]).astype(np.float32)
    idx, pdf = pick_light_uniform(torch.as_tensor(u), num_lights)
    j_idx, j_pdf = j_pick(None, num_lights, jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy().astype(np.int32),
                                  np.asarray(j_idx))
    assert idx.max().item() == num_lights - 1  # u = 1 clamps
    assert np.float32(pdf) == np.asarray(j_pdf)[0]
