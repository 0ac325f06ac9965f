"""Shared pieces of the resident-table walk tests
(tests/test_torch_residentwalk*.py): the scenes, rays and tables built by
both packages."""
import numpy as np

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.scene.builtin import box_mesh as j_box_mesh
from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace import pallas_walk as j_walk
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.scene.builtin import box_mesh
from rendertoy3c_tpu_torch.scene.material import Material
from rendertoy3c_tpu_torch.scene.mesh import Mesh
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import residentwalk
from torch_port_util import box_grid_meshes

TOL = dict(rtol=1e-6, atol=1e-6)


def field_pair():
    """tests/test_pallas_walk.py's 8x8 box field (seed 3), split-ordered,
    built by both packages."""
    jm = box_grid_meshes(JMaterial, JMesh, j_box_mesh, n=8, seed=3)
    tm = box_grid_meshes(Material, Mesh, box_mesh, n=8, seed=3)
    return (j_split_order(j_build_scene(jm)),
            split_order_scene(build_scene(tm)))


def rays(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def grazing(n=128, seed=11):
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2, 0.05, 0], [-1, 0.4, 8], (n, 3)).astype(np.float32)
    d = rng.normal([1.0, 0.0, 0.0], [0.05, 0.02, 0.3], (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def tables(js, ts, leaf):
    jt = j_walk.build_walk_table(js.geom, js.num_faces, leaf=leaf)
    tt = residentwalk.build_walk_table(ts.geom, ts.num_faces, leaf=leaf)
    return jt, tt


def check_closest(got, want, brute):
    """Prims equal to the reference's and the brute tracer's; t, u, v
    within TOL of the reference's."""
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(got.prim.numpy(), brute.prim.numpy())
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL)
