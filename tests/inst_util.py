"""Instanced scenes built by both packages and carried across, shared by
tests/test_torch_inst_*.py."""
from __future__ import annotations

import os

import numpy as np
import torch_port_util  # noqa: F401  (one intra-op thread per worker)

from rendertoy3c_tpu_torch.scene.instanced import instanced_scene_from_numpy

# rendertoy3c_tpu/scene/instanced.py's InstancedScene fields carried over
_GEOM = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "mat_id")


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()
            if v is not None}


def to_port_iscene(js):
    """This package's InstancedScene from the reference's arrays."""
    atlas = js.atlas
    return instanced_scene_from_numpy(
        {k: np.asarray(getattr(js.geom, k)) for k in _GEOM},
        _np(js.instances), _np(js.materials), _np(js.lights),
        mesh_ranges=js.mesh_ranges, num_keys=js.num_keys,
        num_lights=js.num_lights,
        atlas=None if atlas is None else _np(atlas),
        any_uv_transform=js.any_uv_transform,
        any_normal_map=js.any_normal_map)


def j_field(motion=False, grid=24):
    """The reference's InstancedScene of bench.py's instance field, by
    bench's own `_instance_field_scene` (:253-304)."""
    from bench import _instance_field_scene

    return _instance_field_scene(motion=motion, grid=grid)


def ref_config3():
    """The reference's (meshes, instances, camera) of bench.py's
    `multi_instance_tlas` and `multi_instance_tracetime`: a copy of
    bench.py:563-572, which builds them inline."""
    from rendertoy3c_tpu.scene.builtin import cornell_box
    from rendertoy3c_tpu.scene.scene import Instance

    meshes, ccam = cornell_box(with_blocks=False)
    xs = []
    for gx in (-0.6, 0.0, 0.6):
        for gz in (-0.6, 0.0, 0.6):
            t = np.zeros((3, 4), np.float32)
            t[:, :3] = np.eye(3) * 0.25
            t[:, 3] = (gx, 0.2, gz)
            xs.append(t)
    inst = [Instance(mesh_index=i) for i in range(len(meshes))]
    inst += [Instance(mesh_index=0, transforms=t) for t in xs]
    return meshes, inst, ccam


def j_multi_instance_cornell():
    """(the reference's InstancedScene, meshes, instances, camera) of
    ref_config3."""
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene

    meshes, inst, cam = ref_config3()
    return build_instanced_scene(meshes, inst), meshes, inst, cam


def ref_bumpy_quad():
    """The reference's (meshes, instances, textures, camera) of its
    tests/test_hier_instanced.py:242-267, copied: a normal-mapped quad
    placed by a rotated, non-uniformly scaled instance under a lamp."""
    from rendertoy3c_tpu.scene.builtin import quad
    from rendertoy3c_tpu.scene.camera import Camera
    from rendertoy3c_tpu.scene.material import Material
    from rendertoy3c_tpu.scene.mesh import Mesh
    from rendertoy3c_tpu.scene.scene import Instance

    h, w = 16, 16
    yy, xx = np.mgrid[0:h, 0:w] / 8.0 * np.pi
    n = np.stack([0.45 * np.sin(xx), 0.45 * np.cos(yy),
                  np.sqrt(1.0 - 0.45 ** 2) * np.ones_like(xx)], axis=-1)
    ntex = np.concatenate(
        [((n * 0.5 + 0.5) * 255).astype(np.uint8),
         np.full((h, w, 1), 255, np.uint8)], axis=-1)
    white = Material(diffuse=(0.7, 0.7, 0.7), normal_texture_id=0)
    fv, ff = quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1])
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    bumpy = Mesh(vertices=fv[None], indices=ff, texcoords=uvs,
                 material=white)
    lv, lf = quad([-0.5, 2.5, -0.5], [-0.5, 2.5, 0.5], [0.5, 2.5, 0.5],
                  [0.5, 2.5, -0.5])
    lamp = Mesh(vertices=lv[None], indices=lf,
                material=Material(emissive=(15.0, 15.0, 15.0)))
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    t = np.zeros((3, 4), np.float32)
    t[:, :3] = rot @ np.diag([1.3, 1.0, 0.8]).astype(np.float32)
    instances = [Instance(mesh_index=0, transforms=t),
                 Instance(mesh_index=1)]
    cam = Camera(eye=(0, 2.2, 3.2), lookat=(0, 0, 0), fov_y=45.0,
                 aspect_ratio=1.0)
    return [bumpy, lamp], instances, [ntex], cam


class forced_bake:
    """The reference's RT3C_INST_BAKE=2 for a block (its test switch)."""

    def __enter__(self):
        self.prev = os.environ.get("RT3C_INST_BAKE")
        os.environ["RT3C_INST_BAKE"] = "2"

    def __exit__(self, *exc):
        if self.prev is None:
            del os.environ["RT3C_INST_BAKE"]
        else:
            os.environ["RT3C_INST_BAKE"] = self.prev
