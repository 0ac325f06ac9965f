"""Shared pieces of the port's CPU tests (tests/test_torch_*.py): scenes
built in both packages and the reference-to-port scene carry-over."""
from __future__ import annotations

import numpy as np

from rendertoy3c_tpu.scene.builtin import cornell_box as j_cornell_box
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu_torch.scene.builtin import cornell_box
from rendertoy3c_tpu_torch.scene.scene import build_scene, scene_from_numpy


def cornell_pair():
    """(reference scene, port scene, reference camera, port camera)."""
    jm, jcam = j_cornell_box()
    tm, tcam = cornell_box()
    return j_build_scene(jm), build_scene(tm), jcam, tcam


def box_grid_meshes(material_cls, mesh_cls, box_mesh_fn, n=8, seed=7):
    """One mesh of n*n boxes (12 faces each): >512 faces, several tiles."""
    rng = np.random.default_rng(seed)
    white = material_cls(diffuse=(0.7, 0.7, 0.7))
    v_all, f_all, off = [], [], 0
    for gx in range(n):
        for gz in range(n):
            m = box_mesh_fn([gx, 0, gz],
                            [gx + 0.8, rng.uniform(0.3, 2.0), gz + 0.8], white)
            v_all.append(m.vertices[0])
            f_all.append(m.indices + off)
            off += m.vertices.shape[1]
    return [mesh_cls(vertices=np.concatenate(v_all)[None],
                     indices=np.concatenate(f_all), material=white)]


def to_port_scene(jscene):
    """The port's Scene carrying the reference Scene's arrays."""
    def arrays(nt):
        return {k: np.asarray(v) for k, v in nt._asdict().items()
                if v is not None}

    return scene_from_numpy(arrays(jscene.geom), arrays(jscene.materials),
                            arrays(jscene.lights),
                            num_faces=jscene.num_faces,
                            num_lights=jscene.num_lights)


def random_rays(n, seed=0, lo=(-0.9, 0.05, -0.9), hi=(0.9, 1.9, 0.9)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d
