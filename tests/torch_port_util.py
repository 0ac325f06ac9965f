"""Shared pieces of the port's CPU tests (tests/test_torch_*.py): scenes
built in both packages and the reference-to-port scene carry-over."""
from __future__ import annotations

import numpy as np
import torch

from rendertoy3c_tpu.scene.builtin import cornell_box as j_cornell_box
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu_torch.scene.builtin import (cornell_box,
                                                  material_cornell_box)
from rendertoy3c_tpu_torch.scene.scene import build_scene, scene_from_numpy

# The plain versions run many small tensor ops. Under pytest-xdist every
# worker would start an intra-op thread pool as wide as the machine, and the
# pools' spinning threads then starve each other (a 17 s file took 450 s).
torch.set_num_threads(1)


def cornell_pair():
    """(reference scene, port scene, reference camera, port camera)."""
    jm, jcam = j_cornell_box()
    tm, tcam = cornell_box()
    return j_build_scene(jm), build_scene(tm), jcam, tcam


def assert_light_rows_equal(got, want, scene):
    """The port's light table rows [24, Lp] against the reference's: rows
    0-16 equal, row 17 the port's own, the power CDF its kernels search."""
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:17], want[:17])
    np.testing.assert_array_equal(got[18:], want[18:])
    n_l = max(scene.num_lights, 1)  # a scene without lights has a dark one
    np.testing.assert_array_equal(got[17, :n_l],
                                  scene.lights.power_cdf[:n_l])
    assert not got[17, n_l:].any()


def moving_meshes(meshes):
    """The meshes with the last one (the tall block) given a second key at
    +0.1 in x: a 2-key scene of 36 faces."""
    import dataclasses

    v = meshes[-1].vertices
    meshes[-1] = dataclasses.replace(
        meshes[-1], vertices=np.concatenate([v, v + np.float32([0.1, 0, 0])]))
    return meshes


def moving_cornell_pair():
    """cornell_pair() of the 2-key Cornell box (moving_meshes)."""
    jm, jcam = j_cornell_box()
    tm, tcam = cornell_box()
    return (j_build_scene(moving_meshes(jm)), build_scene(moving_meshes(tm)),
            jcam, tcam)


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
                            num_lights=jscene.num_lights,
                            atlas=arrays(jscene.atlas),
                            any_uv_transform=jscene.any_uv_transform,
                            any_normal_map=jscene.any_normal_map)


def material_cornell_pair(motion=False):
    """cornell_pair() of the Cornell box with all four material types
    (scene/builtin.py material_cornell_box), 2-key if `motion`."""
    jm, jcam = material_cornell_box(motion, j_cornell_box())
    tm, tcam = material_cornell_box(motion)
    return j_build_scene(jm), build_scene(tm), jcam, tcam


def j_town_scene(faces, two_key, out_dir, textured=False, principled=False):
    """The reference's town (bench.py `_town_scene`, :307-337), untextured
    unless `textured`, PRINCIPLED as BASELINE config 5 makes it if
    `principled` (:327-334), written to `out_dir`: (scene, camera)."""
    import dataclasses

    from rendertoy3c_tpu.io.genassets import generate_town
    from rendertoy3c_tpu.io.obj import load_obj
    from rendertoy3c_tpu.scene.camera import Camera
    from rendertoy3c_tpu.scene.material import MaterialType

    paths, camkw = generate_town(str(out_dir), faces_target=faces,
                                 two_key=two_key)
    meshes, textures = load_obj(paths if two_key else paths[:1])
    if not textured:
        for m in meshes:
            m.material = dataclasses.replace(
                m.material, diffuse_texture_id=-1, emissive_texture_id=-1,
                roughness_texture_id=-1, normal_texture_id=-1)
        textures = []
    if principled:
        rng = np.random.default_rng(5)
        for m in meshes:
            if max(m.material.emissive) > 0:
                continue
            m.material = dataclasses.replace(
                m.material, material_type=MaterialType.PRINCIPLED,
                roughness=float(rng.uniform(0.15, 0.7)),
                metallic=float(rng.uniform(0.0, 0.9)))
    return j_build_scene(meshes, textures=textures or None), Camera(**camkw)


def random_rays(n, seed=0, lo=(-0.9, 0.05, -0.9), hi=(0.9, 1.9, 0.9)):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def textured_quad_meshes(pkg, variant="repeat", motion=False):
    """(meshes, textures, camera) of a package's `textured_quad_scene`
    (pkg: "jax" or "torch") as the port's `textured_quad_variant` changes
    it: "repeat", "clamp_mirror" (tests/test_fused.py:130-151),
    "uv_transform" (:183-203), "normal_map" or "features"; motion: the
    floor given a second key."""
    from rendertoy3c_tpu_torch.scene.builtin import textured_quad_variant

    if pkg == "torch":
        return textured_quad_variant(variant, motion)
    from rendertoy3c_tpu.scene.builtin import textured_quad_scene
    from rendertoy3c_tpu.scene.texture import TextureImage

    return textured_quad_variant(variant, motion, textured_quad_scene(),
                                 TextureImage)


def textured_quad_pair(variant="repeat", motion=False):
    """cornell_pair() of the textured quad (textured_quad_meshes)."""
    jm, jt, jcam = textured_quad_meshes("jax", variant, motion)
    tm, tt, tcam = textured_quad_meshes("torch", variant, motion)
    return (j_build_scene(jm, textures=jt), build_scene(tm, textures=tt),
            jcam, tcam)


def lit_grid_scene(pkg, n=40):
    """tests/test_walkpool.py:265-292's scene built by `pkg` ("jax" or
    "torch"): n x n boxes (seed 0) under a 12 x 12 lamp at y = 25; n = 40
    gives 19202 faces."""
    if pkg == "torch":
        from rendertoy3c_tpu_torch.scene.builtin import box_mesh, quad
        from rendertoy3c_tpu_torch.scene.material import Material
        from rendertoy3c_tpu_torch.scene.mesh import Mesh
    else:
        from rendertoy3c_tpu.scene.builtin import box_mesh, quad
        from rendertoy3c_tpu.scene.material import Material
        from rendertoy3c_tpu.scene.mesh import Mesh
    lv, lf = quad([-6, 25, -6], [-6, 25, 6], [6, 25, 6], [6, 25, -6])
    lamp = Mesh(vertices=lv[None], indices=lf,
                material=Material(emissive=(40.0, 40.0, 40.0)))
    meshes = box_grid_meshes(Material, Mesh, box_mesh, n=n, seed=0) + [lamp]
    return (build_scene if pkg == "torch" else j_build_scene)(meshes)


def box_field_pair(n=16, motion=False):
    """(reference scene, port scene, camera) of scene/builtin.py
    `box_field(n)` built by both packages; `motion` gives every face a
    second key at +(0.3, 0.1, -0.2)."""
    from rendertoy3c_tpu.scene.builtin import box_mesh, quad
    from rendertoy3c_tpu.scene.material import Material
    from rendertoy3c_tpu.scene.mesh import Mesh
    from rendertoy3c_tpu_torch.scene.builtin import box_field

    jm, _ = box_field(n, box_mesh, quad, Material, Mesh)
    tm, cam = box_field(n)
    if motion:
        for meshes in (jm, tm):
            for m in meshes:
                v = m.vertices
                m.vertices = np.concatenate(
                    [v, v + np.float32([0.3, 0.1, -0.2])])
    return j_build_scene(jm), build_scene(tm), cam


def to_port_hier_table(jtab):
    """The port's HierTable carrying a reference HierTable's arrays."""
    from rendertoy3c_tpu_torch.trace.hierwalk import HierTable

    return HierTable(table=torch.as_tensor(np.array(jtab.table)),
                     level_starts=tuple(jtab.level_starts),
                     leaf_start=int(jtab.leaf_start),
                     num_faces=int(jtab.num_faces), fanout=int(jtab.fanout),
                     seg_rows=int(jtab.seg_rows), n_seg=int(jtab.n_seg))


def hdr_sky(h=16, w=32, seed=0):
    """A seeded lat-long sky: a smooth gradient, noise and a small sun of
    ~1e3 against a sky of ~1."""
    r = np.random.default_rng(seed)
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = (np.float32([0.3, 0.5, 0.9]) * (1.2 - v)
           + r.uniform(0, 0.2, (h, w, 3)).astype(np.float32))
    img[h // 4, w // 3] = (1000.0, 950.0, 800.0)
    return img.astype(np.float32)
