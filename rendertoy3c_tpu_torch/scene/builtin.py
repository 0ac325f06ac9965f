"""Built-in scenes: the Cornell box and the textured quad (port of
rendertoy3c_tpu/scene/builtin.py `cornell_box` and `textured_quad_scene`,
with the `quad` and `box_mesh` helpers), and the variants that the tests
and chip_smoke.py render: the textured quad's (`textured_quad_variant`),
the Cornell box with all four material types (`material_cornell_box`)
and bench.py's 64x64 box field (`box_field`, 49154 faces); the instanced
scenes: the reference's `instanced_cornell`, bench's BASELINE config 3
(`multi_instance_cornell`) and its 578-instance field (`instance_field`)."""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera
from .material import Material, MaterialType
from .mesh import Mesh
from .scene import Instance
from .texture import WRAP_CLAMP, WRAP_MIRROR, TextureImage


def quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    """Two-triangle quad: vertices [4,3], indices [2,3]."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f


def _quad_mesh(p0, p1, p2, p3, material: Material) -> Mesh:
    v, f = quad(p0, p1, p2, p3)
    return Mesh(vertices=v[None], indices=f, material=material)


def box_mesh(lo, hi, material: Material) -> Mesh:
    """Axis-aligned box with outward normals."""
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    f = np.array(
        [
            [4, 5, 6], [4, 6, 7],  # +z
            [1, 0, 3], [1, 3, 2],  # -z
            [5, 1, 2], [5, 2, 6],  # +x
            [0, 4, 7], [0, 7, 3],  # -x
            [3, 7, 6], [3, 6, 2],  # +y
            [0, 1, 5], [0, 5, 4],  # -y
        ],
        np.int32,
    )
    return Mesh(vertices=v[None], indices=f, material=material)


def cornell_box(light_emission=(15.0, 15.0, 15.0), with_blocks: bool = True):
    """Cornell-style box in [-1,1]x[0,2]x[-1,1], open toward a +z camera.

    Returns (meshes, camera), one mesh per material."""
    white = Material(diffuse=(0.73, 0.73, 0.73))
    red = Material(diffuse=(0.65, 0.05, 0.05))
    green = Material(diffuse=(0.12, 0.45, 0.15))
    light = Material(diffuse=(0.0, 0.0, 0.0), emissive=tuple(light_emission))

    meshes = [
        _quad_mesh([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], white),  # floor
        _quad_mesh([-1, 2, -1], [-1, 2, 1], [1, 2, 1], [1, 2, -1], white),  # ceiling
        _quad_mesh([-1, 0, -1], [-1, 2, -1], [1, 2, -1], [1, 0, -1], white),  # back
        _quad_mesh([-1, 0, -1], [-1, 0, 1], [-1, 2, 1], [-1, 2, -1], red),  # left
        _quad_mesh([1, 0, -1], [1, 2, -1], [1, 2, 1], [1, 0, 1], green),  # right
        _quad_mesh(
            [-0.4, 1.99, -0.4], [-0.4, 1.99, 0.4], [0.4, 1.99, 0.4],
            [0.4, 1.99, -0.4], light,
        ),
    ]
    if with_blocks:
        meshes.append(box_mesh([-0.6, 0.0, -0.55], [-0.05, 1.1, 0.0], white))
        meshes.append(box_mesh([0.1, 0.0, 0.0], [0.65, 0.55, 0.5], white))

    camera = Camera(eye=(0.0, 1.0, 3.4), lookat=(0.0, 1.0, 0.0),
                    up=(0.0, 1.0, 0.0), fov_y=45.0, aspect_ratio=1.0)
    return meshes, camera


def textured_quad_scene(checker_size: int = 64):
    """A checker-textured floor quad under an area light (BASELINE.md
    config 2). Returns (meshes, textures, camera)."""
    tex = np.zeros((checker_size, checker_size, 4), np.uint8)
    yy, xx = np.mgrid[0:checker_size, 0:checker_size]
    checker = ((xx // 8 + yy // 8) % 2).astype(np.uint8)
    tex[..., 0] = 255 * checker
    tex[..., 1] = 128
    tex[..., 2] = 255 * (1 - checker)
    tex[..., 3] = 255

    textured = Material(diffuse=(1, 1, 1), diffuse_texture_id=0)
    light = Material(emissive=(10.0, 10.0, 10.0))

    v, f = quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1])
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    floor = Mesh(vertices=v[None], indices=f, texcoords=uvs,
                 material=textured)

    lv, lf = quad([-0.3, 1.5, -0.3], [-0.3, 1.5, 0.3], [0.3, 1.5, 0.3],
                  [0.3, 1.5, -0.3])
    lamp = Mesh(vertices=lv[None], indices=lf, material=light)

    camera = Camera(eye=(0.0, 1.2, 2.2), lookat=(0.0, 0.2, 0.0), fov_y=45.0,
                    aspect_ratio=1.0)
    return [floor, lamp], [tex], camera


def bumpy_normal_map() -> np.ndarray:
    """An 8x8 RGBA8 normal map tilting along x (tests/test_fused.py:194-198
    of the reference package)."""
    bumpy = np.zeros((8, 8, 4), np.uint8)
    bumpy[..., 0] = np.tile(np.linspace(40, 215, 8, dtype=np.uint8), (8, 1))
    bumpy[..., 1], bumpy[..., 2], bumpy[..., 3] = 128, 220, 255
    return bumpy


def textured_quad_variant(variant: str = "repeat", motion: bool = False,
                          base=None, texture_image=TextureImage):
    """(meshes, textures, camera) of a variant of `base`, the output of a
    `textured_quad_scene` (this module's by default): "repeat" as built;
    "clamp_mirror" with uvs stretched to 2.5 uv - 0.75 under CLAMP/MIRROR;
    "uv_transform" with an offset, rotation and scale; "normal_map" with
    bumpy_normal_map on the DIFFUSE floor; "features" with all three;
    "principled" with the normal map on a PRINCIPLED floor (roughness 0.8,
    metallic 0.3, sheen 0.25; the reference's tests/test_texture.py:222).
    motion: the floor given a second key at +0.1 in x. texture_image: the
    class that carries the wrap modes (another package's TextureImage
    builds the same variant from that package's `textured_quad_scene`)."""
    meshes, textures, camera = base or textured_quad_scene()
    floor = meshes[0]
    change = {}
    if variant in ("clamp_mirror", "features"):
        floor.texcoords = floor.texcoords * 2.5 - 0.75
        textures = [texture_image(textures[0], WRAP_CLAMP, WRAP_MIRROR)]
    if variant in ("uv_transform", "features"):
        change.update(tex_offset=(0.15, -0.1), tex_rotation=0.35,
                      tex_scale=(1.5, 0.8))
    if variant in ("normal_map", "features", "principled"):
        textures = textures + [bumpy_normal_map()]
        change.update(normal_texture_id=1)
    if variant == "principled":
        change.update(material_type=MaterialType.PRINCIPLED, roughness=0.8,
                      metallic=0.3, sheen=0.25)
    floor.material = dataclasses.replace(floor.material, **change)
    if motion:
        v = floor.vertices
        meshes[0] = dataclasses.replace(
            floor, vertices=np.concatenate([v, v + np.float32([0.1, 0, 0])]))
    return meshes, textures, camera


def material_cornell_box(motion: bool = False, base=None):
    """(meshes, camera) of the Cornell box with every material type: the
    floor PRINCIPLED (diffuse 0.7 0.6 0.5, roughness 0.35, metallic 0.6),
    the red wall SPECULAR (0.9), the tall block FRESNEL_TRANSMISSIVE (ior
    1.5, transmittance 0.8), the rest DIFFUSE (the reference's
    tests/test_fused.py:67-90 in one scene). motion: the short block given
    a second key at +0.1 in x. base: the output of a `cornell_box` (this
    module's by default; another package's builds the same scene in that
    package)."""
    meshes, camera = base or cornell_box()
    for i, change in ((0, dict(material_type=MaterialType.PRINCIPLED,
                               diffuse=(0.7, 0.6, 0.5), roughness=0.35,
                               metallic=0.6)),
                      (3, dict(material_type=MaterialType.SPECULAR,
                               diffuse=(0.9, 0.9, 0.9))),
                      (6, dict(material_type=MaterialType.FRESNEL_TRANSMISSIVE,
                               ior=1.5, transmittance=0.8,
                               diffuse=(1.0, 1.0, 1.0)))):
        meshes[i].material = dataclasses.replace(meshes[i].material, **change)
    if motion:
        v = meshes[7].vertices
        meshes[7] = dataclasses.replace(
            meshes[7], vertices=np.concatenate([v, v + np.float32([0.1, 0, 0])]))
    return meshes, camera


def box_field(n: int = 64, box_mesh_fn=box_mesh, quad_fn=quad,
              material_cls=Material, mesh_cls=Mesh):
    """(meshes, camera) of bench.py's box field (`_box_field_scene`,
    :224-250; its camera :589-590): n x n boxes of random height (seed 0)
    on a unit grid centred at the origin, 12 faces each, under a 12 x 12
    lamp at y = 25 (n = 64: 49154 faces, the hierwalk gate's scene and
    `large_scene_49k`). The helpers default to this package's; a test
    passes the reference's to build its twin."""
    rng = np.random.default_rng(0)
    white = material_cls(diffuse=(0.7, 0.7, 0.7))
    v_all, f_all, off = [], [], 0
    h = n // 2
    for gx in range(n):
        for gz in range(n):
            m = box_mesh_fn([gx - h, 0, gz - h],
                            [gx - h + 0.8, rng.uniform(0.3, 2.0),
                             gz - h + 0.8], white)
            v_all.append(m.vertices[0])
            f_all.append(m.indices + off)
            off += m.vertices.shape[1]
    big = mesh_cls(vertices=np.concatenate(v_all)[None],
                   indices=np.concatenate(f_all), material=white)
    lv, lf = quad_fn([-6, 25, -6], [-6, 25, 6], [6, 25, 6], [6, 25, -6])
    lamp = mesh_cls(vertices=lv[None], indices=lf,
                    material=material_cls(emissive=(40.0, 40.0, 40.0)))
    return [big, lamp], Camera(eye=(0.0, 20.0, 45.0), lookat=(0.0, 0.0, 0.0),
                               fov_y=50.0)


def instanced_cornell():
    """(meshes, instances, camera): the Cornell shell and one block mesh
    placed three times by instance transforms (the reference's
    scene/builtin.py `instanced_cornell`, :89-117)."""
    meshes, camera = cornell_box(with_blocks=False)
    block = box_mesh([-0.25, 0.0, -0.25], [0.25, 0.5, 0.25],
                     Material(diffuse=(0.73, 0.73, 0.73)))
    meshes.append(block)
    block_id = len(meshes) - 1

    def xform(tx, tz, angle_deg, scale=1.0):
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32)
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                            np.float32) * scale
        m[:, 3] = (tx, 0.0, tz)
        return m

    instances = [Instance(mesh_index=i) for i in range(block_id)]
    instances += [
        Instance(mesh_index=block_id, transforms=xform(-0.45, -0.3, 20.0)),
        Instance(mesh_index=block_id, transforms=xform(0.4, 0.25, -15.0)),
        Instance(mesh_index=block_id,
                 transforms=xform(0.0, 0.55, 35.0, scale=0.6)),
    ]
    return meshes, instances, camera


def multi_instance_cornell():
    """(meshes, instances, camera) of bench.py's `multi_instance_tlas`
    (BASELINE config 3, :560-574) and `multi_instance_tracetime`
    (:576-584): the Cornell shell without blocks plus its floor quad
    (mesh 0) placed 9 times, scaled by 0.25 on a 3 x 3 grid at y = 0.2.
    build_scene bakes it; build_instanced_scene keeps it two-level."""
    meshes, camera = cornell_box(with_blocks=False)
    inst = [Instance(mesh_index=i) for i in range(len(meshes))]
    for gx in (-0.6, 0.0, 0.6):
        for gz in (-0.6, 0.0, 0.6):
            t = np.zeros((3, 4), np.float32)
            t[:, :3] = np.eye(3) * 0.25
            t[:, 3] = (gx, 0.2, gz)
            inst.append(Instance(mesh_index=0, transforms=t))
    return meshes, inst, camera


def instance_field(motion: bool = False, grid: int = 24):
    """(meshes, instances, camera) of bench.py's instance field
    (`_instance_field_scene`, :253-304; seed 0): one tower mesh of 81
    boxes (972 faces) placed grid x grid times on a unit grid, a 16 x 16
    lamp at y = 20 and a 60 x 60 floor; grid 24 gives 578 instances and
    562k effective faces (`multi_instance_large`), `motion` a second key
    per tower of up to 0.35 rad of yaw and 0.3 of drift
    (`multi_instance_motion`)."""
    rng = np.random.default_rng(0)
    white = Material(diffuse=(0.7, 0.7, 0.7))
    v_all, f_all, off = [], [], 0
    for _ in range(81):
        x, y, z = rng.uniform(0, 0.8, 3)
        m = box_mesh([x, y * 2, z], [x + 0.15, y * 2 + 0.3, z + 0.15],
                     white)
        v_all.append(m.vertices[0])
        f_all.append(m.indices + off)
        off += m.vertices.shape[1]
    tower = Mesh(vertices=np.concatenate(v_all)[None],
                 indices=np.concatenate(f_all), material=white)
    lv, lf = quad([-8, 20, -8], [-8, 20, 8], [8, 20, 8], [8, 20, -8])
    lamp = Mesh(vertices=lv[None], indices=lf,
                material=Material(emissive=(40.0, 40.0, 40.0)))
    fv, ff = quad([-30, 0, -30], [30, 0, -30], [30, 0, 30], [-30, 0, 30])
    floor = Mesh(vertices=fv[None], indices=ff, material=white)
    inst = [Instance(mesh_index=1), Instance(mesh_index=2)]
    for gx in range(grid):
        for gz in range(grid):
            t = np.zeros((3, 4), np.float32)
            t[:, :3] = np.eye(3)
            t[:, 3] = (gx - grid // 2, 0, gz - grid // 2)
            if motion:
                ang = rng.uniform(-0.35, 0.35)
                c, s = np.cos(ang), np.sin(ang)
                t1 = np.zeros((3, 4), np.float32)
                t1[:, :3] = np.asarray(
                    [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
                t1[:, 3] = t[:, 3] + rng.uniform(-0.3, 0.3, 3)
                inst.append(Instance(mesh_index=0,
                                     transforms=np.stack([t, t1])))
            else:
                inst.append(Instance(mesh_index=0, transforms=t))
    cam = Camera(eye=(0.0, 16.0, 34.0), lookat=(0.0, 0.5, 0.0), fov_y=50.0)
    return [tower, lamp, floor], inst, cam


def instanced_bumpy_quad():
    """(meshes, instances, textures, camera): a normal-mapped quad placed
    by a rotated, non-uniformly scaled instance under a lamp (the
    reference's tests/test_hier_instanced.py:227-270), for the instance
    rows' tangent transform."""
    h, w = 16, 16
    yy, xx = np.mgrid[0:h, 0:w] / 8.0 * np.pi
    n = np.stack([0.45 * np.sin(xx), 0.45 * np.cos(yy),
                  np.sqrt(1.0 - 0.45 ** 2) * np.ones_like(xx)], axis=-1)
    ntex = np.concatenate([((n * 0.5 + 0.5) * 255).astype(np.uint8),
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
    instances = [Instance(mesh_index=0, transforms=t), Instance(mesh_index=1)]
    cam = Camera(eye=(0, 2.2, 3.2), lookat=(0, 0, 0), fov_y=45.0)
    return [bumpy, lamp], instances, [ntex], cam
