"""Built-in scenes: the Cornell box and the textured quad (port of
rendertoy3c_tpu/scene/builtin.py `cornell_box` and `textured_quad_scene`,
with the `quad` and `box_mesh` helpers), and the variants that the tests
and chip_smoke.py render: the textured quad's (`textured_quad_variant`),
the Cornell box with all four material types (`material_cornell_box`)
and bench.py's 64x64 box field (`box_field`, 49154 faces)."""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera
from .material import Material, MaterialType
from .mesh import Mesh
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
