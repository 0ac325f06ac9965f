"""Host scene: per-face structure-of-arrays, material and light tables.

Port of rendertoy3c_tpu/scene/scene.py `Instance` (:77-95) and
`build_scene` (:143-315): meshes placed by instances (one identity
instance per mesh by default) and baked into world space, each key of the
scene sampling the mesh's vertex track and the instance's transform track
clamped to their last key, normals by the inverse-transpose; the same
face order, the face axis padded to FACE_ALIGN with degenerate (never
hit) faces, and the texture atlas with the `any_uv_transform` and
`any_normal_map` flags, and the optional environment map `env`.
Arrays stay numpy on the host (the environment map is a tensor on the
device build_env_map was given); the tracers build device tables from
them with an explicit `device=`.

`scene_from_numpy` takes the arrays of a reference Scene (as numpy) and
returns this package's Scene, so a test can carry one scene across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple, Sequence

import numpy as np

from .light import LightTable, build_light_table
from .material import Material, MaterialType
from .mesh import Mesh
from .texture import TextureAtlas, build_texture_atlas, empty_atlas

# Face-axis alignment of the scene SoA (scene/scene.py:42 of the reference).
FACE_ALIGN = 512


@dataclass
class Instance:
    """One placement of a mesh: transforms [KT, 3, 4] row-major affines
    (KT = 1 static, 2 for matrix motion); identity by default."""

    mesh_index: int
    transforms: np.ndarray = None

    def __post_init__(self):
        if self.transforms is None:
            t = np.zeros((1, 3, 4), np.float32)
            t[0, :, :3] = np.eye(3)
            self.transforms = t
        else:
            self.transforms = np.asarray(self.transforms, np.float32)
            if self.transforms.ndim == 2:
                self.transforms = self.transforms[None]


class GeometrySoA(NamedTuple):
    """Per-face world-space SoA, one slab per motion key."""

    v0: np.ndarray  # [K, F, 3]
    e1: np.ndarray  # [K, F, 3] (v1 - v0)
    e2: np.ndarray  # [K, F, 3] (v2 - v0)
    n0: np.ndarray  # [K, F, 3]
    n1: np.ndarray  # [K, F, 3]
    n2: np.ndarray  # [K, F, 3]
    uv0: np.ndarray  # [F, 2]
    uv1: np.ndarray  # [F, 2]
    uv2: np.ndarray  # [F, 2]
    mat_id: np.ndarray  # [F] int32


class MaterialTable(NamedTuple):
    """One row per material, gathered by face material id."""

    mtype: np.ndarray  # [M] int32
    diffuse: np.ndarray  # [M, 3] f32
    emission: np.ndarray  # [M, 3] f32
    roughness: np.ndarray  # [M] f32
    metallic: np.ndarray  # [M] f32
    ior: np.ndarray  # [M] f32
    transmittance: np.ndarray  # [M] f32
    sheen: np.ndarray  # [M] f32
    diffuse_tex: np.ndarray  # [M] int32, -1 = none
    emissive_tex: np.ndarray  # [M] int32
    roughness_tex: np.ndarray  # [M] int32
    normal_tex: np.ndarray  # [M] int32
    uv_xform: np.ndarray  # [M, 6] f32 (m00 m01 m10 m11 ox oy)


@dataclass
class Scene:
    geom: GeometrySoA
    materials: MaterialTable
    lights: LightTable
    atlas: TextureAtlas = None  # the empty 1x1 atlas without textures
    num_keys: int = 1
    num_faces: int = 0
    num_lights: int = 0
    num_materials: int = 0
    any_uv_transform: bool = False  # a material transforms its uvs
    any_normal_map: bool = False  # a material has a normal map
    # the lat-long environment map of the miss program (scene/envmap.py
    # EnvMap), None for the constant ambient (scene.py:105-107)
    env: object = None

    def __post_init__(self):
        if self.atlas is None:
            self.atlas = empty_atlas()

    @property
    def all_diffuse(self) -> bool:
        return bool((self.materials.mtype == int(MaterialType.DIFFUSE)).all())

    @property
    def textured(self) -> bool:
        """The scene carries texture images (its atlas is not the empty 1x1
        one), as the reference's `_fused_texture_state` reads it."""
        return self.atlas.data.shape[:2] != (1, 1)


def _apply_affine(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """[3,4] affine applied to [N,3] points."""
    return pts @ m[:, :3].T + m[:, 3]


def _apply_normal(m: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose of the linear part."""
    nt = nrm @ np.linalg.inv(m[:, :3])
    lens = np.linalg.norm(nt, axis=-1, keepdims=True)
    return nt / np.maximum(lens, 1e-20)


def build_material_table(materials: Sequence[Material]) -> MaterialTable:
    if not materials:
        materials = [Material()]
    return MaterialTable(
        mtype=np.asarray([int(m.material_type) for m in materials], np.int32),
        diffuse=np.asarray([m.diffuse for m in materials], np.float32),
        emission=np.asarray([m.emissive for m in materials], np.float32),
        roughness=np.asarray([m.roughness for m in materials], np.float32),
        metallic=np.asarray([m.metallic for m in materials], np.float32),
        ior=np.asarray([m.ior for m in materials], np.float32),
        transmittance=np.asarray([m.transmittance for m in materials],
                                 np.float32),
        sheen=np.asarray([m.sheen for m in materials], np.float32),
        diffuse_tex=np.asarray([m.diffuse_texture_id for m in materials],
                               np.int32),
        emissive_tex=np.asarray([m.emissive_texture_id for m in materials],
                                np.int32),
        roughness_tex=np.asarray([m.roughness_texture_id for m in materials],
                                 np.int32),
        normal_tex=np.asarray([m.normal_texture_id for m in materials],
                              np.int32),
        uv_xform=np.asarray([m.uv_transform_row() for m in materials],
                            np.float32),
    )


def build_scene(meshes: Sequence[Mesh],
                instances: Sequence[Instance] | None = None,
                textures: Sequence | None = None,
                emissive_threshold: float = 1e-5,
                env_map=None) -> Scene:
    """Flatten meshes placed by `instances` (default: one identity
    instance per mesh, src/wavefront.cpp:141-147) into a world-space
    scene. textures: the images the materials' texture ids index ([h, w,
    4] uint8 arrays or TextureImage entries), packed into the scene's
    atlas. env_map: the scene's environment map (scene/envmap.py
    build_env_map), which the miss lanes sample instead of the constant
    ambient. An instance with both vertex motion and matrix motion raises
    ValueError: their product is not linear in t."""
    meshes = [m.with_computed_normals() for m in meshes]
    if instances is None:
        instances = [Instance(mesh_index=i) for i in range(len(meshes))]
    num_keys = 1
    for inst in instances:
        mesh = meshes[inst.mesh_index]
        kt = inst.transforms.shape[0]
        if kt > 1 and mesh.num_keys > 1:
            raise ValueError(
                "combined vertex-motion + matrix-motion on one instance is "
                "not linear in t; bake one of them instead")
        num_keys = max(num_keys, kt, mesh.num_keys)

    slabs = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2")}
    uv0s, uv1s, uv2s, mat_ids = [], [], [], []
    materials: list[Material] = []
    light_v0, light_v1, light_v2, light_e = [], [], [], []
    for inst in instances:
        mesh = meshes[inst.mesh_index]
        mat_index = len(materials)
        materials.append(mesh.material)
        f = mesh.indices
        per_key = {k: [] for k in slabs}
        for key in range(num_keys):
            # both tracks sampled at this key, clamped to their last key
            tk = inst.transforms[min(key, inst.transforms.shape[0] - 1)]
            vw = _apply_affine(tk, mesh.vertices[min(key, mesh.num_keys - 1)])
            nw = _apply_normal(tk, mesh.normals[min(key, mesh.num_keys - 1)])
            per_key["v0"].append(vw[f[:, 0]])
            per_key["e1"].append(vw[f[:, 1]] - vw[f[:, 0]])
            per_key["e2"].append(vw[f[:, 2]] - vw[f[:, 0]])
            per_key["n0"].append(nw[f[:, 0]])
            per_key["n1"].append(nw[f[:, 1]])
            per_key["n2"].append(nw[f[:, 2]])
        for k in slabs:
            slabs[k].append(np.stack(per_key[k], axis=0))
        uvs = (mesh.texcoords if mesh.texcoords is not None
               else np.zeros((mesh.vertices.shape[1], 2), np.float32))
        uv0s.append(uvs[f[:, 0]])
        uv1s.append(uvs[f[:, 1]])
        uv2s.append(uvs[f[:, 2]])
        mat_ids.append(np.full(mesh.num_faces, mat_index, np.int32))
        # light table entries from key-0 world vertices of emissive meshes
        # (src/wavefront.cpp:257-275)
        emissive = np.asarray(mesh.material.emissive, np.float32)
        if np.linalg.norm(emissive) >= emissive_threshold:
            vw0 = _apply_affine(inst.transforms[0], mesh.vertices[0])
            light_v0.append(vw0[f[:, 0]])
            light_v1.append(vw0[f[:, 1]])
            light_v2.append(vw0[f[:, 2]])
            light_e.append(np.broadcast_to(emissive, (len(f), 3)))

    num_faces = int(sum(len(x) for x in mat_ids))
    padded = -(-max(num_faces, 1) // FACE_ALIGN) * FACE_ALIGN

    def cat(xs, per_key: bool):
        a = np.concatenate(xs, axis=1 if per_key else 0).astype(np.float32)
        pad_n = padded - num_faces
        if pad_n:
            width = (((0, 0), (0, pad_n), (0, 0)) if per_key
                     else ((0, pad_n), (0, 0)))
            a = np.pad(a, width)
        return a

    geom = GeometrySoA(
        v0=cat(slabs["v0"], True), e1=cat(slabs["e1"], True),
        e2=cat(slabs["e2"], True), n0=cat(slabs["n0"], True),
        n1=cat(slabs["n1"], True), n2=cat(slabs["n2"], True),
        uv0=cat(uv0s, False), uv1=cat(uv1s, False), uv2=cat(uv2s, False),
        mat_id=np.pad(np.concatenate(mat_ids),
                      (0, padded - num_faces)).astype(np.int32),
    )

    def stack(xs):
        return np.concatenate(xs) if xs else np.zeros((0, 3))

    lights = build_light_table(stack(light_v0), stack(light_v1),
                               stack(light_v2), stack(light_e))
    return Scene(geom=geom, materials=build_material_table(materials),
                 lights=lights,
                 atlas=build_texture_atlas(textures) if textures
                 else empty_atlas(),
                 num_keys=num_keys, num_faces=num_faces,
                 num_lights=int(sum(len(x) for x in light_v0)),
                 num_materials=len(materials),
                 any_uv_transform=any(m.has_uv_transform()
                                      for m in materials),
                 any_normal_map=any(m.normal_texture_id >= 0
                                    for m in materials),
                 env=env_map)


def scene_from_numpy(geom: Mapping[str, np.ndarray],
                     materials: Mapping[str, np.ndarray],
                     lights: Mapping[str, np.ndarray], *, num_faces: int,
                     num_lights: int,
                     atlas: Mapping[str, np.ndarray] | None = None,
                     any_uv_transform: bool = False,
                     any_normal_map: bool = False) -> Scene:
    """This package's Scene from the arrays of a reference Scene.

    Each mapping holds numpy arrays by field name (the reference's
    GeometrySoA, MaterialTable, LightTable and TextureAtlas fields; extra
    fields are ignored)."""
    def pick(cls, src):
        return cls(**{k: np.asarray(src[k]) for k in cls._fields})

    mats = pick(MaterialTable, materials)
    g = pick(GeometrySoA, geom)
    tex = None
    if atlas is not None:
        tex = TextureAtlas(**{k: np.asarray(atlas[k])
                              for k in TextureAtlas._fields})
    return Scene(geom=g, materials=mats, lights=pick(LightTable, lights),
                 atlas=tex, num_keys=int(g.v0.shape[0]),
                 num_faces=int(num_faces), num_lights=int(num_lights),
                 num_materials=int(mats.mtype.shape[0]),
                 any_uv_transform=bool(any_uv_transform),
                 any_normal_map=bool(any_normal_map))
