"""Trace-time instancing: object-space meshes stored once and an instance
table, the scene of the two-level walk (trace/hier_instanced.py).

Port of rendertoy3c_tpu/scene/instanced.py (:79-247): `INST_FACE_ALIGN`,
`InstanceTable`, `InstancedScene`, `_affine_inverse` and
`build_instanced_scene`. Each mesh's faces are padded to INST_FACE_ALIGN
with degenerate (never hit) faces; the instance table holds two keys per
instance (key 1 = key 0 when static): the forward and inverse affines,
the normals' inverse-transpose and the world box over both keys; emissive
meshes enter the light table once per instance, in world space at key 0.

The reference stores only keys 0 and 1 of a transform track while
reporting more (ROADMAP C1); this port raises ValueError for an instance
of more than 2 keys instead.

`instanced_scene_from_numpy` takes a reference InstancedScene's arrays as
numpy and returns this package's, so a test can carry one scene across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple, Sequence

import numpy as np

from .light import LightTable, build_light_table
from .material import Material, MaterialType
from .mesh import Mesh
from .scene import (GeometrySoA, Instance, MaterialTable, _apply_affine,
                    build_material_table)
from .texture import TextureAtlas, build_texture_atlas, empty_atlas

INST_FACE_ALIGN = 128  # per-mesh face padding on the instanced path


class InstanceTable(NamedTuple):
    """Per-instance arrays (two keys each)."""

    mesh_id: np.ndarray  # [I] int32
    m: np.ndarray  # [I, 2, 3, 4] object -> world
    minv: np.ndarray  # [I, 2, 3, 4] world -> object
    inv_t: np.ndarray  # [I, 2, 3, 3] inverse-transpose (normals)
    aabb_lo: np.ndarray  # [I, 3] world box over both keys
    aabb_hi: np.ndarray  # [I, 3]


@dataclass
class InstancedScene:
    geom: GeometrySoA  # object space, every mesh concatenated on the faces
    instances: InstanceTable
    materials: MaterialTable
    lights: LightTable
    atlas: TextureAtlas = None
    mesh_ranges: tuple = ()  # (start, padded count) per mesh
    num_keys: int = 1
    num_faces: int = 0  # stored (padded) faces
    num_instances: int = 0
    num_lights: int = 0
    num_materials: int = 0
    any_uv_transform: bool = False
    any_normal_map: bool = False
    instance_mesh: tuple = ()  # the instances' mesh ids

    def __post_init__(self):
        if self.atlas is None:
            self.atlas = empty_atlas()

    @property
    def all_diffuse(self) -> bool:
        return bool((self.materials.mtype == int(MaterialType.DIFFUSE)).all())

    @property
    def textured(self) -> bool:
        return self.atlas.data.shape[:2] != (1, 1)


def _affine_inverse(m: np.ndarray) -> np.ndarray:
    """[3, 4] affine inverse."""
    lin = np.linalg.inv(m[:, :3])
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = lin
    out[:, 3] = -lin @ m[:, 3]
    return out


def build_instanced_scene(meshes: Sequence[Mesh],
                          instances: Sequence[Instance],
                          textures: Sequence | None = None,
                          emissive_threshold: float = 1e-5) -> InstancedScene:
    """Object-space static meshes and an instance table of at most 2
    transform keys per instance (ValueError otherwise: ROADMAP C1)."""
    meshes = [m.with_computed_normals() for m in meshes]
    for m in meshes:
        if m.num_keys != 1:
            raise ValueError(
                "instanced path supports static meshes; bake vertex-keyed "
                "meshes with build_scene")
    for inst in instances:
        if inst.transforms.shape[0] > 2:
            raise ValueError(
                f"an instance has {inst.transforms.shape[0]} transform keys; "
                "trace-time instancing takes at most 2 (the reference keeps "
                "keys 0-1 of longer tracks, ROADMAP C1)")

    slabs = {k: [] for k in ("v0", "e1", "e2", "n0", "n1", "n2")}
    uv0s, uv1s, uv2s, mat_ids = [], [], [], []
    materials: list[Material] = []
    mesh_ranges = []
    cursor = 0
    for mesh in meshes:
        mat_index = len(materials)
        materials.append(mesh.material)
        f = mesh.indices
        v = mesh.vertices[0]
        n = mesh.normals[0]
        nf = mesh.num_faces
        padded = -(-max(nf, 1) // INST_FACE_ALIGN) * INST_FACE_ALIGN

        def padf(a):
            return np.pad(a.astype(np.float32), ((0, padded - nf), (0, 0)))

        slabs["v0"].append(padf(v[f[:, 0]]))
        slabs["e1"].append(padf(v[f[:, 1]] - v[f[:, 0]]))
        slabs["e2"].append(padf(v[f[:, 2]] - v[f[:, 0]]))
        slabs["n0"].append(padf(n[f[:, 0]]))
        slabs["n1"].append(padf(n[f[:, 1]]))
        slabs["n2"].append(padf(n[f[:, 2]]))
        uvs = (mesh.texcoords if mesh.texcoords is not None
               else np.zeros((v.shape[0], 2), np.float32))
        uv0s.append(padf(uvs[f[:, 0]]))
        uv1s.append(padf(uvs[f[:, 1]]))
        uv2s.append(padf(uvs[f[:, 2]]))
        mat_ids.append(np.pad(np.full(nf, mat_index, np.int32),
                              (0, padded - nf)))
        mesh_ranges.append((cursor, padded))
        cursor += padded
    geom = GeometrySoA(
        **{k: np.concatenate(slabs[k])[None] for k in slabs},
        uv0=np.concatenate(uv0s), uv1=np.concatenate(uv1s),
        uv2=np.concatenate(uv2s), mat_id=np.concatenate(mat_ids))

    n_inst = len(instances)
    mids = np.zeros(n_inst, np.int32)
    m_arr = np.zeros((n_inst, 2, 3, 4), np.float32)
    minv_arr = np.zeros((n_inst, 2, 3, 4), np.float32)
    invt_arr = np.zeros((n_inst, 2, 3, 3), np.float32)
    lo_arr = np.zeros((n_inst, 3), np.float32)
    hi_arr = np.zeros((n_inst, 3), np.float32)
    light_v0, light_v1, light_v2, light_e = [], [], [], []
    num_keys = 1
    for i, inst in enumerate(instances):
        mesh = meshes[inst.mesh_index]
        mids[i] = inst.mesh_index
        kt = inst.transforms.shape[0]
        num_keys = max(num_keys, kt)
        for key in range(2):
            t = inst.transforms[min(key, kt - 1)]
            m_arr[i, key] = t
            minv_arr[i, key] = _affine_inverse(t)
            invt_arr[i, key] = np.linalg.inv(t[:, :3]).T
        v = mesh.vertices[0]
        pts = np.concatenate([_apply_affine(m_arr[i, 0], v),
                              _apply_affine(m_arr[i, 1], v)])
        lo_arr[i] = pts.min(axis=0)
        hi_arr[i] = pts.max(axis=0)
        emissive = np.asarray(mesh.material.emissive, np.float32)
        if np.linalg.norm(emissive) >= emissive_threshold:
            f = mesh.indices
            vw0 = _apply_affine(inst.transforms[0], v)
            light_v0.append(vw0[f[:, 0]])
            light_v1.append(vw0[f[:, 1]])
            light_v2.append(vw0[f[:, 2]])
            light_e.append(np.broadcast_to(emissive, (len(f), 3)))

    def stack(xs):
        return np.concatenate(xs) if xs else np.zeros((0, 3))

    return InstancedScene(
        geom=geom,
        instances=InstanceTable(mesh_id=mids, m=m_arr, minv=minv_arr,
                                inv_t=invt_arr, aabb_lo=lo_arr,
                                aabb_hi=hi_arr),
        materials=build_material_table(materials),
        lights=build_light_table(stack(light_v0), stack(light_v1),
                                 stack(light_v2), stack(light_e)),
        atlas=build_texture_atlas(textures) if textures else empty_atlas(),
        mesh_ranges=tuple(mesh_ranges), num_keys=num_keys,
        num_faces=cursor, num_instances=n_inst,
        num_lights=int(sum(len(x) for x in light_v0)),
        num_materials=len(materials),
        any_uv_transform=any(m.has_uv_transform() for m in materials),
        any_normal_map=any(m.normal_texture_id >= 0 for m in materials),
        instance_mesh=tuple(int(x) for x in mids))


def instanced_scene_from_numpy(
        geom: Mapping[str, np.ndarray], instances: Mapping[str, np.ndarray],
        materials: Mapping[str, np.ndarray],
        lights: Mapping[str, np.ndarray], *, mesh_ranges, num_keys: int,
        num_lights: int, atlas: Mapping[str, np.ndarray] | None = None,
        any_uv_transform: bool = False,
        any_normal_map: bool = False) -> InstancedScene:
    """This package's InstancedScene from the arrays of a reference one.

    Each mapping holds numpy arrays by field name (the reference's
    GeometrySoA, InstanceTable, MaterialTable, LightTable and TextureAtlas
    fields; extra fields are ignored)."""
    def pick(cls, src):
        return cls(**{k: np.asarray(src[k]) for k in cls._fields})

    g = pick(GeometrySoA, geom)
    it = pick(InstanceTable, instances)
    mats = pick(MaterialTable, materials)
    tex = None
    if atlas is not None:
        tex = TextureAtlas(**{k: np.asarray(atlas[k])
                              for k in TextureAtlas._fields})
    return InstancedScene(
        geom=g, instances=it, materials=mats, lights=pick(LightTable, lights),
        atlas=tex, mesh_ranges=tuple((int(a), int(b)) for a, b in mesh_ranges),
        num_keys=int(num_keys), num_faces=int(g.mat_id.shape[0]),
        num_instances=int(it.mesh_id.shape[0]), num_lights=int(num_lights),
        num_materials=int(mats.mtype.shape[0]),
        any_uv_transform=bool(any_uv_transform),
        any_normal_map=bool(any_normal_map),
        instance_mesh=tuple(int(x) for x in it.mesh_id))
