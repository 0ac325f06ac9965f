"""Wavefront OBJ/MTL loader (tinyobj-equivalent), mirroring
rendertoy3o::loadOBJ (src/mesh.cpp:37-210).

Port of rendertoy3c_tpu/io/obj.py (:47-357): `parse_mtl`, `_parse_obj`,
`_unique_first_appearance` and `load_obj`, with the pure-Python parser
only (the reference's optional native parser is not ported).

  * N obj paths = N motion keyframes of one topology (mesh.cpp:39-55);
  * each shape is split per material id into separate meshes (mesh.cpp:63-71);
  * vertices dedup'd by their (v, vt, vn) index triple; all keyframes share
    the dedup map so topology stays aligned across keys (mesh.cpp:80-110);
  * textures load as RGBA8 with a vertical flip (mesh.cpp:150-160)
    through film.image.read_image (PIL, or stdlib decoders of PNG, TGA and
    BMP where PIL is missing); a file that is missing gives texture id -1,
    and so does one that does not decode, with a warning naming it;
    dedup'd globally by filename;
  * material fields map like mesh.cpp:186-198: Kd->diffuse, Ke->emissive,
    Pr->roughness, aniso, Ni->ior, Tf->transmittance, map_* -> texture ids.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..film.image import read_image
from ..scene.material import Material
from ..scene.mesh import Mesh


@dataclass
class MtlMaterial:
    name: str = ""
    diffuse: tuple = (1.0, 1.0, 1.0)
    emission: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    anisotropy: float = 0.0
    ior: float = 1.333
    transmittance: float = 0.0
    shininess: float = 0.0
    dissolve: float = 1.0
    diffuse_texname: str = ""
    emissive_texname: str = ""
    roughness_texname: str = ""
    normal_texname: str = ""


def parse_mtl(path: str) -> Dict[str, MtlMaterial]:
    """Parse a .mtl file -> {name: MtlMaterial}."""
    mats: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                cur = MtlMaterial(name=" ".join(parts[1:]))
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == "Ks" and len(parts) >= 4:
                cur.specular = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur.shininess = float(parts[1])
            elif key == "Ni":
                cur.ior = float(parts[1])
            elif key == "Pr":  # PBR extension: roughness
                cur.roughness = float(parts[1])
            elif key == "aniso":
                cur.anisotropy = float(parts[1])
            elif key == "Tf" and len(parts) >= 4:
                # tinyobj stores transmittance as a color; the reference reads
                # it as a single float (first component).
                cur.transmittance = float(parts[1])
            elif key == "d":
                cur.dissolve = float(parts[1])
            elif key == "Tr":
                cur.dissolve = 1.0 - float(parts[1])
            elif key == "map_Kd":
                cur.diffuse_texname = parts[-1]
            elif key == "map_Ke":
                cur.emissive_texname = parts[-1]
            elif key == "map_Pr":
                cur.roughness_texname = parts[-1]
            elif key in ("norm", "map_bump", "bump"):
                cur.normal_texname = parts[-1]
    return mats


@dataclass
class _ObjData:
    vertices: List[Tuple[float, float, float]] = field(default_factory=list)
    normals: List[Tuple[float, float, float]] = field(default_factory=list)
    texcoords: List[Tuple[float, float]] = field(default_factory=list)
    # faces per shape: list of (shape_name, [(idx_triple, idx_triple, idx_triple, mat_name)])
    shapes: List[Tuple[str, List]] = field(default_factory=list)
    materials: Dict[str, MtlMaterial] = field(default_factory=dict)


def _parse_obj(path: str) -> _ObjData:
    data = _ObjData()
    cur_faces: List = []
    cur_name = ""
    cur_mtl = ""

    def flush():
        nonlocal cur_faces, cur_name
        if cur_faces:
            data.shapes.append((cur_name, cur_faces))
            cur_faces = []

    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                data.vertices.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif key == "vn":
                data.normals.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif key == "vt":
                data.texcoords.append((float(parts[1]), float(parts[2])))
            elif key == "f":
                corners = []
                for spec in parts[1:]:
                    fields = spec.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(data.vertices) + vi
                    ti = ni = -1
                    if len(fields) > 1 and fields[1]:
                        ti = int(fields[1])
                        ti = ti - 1 if ti > 0 else len(data.texcoords) + ti
                    if len(fields) > 2 and fields[2]:
                        ni = int(fields[2])
                        ni = ni - 1 if ni > 0 else len(data.normals) + ni
                    corners.append((vi, ti, ni))
                # fan-triangulate polygons
                for i in range(1, len(corners) - 1):
                    cur_faces.append(
                        (corners[0], corners[i], corners[i + 1], cur_mtl)
                    )
            elif key in ("o", "g"):
                flush()
                cur_name = " ".join(parts[1:])
            elif key == "usemtl":
                cur_mtl = " ".join(parts[1:])
            elif key == "mtllib":
                for lib in parts[1:]:
                    data.materials.update(
                        parse_mtl(os.path.join(base, lib.replace("\\", "/")))
                    )
    flush()
    return data


def _load_texture(path: str) -> Optional[np.ndarray]:
    """Load an image as RGBA8 with vertical flip (stbi convention of
    mesh.cpp:150-160), through film.image.read_image (PIL, or its stdlib
    decoders of PNG, TGA and BMP where PIL is missing). Returns None when
    the file is missing, as the reference does; a file that exists but does
    not decode also gives None, with a warning that names it."""
    if not os.path.isfile(path):
        return None
    try:
        rgba = read_image(path)
    except Exception as e:  # any decoder's failure: the texture is dropped
        warnings.warn(f"texture {path} does not decode and is left out "
                      f"({type(e).__name__}: {e})", stacklevel=2)
        return None
    return rgba[::-1].copy()


def _parse_obj_arrays(path: str):
    """Parse geometry to flat arrays.

    Returns (dict(v, vn, vt, face_idx [nf,3,3], face_mat [nf],
    face_shape [nf], mat_names), materials {name: MtlMaterial}).
    """
    data = _parse_obj(path)
    mat_names: List[str] = []
    mat_ids: Dict[str, int] = {}
    fi, fm, fs = [], [], []
    for shape_i, (_name, faces) in enumerate(data.shapes):
        for c0, c1, c2, mname in faces:
            if mname not in mat_ids:
                mat_ids[mname] = len(mat_names)
                mat_names.append(mname)
            fi.append((c0, c1, c2))
            fm.append(mat_ids[mname])
            fs.append(shape_i)
    nf = len(fi)
    return (
        dict(
            v=np.asarray(data.vertices, np.float32).reshape(-1, 3),
            vn=np.asarray(data.normals, np.float32).reshape(-1, 3),
            vt=np.asarray(data.texcoords, np.float32).reshape(-1, 2),
            face_idx=np.asarray(fi, np.int32).reshape(nf, 3, 3),
            face_mat=np.asarray(fm, np.int32).reshape(nf),
            face_shape=np.asarray(fs, np.int32).reshape(nf),
            mat_names=mat_names,
        ),
        data.materials,
    )


def _unique_first_appearance(rows: np.ndarray):
    """np.unique(axis=0) reordered to first appearance.

    Returns (uniq_rows, inverse) with inverse mapping each input row to its
    slot in uniq_rows — reproducing the reference loader's insertion-order
    vertex dedup (src/mesh.cpp:13-35)."""
    _, first_idx, inv = np.unique(
        rows, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rows[np.sort(first_idx)], rank[inv.reshape(-1)]


def load_obj(paths: Sequence[str] | str):
    """Load one or more .obj files (N files = N motion keyframes).

    Returns (meshes, textures): a list of scene.Mesh (one per
    shape x material, like the reference) and a list of RGBA8 numpy images
    indexed by the material texture ids.

    Mesh assembly (per-material split + vertex dedup + keyframe stacking)
    is vectorized numpy.
    """
    if isinstance(paths, str):
        paths = [paths]
    key_frames = len(paths)
    parsed = [_parse_obj_arrays(p) for p in paths]
    objs = [p[0] for p in parsed]
    base = objs[0]
    materials_by_name = parsed[0][1]
    model_dir = os.path.dirname(os.path.abspath(paths[0]))

    textures: List[np.ndarray] = []
    known_textures: Dict[str, int] = {}

    def texture_id(name: str) -> int:
        if not name:
            return -1
        norm = name.replace("\\", "/")
        if norm in known_textures:
            return known_textures[norm]
        img = _load_texture(os.path.join(model_dir, norm))
        if img is None:
            known_textures[norm] = -1
            return -1
        tid = len(textures)
        textures.append(img)
        known_textures[norm] = tid
        return tid

    meshes: List[Mesh] = []
    face_idx = base["face_idx"]
    face_mat = base["face_mat"]
    face_shape = base["face_shape"]
    mat_name_of = dict(enumerate(base["mat_names"]))
    mat_name_of[-1] = ""

    for shape_i in np.unique(face_shape):
        in_shape = face_shape == shape_i
        mats_here = sorted(
            {mat_name_of[int(m)] for m in np.unique(face_mat[in_shape])}
        )
        for mat_name in mats_here:
            mat_id = next(
                mid for mid, nm in mat_name_of.items() if nm == mat_name
            )
            mask = in_shape & (face_mat == mat_id)
            if not mask.any():
                continue
            corners = face_idx[mask].reshape(-1, 3)  # [3k, (v,t,n)]
            uniq, inverse = _unique_first_appearance(corners)
            indices = inverse.reshape(-1, 3)
            vi = uniq[:, 0]
            ti = uniq[:, 1]
            ni = uniq[:, 2]
            has_normals = bool((ni >= 0).any())
            has_uvs = bool((ti >= 0).any())

            verts = [objs[k]["v"][vi] for k in range(key_frames)]
            norms = []
            for k in range(key_frames):
                vn = objs[k]["vn"]
                nk = np.zeros((len(uniq), 3), np.float32)
                if len(vn) and has_normals:
                    ok_n = ni >= 0
                    nk[ok_n] = vn[ni[ok_n]]
                norms.append(nk)
            uvs = np.zeros((len(uniq), 2), np.float32)
            if len(base["vt"]) and has_uvs:
                ok_t = ti >= 0
                uvs[ok_t] = base["vt"][ti[ok_t]]

            mtl = materials_by_name.get(mat_name, MtlMaterial(name=mat_name))
            material = Material(
                diffuse=mtl.diffuse,
                diffuse_texture_id=texture_id(mtl.diffuse_texname),
                emissive=mtl.emission,
                emissive_texture_id=texture_id(mtl.emissive_texname),
                roughness=mtl.roughness,
                roughness_texture_id=texture_id(mtl.roughness_texname),
                anisotropy=mtl.anisotropy,
                ior=mtl.ior,
                transmittance=mtl.transmittance,
                normal_texture_id=texture_id(mtl.normal_texname),
            )
            mesh = Mesh(
                vertices=np.asarray(verts, np.float32),
                indices=np.asarray(indices, np.int32),
                normals=np.asarray(norms, np.float32) if has_normals else None,
                texcoords=np.asarray(uvs, np.float32) if has_uvs else None,
                material=material,
            )
            if not has_normals:
                mesh = mesh.with_computed_normals()
            meshes.append(mesh)

    return meshes, textures
