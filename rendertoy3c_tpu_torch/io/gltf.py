"""glTF 2.0 scene import (.gltf and .glb), host-side numpy.

Port of rendertoy3c_tpu/io/gltf.py (the legacy glTF stack of the reference,
sutil/Scene.cpp:125-551 over tinygltf): `load_gltf` (:398) with `_load_glb`
(:58), `_read_uri` (:81), `_GltfDoc` (:91), `_quat_matrix` (:158),
`_node_matrix` (:167), the animation sampling `_slerp` (:191),
`_sample_channel` (:204, LINEAR, STEP and CUBICSPLINE, clamped to the key
range), `_animation_channels` (:242) and `_world_matrices` (:266),
linear-blend skinning `_skin_vertices` (:287) and `_material_from_gltf`
(:313). The numpy arithmetic is the reference's, in its order and dtypes,
so the vertices come out array-equal.

  * the node hierarchy (TRS or matrix) is baked to world space, one Mesh
    per (node, triangle primitive), split by material;
  * `times` samples animation clip `animation` at each time stamp, one
    motion keyframe each: two stamps give 2-key motion blur, N stamps N
    keys (trace/auto.py routes N > 2 keys);
  * pbrMetallicRoughness materials become PRINCIPLED (FRESNEL_TRANSMISSIVE
    under KHR_materials_transmission), with KHR_materials_ior,
    KHR_materials_emissive_strength and KHR_texture_transform on the base
    colour; textures keep their sampler's wrap modes, one atlas entry per
    (image, wrap) pair;
  * perspective cameras and KHR_lights_punctual point lights (first key).
    The path renderer does not read the point lights; the reference's CLI
    hands them only to its direct renderer (ROADMAP A21).

Images decode from their bytes (files, data URIs, GLB buffer views) by the
port's own PNG, BMP and TGA decoders (film/image.py), which give the
arrays Pillow's convert("RGBA") gives, so they load where Pillow is not
installed; Pillow, where it is, decodes other formats. An image that
neither decodes raises ValueError naming it (the reference drops such a
texture). Rows are flipped bottom-up, as the reference stores textures.

Not ported, raising NotImplementedError naming ROADMAP A21: alphaMode MASK
and BLEND (the port's Material has no alpha) and a texture read through
texCoord 1 (the port has no second uv set). TEXCOORD_1 and COLOR_0
attributes are not read: only the reference's direct renderer reads them.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..film.image import decode_image_bytes
from ..scene.camera import Camera
from ..scene.material import Material, MaterialType
from ..scene.mesh import Mesh
from ..scene.texture import WRAP_REPEAT, TextureImage, wrap_from_gl

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


@dataclass
class PointLight:
    """A point light (cuda/Light.h:31-50): position, colour, intensity."""

    position: tuple
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0


def _load_glb(path: str):
    """(JSON document, BIN chunk bytes) of a .glb container."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"{path}: not a GLB file")
    if version != 2:
        raise ValueError(f"{path}: unsupported GLB version {version}")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + clen]
        if ctype == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + clen + (-clen % 4)
    if gltf is None:
        raise ValueError(f"{path}: GLB missing JSON chunk")
    return gltf, bin_chunk


def _read_uri(uri: str, base_dir: str) -> bytes:
    """The bytes of a data URI or of a file relative to base_dir."""
    if uri.startswith("data:"):
        _, payload = uri.split(",", 1)
        return base64.b64decode(payload)
    from urllib.parse import unquote

    with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
        return f.read()


def _decode_image(raw: bytes, name: str, tga: bool) -> np.ndarray:
    """[H, W, 4] uint8 RGBA, row 0 at the top: the port's decoders for
    PNG, BMP and TGA, Pillow (where installed) for anything else."""
    try:
        return decode_image_bytes(raw, name, tga=tga)
    except ValueError as err:
        if raw[:8] == b"\x89PNG\r\n\x1a\n" or raw[:2] == b"BM" or tga:
            raise
        stdlib_err = err
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{name}: cannot decode this image without "
                         f"Pillow ({stdlib_err})") from None
    import io as _io

    try:
        with Image.open(_io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception as err:  # Pillow raises several types
        raise ValueError(f"{name}: cannot decode this image ({err})") \
            from None


class _GltfDoc:
    """The JSON document, its buffers, and accessor and image reads."""

    def __init__(self, path: str):
        self.path = path
        self.base_dir = os.path.dirname(os.path.abspath(path))
        if path.endswith(".glb"):
            self.j, bin_chunk = _load_glb(path)
        else:
            with open(path) as f:
                self.j = json.load(f)
            bin_chunk = b""
        self.buffers = []
        for buf in self.j.get("buffers", []):
            if "uri" in buf:
                self.buffers.append(_read_uri(buf["uri"], self.base_dir))
            else:
                self.buffers.append(bin_chunk)

    def buffer_view(self, idx: int) -> Tuple[bytes, int]:
        bv = self.j["bufferViews"][idx]
        buf = self.buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        return buf[off: off + bv["byteLength"]], bv.get("byteStride", 0)

    def accessor(self, idx: int) -> np.ndarray:
        acc = self.j["accessors"][idx]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            return np.zeros((count, ncomp), dtype)
        raw, stride = self.buffer_view(acc["bufferView"])
        off = acc.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            out = np.empty((count, ncomp), dtype)
            for i in range(count):
                out[i] = np.frombuffer(
                    raw, dtype, count=ncomp, offset=off + i * stride)
            arr = out
        else:
            arr = np.frombuffer(
                raw, dtype, count=count * ncomp, offset=off
            ).reshape(count, ncomp)
        if acc.get("normalized"):
            arr = arr.astype(np.float32) / np.iinfo(dtype).max
        return arr

    def image_rgba(self, image_idx: int) -> np.ndarray:
        """Image `image_idx` as [H, W, 4] uint8, rows bottom-up (the stbi
        vertical flip of src/mesh.cpp:131)."""
        img = self.j["images"][image_idx]
        if "uri" in img:
            uri = img["uri"]
            raw = _read_uri(uri, self.base_dir)
            name = (f"{self.path}: image {image_idx}" if
                    uri.startswith("data:") else
                    os.path.join(self.base_dir, uri))
            tga = uri.split(";")[0] in ("data:image/x-tga", "data:image/tga") \
                or uri.lower().endswith((".tga", ".tpic"))
        else:
            raw, _ = self.buffer_view(img["bufferView"])
            name = f"{self.path}: image {image_idx}"
            tga = False
        tga = tga or img.get("mimeType") in ("image/x-tga", "image/tga")
        rgba = _decode_image(raw, name, tga)
        return rgba[::-1].copy()


def _quat_matrix(q) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _node_matrix(node: dict, overrides: Optional[dict] = None) -> np.ndarray:
    """Local transform; `overrides` replaces animated TRS properties."""
    ov = overrides or {}
    if "matrix" in node and not ov:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    scale = ov.get("scale", node.get("scale"))
    if scale is not None:
        m[:3, :3] *= np.asarray(scale, np.float32)
    rot = ov.get("rotation", node.get("rotation"))
    if rot is not None:
        m[:3, :3] = _quat_matrix(rot) @ m[:3, :3]
    trans = ov.get("translation", node.get("translation"))
    if trans is not None:
        m[:3, 3] = trans
    return m


def _slerp(q0: np.ndarray, q1: np.ndarray, f: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:  # the shortest path
        q1 = -q1
        d = -d
    if d > 0.9995:  # nearly parallel: nlerp
        q = q0 + f * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - f) * th) * q0 + np.sin(f * th) * q1) / np.sin(th)


def _sample_channel(times: np.ndarray, values: np.ndarray, interp: str,
                    path: str, t: float):
    """One animation sampler at time t (clamped to the key range)."""
    n = len(times)
    if interp == "CUBICSPLINE":
        values = values.reshape(n, 3, -1)  # (in-tangent, value, out-tangent)
    if t <= times[0]:
        v = values[0, 1] if interp == "CUBICSPLINE" else values[0]
        return np.asarray(v, np.float32)
    if t >= times[-1]:
        v = values[-1, 1] if interp == "CUBICSPLINE" else values[-1]
        return np.asarray(v, np.float32)
    i1 = int(np.searchsorted(times, t, side="right"))
    i0 = i1 - 1
    dt = float(times[i1] - times[i0])
    f = 0.0 if dt <= 0 else (t - float(times[i0])) / dt
    if interp == "STEP":
        return np.asarray(values[i0], np.float32)
    if interp == "CUBICSPLINE":
        p0, m0 = values[i0, 1], values[i0, 2] * dt
        p1, m1 = values[i1, 1], values[i1, 0] * dt
        f2, f3 = f * f, f * f * f
        v = ((2 * f3 - 3 * f2 + 1) * p0 + (f3 - 2 * f2 + f) * m0
             + (-2 * f3 + 3 * f2) * p1 + (f3 - f2) * m1)
        if path == "rotation":
            v = v / max(np.linalg.norm(v), 1e-20)
        return np.asarray(v, np.float32)
    # LINEAR
    if path == "rotation":
        return _slerp(np.asarray(values[i0], np.float64),
                      np.asarray(values[i1], np.float64), f).astype(np.float32)
    return np.asarray((1 - f) * values[i0] + f * values[i1], np.float32)


def _animation_channels(doc: _GltfDoc, animation: int) -> dict:
    """node -> {path: (times, values, interpolation)} of one clip; morph
    target weights are skipped."""
    anims = doc.j.get("animations", [])
    if not anims or animation >= len(anims):
        return {}
    out: dict = {}
    clip = anims[animation]
    samplers = clip.get("samplers", [])
    for ch in clip.get("channels", []):
        tgt = ch.get("target", {})
        node = tgt.get("node")
        path = tgt.get("path")
        if node is None or path not in ("translation", "rotation", "scale"):
            continue
        smp = samplers[ch["sampler"]]
        times = np.asarray(doc.accessor(smp["input"]), np.float32).reshape(-1)
        values = np.asarray(doc.accessor(smp["output"]), np.float32)
        out.setdefault(node, {})[path] = (
            times, values, smp.get("interpolation", "LINEAR"))
    return out


def _world_matrices(j: dict, roots, channels: dict,
                    t: Optional[float]) -> dict:
    """node -> world 4 x 4 at animation time t (None: the static TRS)."""
    worlds: dict = {}

    def rec(i, parent):
        node = j["nodes"][i]
        ov = None
        if t is not None and i in channels:
            ov = {path: _sample_channel(*spec, path, t)
                  for path, spec in channels[i].items()}
        world = parent @ _node_matrix(node, ov)
        worlds[i] = world
        for c in node.get("children", []):
            rec(c, world)

    identity = np.eye(4, dtype=np.float32)
    for r in roots:
        rec(r, identity)
    return worlds


def _skin_vertices(doc: _GltfDoc, skin: dict, worlds: dict,
                   joints_idx: np.ndarray, weights: np.ndarray,
                   pos: np.ndarray, nrm: Optional[np.ndarray]):
    """Linear-blend skinning: world positions (and normals) for one
    evaluation; joint matrix = world of the joint @ its inverse bind
    matrix (a skinned mesh ignores its node's own transform)."""
    joints = skin["joints"]
    if "inverseBindMatrices" in skin:
        ibm = np.asarray(doc.accessor(skin["inverseBindMatrices"]),
                         np.float32).reshape(-1, 4, 4).transpose(0, 2, 1)
    else:
        ibm = np.tile(np.eye(4, dtype=np.float32), (len(joints), 1, 1))
    jm = np.stack([worlds[joints[k]] @ ibm[k] for k in range(len(joints))])

    w = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-20)
    blended = np.einsum("vc,vcij->vij", w, jm[joints_idx])  # [V, 4, 4]
    pos_w = (np.einsum("vij,vj->vi", blended[:, :3, :3], pos)
             + blended[:, :3, 3])
    nrm_w = None
    if nrm is not None:
        lin_it = np.linalg.inv(blended[:, :3, :3]).transpose(0, 2, 1)
        nrm_w = np.einsum("vij,vj->vi", lin_it, nrm)
        nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True),
                            1e-20)
    return pos_w.astype(np.float32), (
        None if nrm_w is None else nrm_w.astype(np.float32))


def _material_from_gltf(doc: _GltfDoc, mat_idx: Optional[int],
                        texture_of_image) -> Material:
    if mat_idx is None:
        return Material(material_type=MaterialType.PRINCIPLED,
                        diffuse=(0.8, 0.8, 0.8), roughness=1.0, metallic=0.0)
    m = doc.j["materials"][mat_idx]
    if m.get("alphaMode") in ("MASK", "BLEND"):
        raise NotImplementedError(
            f"{doc.path}: material {mat_idx} has alphaMode "
            f"{m['alphaMode']}; alpha is not ported yet (ROADMAP A21)")
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])

    def tex_id(tinfo):
        if tinfo is None:
            return -1
        # texCoord past 1 clamps to set 0, as sutil/Scene.cpp:254-257
        if int(tinfo.get("texCoord", 0)) == 1:
            raise NotImplementedError(
                f"{doc.path}: material {mat_idx} reads a texture through "
                "texCoord 1; the second uv set is not ported yet (ROADMAP "
                "A21)")
        tex = doc.j["textures"][tinfo["index"]]
        src = tex.get("source")
        if src is None:
            return -1
        ws = wt = WRAP_REPEAT
        if "sampler" in tex:
            smp = doc.j.get("samplers", [])[tex["sampler"]]
            ws = wrap_from_gl(smp.get("wrapS", 10497))
            wt = wrap_from_gl(smp.get("wrapT", 10497))
        return texture_of_image(src, ws, wt)

    # KHR_texture_transform on the base colour texture: the uv transform
    xform = (pbr.get("baseColorTexture", {}).get("extensions", {})
             .get("KHR_texture_transform", {}))
    ext = m.get("extensions", {})
    emissive_strength = float(
        ext.get("KHR_materials_emissive_strength", {})
        .get("emissiveStrength", 1.0))
    ior = float(ext.get("KHR_materials_ior", {}).get("ior", 1.5))
    transmission = float(
        ext.get("KHR_materials_transmission", {})
        .get("transmissionFactor", 0.0))
    mtype = (MaterialType.FRESNEL_TRANSMISSIVE if transmission > 0.0
             else MaterialType.PRINCIPLED)
    # the texture ids in the reference's order, which numbers the atlas
    return Material(
        material_type=mtype,
        diffuse=tuple(base[:3]),
        diffuse_texture_id=tex_id(pbr.get("baseColorTexture")),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness_texture_id=tex_id(pbr.get("metallicRoughnessTexture")),
        ior=ior,
        transmittance=transmission,
        emissive=tuple(emissive_strength * c
                       for c in m.get("emissiveFactor", [0, 0, 0])),
        emissive_texture_id=tex_id(m.get("emissiveTexture")),
        normal_texture_id=tex_id(m.get("normalTexture")),
        tex_offset=tuple(xform.get("offset", [0.0, 0.0])),
        tex_rotation=float(xform.get("rotation", 0.0)),
        tex_scale=tuple(xform.get("scale", [1.0, 1.0])),
    )


def load_gltf(path: str, times=None, animation: int = 0):
    """Load a .gltf or .glb file.

    times: animation time stamps (seconds), one motion keyframe each: the
    node TRS channels of clip `animation` are sampled and skins deformed
    at every stamp. None bakes the static pose (one key).

    Returns (meshes, textures, cameras, point_lights): one Mesh per (node,
    triangle primitive) in world space; TextureImage entries (RGBA8 rows
    bottom-up, sampler wraps) that the materials' texture ids index;
    world-posed perspective Cameras and PointLights at the first key."""
    doc = _GltfDoc(path)
    j = doc.j

    textures: List[TextureImage] = []
    image_to_texture = {}
    image_cache = {}

    def texture_of_image(image_idx: int, wrap_s: int = WRAP_REPEAT,
                         wrap_t: int = WRAP_REPEAT) -> int:
        # one atlas entry per (image, sampler wrap)
        key = (image_idx, wrap_s, wrap_t)
        if key in image_to_texture:
            return image_to_texture[key]
        if image_idx not in image_cache:
            image_cache[image_idx] = doc.image_rgba(image_idx)
        tid = len(textures)
        textures.append(TextureImage(image_cache[image_idx], wrap_s, wrap_t))
        image_to_texture[key] = tid
        return tid

    meshes: List[Mesh] = []
    cameras: List[Camera] = []
    point_lights: List[PointLight] = []
    ext_lights = (j.get("extensions", {}).get("KHR_lights_punctual", {})
                  .get("lights", []))

    scene_idx = j.get("scene", 0)
    scenes = j.get("scenes", [{}])
    roots = scenes[scene_idx].get("nodes", []) if scenes else []
    all_children = {c for n in j.get("nodes", [])
                    for c in n.get("children", [])}
    if not roots:  # no scene graph: every node that is no child is a root
        roots = [i for i in range(len(j.get("nodes", [])))
                 if i not in all_children]

    channels = _animation_channels(doc, animation) if times is not None \
        else {}
    eval_times = list(times) if times is not None else [None]
    # the world matrices cover orphan subtrees too (skin joints may sit
    # outside the rendered scene's roots)
    mat_roots = list(dict.fromkeys(
        roots + [i for i in range(len(j.get("nodes", [])))
                 if i not in all_children and i not in roots]))
    worlds_k = [_world_matrices(j, mat_roots, channels, t)
                for t in eval_times]
    worlds0 = worlds_k[0]

    def bake_prim(node_idx: int, node: dict, prim: dict):
        attrs = prim["attributes"]
        pos = doc.accessor(attrs["POSITION"]).astype(np.float32)
        nrm = (doc.accessor(attrs["NORMAL"]).astype(np.float32)
               if "NORMAL" in attrs else None)
        skin = (j["skins"][node["skin"]]
                if "skin" in node and "JOINTS_0" in attrs
                and "WEIGHTS_0" in attrs else None)
        if skin is not None:
            joints_idx = doc.accessor(attrs["JOINTS_0"]).astype(np.int32)
            weights = doc.accessor(attrs["WEIGHTS_0"]).astype(np.float32)

        pos_keys, nrm_keys = [], []
        for worlds in worlds_k:
            if skin is not None:
                pk, nk = _skin_vertices(doc, skin, worlds, joints_idx,
                                        weights, pos, nrm)
            else:
                world = worlds[node_idx]
                pk = pos @ world[:3, :3].T + world[:3, 3]
                nk = None
                if nrm is not None:
                    lin_it = np.linalg.inv(world[:3, :3]).T
                    nk = nrm @ lin_it.T
                    nk /= np.maximum(
                        np.linalg.norm(nk, axis=-1, keepdims=True), 1e-20)
            pos_keys.append(pk.astype(np.float32))
            if nk is not None:
                nrm_keys.append(nk.astype(np.float32))

        uv = None
        if "TEXCOORD_0" in attrs:
            a = doc.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
            # glTF's uv origin is the top left; the flipped textures
            # expect the bottom left (the .obj convention)
            uv = np.stack([a[:, 0], 1.0 - a[:, 1]], axis=1)
        if "indices" in prim:
            idx = doc.accessor(prim["indices"]).reshape(-1)
            idx = idx.astype(np.int32).reshape(-1, 3)
        else:
            idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
        material = _material_from_gltf(doc, prim.get("material"),
                                       texture_of_image)
        mesh = Mesh(vertices=np.stack(pos_keys), indices=idx,
                    normals=np.stack(nrm_keys) if nrm_keys else None,
                    texcoords=uv, material=material)
        if not nrm_keys:
            mesh = mesh.with_computed_normals()
        meshes.append(mesh)

    def visit(node_idx: int):
        node = j["nodes"][node_idx]
        world = worlds0[node_idx]
        if "mesh" in node:
            for prim in j["meshes"][node["mesh"]].get("primitives", []):
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                bake_prim(node_idx, node, prim)
        if "camera" in node:
            cam = j["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                import math

                p = cam["perspective"]
                eye = world[:3, 3]
                fwd = -world[:3, 2]  # glTF cameras look down -z
                up = world[:3, 1]
                cameras.append(Camera(
                    eye=tuple(eye.tolist()),
                    lookat=tuple((eye + fwd).tolist()),
                    up=tuple(up.tolist()),
                    fov_y=math.degrees(p.get("yfov", 0.8)),
                    aspect_ratio=float(p.get("aspectRatio", 1.0))))
        light_idx = (node.get("extensions", {})
                     .get("KHR_lights_punctual", {}).get("light"))
        if light_idx is not None and light_idx < len(ext_lights):
            li = ext_lights[light_idx]
            if li.get("type") == "point":
                point_lights.append(PointLight(
                    position=tuple(world[:3, 3].tolist()),
                    color=tuple(li.get("color", [1, 1, 1])),
                    intensity=float(li.get("intensity", 1.0))))
        for child in node.get("children", []):
            visit(child)

    for r in roots:
        visit(r)
    return meshes, textures, cameras, point_lights
