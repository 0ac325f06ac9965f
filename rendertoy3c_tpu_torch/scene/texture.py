"""Texture atlas and batched bilinear sampling.

Port of rendertoy3c_tpu/scene/texture.py: the wrap modes, the shelf-packed
RGBA8 atlas with its per-texture meta rows (`build_texture_atlas`,
:63-131), its single-gather quad table on request (`build_quad_table`: no
kernel of the port reads it), and `sample_texture_bilinear` (:164-215) on
tensors, by four gathers of the RGBA8 texels. The atlas arrays stay numpy
on the host; `atlas_to` puts them on a device. `sample_texture_bilinear`
is the plain version of the texture fetch of the shading kernels
(kernels/csrc/shade.cuh `tex_fetch`), which reads the RGBA8 atlas with four
loads and the quad table's +1 neighbour rule.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

# Address modes (cudaTextureAddressMode, src/cuda/cuda_texture.h:63-64, and
# glTF sampler wrapS/wrapT).
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

_GL_WRAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR,
            # CLAMP_TO_BORDER/legacy CLAMP: closest supported behavior
            33069: WRAP_CLAMP, 10496: WRAP_CLAMP}


def wrap_from_gl(gl_enum: int) -> int:
    """Map a GL/glTF sampler wrap enum to a WRAP_* mode (default REPEAT)."""
    return _GL_WRAP.get(gl_enum, WRAP_REPEAT)


class TextureImage(NamedTuple):
    """An atlas input with sampler state (plain ndarrays mean REPEAT)."""

    data: np.ndarray  # [h, w, 4] uint8
    wrap_s: int = WRAP_REPEAT
    wrap_t: int = WRAP_REPEAT


class TextureAtlas(NamedTuple):
    """numpy arrays on the host, or tensors after `atlas_to`."""

    data: np.ndarray  # [AH, AW, 4] uint8 (rows already v-flipped at load)
    meta: np.ndarray  # [T, 6] int32: (y0, x0, height, width, wrap_s, wrap_t)


def empty_atlas() -> TextureAtlas:
    meta = np.zeros((1, 6), np.int32)
    meta[0, 2:4] = 1
    return TextureAtlas(data=np.zeros((1, 1, 4), np.uint8), meta=meta)


def _texel_scale() -> np.float32:
    return np.float32(1.0 / 255.0)


def build_texture_atlas(images: Sequence) -> TextureAtlas:
    """Shelf-pack RGBA8 images into one atlas.

    images: [h, w, 4] uint8 arrays (already vertically flipped, as the
    reference's stbi load leaves them, src/mesh.cpp:150-160), or
    TextureImage entries carrying per-texture wrap modes."""
    if not images:
        return empty_atlas()
    entries = [im if isinstance(im, TextureImage) else TextureImage(im)
               for im in images]
    images = [e.data for e in entries]
    for im in images:
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 4:
            raise ValueError("textures are [h, w, 4] uint8 arrays")

    # shelf packing: sort by height, fill rows up to a power-of-two width
    total_area = sum(im.shape[0] * im.shape[1] for im in images)
    max_w = max(im.shape[1] for im in images)
    atlas_w = 1
    while atlas_w < max(max_w, int(np.ceil(np.sqrt(total_area)))):
        atlas_w *= 2

    order = sorted(range(len(images)), key=lambda i: -images[i].shape[0])
    meta = np.zeros((len(images), 6), np.int32)
    x = y = shelf_h = 0
    for idx in order:
        h, w = images[idx].shape[:2]
        if x + w > atlas_w:
            y += shelf_h
            x = 0
            shelf_h = 0
        meta[idx] = (y, x, h, w, entries[idx].wrap_s, entries[idx].wrap_t)
        x += w
        shelf_h = max(shelf_h, h)
    atlas_h = y + shelf_h

    data = np.zeros((atlas_h, atlas_w, 4), np.uint8)
    for idx, im in enumerate(images):
        y0, x0, h, w = meta[idx, :4]
        data[y0:y0 + h, x0:x0 + w] = im

    return TextureAtlas(data=data, meta=meta)


def build_quad_table(atlas: TextureAtlas) -> np.ndarray:
    """The reference's single-gather quad table (`TextureAtlas.quad`): per
    atlas texel, the RGB of its 2x2 wrap-mode footprint (c00 c01 c10 c11)
    scaled by 1/255, [AH * AW, 12] f32."""
    data, meta = np.asarray(atlas.data), np.asarray(atlas.meta)
    atlas_h, atlas_w = data.shape[:2]
    rgbf = data[..., :3].astype(np.float32) * _texel_scale()
    c01 = rgbf.copy()
    c10 = rgbf.copy()
    c11 = rgbf.copy()
    for y0, x0, h, w, ws, wt in meta:
        sub = rgbf[y0:y0 + h, x0:x0 + w]
        # +1 neighbour index per address mode; at the far edge both CLAMP
        # and MIRROR resolve to the edge texel itself
        nx = ((np.arange(w) + 1) % w if ws == WRAP_REPEAT
              else np.minimum(np.arange(w) + 1, w - 1))
        ny = ((np.arange(h) + 1) % h if wt == WRAP_REPEAT
              else np.minimum(np.arange(h) + 1, h - 1))
        c01[y0:y0 + h, x0:x0 + w] = sub[:, nx]
        c10[y0:y0 + h, x0:x0 + w] = sub[ny, :]
        c11[y0:y0 + h, x0:x0 + w] = sub[ny][:, nx]
    quad = np.concatenate([rgbf, c01, c10, c11], axis=-1)
    return quad.reshape(atlas_h * atlas_w, 12)


def atlas_to(atlas: TextureAtlas, device) -> TextureAtlas:
    """The atlas's RGBA8 data and meta as contiguous tensors on `device`."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return TextureAtlas(data=put(atlas.data), meta=put(atlas.meta))


def fmod_floored(x: torch.Tensor, y) -> torch.Tensor:
    """jnp.mod on floats: the C fmod, moved into y's sign (exact)."""
    r = torch.fmod(x, y)
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _wrap_footprint(c, size_i, mode):
    """Bilinear footprint along one axis under a per-lane address mode
    (texture.py:134-161): (i0, i1, frac), texel centres at (i + 0.5) /
    size."""
    size_f = size_i.to(torch.float32)
    two = torch.tensor(2.0, dtype=torch.float32, device=c.device)
    # MIRRORED_REPEAT folds the coordinate into [0, 1] with period 2; its
    # edge footprint then equals CLAMP's
    cm = torch.where(mode == WRAP_MIRROR,
                     1.0 - torch.abs(fmod_floored(c, two) - 1.0), c)
    repeat = mode == WRAP_REPEAT
    cc = torch.where(repeat, cm - torch.floor(cm), cm)
    sc = cc * size_f - 0.5
    # CLAMP_TO_EDGE pins the texel-space coordinate to [0, N - 1]
    sc = torch.where(repeat, sc,
                     torch.minimum(torch.clamp(sc, min=0.0), size_f - 1.0))
    i0f = torch.floor(sc)
    frac = sc - i0f
    i0 = i0f.to(torch.int64)
    i0w = torch.where(repeat, torch.remainder(i0, size_i), i0)
    i1w = torch.where(repeat, torch.remainder(i0w + 1, size_i),
                      torch.minimum(i0 + 1, size_i - 1))
    return i0w, i1w, frac


def bilinear_footprint(atlas: TextureAtlas, tex_id: torch.Tensor,
                       u: torch.Tensor, v: torch.Tensor):
    """The four atlas texels of each lane's bilinear fetch as flat indices
    into [AH * AW] (c00, c01, c10, c11) and the weights' (fu, fv). tex_id
    [...] int, clamped into the meta table as XLA clamps a gather's index
    (values < 0 read texture 0); the atlas on u's device."""
    meta = torch.as_tensor(atlas.meta, device=u.device).to(torch.int64)
    m = meta[torch.clamp(tex_id.to(torch.int64), 0, meta.shape[0] - 1)]
    y0, x0 = m[..., 0], m[..., 1]
    th, tw = m[..., 2], m[..., 3]
    iu0, iu1, fu = _wrap_footprint(u, tw, m[..., 4])
    iv0, iv1, fv = _wrap_footprint(v, th, m[..., 5])
    aw = atlas.data.shape[1]
    r0, r1 = (y0 + iv0) * aw + x0, (y0 + iv1) * aw + x0
    return (r0 + iu0, r0 + iu1, r1 + iu0, r1 + iu1), fu, fv


def sample_texture_bilinear(atlas: TextureAtlas, tex_id: torch.Tensor,
                            u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Wrap-mode bilinear fetch, normalized coordinates -> linear RGB
    [..., 3] (cudaAddressModeWrap/Clamp/Mirror + cudaFilterModeLinear +
    cudaReadModeNormalizedFloat, src/cuda/cuda_texture.h:62-74): texel
    centres at (i + 0.5) / size, u8 values scaled by 1/255, black where
    tex_id < 0.

    Four gathers of the RGBA8 texels, which give the reference's quad-table
    values exactly. The combine order is the reference's, q00 (1-fu)(1-fv)
    + q01 fu (1-fv) + q10 (1-fu) fv + q11 fu fv."""
    (f00, f01, f10, f11), fu, fv = bilinear_footprint(atlas, tex_id, u, v)
    fu, fv = fu[..., None], fv[..., None]
    rgb8 = torch.as_tensor(atlas.data, device=u.device).reshape(-1, 4)
    scale = torch.tensor(_texel_scale(), device=u.device)

    def fetch(flat):
        return rgb8[flat, :3].to(torch.float32) * scale

    c00, c01, c10, c11 = fetch(f00), fetch(f01), fetch(f10), fetch(f11)
    rgb = (c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv)
           + c10 * (1 - fu) * fv + c11 * fu * fv)
    return torch.where((tex_id >= 0)[..., None], rgb, torch.zeros_like(rgb))
