"""Environment-map background.

Port of rendertoy3c_tpu/scene/envmap.py (:1-59). The reference's miss
program delegates background radiance to a direct callable that ships as
a constant-grey stub (src/shader/miss.cu:30, src/shader/test.cu:3-6);
this is the environment shader for that slot: a lat-long
(equirectangular) radiance map sampled by ray direction with bilinear
filtering (wrap in azimuth, clamp in polar), evaluated for every miss
lane in one batched gather. It runs in torch ops on whatever device the
map lies on; no kernel of the reference shades an environment map.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class EnvMap(NamedTuple):
    data: torch.Tensor  # [H, W, 3] f32 linear radiance


def build_env_map(image, scale: float = 1.0, *, device) -> EnvMap:
    """The map of an [H, W, 3|4] float or uint8 lat-long image on
    `device`: uint8 decodes as (x / 255) ** 2.2, then the first three
    channels times `scale` (envmap.py:24-30, in its numpy arithmetic)."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = (img.astype(np.float32) / 255.0) ** 2.2  # sRGB-ish decode
    img = img[..., :3].astype(np.float32) * scale
    return EnvMap(data=torch.as_tensor(np.ascontiguousarray(img),
                                       device=device))


def env_map_to(env: EnvMap | None, device) -> EnvMap | None:
    """The map on `device` (None stays None)."""
    if env is None:
        return None
    return EnvMap(data=env.data.to(device))


def sample_env_map(env: EnvMap, direction: torch.Tensor) -> torch.Tensor:
    """direction [..., 3] (unit) -> radiance [..., 3] (envmap.py:33-59).
    The divisions divide by tensors, since CUDA torch turns a division by
    a Python scalar into a product with its reciprocal."""
    h, w = env.data.shape[:2]
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32,
                          device=direction.device)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=direction.device)
    u = (torch.atan2(x, -z) / two_pi + 0.5) * w - 0.5
    v = (torch.acos(torch.clamp(y, -1.0, 1.0)) / pi) * h - 0.5

    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]

    def tap(ui, vi):
        # jnp.mod is a floor modulo: torch.remainder, not torch.fmod
        ui = torch.remainder(ui.to(torch.int32), w)  # wrap azimuth
        vi = torch.clamp(vi.to(torch.int32), 0, h - 1)  # clamp polar
        return env.data[vi.long(), ui.long()]

    c00 = tap(u0, v0)
    c10 = tap(u0 + 1, v0)
    c01 = tap(u0, v0 + 1)
    c11 = tap(u0 + 1, v0 + 1)
    return (
        c00 * (1 - fu) * (1 - fv)
        + c10 * fu * (1 - fv)
        + c01 * (1 - fu) * fv
        + c11 * fu * fv
    )
