"""Progressive accumulation film (src/shader/raygen.cu:75-86).

Port of rendertoy3c_tpu/film/film.py, with the optional first-hit albedo
and shading-normal guide buffers of an AOV render. The film is updated in
place: `accum` (and each guide buffer) is one device tensor for the whole
render.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Film:
    accum: torch.Tensor  # [H, W, 3] float32 linear radiance; row 0 = bottom
    subframe_index: int = 0
    # the AOV guide buffers, [H, W, 3] float32 each, or None
    albedo: Optional[torch.Tensor] = None  # first-hit albedo
    normal: Optional[torch.Tensor] = None  # first-hit shading normal


def film_create(height: int, width: int, device, aov: bool = False) -> Film:
    def zeros():
        return torch.zeros((height, width, 3), dtype=torch.float32,
                           device=device)

    return Film(accum=zeros(), albedo=zeros() if aov else None,
                normal=zeros() if aov else None)


def film_accumulate(film: Film, frame: torch.Tensor, aov=None) -> Film:
    """accum = lerp(prev, cur, 1/(n+1)) for n > 0, accum = cur for n == 0
    (raygen.cu:79-85). `aov`, an (albedo, normal) frame pair, blends into
    the guide buffers the same way where the film has them."""
    n = film.subframe_index
    a = torch.tensor(1.0, dtype=torch.float32) / (float(n) + 1.0)
    pairs = [(film.accum, frame)]
    if aov is not None and film.albedo is not None:
        pairs += [(film.albedo, aov[0]), (film.normal, aov[1])]
    for buf, cur in pairs:
        cur = cur.reshape(buf.shape)
        if n > 0:
            buf.add_((cur - buf) * a.to(buf.device))
        else:
            buf.copy_(cur)
    film.subframe_index = n + 1
    return film
