"""Progressive accumulation film (src/shader/raygen.cu:75-86).

Port of rendertoy3c_tpu/film/film.py without the AOV buffers. The film is
updated in place: `accum` is one device tensor for the whole render.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Film:
    accum: torch.Tensor  # [H, W, 3] float32 linear radiance; row 0 = bottom
    subframe_index: int = 0


def film_create(height: int, width: int, device) -> Film:
    return Film(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=device))


def film_accumulate(film: Film, frame: torch.Tensor) -> Film:
    """accum = lerp(prev, cur, 1/(n+1)) for n > 0, accum = cur for n == 0
    (raygen.cu:79-85)."""
    n = film.subframe_index
    if n > 0:
        a = torch.tensor(1.0, dtype=torch.float32) / (float(n) + 1.0)
        film.accum.add_((frame - film.accum) * a.to(film.accum.device))
    else:
        film.accum.copy_(frame)
    film.subframe_index = n + 1
    return film
