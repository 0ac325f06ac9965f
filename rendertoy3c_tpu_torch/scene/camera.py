"""Pinhole camera (sutil/Camera.{h,cpp}).

Port of the Camera / CameraParams part of rendertoy3c_tpu/scene/camera.py.
`params()` gives the flat (eye, U, V, W) basis of ray generation, as
float32 numpy arrays; W keeps its length (the focal distance), as in
sutil/Camera.cpp:34-45.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..math.vec import normalize3


class CameraParams(NamedTuple):
    eye: np.ndarray  # [3]
    u: np.ndarray  # [3] right, length = tan(fov/2) * aspect * focal
    v: np.ndarray  # [3] up, length = tan(fov/2) * focal
    w: np.ndarray  # [3] forward, length = focal


@dataclass
class Camera:
    eye: tuple = (1.0, 1.0, 1.0)
    lookat: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y: float = 35.0  # degrees
    aspect_ratio: float = 1.0

    def uvw_frame(self):
        eye = np.asarray(self.eye, np.float32)
        lookat = np.asarray(self.lookat, np.float32)
        up = np.asarray(self.up, np.float32)
        w = lookat - eye  # not normalised: its length is the focal distance
        wlen = float(np.linalg.norm(w))
        u = np.cross(w, up)
        u = u / np.linalg.norm(u)
        v = np.cross(u, w)
        v = v / np.linalg.norm(v)
        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        v = v * vlen
        u = u * (vlen * self.aspect_ratio)
        return u.astype(np.float32), v.astype(np.float32), w.astype(np.float32)

    def params(self) -> CameraParams:
        u, v, w = self.uvw_frame()
        return CameraParams(eye=np.asarray(self.eye, np.float32), u=u, v=v,
                            w=w)


def camera_ray_dir(scf, pixel, width: int, height: int, jx, jy):
    """Jittered pinhole ray direction through each `pixel` (int64 [R],
    row-major from the bottom row) as (dx, dy, dz) (raygen.cu:32-39); scf is
    (eye, u, v, w) as 12 floats and the origin is the eye. Divides by
    tensors: CUDA torch turns division by a Python scalar into a
    multiplication by its reciprocal, which the kernels do not do."""
    px = (pixel % width).to(torch.float32)
    py = (pixel // width).to(torch.float32)
    dx = 2.0 * ((px + jx) / torch.full_like(jx, float(width))) - 1.0
    dy = 2.0 * ((py + jy) / torch.full_like(jy, float(height))) - 1.0
    cdx = dx * scf[3] + dy * scf[6] + scf[9]
    cdy = dx * scf[4] + dy * scf[7] + scf[10]
    cdz = dx * scf[5] + dy * scf[8] + scf[11]
    cdx, cdy, cdz, _ = normalize3(cdx, cdy, cdz)
    return cdx, cdy, cdz
