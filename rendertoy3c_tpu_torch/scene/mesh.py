"""Host-side mesh container (src/mesh.h:12-22).

Port of rendertoy3c_tpu/scene/mesh.py without the second texcoord set and
vertex colours. A Mesh holds one topology with K motion keyframes of
vertex/normal data; arrays are numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .material import Material


@dataclass
class Mesh:
    vertices: np.ndarray  # [K, V, 3] float32, K motion keys
    indices: np.ndarray  # [F, 3] int32
    normals: Optional[np.ndarray] = None  # [K, V, 3] float32
    texcoords: Optional[np.ndarray] = None  # [V, 2] float32
    material: Material = field(default_factory=Material)

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32)
        if self.vertices.ndim == 2:
            self.vertices = self.vertices[None]
        self.indices = np.asarray(self.indices, np.int32).reshape(-1, 3)
        if self.normals is not None:
            self.normals = np.asarray(self.normals, np.float32)
            if self.normals.ndim == 2:
                self.normals = self.normals[None]
        if self.texcoords is not None:
            self.texcoords = np.asarray(self.texcoords,
                                        np.float32).reshape(-1, 2)

    @property
    def num_keys(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_faces(self) -> int:
        return self.indices.shape[0]

    def with_computed_normals(self) -> "Mesh":
        """Fill missing normals with area-weighted smooth vertex normals."""
        if self.normals is not None:
            return self
        normals = np.zeros_like(self.vertices)
        f = self.indices
        for ki in range(self.num_keys):
            v = self.vertices[ki]
            fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
            for c in range(3):
                np.add.at(normals[ki], f[:, c], fn)
            lens = np.linalg.norm(normals[ki], axis=-1, keepdims=True)
            normals[ki] /= np.maximum(lens, 1e-20)
        return Mesh(vertices=self.vertices, indices=self.indices,
                    normals=normals, texcoords=self.texcoords,
                    material=self.material)
