"""Axis-aligned bounding boxes, numpy only.

Host-side counterpart of ``vktf_tpu/mathx/bounding_box.py`` (reference:
src/engine/bounding_box.cppm:19-61): an AABB as a (min, max) corner pair,
and its transform by an affine matrix (all 8 corners, then the refit),
vectorized over many boxes at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BoundingBox:
    """Host-side AABB; many boxes travel as raw (..., 2, 3) arrays."""

    min: np.ndarray
    max: np.ndarray

    @staticmethod
    def empty() -> "BoundingBox":
        inf = np.float32(np.inf)
        return BoundingBox(np.full(3, inf, np.float32), np.full(3, -inf, np.float32))

    def union(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def as_array(self) -> np.ndarray:
        return np.stack([self.min, self.max]).astype(np.float32)


_CORNER_SELECT = np.array(
    [[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)], dtype=np.float32
)  # (8, 3) of {0, 1}: 0 -> min, 1 -> max


def transform_aabbs(aabbs, matrices):
    """Transform AABBs by affine matrices and refit: aabbs (..., 2, 3)
    stacked (min, max), matrices (..., 4, 4) -> (..., 2, 3), the
    componentwise min and max of the 8 transformed corners
    (bounding_box.cppm:41-61)."""
    aabbs = np.asarray(aabbs)
    matrices = np.asarray(matrices)
    lo = aabbs[..., 0, :][..., None, :]  # (..., 1, 3)
    hi = aabbs[..., 1, :][..., None, :]
    sel = np.asarray(_CORNER_SELECT, dtype=aabbs.dtype)  # (8, 3)
    corners = lo + (hi - lo) * sel  # (..., 8, 3)
    rot = matrices[..., :3, :3]
    trans = matrices[..., :3, 3]
    world = np.einsum("...ij,...cj->...ci", rot, corners) + trans[..., None, :]
    return np.stack([world.min(axis=-2), world.max(axis=-2)], axis=-2)


def transform_aabb(box: BoundingBox, matrix) -> BoundingBox:
    """One box."""
    out = transform_aabbs(box.as_array()[None], np.asarray(matrix)[None])[0]
    return BoundingBox(out[0], out[1])
