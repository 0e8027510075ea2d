"""View-frustum plane extraction and batched AABB tests, numpy only.

Counterpart of ``vktf_tpu/mathx/frustum.py``. The frame path culls per
triangle against its clamped screen bbox instead (``ops/vertex.py``), so
these serve host-side callers.
"""

from __future__ import annotations

import numpy as np


def frustum_planes(view_projection):
    """6 normalized planes (left, right, top, bottom, near, far), (6, 4)."""
    rows = np.asarray(view_projection)
    planes = np.stack([
        rows[3] + rows[0],
        rows[3] - rows[0],
        rows[3] + rows[1],
        rows[3] - rows[1],
        rows[2],
        rows[3] - rows[2],
    ])
    norms = np.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / norms


def aabbs_intersect_frustum(aabbs, planes):
    """(N, 2, 3) world AABBs vs (6, 4) planes -> (N,) bool visibility."""
    aabbs = np.asarray(aabbs)
    planes = np.asarray(planes)
    normals = planes[:, :3]
    lo = aabbs[:, 0, :][:, None, :]
    hi = aabbs[:, 1, :][:, None, :]
    positive = np.where(normals[None, :, :] >= 0.0, hi, lo)
    dist = np.einsum("npk,pk->np", positive, normals) + planes[None, :, 3]
    return np.all(dist >= 0.0, axis=-1)
