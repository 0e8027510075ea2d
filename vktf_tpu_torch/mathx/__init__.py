"""Host math (numpy): quaternions, camera, AABBs, view frustum.

The names of ``vktf_tpu.mathx``, each on numpy arrays.
"""

from vktf_tpu_torch.mathx.quaternion import (
    quat_angle_axis,
    quat_conjugate,
    quat_look_at,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)
from vktf_tpu_torch.mathx.camera import Camera, ViewFrustumParams, perspective, view_matrix
from vktf_tpu_torch.mathx.bounding_box import BoundingBox, transform_aabb, transform_aabbs
from vktf_tpu_torch.mathx.frustum import aabbs_intersect_frustum, frustum_planes

__all__ = [
    "quat_angle_axis",
    "quat_conjugate",
    "quat_look_at",
    "quat_multiply",
    "quat_normalize",
    "quat_rotate",
    "quat_to_matrix",
    "Camera",
    "ViewFrustumParams",
    "perspective",
    "view_matrix",
    "BoundingBox",
    "transform_aabb",
    "transform_aabbs",
    "frustum_planes",
    "aabbs_intersect_frustum",
]
