"""Host math (numpy): quaternions, camera, view frustum."""

from vktf_tpu_torch.mathx.camera import (
    Camera,
    ViewFrustumParams,
    perspective,
    view_matrix,
)
from vktf_tpu_torch.mathx.frustum import aabbs_intersect_frustum, frustum_planes

__all__ = [
    "Camera",
    "ViewFrustumParams",
    "perspective",
    "view_matrix",
    "aabbs_intersect_frustum",
    "frustum_planes",
]
