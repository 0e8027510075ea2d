"""First-person quaternion camera, numpy only.

Counterpart of ``vktf_tpu/mathx/camera.py``: right-handed perspective with
depth in [0, 1] and the Vulkan y-flip, view matrix from the conjugate
rotation. The matrices are host numpy arrays; the frame program uploads the
(4, 4) view-projection once per frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vktf_tpu_torch.mathx.quaternion import (
    quat_angle_axis,
    quat_look_at,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)

WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)
_LOCAL_RIGHT = np.array([1.0, 0.0, 0.0], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class ViewFrustumParams:
    field_of_view_y: float
    aspect_ratio: float
    z_near: float
    z_far: float


def view_matrix(position, orientation):
    """World->view transform: upper-left block is the conjugate rotation,
    translation is R^T @ (-position)."""
    rot = quat_to_matrix(quat_normalize(np.asarray(orientation)))
    rot_t = np.swapaxes(rot, -1, -2)
    pos = np.asarray(position, dtype=np.float32)
    trans = -np.einsum("...ij,...j->...i", rot_t, pos)
    top = np.concatenate([rot_t, trans[..., None]], axis=-1)
    bottom = np.broadcast_to(
        np.asarray([0.0, 0.0, 0.0, 1.0], dtype=np.float32),
        top.shape[:-2] + (1, 4),
    )
    return np.concatenate([top, bottom], axis=-2)


def perspective(fov_y: float, aspect: float, z_near: float, z_far: float):
    """Right-handed perspective, depth in [0, 1], Vulkan y-flip applied."""
    tan_half = np.tan(fov_y / 2.0)
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 1.0 / (aspect * tan_half)
    proj[1, 1] = -1.0 / tan_half
    proj[2, 2] = z_far / (z_near - z_far)
    proj[2, 3] = -(z_far * z_near) / (z_far - z_near)
    proj[3, 2] = -1.0
    return proj


class Camera:
    """Mutable FPS camera with quaternion orientation."""

    def __init__(self, position, direction, view_frustum: ViewFrustumParams):
        direction = np.asarray(direction, dtype=np.float32)
        norm = float(np.linalg.norm(direction))
        if not norm > 0.0:
            raise ValueError("camera direction must be non-zero")
        self.position = np.asarray(position, dtype=np.float32).copy()
        self.orientation = np.asarray(
            quat_look_at(direction / norm, WORLD_UP), dtype=np.float32)
        self.view_frustum = view_frustum
        self._view = None
        self._projection = None

    def set_pose(self, position, orientation) -> None:
        """Take another camera's position and orientation quaternion."""
        self.position = np.asarray(position, dtype=np.float32).copy()
        self.orientation = np.asarray(orientation, dtype=np.float32).copy()
        self._view = None

    def translate(self, translation) -> None:
        """Translate in the camera's local frame."""
        t = np.asarray(translation, dtype=np.float32)
        self.position = self.position + np.asarray(
            quat_rotate(self.orientation, t))
        self._view = None

    def rotate(self, pitch: float, yaw: float) -> None:
        """Pitch about local +x, yaw about world +y."""
        pitch_q = quat_angle_axis(np.float32(pitch), _LOCAL_RIGHT)
        yaw_q = quat_angle_axis(np.float32(yaw), WORLD_UP)
        q = quat_multiply(yaw_q, quat_multiply(self.orientation, pitch_q))
        self.orientation = np.asarray(quat_normalize(q), dtype=np.float32)
        self._view = None

    @property
    def view_transform(self):
        if self._view is None:
            self._view = np.asarray(view_matrix(self.position,
                                                self.orientation))
        return self._view

    @property
    def projection_transform(self):
        if self._projection is None:
            f = self.view_frustum
            self._projection = np.asarray(perspective(
                f.field_of_view_y, f.aspect_ratio, f.z_near, f.z_far))
        return self._projection

    @property
    def view_projection_transform(self):
        return self.projection_transform @ self.view_transform
