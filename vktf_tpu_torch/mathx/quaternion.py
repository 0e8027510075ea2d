"""Quaternion operations (w, x, y, z layout), numpy only.

Host-side counterpart of ``vktf_tpu/mathx/quaternion.py``: the same
expressions on numpy arrays, so camera matrices are bit-identical to the
JAX package's host path.
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q):
    q = np.asarray(q)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q):
    q = np.asarray(q)
    return q * np.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_multiply(a, b):
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    a, b = np.asarray(a), np.asarray(b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_angle_axis(angle, axis):
    """Unit quaternion for a rotation of `angle` radians about unit `axis`."""
    axis = np.asarray(axis, dtype=np.float32)
    half = np.asarray(angle, dtype=np.float32)[..., None] * 0.5
    return np.concatenate([np.cos(half), np.sin(half) * axis], axis=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v of shape (..., 3) by unit quaternion(s) q."""
    q, v = np.asarray(q), np.asarray(v)
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


def quat_to_matrix(q):
    """Rotation matrix (..., 3, 3) such that M @ v == quat_rotate(q, v)."""
    q = np.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def _matrix_to_quat(m):
    """Rotation matrix (3, 3) -> unit quaternion (w, x, y, z); branch-free."""
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    trace = m00 + m11 + m22
    qw = np.sqrt(np.maximum(0.0, 1.0 + trace)) / 2.0
    qx = np.sqrt(np.maximum(0.0, 1.0 + m00 - m11 - m22)) / 2.0
    qy = np.sqrt(np.maximum(0.0, 1.0 - m00 + m11 - m22)) / 2.0
    qz = np.sqrt(np.maximum(0.0, 1.0 - m00 - m11 + m22)) / 2.0
    qx = np.copysign(qx, m21 - m12)
    qy = np.copysign(qy, m02 - m20)
    qz = np.copysign(qz, m10 - m01)
    return quat_normalize(np.stack([qw, qx, qy, qz]))


def quat_look_at(direction, up):
    """Orientation whose local -z axis points along `direction` (glm
    quatLookAt, right-handed): matrix columns (right, true_up, -direction)."""
    direction = np.asarray(direction, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    back = -direction / np.linalg.norm(direction)
    right = np.cross(up, back)
    right = right / np.linalg.norm(right)
    true_up = np.cross(back, right)
    m = np.stack([right, true_up, back], axis=-1)
    return _matrix_to_quat(m)
