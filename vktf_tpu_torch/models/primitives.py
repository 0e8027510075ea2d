"""Procedural mesh primitives (SoA numpy): box, plane, cylinder, UV sphere.

The same generators as ``vktf_tpu/models/primitives.py``.

Vertex layout matches the renderer's expectations (reference Vertex struct,
src/engine/mesh.cppm:22-40): position vec3, normal vec3, tangent vec4
(w = bitangent handedness), texcoord vec2. Winding is counter-clockwise when
viewed from outside (glTF front-face convention).
"""

from __future__ import annotations

import numpy as np


def _mesh(positions, normals, tangents, uvs, indices):
    return {
        "positions": np.asarray(positions, np.float32),
        "normals": np.asarray(normals, np.float32),
        "tangents": np.asarray(tangents, np.float32),
        "uvs": np.asarray(uvs, np.float32),
        "indices": np.asarray(indices, np.uint32).reshape(-1, 3),
    }


def box_mesh(half_extent: float = 0.5):
    """Axis-aligned box with 24 vertices (4 per face), CCW outward faces."""
    h = half_extent
    faces = [
        # (normal, tangent(+handedness w=1), corner order)
        ((0, 0, 1), (1, 0, 0)),  # +z
        ((0, 0, -1), (-1, 0, 0)),  # -z
        ((1, 0, 0), (0, 0, -1)),  # +x
        ((-1, 0, 0), (0, 0, 1)),  # -x
        ((0, 1, 0), (1, 0, 0)),  # +y
        ((0, -1, 0), (1, 0, 0)),  # -y
    ]
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    for face_index, (n, t) in enumerate(faces):
        n = np.asarray(n, np.float32)
        t = np.asarray(t, np.float32)
        b = np.cross(n, t)
        base = len(positions)
        for (u, v) in [(0, 0), (1, 0), (1, 1), (0, 1)]:
            corner = n * h + t * (2 * u - 1) * h + b * (2 * v - 1) * h
            positions.append(corner)
            normals.append(n)
            tangents.append([t[0], t[1], t[2], 1.0])
            uvs.append([u, 1 - v])
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(positions, normals, tangents, uvs, indices)


def plane_mesh(size: float = 1.0, segments: int = 1, normal_axis: str = "y"):
    """Flat plane in the plane perpendicular to `normal_axis` (+ side up)."""
    s = segments
    grid = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
    uu, vv = np.meshgrid(grid, grid, indexing="xy")
    flat_u = uu.reshape(-1)
    flat_v = vv.reshape(-1)
    zeros = np.zeros_like(flat_u)
    if normal_axis == "y":
        positions = np.stack([flat_u, zeros, -flat_v], axis=-1)
        normal = [0, 1, 0]
        tangent = [1, 0, 0, 1]
    elif normal_axis == "z":
        positions = np.stack([flat_u, flat_v, zeros], axis=-1)
        normal = [0, 0, 1]
        tangent = [1, 0, 0, 1]
    else:
        raise ValueError(f"unsupported normal_axis {normal_axis!r}")
    count = positions.shape[0]
    normals = np.tile(np.asarray(normal, np.float32), (count, 1))
    tangents = np.tile(np.asarray(tangent, np.float32), (count, 1))
    uvs = np.stack(
        [(flat_u / size + 0.5), (1.0 - (flat_v / size + 0.5))], axis=-1
    )
    indices = []
    for j in range(s):
        for i in range(s):
            a = j * (s + 1) + i
            b = a + 1
            c = a + s + 1
            d = c + 1
            indices += [a, b, d, a, d, c]
    return _mesh(positions, normals, tangents, uvs, indices)


def cylinder_mesh(radius: float = 0.5, height: float = 1.0, sectors: int = 32, stacks: int = 1):
    """Capped cylinder along +y, centred at the origin. CCW outward faces."""
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    # side shell
    for si in range(sectors + 1):
        phi = 2.0 * np.pi * si / sectors
        n = np.asarray([np.cos(phi), 0.0, -np.sin(phi)], np.float32)
        t = np.asarray([-np.sin(phi), 0.0, -np.cos(phi)], np.float32)
        for st in range(stacks + 1):
            y = height * (st / stacks - 0.5)
            positions.append([n[0] * radius, y, n[2] * radius])
            normals.append(n)
            tangents.append([t[0], t[1], t[2], 1.0])
            uvs.append([si / sectors, 1.0 - st / stacks])
    stride = stacks + 1
    for si in range(sectors):
        for st in range(stacks):
            a = si * stride + st
            b = a + stride
            indices += [a, b, b + 1, a, b + 1, a + 1]
    # caps
    for sign in (1.0, -1.0):
        n = np.asarray([0.0, sign, 0.0], np.float32)
        center = len(positions)
        positions.append([0.0, sign * height / 2, 0.0])
        normals.append(n)
        tangents.append([1.0, 0.0, 0.0, 1.0])
        uvs.append([0.5, 0.5])
        ring = len(positions)
        for si in range(sectors + 1):
            phi = 2.0 * np.pi * si / sectors
            x, z = np.cos(phi), -np.sin(phi)
            positions.append([x * radius, sign * height / 2, z * radius])
            normals.append(n)
            tangents.append([1.0, 0.0, 0.0, 1.0])
            uvs.append([0.5 + 0.5 * x, 0.5 + 0.5 * z * sign])
        for si in range(sectors):
            if sign > 0:
                indices += [center, ring + si, ring + si + 1]
            else:
                indices += [center, ring + si + 1, ring + si]
    return _mesh(positions, normals, tangents, uvs, indices)


def uv_sphere_mesh(radius: float = 0.5, rings: int = 16, sectors: int = 32):
    """UV sphere with per-vertex smooth normals and spherical tangents."""
    ring_angles = np.linspace(0.0, np.pi, rings + 1)
    sector_angles = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    positions, normals, tangents, uvs = [], [], [], []
    for ri, theta in enumerate(ring_angles):
        for si, phi in enumerate(sector_angles):
            n = np.asarray(
                [np.sin(theta) * np.cos(phi), np.cos(theta), -np.sin(theta) * np.sin(phi)],
                np.float32,
            )
            positions.append(n * radius)
            normals.append(n)
            # tangent along +phi direction (continuous except poles)
            t = np.asarray([-np.sin(phi), 0.0, -np.cos(phi)], np.float32)
            tangents.append([t[0], t[1], t[2], 1.0])
            uvs.append([si / sectors, ri / rings])
    indices = []
    stride = sectors + 1
    for ri in range(rings):
        for si in range(sectors):
            a = ri * stride + si
            b = a + 1
            c = a + stride
            d = c + 1
            if ri > 0:
                indices += [a, c, b]
            if ri < rings - 1:
                indices += [b, c, d]
    return _mesh(positions, normals, tangents, uvs, indices)
