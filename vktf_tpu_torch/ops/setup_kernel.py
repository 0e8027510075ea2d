"""Per-triangle setup + stream-row pack: CUDA kernel and its plain version.

Replaces ``vktf_tpu/ops/setup_kernel.py`` (``setup_pack_kernel``, kernel
body ``_kernel`` / ``_flat_valid``): per triangle, the world and clip
transform of the 3 corners, the homogeneous setup (``ops/vertex.py``), the
per-triangle screen cull, and the packed rows the raster and table stages
read:

  tri_data  (24, T) f32  raster stream rows (layout below)
  bbox_rows (4, T)  f32  valid-masked clamped screen bbox (x0, y0, x1, y1)
  edge9     (9, T)  f32  anchored cofactor edge planes (table build)
  anchor2   (2, T)  f32  plane anchor (bbox corner)
  valid     (T,)    bool

tri_data rows: 0..8 coverage edge planes (a, b, e(anchor)) x 3; 9..11 depth
plane; 12..14 w-recip plane; 15 triangle id (-1 invalid, exact below 2^24);
16..18 top-left fill thresholds (-1.0 inclusive, 0.0 strict); 19 slim-body
flag (per triangle here; ``ops/raster.py`` reduces it per group); 20..23
zero. Plane constants are normalized so an exact zero is +0.0.

The instance matrices come as ``inst_rows`` (I, 16) f32, row-major, with
an int32 ``tri_instance`` (T,) naming each triangle's instance; the plain
version gathers the (16, T) per-triangle rows from them.

CUDA design (``csrc/setup.cu``): one thread per triangle, component-major
inputs and outputs, so every load and store of a warp is one coalesced
128-byte line; each thread reads its instance's matrix as three 16-byte
loads from the (I, 16) rows (a few KB, cached, and mostly one instance per
warp). Bound on the card: bytes — 36 bytes of corners and a 4-byte index
read, 157 bytes written per triangle, against ~720 flops and 30 IEEE
divisions, 18 of them in the near-plane clip, which only a triangle with a
corner behind the eye reads and the others skip, and 2 in the
screen-space depth slopes (``ops/vertex.py``), which those triangles skip. The wrapper does no work
beyond its checks, the output allocations and the launch: ``ids=None``
launches with a null pointer and the kernel writes the triangle's own
index, and ``valid`` is a bool view of the kernel's byte output. Times
(the wrapper and the bare launch): PERF.md.
The JAX kernel ran twice per frame (original and stream order); here it
runs once and the raster prologue permutes its columns.
"""

from __future__ import annotations

import ctypes

import torch

from vktf_tpu_torch.ops import _cuda
from vktf_tpu_torch.ops.fmath import f32
from vktf_tpu_torch.ops.vertex import clip_corners, setup_from_corners

TRI_ROWS = 24

KERNEL = _cuda.Kernel(
    "setup", "setup.cu",
    "vktf_tpu/ops/setup_kernel.py:109 (_kernel via setup_pack_kernel, pallas_call :178)",
)
_cuda.declare("setup.cu", "vktf_setup_pack",
              [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _no_negzero(c):
    return torch.where(c == 0.0, torch.zeros_like(c), c)


def instance_rowsT(inst_rows, tri_instance):
    """The (16, T) per-triangle instance-matrix rows the plain versions
    read: inst_rows (I, 16) gathered by tri_instance (T,)."""
    return inst_rows[tri_instance.long()].T


def setup_pack_plain(tri_corner, inst_rows, tri_instance, view_projection, width: int,
                     height: int, ids=None) -> dict:
    """Plain-torch version: the same math, op by op."""
    t = tri_corner.shape[1]
    if ids is None:
        ids = torch.arange(t, dtype=torch.float32, device=tri_corner.device)
    vp = view_projection.to(torch.float32)
    x, y, z, w = clip_corners(tri_corner, instance_rowsT(inst_rows, tri_instance), vp)
    flat = setup_from_corners(x, y, z, w, width, height)
    b0, b1, b2, b3 = flat["bbox_cols"]
    valid = flat["valid"] & (b2 > b0) & (b3 > b1)

    er = flat["edges_raster"]
    zp, wp = flat["zplane"], flat["wplane"]
    rows = []
    for e in er:
        rows += [e[0], e[1], _no_negzero(e[2])]
    rows += [zp[0], zp[1], _no_negzero(zp[2])]
    rows += [wp[0], wp[1], _no_negzero(wp[2])]
    minus_one = f32(-1.0, ids)
    zero = torch.zeros_like(ids)
    rows.append(torch.where(valid, ids, minus_one))
    for e in er:
        tl = (e[0] > 0.0) | ((e[0] == 0.0) & (e[1] > 0.0))
        rows.append(torch.where(tl, minus_one, zero))
    rows.append(torch.where(flat["safe"] | ~valid, f32(1.0, ids), zero))
    while len(rows) < TRI_ROWS:
        rows.append(zero)
    big = 2 ** 30
    bbox_rows = [
        torch.where(valid, b0, big).to(torch.float32),
        torch.where(valid, b1, big).to(torch.float32),
        torch.where(valid, b2, -big).to(torch.float32),
        torch.where(valid, b3, -big).to(torch.float32),
    ]
    edge9 = [c for e in flat["edges"] for c in e]
    return dict(
        tri_data=torch.stack(rows),
        bbox_rows=torch.stack(bbox_rows),
        edge9=torch.stack(edge9),
        anchor2=torch.stack([flat["anchor_x"], flat["anchor_y"]]),
        valid=valid,
    )


def setup_pack(tri_corner, inst_rows, tri_instance, view_projection, width: int,
               height: int, ids=None) -> dict:
    """Packed setup dict (module docstring). tri_corner (36, T) f32,
    inst_rows (I, 16) f32, tri_instance (T,) i32 in [0, I), view_projection
    (4, 4) f32, ids (T,) f32 or None for the triangles' own indices. CPU
    tensors take the plain version; CUDA tensors launch the kernel, with
    every operand already on the card."""
    if not tri_corner.is_cuda:
        return setup_pack_plain(tri_corner, inst_rows, tri_instance, view_projection,
                                width, height, ids)
    t = tri_corner.shape[1]
    if t >= 1 << 24:
        raise ValueError("triangle ids ride f32 rows: exact only below 2^24")
    dev = tri_corner.device
    _cuda.require(tri_corner, "tri_corner", torch.float32, (36, t))
    _cuda.require(inst_rows, "inst_rows", torch.float32, (inst_rows.shape[0], 16), dev)
    _cuda.require_aligned(inst_rows, "inst_rows")
    _cuda.require(tri_instance, "tri_instance", torch.int32, (t,), dev)
    _cuda.require(view_projection, "view_projection", torch.float32, (4, 4), dev)
    if ids is not None:
        _cuda.require(ids, "ids", torch.float32, (t,), dev)
    tri_data = torch.empty((TRI_ROWS, t), dtype=torch.float32, device=dev)
    bbox_rows = torch.empty((4, t), dtype=torch.float32, device=dev)
    edge9 = torch.empty((9, t), dtype=torch.float32, device=dev)
    anchor2 = torch.empty((2, t), dtype=torch.float32, device=dev)
    valid = torch.empty((t,), dtype=torch.uint8, device=dev)
    if t:
        _cuda.launch(KERNEL, "vktf_setup_pack", (
            _cuda.ptr(tri_corner), _cuda.ptr(inst_rows), _cuda.ptr(tri_instance),
            _cuda.ptr(view_projection), None if ids is None else _cuda.ptr(ids),
            _cuda.ptr(tri_data), _cuda.ptr(bbox_rows), _cuda.ptr(edge9), _cuda.ptr(anchor2),
            _cuda.ptr(valid), t, width, height, _cuda.stream_of(tri_corner)), "setup kernel", dev)
    return dict(tri_data=tri_data, bbox_rows=bbox_rows, edge9=edge9,
                anchor2=anchor2, valid=valid.view(torch.bool))
