"""Per-triangle shade table: CUDA kernel and its plain version.

Replaces ``vktf_tpu/ops/shade_table.py`` ``build_shade_table_pallas``
(kernel body ``_table_build_kernel``): one row of 64 f32 columns per
triangle holding everything the deferred shade needs — attribute PLANES
(perspective-correct: A(s) = P_A . (s - anchor) / W(s), P_A = sum_i cof_i *
A_i over the anchored cofactor edges) plus material constants. The TPU
kernel emits the row as u16 hi|lo halves for its gather unit; the port
keeps plain f32 (bit-identical values).

Column layout (same as the JAX package):
  0..2   w plane            3..8   u, v planes
  9..17  world position      18..26 normal        27..38 tangent (xyzw)
  39..42 base color factor   43..44 metallic, roughness   45 normal scale
  46 pool base row   47 level-0 width   48 levels   49..51 sampler codes
  52 alpha mode   53 alpha cutoff   54..55 plane anchor (x, y)   56..63 0

The instance matrices come as ``inst_rows`` (I, 16) f32 with an int32
``tri_instance`` (T,), as in ``ops/setup_kernel.py``.

CUDA design (``csrc/shade_table.cu``): bound on the card by bytes — 62
input floats and a 4-byte index read, 64 floats written per triangle,
against ~600 flops. A block owns 128 consecutive triangles, one thread
each; their rows are one contiguous 32 KB span of the table. Each thread
reads its component-major inputs (coalesced across the warp) and its
instance's matrix (three 16-byte loads from the small (I, 16) rows), and
writes each column into a shared-memory tile as soon as it has it, so the
64 outputs never sit in registers together. The tile is XOR-swizzled
(column ^ (row & 31)), so neither the column writes of a warp (32 rows, one
column) nor the 16-byte row reads conflict on banks. After one barrier the
block stores its span with 16-byte stores by consecutive threads, each
table sector written whole by one instruction. Times: PERF.md.
"""

from __future__ import annotations

import ctypes

import torch

from vktf_tpu_torch.ops import _cuda
from vktf_tpu_torch.ops.fmath import fma
from vktf_tpu_torch.ops.setup_kernel import instance_rowsT
from vktf_tpu_torch.ops.vertex import world_corners

ROW = 64
C_WPLANE, C_UV, C_WPOS, C_NRM, C_TAN = 0, 3, 9, 18, 27
C_BASE, C_MR, C_NSCALE, C_MROW, C_MW0, C_MLEVELS, C_SAMP0 = 39, 43, 45, 46, 47, 48, 49
C_AMODE, C_ACUT, C_AX, C_AY = 52, 53, 54, 55

KERNEL = _cuda.Kernel(
    "shade_table", "shade_table.cu",
    "vktf_tpu/ops/shade_table.py:128 (_table_build_kernel via build_shade_table_pallas, pallas_call :232)",
)
_cuda.declare("shade_table.cu", "vktf_shade_table",
              [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])


def build_shade_table_plain(edge9, tri_corner, static_cols, anchor2, inst_rows,
                            tri_instance):
    """Plain-torch version: (T, 64) f32."""
    e = [[edge9[i * 3 + k] for k in range(3)] for i in range(3)]
    tc = tri_corner
    mrowsT = instance_rowsT(inst_rows, tri_instance)
    wp = world_corners(mrowsT, tc, 6, translate=True)
    wn = world_corners(mrowsT, tc, 15, translate=False)
    wt = world_corners(mrowsT, tc, 24, translate=False)
    wt.append([tc[24 + 9 + i] for i in range(3)])
    uv = [[tc[c * 3 + i] for i in range(3)] for c in range(2)]
    cols = [e[0][k] + e[1][k] + e[2][k] for k in range(3)]
    for corners in (uv, wp, wn, wt):
        for corner in corners:
            for k in range(3):
                cols.append(fma(e[2][k], corner[2],
                                fma(e[0][k], corner[0], e[1][k] * corner[1])))
    cols += list(static_cols)
    cols += [anchor2[0], anchor2[1]]
    zero = torch.zeros_like(cols[0])
    while len(cols) < ROW:
        cols.append(zero)
    return torch.stack(cols, dim=1)


def build_shade_table(edge9, tri_corner, static_cols, anchor2, inst_rows, tri_instance):
    """(T, 64) f32 shade table. inst_rows (I, 16) f32, tri_instance (T,)
    i32 in [0, I). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if not edge9.is_cuda:
        return build_shade_table_plain(edge9, tri_corner, static_cols, anchor2, inst_rows,
                                       tri_instance)
    t = edge9.shape[1]
    dev = edge9.device
    _cuda.require(edge9, "edge9", torch.float32, (9, t))
    _cuda.require(tri_corner, "tri_corner", torch.float32, (36, t), dev)
    _cuda.require(static_cols, "static_cols", torch.float32, (15, t), dev)
    _cuda.require(anchor2, "anchor2", torch.float32, (2, t), dev)
    _cuda.require(inst_rows, "inst_rows", torch.float32, (inst_rows.shape[0], 16), dev)
    _cuda.require_aligned(inst_rows, "inst_rows")
    _cuda.require(tri_instance, "tri_instance", torch.int32, (t,), dev)
    table = torch.empty((t, ROW), dtype=torch.float32, device=dev)
    if t:
        _cuda.launch(KERNEL, "vktf_shade_table", (
            _cuda.ptr(edge9), _cuda.ptr(tri_corner), _cuda.ptr(static_cols),
            _cuda.ptr(anchor2), _cuda.ptr(inst_rows), _cuda.ptr(tri_instance),
            _cuda.ptr(table), t, _cuda.stream_of(edge9)), "shade-table kernel", dev)
    return table
