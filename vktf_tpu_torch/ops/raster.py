"""Streaming visibility raster: stream order, prologue, CUDA kernel and its
plain version.

Replaces ``vktf_tpu/ops/raster_pallas.py``: ``stream_perm`` (screen-Morton
stream order), the prologue of ``rasterize_pallas`` (per-group slim flag,
group and chunk bboxes) and the kernel ``_raster_kernel`` at K = 1..8
depth-peel layers.

Semantics, per MSAA sample of every pixel: among the stream's valid
triangles whose clamped screen bbox contains the pixel, the sample is
covered when all three anchored edge functions pass the top-left fill rule
(``e > 0``, or ``e == 0`` on a top/left edge: one signed-integer compare of
the float bits against the row-16..18 threshold), and — unless the
triangle's group carries the slim flag, whose setup proof makes the tests
redundant — ``w_recip > 0`` and ``0 <= depth <= 1`` (one unsigned compare).
Layer l of the sample is its (l+1)-th lexicographically smallest (depth,
draw-order id) fragment (layer 0 is the winner), so stream order never
changes the output. An empty layer is id -1, depth 1.0. The TPU kernel
keeps the K layers by a sorted insertion (raster_pallas.py:831-852); each
triangle meets a sample once, so that list is exactly the K smallest keys.

The TPU kernel's lane interleave, column supertiles, row windows and
SMEM chunk DMAs are layout devices of that chip and are not copied; its
window/strip hit tests are a superset of the per-pixel bbox test used here
that never adds coverage (a triangle's edge functions pass only inside its
bbox, which is inflated past every sample the triangle can cover).

CUDA design (``csrc/raster.cu``): one 256-thread block per 16x16-pixel
block, one thread per pixel holding its S samples' K sorted (depth, id)
slots in registers — one owner per sample, so no atomics and nothing can
race (the TPU kernel's overlapping accumulator windows raced on hardware,
raster_pallas.py:413-418). The kernel's time goes to finding the few
triangles that touch a block (a block hits ~4 of ~1,000 chunks, and ~3%
of their triangles touch it) and to evaluating them, not to moving bytes.
So the block tests the chunk bboxes 4 per thread with their loads in
flight together, lists the hit chunks by a warp scan and block prefix,
tests 2 hit chunks' triangles at a time (one triangle per thread, straight
from global memory) and appends only the touching ones to a compacted
list of 128, their 19 evaluation rows gathered by ``cp.async`` while the
next chunks are tested; two lists alternate, and a full one is evaluated
once the next page's copies are in flight. Each thread then tests its
pixel against each listed bbox and evaluates its samples; a passing
fragment nearer than the last slot is inserted by the fully unrolled
bubble-down of raster_pallas.py:831-852. The kernel is templated on
(S, K) with K rounded up to 1, 2, 4 or 8, and its launch bounds ask ptxas
for as many resident blocks as the accumulators allow (no spill at any
(S, K); the ptxas report is in PERF.md). The plain version runs K rounds
of scatter_reduce("amin"), round l keeping only keys above round l-1's.
Both take a band offset ``y_offset`` (``rasterize_pallas``'s, for the
multi-device frame, ``parallel/tiles.py``): the output is the frame's rows
y_offset .. y_offset + height, every test on global rows. Times on the card, against the previous design and the bound: PERF.md
(kernel_ab.py, chip_smoke.py).
"""

from __future__ import annotations

import ctypes

import torch

from vktf_tpu_torch.config import PEEL_LAYERS_MAX, SAMPLE_OFFSETS
from vktf_tpu_torch.ops import _cuda
from vktf_tpu_torch.ops.fmath import f32, fma

KERNEL = _cuda.Kernel(
    "raster", "raster.cu",
    "vktf_tpu/ops/raster_pallas.py:365 (_raster_kernel via rasterize_pallas, pallas_call :1201)",
)
# the same kernel keeping K = 2..8 layers (counted apart from K = 1)
KERNEL_LAYERS = _cuda.Kernel(
    "raster_layers", "raster.cu",
    "vktf_tpu/ops/raster_pallas.py:365 (_raster_kernel, K-layer sorted insertion :831-852, "
    "via rasterize_pallas, pallas_call :1201)",
)
_cuda.declare("raster.cu", "vktf_raster",
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
_cuda.declare("raster.cu", "vktf_raster_band",
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)

# triangles per group: the slim flag is their AND; tri_bbox rows 4..7 hold
# the group bbox, the TPU kernel's mid-level skip (the CUDA kernel lists
# the triangles that touch a block without it)
GROUP_SIZE = 8

_BIG = 2 ** 30
_INT_MAX = 2 ** 31 - 1


def _part1by1(x):
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def stream_perm(bbox_rows, valid, chunk: int = 256, granularity: int = 16):
    """Screen-Morton stream permutation (t_pad,) of the triangles by their
    bbox centre; invalid triangles and chunk padding sort to the tail."""
    t = valid.shape[0]
    t_pad = -(-t // chunk) * chunk
    g = granularity
    cx = torch.clamp(
        torch.div((bbox_rows[0] + bbox_rows[2]).to(torch.int32), 2 * g,
                  rounding_mode="floor"), 0, 1023)
    cy = torch.clamp(
        torch.div((bbox_rows[1] + bbox_rows[3]).to(torch.int32), 2 * g,
                  rounding_mode="floor"), 0, 1023)
    key = _part1by1(cx) | (_part1by1(cy) << 1)
    key = torch.where(valid, key, torch.full_like(key, _INT_MAX))
    if t_pad != t:
        key = torch.cat([key, torch.full((t_pad - t,), _INT_MAX,
                                         dtype=key.dtype, device=key.device)])
    return torch.argsort(key, stable=True)


def raster_stream(tri_data, bbox_rows, perm, chunk: int = 256,
                  group_size: int = GROUP_SIZE):
    """The raster prologue: pad the setup rows to whole chunks (padding is
    invalid: id -1, slim 1, empty bbox), put them in stream order, reduce
    row 19 to a per-GROUP slim flag (AND over the group's members), and
    build the group bbox rows and the chunk bboxes.

    Returns (tri_data (24, t_pad), tri_bbox (8, t_pad): rows 0..3 the
    triangle bbox, 4..7 its group's bbox, chunk_bbox (4, n_chunks))."""
    t = tri_data.shape[1]
    t_pad = perm.shape[0]
    if t_pad % chunk or t_pad < t:
        raise ValueError(f"perm length {t_pad} must cover {t} triangles in "
                         f"whole chunks of {chunk}")
    dev = tri_data.device
    if t_pad > t:
        pad = torch.zeros((tri_data.shape[0], t_pad - t), dtype=tri_data.dtype,
                          device=dev)
        pad[15] = -1.0
        pad[19] = 1.0
        tri_data = torch.cat([tri_data, pad], dim=1)
        lo = torch.full((2, t_pad - t), float(_BIG), device=dev)
        bbox_rows = torch.cat([bbox_rows, torch.cat([lo, -lo])], dim=1)
    tri_data = tri_data[:, perm]
    bbox_rows = bbox_rows[:, perm]
    groups = t_pad // group_size
    gsafe = tri_data[19].reshape(groups, group_size).amin(dim=1)
    tri_data[19] = gsafe.repeat_interleave(group_size)
    g = bbox_rows.reshape(4, groups, group_size)
    group_rows = torch.cat([
        g[:2].amin(dim=2).repeat_interleave(group_size, dim=1),
        g[2:].amax(dim=2).repeat_interleave(group_size, dim=1),
    ])
    tri_bbox = torch.cat([bbox_rows, group_rows]).contiguous()
    c = bbox_rows.reshape(4, t_pad // chunk, chunk)
    chunk_bbox = torch.cat([c[:2].amin(dim=2), c[2:].amax(dim=2)]).contiguous()
    return tri_data.contiguous(), tri_bbox, chunk_bbox


def _plane(rows, r, dxx, dyy):
    """Anchored plane a*dx + b*dy + c at the sample, contracted as XLA's
    CPU build contracts the JAX kernel's expression: fma(b, dy, a*dx) + c
    (pinned bit for bit on depth by tests/test_torch_raster.py)."""
    return fma(rows[r + 1], dyy, rows[r] * dxx) + rows[r + 2]


def _order_key(depth):
    """int64 key ordering (depth, id) lexicographically: the float's
    order-preserving integer in the high word."""
    bits = depth.view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) << 32


def _candidates(tri_data, tri_bbox, height: int, width: int, msaa_samples: int,
                max_pairs: int, y_offset: int = 0):
    """Every passing fragment of the band of rows y_offset .. y_offset +
    height, in batches: (flat sample index (s, y - y_offset, x), int64
    (depth, id) key). Enumerates (triangle, pixel) pairs over each valid
    triangle's bbox cut to the band, at most max_pairs pixels per batch;
    pixel rows are global, so a band's fragments are the full frame's."""
    dev = tri_data.device
    offsets = SAMPLE_OFFSETS[msaa_samples]
    idx = torch.nonzero(tri_data[15] >= 0.0).flatten()
    x0 = tri_bbox[0, idx].to(torch.int64)
    y0 = tri_bbox[1, idx].to(torch.int64).clamp(min=y_offset)
    bw = (tri_bbox[2, idx].to(torch.int64) - x0).clamp(min=0)
    bh = (tri_bbox[3, idx].to(torch.int64).clamp(max=y_offset + height) - y0).clamp(min=0)
    area = bw * bh
    keep = area > 0
    idx, x0, y0, bw, area = idx[keep], x0[keep], y0[keep], bw[keep], area[keep]
    ends = torch.cumsum(area, 0)
    one_f = f32(1.0, tri_data)
    zero_f = f32(0.0, tri_data)
    start = 0
    while start < idx.shape[0]:
        base = int(ends[start - 1]) if start else 0
        stop = int(torch.searchsorted(ends, base + max_pairs, right=True))
        stop = max(stop, start + 1)
        sel = slice(start, stop)
        counts = area[sel]
        tri = torch.repeat_interleave(idx[sel], counts)
        first = torch.repeat_interleave(ends[sel] - counts, counts)
        local = torch.arange(base, base + int(counts.sum()), device=dev) - first
        rbw = torch.repeat_interleave(bw[sel], counts)
        px = torch.repeat_interleave(x0[sel], counts) + local % rbw
        py = torch.repeat_interleave(y0[sel], counts) + torch.div(
            local, rbw, rounding_mode="floor")
        rows = tri_data[:, tri]
        tx0 = tri_bbox[0, tri]
        ty0 = tri_bbox[1, tri]
        slim = rows[19] > 0.0
        tri_id = rows[15].to(torch.int64)
        pxf = px.to(torch.float32)
        pyf = py.to(torch.float32)
        for s, (ox, oy) in enumerate(offsets):
            dxx = (pxf + f32(ox, pxf)) - tx0
            dyy = (pyf + f32(oy, pyf)) - ty0
            inside = torch.ones_like(slim)
            for e in range(3):
                ev = _plane(rows, 3 * e, dxx, dyy)
                thr = rows[16 + e].to(torch.int32)
                inside = inside & (ev.view(torch.int32) > thr)
            depth = _plane(rows, 9, dxx, dyy)
            w_recip = _plane(rows, 12, dxx, dyy)
            in_range = (depth >= zero_f) & (depth <= one_f) & (
                depth.view(torch.int32) >= 0)
            ok = inside & (slim | ((w_recip > zero_f) & in_range))
            # the clear value (1.0, -1) wins every tie at depth 1.0
            ok = ok & (depth < one_f)
            yield ((s * height + py[ok] - y_offset) * width + px[ok],
                   _order_key(depth[ok]) | tri_id[ok])
        start = stop


def rasterize_plain(tri_data, tri_bbox, chunk_bbox, height: int, width: int,
                    msaa_samples: int, layers: int = 1, y_offset: int = 0, *,
                    max_pairs: int = 1 << 22):
    """Plain-torch version. Layer l of a sample is the minimum (depth, id)
    key among its fragments whose key exceeds layer l-1's: K rounds of
    scatter_reduce("amin") over every fragment (each triangle covers a
    sample at most once, so the keys are distinct and this is the sorted
    insertion's K nearest). chunk_bbox is unused: chunk skipping cannot
    change the result."""
    del chunk_bbox
    dev = tri_data.device
    s_count = len(SAMPLE_OFFSETS[msaa_samples])
    n = s_count * height * width
    sentinel = torch.iinfo(torch.int64).max
    best = []
    for _ in range(layers):
        cur = torch.full((n,), sentinel, dtype=torch.int64, device=dev)
        prev = best[-1] if best else None
        # once a layer is empty everywhere, so is every deeper one
        if prev is None or bool((prev != sentinel).any()):
            for flat, key in _candidates(tri_data, tri_bbox, height, width,
                                         msaa_samples, max_pairs, y_offset):
                if prev is not None:
                    deeper = key > prev[flat]
                    flat, key = flat[deeper], key[deeper]
                cur.scatter_reduce_(0, flat, key, reduce="amin")
        best.append(cur)

    keys = torch.stack(best)
    hit = keys != sentinel
    ids = torch.where(hit, keys & 0xFFFFFFFF, torch.full_like(keys, -1))
    ordered = keys >> 32
    bits = torch.where(ordered >= 0, ordered, ordered ^ 0x7FFFFFFF).to(torch.int32)
    depth = torch.where(hit, bits.view(torch.float32), f32(1.0, tri_data))
    shape = (layers, s_count, height, width) if layers > 1 else (s_count, height, width)
    return ids.to(torch.int32).reshape(shape), depth.reshape(shape)


def rasterize(tri_data, tri_bbox, chunk_bbox, height: int, width: int,
              msaa_samples: int, layers: int = 1, y_offset: int = 0):
    """Per-sample (tri_id i32, depth f32) of a stream built by raster_stream:
    (S, H, W) at layers == 1, else the `layers` nearest fragments of every
    sample nearest first, (K, S, H, W); an empty layer is (-1, 1.0).
    height/width must be multiples of 16. y_offset (a multiple of 16) makes
    it the band of the frame's rows y_offset .. y_offset + height, equal to
    those rows of the whole frame's raster. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if height % 16 or width % 16:
        raise ValueError(f"framebuffer {height}x{width} must be a multiple of 16")
    if y_offset < 0 or y_offset % 16:
        raise ValueError(f"y_offset must be a non-negative multiple of 16, got {y_offset}")
    if not 1 <= layers <= PEEL_LAYERS_MAX:
        raise ValueError(f"layers must be 1..{PEEL_LAYERS_MAX}, got {layers}")
    if not tri_data.is_cuda:
        return rasterize_plain(tri_data, tri_bbox, chunk_bbox, height, width,
                               msaa_samples, layers, y_offset)
    t_pad = tri_data.shape[1]
    if t_pad >= 1 << 24:
        raise ValueError("triangle ids ride f32 rows: exact only below 2^24")
    n_chunks = chunk_bbox.shape[1]
    if n_chunks == 0 or t_pad % n_chunks:
        raise ValueError("chunk_bbox does not tile the stream")
    chunk = t_pad // n_chunks
    if chunk != 256:
        raise ValueError(f"the CUDA raster kernel stages 256-triangle chunks, got {chunk}")
    dev = tri_data.device
    _cuda.require(tri_data, "tri_data", torch.float32, (24, t_pad))
    _cuda.require(tri_bbox, "tri_bbox", torch.float32, (8, t_pad), dev)
    _cuda.require(chunk_bbox, "chunk_bbox", torch.float32, (4, n_chunks), dev)
    s_count = len(SAMPLE_OFFSETS[msaa_samples])
    shape = (layers, s_count, height, width) if layers > 1 else (s_count, height, width)
    ids = torch.empty(shape, dtype=torch.int32, device=dev)
    depth = torch.empty(shape, dtype=torch.float32, device=dev)
    offsets = (ctypes.c_float * (2 * s_count))(
        *[c for xy in SAMPLE_OFFSETS[msaa_samples] for c in xy])
    lib = _cuda.library(KERNEL.source)
    operands = (_cuda.ptr(tri_data), _cuda.ptr(tri_bbox), _cuda.ptr(chunk_bbox), _cuda.ptr(ids),
                _cuda.ptr(depth), n_chunks, height, width, s_count, layers)
    tail = (ctypes.cast(offsets, ctypes.c_void_p), _cuda.stream_of(tri_data))
    (KERNEL if layers == 1 else KERNEL_LAYERS).launches += 1
    # the whole frame through vktf_raster, the entry earlier sources have too
    # (kernel_ab.py times them against these); a band through vktf_raster_band
    status = (lib.vktf_raster(*operands, *tail) if y_offset == 0
              else lib.vktf_raster_band(*operands, y_offset, *tail))
    _cuda.check(status, "raster kernel")
    return ids, depth
