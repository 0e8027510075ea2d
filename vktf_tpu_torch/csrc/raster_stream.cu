// The raster prologue (ops/raster.py raster_stream): the setup rows put in
// stream order, the per-group slim flag, the group bboxes and the chunk
// bboxes, in one pass.
//
// Replaces vktf_tpu/ops/raster_pallas.py:1048-1092, rasterize_pallas's
// prologue: the perm gather of tri_data and bbox_rows, row 19's group AND
// (a min over the group), the group bbox rows 4..7 and the chunk bboxes.
// The plain version (raster_stream_plain) pads the inputs to whole chunks,
// gathers, and reduces in separate passes; here no padded copy is made and
// nothing is written and read back.
//
// What bounds it on the card: bytes. Each stream position reads its 24
// tri_data and 4 bbox floats from its source column and its perm entry, and
// writes 24 tri_data and 8 tri_bbox floats: 28 x 4 x t + 8 x t_pad bytes
// read, 32 x 4 x t_pad written, about 727 MB (0.217 ms at 3.35 TB/s) for
// the 2,979,744 triangles of the 2160p cell. So the kernel
//   1. runs one 256-thread block per 256-triangle chunk, thread j on stream
//      position 256 c + j: its perm entry, then its 28 loads from that
//      source column, all in flight together (a source at or past t is
//      chunk padding: id -1, slim 1, the empty bbox (2^30, 2^30, -2^30,
//      -2^30), and reads nothing);
//   2. reduces each group of 8 consecutive positions (8 adjacent lanes) in
//      registers by __shfl_xor_sync over lane offsets 1, 2 and 4: row 19's
//      minimum and the group bbox (min x0, min y0, max x1, max y1);
//   3. carries the same shuffles on over offsets 8 and 16 to the warp's
//      bbox, then across the block's 8 warps in shared memory, to the
//      chunk's bbox, written by 4 threads;
//   4. stores every output row r at r * t_pad + 256 c + j: coalesced.
// The gathered loads are the only ones that are not coalesced. The stream
// is in screen-Morton order and meshes are stored in spatially coherent
// order, so neighbouring positions mostly read nearby source columns and
// share their 32-byte sectors; how close this comes to the bound is in
// PERF.md. Min and max propagate NaN as torch.amin / amax do; the bbox
// rows are integers and row 19 is 0 or 1, so no signed zero can make the
// order of the reduction show.
// 32-bit offsets: the wrapper keeps t_pad below 2^24, so 32 rows fit.
#include "common.cuh"

namespace {

constexpr int kChunk = 256;  // stream positions per chunk, one block each
constexpr int kGroup = 8;    // positions per group (raster.GROUP_SIZE)
constexpr int kWarps = kChunk / 32;
constexpr int kRows = 24;    // tri_data rows
constexpr int kIdRow = 15;
constexpr int kSlimRow = 19;
constexpr float kBig = 1073741824.0f;  // 2^30, the empty bbox's corner
constexpr unsigned kAll = 0xFFFFFFFFu;

// rows 0, 1 of a bbox take the minimum, rows 2, 3 the maximum
__device__ __forceinline__ float bbox_op(int r, float a, float b) {
  return r < 2 ? tmin(a, b) : tmax(a, b);
}

__global__ void __launch_bounds__(kChunk) stream_kernel(
    const float* __restrict__ tri_data, const float* __restrict__ bbox_rows,
    const long long* __restrict__ perm, int t, int t_pad, float* __restrict__ out_data,
    float* __restrict__ out_bbox, float* __restrict__ chunk_bbox) {
  __shared__ float warp_box[4][kWarps];
  const int c = blockIdx.x, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int p = c * kChunk + j;

  // 1. the source column's rows, or the padding's
  const long long src = perm[p];
  float row[kRows], box[4];
  if (src >= 0 && src < t) {
    const int s = (int)src;
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = tri_data[r * t + s];
#pragma unroll
    for (int r = 0; r < 4; ++r) box[r] = bbox_rows[r * t + s];
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = 0.0f;
    row[kIdRow] = -1.0f;
    row[kSlimRow] = 1.0f;
    box[0] = box[1] = kBig;
    box[2] = box[3] = -kBig;
  }

  // 2. the group's slim flag and bbox: lanes 8k .. 8k + 7
  float slim = row[kSlimRow];
  float group[4] = {box[0], box[1], box[2], box[3]};
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) {
    slim = tmin(slim, __shfl_xor_sync(kAll, slim, o));
#pragma unroll
    for (int r = 0; r < 4; ++r) group[r] = bbox_op(r, group[r], __shfl_xor_sync(kAll, group[r], o));
  }
  row[kSlimRow] = slim;

  // 3. the chunk's bbox: the warp's from the group bboxes, then the block's
  float wide[4] = {group[0], group[1], group[2], group[3]};
#pragma unroll
  for (int o = kGroup; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) wide[r] = bbox_op(r, wide[r], __shfl_xor_sync(kAll, wide[r], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) warp_box[r][warp] = wide[r];
  }

  // 4. coalesced stores, row by row
#pragma unroll
  for (int r = 0; r < kRows; ++r) out_data[r * t_pad + p] = row[r];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    out_bbox[r * t_pad + p] = box[r];
    out_bbox[(4 + r) * t_pad + p] = group[r];
  }

  __syncthreads();
  if (j < 4) {
    float v = warp_box[j][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = bbox_op(j, v, warp_box[j][w]);
    chunk_bbox[j * (t_pad / kChunk) + c] = v;
  }
}

}  // namespace

// tri_data (24, t) and bbox_rows (4, t) f32, perm (t_pad,) i64 with t_pad a
// multiple of 256; out_data (24, t_pad), out_bbox (8, t_pad), chunk_bbox
// (4, t_pad / 256) f32.
VKTF_EXPORT int vktf_raster_stream(const float* tri_data, const float* bbox_rows,
                                   const long long* perm, int t, int t_pad, float* out_data,
                                   float* out_bbox, float* chunk_bbox, cudaStream_t stream) {
  if (t < 0 || t_pad <= 0 || t_pad % kChunk || t_pad < t) return (int)cudaErrorInvalidValue;
  stream_kernel<<<t_pad / kChunk, kChunk, 0, stream>>>(tri_data, bbox_rows, perm, t, t_pad,
                                                       out_data, out_bbox, chunk_bbox);
  return launch_status();
}
