// Streaming visibility raster with a K-layer depth peel (ops/raster.py).
//
// Replaces vktf_tpu/ops/raster_pallas.py `_raster_kernel`, K = 1..8 layers.
// One 256-thread block per 16x16-pixel block; each thread owns one pixel
// and keeps, for each of its S samples, the K lexicographically nearest
// (depth, id) fragments in registers, sorted, so every sample has exactly
// one writer and nothing races.
//
// What bounds it on the card: not bytes (each valid triangle's rows once,
// the outputs once) but instructions and latency. A block must find the
// few triangles that touch it among the ~1,000 chunks of 256 a frame
// streams (it hits ~4 chunks, and ~3% of their triangles touch it), a
// chain of dependent loads and barriers that only many blocks in flight
// hide; then every pixel tests every listed triangle, and a warp evaluates
// samples wherever any of its pixels lies in the triangle's bbox, the
// larger part of the time (PERF.md). So the block
//   1. tests the chunk bboxes, 4 per thread and round with their loads in
//      flight together, and lists the hits in thread order (a warp scan and
//      a block prefix: no atomics);
//   2. tests 2 hit chunks at a time, each thread its own triangle of each
//      (valid id, bbox against the block), straight from global memory:
//      2 x 5 coalesced loads in flight per thread;
//   3. appends the touching triangles to a compacted list (block prefix
//      again): their bbox and id from registers, their evaluation rows
//      (tri_data rows 0..19) gathered by cp.async, which lands while the
//      next chunks are tested; two lists of 128 alternate, and a full list
//      is evaluated only once the next page's copies are in flight;
//   4. evaluates a list (a triangle's 24 floats contiguous: six 16-byte
//      shared loads, broadcast): each thread tests its pixel against each
//      listed triangle's bbox, then its samples: the three fill-rule edge
//      compares on the float bits against rows 16..18, and unless the slim
//      flag (row 19, the group AND) is set, w > 0 and 0 <= depth <= 1; a
//      passing fragment nearer than the last slot is inserted as
//      raster_pallas.py:831-852 does (it bubbles down, and each entry it
//      displaces continues down in its place).
// The K nearest (depth, draw-order id) keys form a set, so the order in
// which triangles are visited does not change a bit of the output. The
// list length is a template parameter rounded up to 1, 2, 4 or 8 (the
// first K entries of a longer sorted list are the K nearest); fully
// unrolled, the S x K x 2 words stay in registers, and the launch bounds
// ask ptxas for as many resident blocks as the (S, K) accumulators allow
// without a spill. Shared memory (29 KB a block) does not bound occupancy.
// Each warp covers an 8x4 pixel tile, so a small triangle's bbox meets
// fewer warps than with two 16-pixel rows.
// A band of rows (the multi-device frame, parallel/tiles.py) is the frame's
// rows y_offset .. y_offset + height: every test and plane evaluation takes
// the global pixel row (an exact integer in f32), and only the output index
// takes the row within the band, so a band's rows equal the full frame's
// rows bit for bit (rasterize_pallas's y_offset, raster_pallas.py:916).
// No matrix product occurs, so wgmma does not apply. The alternatives
// measured against these choices (plain loads, one chunk per list, other
// group and test widths, 16-pixel warp rows, lists row by row, ptxas's own
// register count) are recorded in PERF.md.
#include "common.cuh"

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = kBlock * kBlock;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;
constexpr int kTestWidth = 4;  // chunk bboxes per thread and round
constexpr int kGroup = 2;      // hit chunks whose triangles are tested together
constexpr int kList = 128;     // triangles per list (two lists)
constexpr int kListRows = 24;  // tri_data rows 0..19, then the bbox
constexpr int kIdRow = 15;
constexpr int kBox = 20;       // list row of the bbox

// MSAA sample offsets (config.SAMPLE_OFFSETS), passed by value
struct Offsets {
  float v[8][2];
};

// ---- asynchronous copies (cp.async) ------------------------------------------

__device__ __forceinline__ void copy4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's most recent copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// anchored plane a*dx + b*dy + c (rows r, r+1, r+2 of a triangle),
// contracted as ops/raster.py _plane
__device__ __forceinline__ float plane(const float* r, float dxx, float dyy) {
  return fma_rn(r[1], dyy, r[0] * dxx) + r[2];
}

// A list holds kList triangles of kListRows floats: a triangle's rows are
// contiguous, so one 16-byte shared load reads four (broadcast to the warp).
// Rows 4q..4q+3 of listed triangle k:
__device__ __forceinline__ float4 list_quad(const float* list, int k, int q) {
  return reinterpret_cast<const float4*>(list + k * kListRows)[q];
}

// Exclusive prefix of v over the block's threads in thread order, and the
// block's total. Consecutive calls alternate between two sums arrays: a
// call's writes then follow the previous call's barrier, after which every
// thread has read the sums of the call before it.
__device__ __forceinline__ int block_scan(int v, int tid, int* warp_sums, int& total) {
  const int lane = tid & 31, warp = tid >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    total += c;
  }
  return before + incl - v;
}

template <int S, int K>
struct Samples {
  float d[S][K];
  int i[S][K];
};

// Every listed triangle against this thread's pixel and samples.
template <int S, int K>
__device__ __forceinline__ void evaluate(const float* list, int count, float fpx, float fpy,
                                         const Offsets& off, Samples<S, K>& best) {
  for (int kk = 0; kk < count; ++kk) {
    const float4 box = list_quad(list, kk, kBox / 4);
    const float tx0 = box.x, ty0 = box.y, tx1 = box.z, ty1 = box.w;
    if (!(fpx >= tx0 && fpx < tx1 && fpy >= ty0 && fpy < ty1)) continue;
    float r[20];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float4 v = list_quad(list, kk, q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
    const int id = (int)r[kIdRow];
    const int thr0 = (int)r[16], thr1 = (int)r[17], thr2 = (int)r[18];
    const bool slim = r[19] > 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dxx = (fpx + off.v[s][0]) - tx0;
      const float dyy = (fpy + off.v[s][1]) - ty0;
      bool ok = __float_as_int(plane(&r[0], dxx, dyy)) > thr0 &&
                __float_as_int(plane(&r[3], dxx, dyy)) > thr1 &&
                __float_as_int(plane(&r[6], dxx, dyy)) > thr2;
      const float depth = plane(&r[9], dxx, dyy);
      if (!slim) {
        const float w_recip = plane(&r[12], dxx, dyy);
        ok = ok && w_recip > 0.0f && __float_as_uint(depth) <= 0x3F800000u;
      }
      // sorted insertion: the candidate bubbles down, a displaced entry
      // continues down in its place (nothing moves unless the candidate is
      // nearer than the last slot)
      if (ok && (depth < best.d[s][K - 1] ||
                 (depth == best.d[s][K - 1] && id < best.i[s][K - 1]))) {
        float cd = depth;
        int ci = id;
#pragma unroll
        for (int l = 0; l < K; ++l) {
          const float dl = best.d[s][l];
          const int il = best.i[s][l];
          const bool swap = cd < dl || (cd == dl && ci < il);
          best.d[s][l] = swap ? cd : dl;
          best.i[s][l] = swap ? ci : il;
          cd = swap ? dl : cd;
          ci = swap ? il : ci;
        }
      }
    }
  }
}

// Resident blocks per SM asked of ptxas: as many as the (S, K)
// accumulators' registers allow without a spill.
template <int S, int K>
constexpr int kMinBlocks = S * K <= 4 ? 4 : (S * K <= 8 ? 3 : (S * K <= 32 ? 2 : 1));

template <int S, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<S, K>) raster_kernel(
    const float* __restrict__ tri_data, const float* __restrict__ tri_bbox,
    const float* __restrict__ chunk_bbox, int* __restrict__ out_id,
    float* __restrict__ out_depth, int n_chunks, int height, int width, int layers,
    int y_offset, Offsets off) {
  __shared__ __align__(16) float lists[2][kList * kListRows];
  __shared__ int hit_list[kThreads * kTestWidth];
  __shared__ int sums[2][kWarps];

  const int tid = threadIdx.y * kBlock + threadIdx.x;
  // each warp an 8x4 pixel tile
  const int warp = tid >> 5, lane = tid & 31;
  const int qx = (warp & 1) * 8 + (lane & 7), qy = (warp >> 1) * 4 + (lane >> 3);
  // global rows: the band starts at row y_offset
  const int bx0 = blockIdx.x * kBlock, by0 = y_offset + blockIdx.y * kBlock;
  const int px = bx0 + qx, py = by0 + qy;
  const float fbx0 = (float)bx0, fby0 = (float)by0;
  const float fbx1 = fbx0 + kBlock, fby1 = fby0 + kBlock;
  const float fpx = (float)px, fpy = (float)py;
  // 32-bit offsets (the wrapper keeps t_pad below 2^24, so 24 rows fit):
  // fewer registers than 64-bit ones
  const int t_pad = n_chunks * kChunk;

  // per sample, K (depth, id) slots sorted nearest first; clear (1.0, -1)
  Samples<S, K> best;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      best.d[s][l] = 1.0f;
      best.i[s][l] = -1;
    }
  }

  // block-uniform list state: entries in lists[cur], whether lists[cur ^ 1]
  // is full and waits for evaluation, and which sums array scans next
  int cur = 0, n_list = 0, par = 0;
  bool pending = false;

  for (int base = 0; base < n_chunks; base += kThreads * kTestWidth) {
    // 1. this round's hit chunks: kTestWidth bboxes per thread, loads in flight
    // together, listed in thread order
    bool hit[kTestWidth];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kTestWidth; ++j) {
      const int c = base + j * kThreads + tid;
      hit[j] = false;
      if (c < n_chunks) {
        const float cx0 = chunk_bbox[c], cy0 = chunk_bbox[n_chunks + c];
        const float cx1 = chunk_bbox[2 * n_chunks + c], cy1 = chunk_bbox[3 * n_chunks + c];
        hit[j] = cx0 < fbx1 && cy0 < fby1 && cx1 > fbx0 && cy1 > fby0;
      }
      mine += hit[j] ? 1 : 0;
    }
    int hits;
    int at = block_scan(mine, tid, sums[par], hits);
    par ^= 1;
#pragma unroll
    for (int j = 0; j < kTestWidth; ++j)
      if (hit[j]) hit_list[at++] = base + j * kThreads + tid;
    __syncthreads();

    // 2. kGroup hit chunks at a time: triangle tid of each against the block
    for (int g = 0; g < hits; g += kGroup) {
      float x0[kGroup], y0[kGroup], x1[kGroup], y1[kGroup], id[kGroup];
      int chunk[kGroup];
      bool touch[kGroup];
      int own = 0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        touch[j] = false;
        chunk[j] = 0;
        if (g + j < hits) {
          chunk[j] = hit_list[g + j];
          const int col = chunk[j] * kChunk + tid;
          x0[j] = tri_bbox[col];
          y0[j] = tri_bbox[t_pad + col];
          x1[j] = tri_bbox[2 * t_pad + col];
          y1[j] = tri_bbox[3 * t_pad + col];
          id[j] = tri_data[kIdRow * t_pad + col];
          touch[j] = id[j] >= 0.0f && x0[j] < fbx1 && x1[j] > fbx0 && y0[j] < fby1 &&
                     y1[j] > fby0;
        }
        own += touch[j] ? 1 : 0;
      }
      int total;
      const int pre = block_scan(own, tid, sums[par], total);
      par ^= 1;

      // 3. list the touching triangles page by page: a page fills the rest
      // of lists[cur], its evaluation rows gathered by cp.async; a full list
      // is evaluated after the next page's copies are in flight
      for (int done = 0; done < total;) {
        const int take = min(kList - n_list, total - done);
        float* list = lists[cur];
        int e = pre;
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (!touch[j]) continue;
          if (e >= done && e < done + take) {
            float* dst = list + (n_list + e - done) * kListRows;
            dst[kBox] = x0[j];
            dst[kBox + 1] = y0[j];
            dst[kBox + 2] = x1[j];
            dst[kBox + 3] = y1[j];
            dst[kIdRow] = id[j];
            // a rolled loop: one running offset, not 19 hoisted ones
            int src = chunk[j] * kChunk + tid;
#pragma unroll 1
            for (int r = 0; r < 20; ++r, src += t_pad)
              if (r != kIdRow) copy4(&dst[r], tri_data + src);
          }
          ++e;
        }
        copy_commit();
        n_list += take;
        done += take;
        if (pending) {  // every copy but this page's has landed
          copy_wait<1>();
          __syncthreads();
          evaluate<S, K>(lists[cur ^ 1], kList, fpx, fpy, off, best);
          __syncthreads();
          pending = false;
        }
        if (n_list == kList) {
          pending = true;
          cur ^= 1;
          n_list = 0;
        }
      }
    }
    // hit_list is rewritten by the next round
    __syncthreads();
  }
  copy_wait<0>();
  __syncthreads();
  if (pending) evaluate<S, K>(lists[cur ^ 1], kList, fpx, fpy, off, best);
  evaluate<S, K>(lists[cur], n_list, fpx, fpy, off, best);

  // output (layers, S, height, width) of the band: layer-major, layers <= K
  const int row = py - y_offset;
  if (px < width && row < height) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l >= layers) break;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t o = (((size_t)l * S + s) * height + row) * width + px;
        out_id[o] = best.i[s][l];
        out_depth[o] = best.d[s][l];
      }
    }
  }
}

template <int S, int K>
void launch(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
            const float* tri_bbox, const float* chunk_bbox, int* out_id, float* out_depth,
            int n_chunks, int height, int width, int layers, int y_offset, const Offsets& off) {
  raster_kernel<S, K><<<blocks, threads, 0, stream>>>(tri_data, tri_bbox, chunk_bbox, out_id,
                                                      out_depth, n_chunks, height, width,
                                                      layers, y_offset, off);
}

template <int S>
int launch_layers(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
                  const float* tri_bbox, const float* chunk_bbox, int* out_id, float* out_depth,
                  int n_chunks, int height, int width, int layers, int y_offset,
                  const Offsets& off) {
  if (layers == 1)
    launch<S, 1>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, y_offset, off);
  else if (layers == 2)
    launch<S, 2>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, y_offset, off);
  else if (layers <= 4)
    launch<S, 4>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, y_offset, off);
  else if (layers <= 8)
    launch<S, 8>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, y_offset, off);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

}  // namespace

// The rows y_offset .. y_offset + height of the frame (y_offset a multiple
// of 16); vktf_raster is the whole frame from row 0.
VKTF_EXPORT int vktf_raster_band(const float* tri_data, const float* tri_bbox,
                                 const float* chunk_bbox, int* out_id, float* out_depth,
                                 int n_chunks, int height, int width, int samples, int layers,
                                 int y_offset, const float* offsets, cudaStream_t stream) {
  if (layers < 1 || y_offset < 0 || y_offset % kBlock) return (int)cudaErrorInvalidValue;
  Offsets off = {};
  for (int s = 0; s < samples && s < 8; ++s) {
    off.v[s][0] = offsets[2 * s];
    off.v[s][1] = offsets[2 * s + 1];
  }
  const dim3 threads(kBlock, kBlock);
  const dim3 blocks((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock);
  switch (samples) {
    case 1:
      return launch_layers<1>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, y_offset, off);
    case 2:
      return launch_layers<2>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, y_offset, off);
    case 4:
      return launch_layers<4>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, y_offset, off);
    case 8:
      return launch_layers<8>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, y_offset, off);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

VKTF_EXPORT int vktf_raster(const float* tri_data, const float* tri_bbox, const float* chunk_bbox,
                            int* out_id, float* out_depth, int n_chunks, int height, int width,
                            int samples, int layers, const float* offsets, cudaStream_t stream) {
  return vktf_raster_band(tri_data, tri_bbox, chunk_bbox, out_id, out_depth, n_chunks, height,
                          width, samples, layers, 0, offsets, stream);
}
