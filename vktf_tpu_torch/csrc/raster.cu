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
// few triangles that touch it among the chunks of 256 a frame streams
// (~1,000 at 1080p, ~11,600 at 2160p; it hits ~4, and ~3% of their
// triangles touch it), a chain of dependent loads and barriers that only
// many blocks in flight hide; then every pixel tests every listed
// triangle, and a warp evaluates samples wherever any of its pixels lies
// in the triangle's bbox (PERF.md). So, before the block
//   0. chunk_group_kernel reduces each run of kChunkGroup consecutive chunk
//      bboxes to a group bbox (the stream is in screen-Morton order, so a
//      run is compact); then the block
//   1. tests every group bbox, 4 per thread and round with their loads in
//      flight together, and lists the hit groups in thread order (a warp
//      scan and a block prefix: no atomics); then the chunks of the hit
//      groups, one group a warp and one chunk a lane, kWarps groups a
//      round, listing the hit chunks the same way. A chunk can touch the
//      block only if its group does, so the hit chunks are those a test of
//      every chunk bbox finds, at 1/25-1/27 of its tests at 2160p (~465 a
//      block, not 11,640). Step 1 is then bound by its fixed chain (one
//      round of group tests, one of chunk tests, each a scan and barriers)
//      and not by the count: 0.10 ms of a 2160p frame, 0.75 ms before;
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
// without a spill. Shared memory (30 KB a block) does not bound occupancy.
// Each warp covers an 8x4 pixel tile, so a small triangle's bbox meets
// fewer warps than with two 16-pixel rows.
// A band of rows (the multi-device frame, parallel/tiles.py) is the frame's
// rows y_offset .. y_offset + height: every test and plane evaluation takes
// the global pixel row (an exact integer in f32), and only the output index
// takes the row within the band, so a band's rows equal the full frame's
// rows bit for bit (rasterize_pallas's y_offset, raster_pallas.py:916).
// Two output forms share every line but the epilogue. The planes form writes
// each sample's K slots as (layers, S, height, width) ids and depths. The
// winner form writes phase A (ops/pipeline.py pixel_winner) from the slots
// the thread already holds: per layer the pixel's winner, the least id among
// its covered samples at the least depth (-1 when none), as (layers,
// height * width) ids, and layer 0's covered-sample share as (height * width)
// floats, so a pixel-rate frame never writes the planes or reads them back.
// The kernel's time now goes to steps 2-4: the triangle tests of the hit
// chunks and the per-pixel evaluation. No matrix product occurs, so wgmma
// does not apply. The alternatives measured against these choices (plain
// loads, one chunk per list, other group and test widths, 16-pixel warp
// rows, lists row by row, ptxas's own register count, a test of every
// chunk bbox, groups of 64 chunks, 32-bit group indices, group and chunk
// tests interleaved round by round, which took registers and spilled) are
// recorded in PERF.md.
#include "common.cuh"

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = kBlock * kBlock;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;
constexpr int kTestWidth = 4;    // group bboxes per thread and round
constexpr int kChunkGroup = 32;  // consecutive chunks under one group bbox
constexpr int kGroup = 2;        // hit chunks whose triangles are tested together
constexpr int kList = 128;       // triangles per list (two lists)
constexpr int kListRows = 24;    // tri_data rows 0..19, then the bbox
constexpr int kIdRow = 15;
constexpr int kBox = 20;         // list row of the bbox
constexpr float kBig = 1073741824.0f;  // 2^30, the empty bbox's corner
// the most groups a stream has (the wrapper keeps t_pad below 2^24), and
// the group list's end mark
constexpr int kMaxGroups = (1 << 24) / (kChunk * kChunkGroup);
constexpr unsigned short kEnd = 0xFFFF;

__host__ __device__ constexpr int n_groups_of(int n_chunks) {
  return (n_chunks + kChunkGroup - 1) / kChunkGroup;
}

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

// Whether column c of a (4, n) bbox array overlaps the block.
__device__ __forceinline__ bool overlaps(const float* bbox, int n, int c, float fbx0, float fby0,
                                         float fbx1, float fby1) {
  const float x0 = bbox[c], y0 = bbox[n + c], x1 = bbox[2 * n + c], y1 = bbox[3 * n + c];
  return x0 < fbx1 && y0 < fby1 && x1 > fbx0 && y1 > fby0;
}

// 0. The group bboxes: group g covers chunks kChunkGroup g .. kChunkGroup g
// + kChunkGroup - 1 (a ragged last group the chunks it has), one warp a
// group; min x0, min y0, max x1, max y1 from the empty bbox, propagating NaN
// as torch.amin / amax do (chunk_group_bbox_plain).
__global__ void __launch_bounds__(kThreads) chunk_group_kernel(
    const float* __restrict__ chunk_bbox, float* __restrict__ group_bbox, int n_chunks,
    int n_groups) {
  const int lane = threadIdx.x & 31, g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n_groups) return;  // a whole warp
  float box[4] = {kBig, kBig, -kBig, -kBig};
#pragma unroll
  for (int j = 0; j < kChunkGroup / 32; ++j) {
    const int c = g * kChunkGroup + j * 32 + lane;
    if (c < n_chunks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = chunk_bbox[r * n_chunks + c];
        box[r] = r < 2 ? tmin(box[r], v) : tmax(box[r], v);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = __shfl_xor_sync(0xFFFFFFFFu, box[r], o);
      box[r] = r < 2 ? tmin(box[r], v) : tmax(box[r], v);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) group_bbox[r * n_groups + g] = box[r];
  }
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

template <int S, int K, bool Winner>
__global__ void __launch_bounds__(kThreads, kMinBlocks<S, K>) raster_kernel(
    const float* __restrict__ tri_data, const float* __restrict__ tri_bbox,
    const float* __restrict__ chunk_bbox, const float* __restrict__ group_bbox,
    int* __restrict__ out_id, float* __restrict__ out_depth, int n_chunks, int height, int width,
    int layers, int y_offset, Offsets off) {
  __shared__ __align__(16) float lists[2][kList * kListRows];
  // 16-bit group indices: 4 KB of shared memory a block less than 32-bit
  // ones, and no slower (PERF.md)
  __shared__ unsigned short group_list[kMaxGroups + kWarps];
  __shared__ int hit_list[kWarps * kChunkGroup];
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

  // 1a. every group bbox, kTestWidth per thread and round with their loads
  // in flight together; the hit groups listed in thread order, then kWarps
  // end marks, so no count stays live through the loops below
  {
    const int n_groups = n_groups_of(n_chunks);
    int listed = 0;
    for (int base = 0; base < n_groups; base += kThreads * kTestWidth) {
      bool hit[kTestWidth];
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kTestWidth; ++j) {
        const int g = base + j * kThreads + tid;
        hit[j] = g < n_groups && overlaps(group_bbox, n_groups, g, fbx0, fby0, fbx1, fby1);
        mine += hit[j] ? 1 : 0;
      }
      int total;
      int at = listed + block_scan(mine, tid, sums[par], total);
      par ^= 1;
#pragma unroll
      for (int j = 0; j < kTestWidth; ++j)
        if (hit[j]) group_list[at++] = (unsigned short)(base + j * kThreads + tid);
      listed += total;
    }
    if (tid < kWarps) group_list[listed + tid] = kEnd;
    __syncthreads();
  }

  // 1b. the chunks of kWarps hit groups at a time, a group a warp and a
  // chunk a lane, listed in thread order
  for (int first = 0; group_list[first] != kEnd; first += kWarps) {
    bool in[kChunkGroup / 32];
    int own_chunks = 0;
    const unsigned short mark = group_list[first + warp];
    const int gw = mark == kEnd ? -1 : mark;
#pragma unroll
    for (int j = 0; j < kChunkGroup / 32; ++j) {
      const int c = gw * kChunkGroup + j * 32 + lane;
      in[j] = gw >= 0 && c < n_chunks &&
              overlaps(chunk_bbox, n_chunks, c, fbx0, fby0, fbx1, fby1);
      own_chunks += in[j] ? 1 : 0;
    }
    int hits;
    int slot = block_scan(own_chunks, tid, sums[par], hits);
    par ^= 1;
#pragma unroll
    for (int j = 0; j < kChunkGroup / 32; ++j)
      if (in[j]) hit_list[slot++] = gw * kChunkGroup + j * 32 + lane;
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

  const int row = py - y_offset;
  if constexpr (Winner) {
    // phase A of the band: out_id (layers, height * width) the winners,
    // out_depth (height * width) layer 0's coverage; layers <= K
    if (px < width && row < height) {
      const size_t n = (size_t)height * width, pixel = (size_t)row * width + px;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        if (l >= layers) break;
        float d_min = best.d[0][l];
#pragma unroll
        for (int s = 1; s < S; ++s) d_min = best.d[s][l] < d_min ? best.d[s][l] : d_min;
        int tri = -1;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = best.i[s][l];
          if (best.d[s][l] == d_min && i >= 0 && (tri < 0 || i < tri)) tri = i;
        }
        out_id[l * n + pixel] = tri;
      }
      int covered = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) covered += best.i[s][0] >= 0 ? 1 : 0;
      out_depth[pixel] = (float)covered * (1.0f / S);  // exact: S is a power of two
    }
  } else {
    // output (layers, S, height, width) of the band: layer-major, layers <= K
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
}

template <int S, int K, bool Winner>
void launch(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
            const float* tri_bbox, const float* chunk_bbox, const float* group_bbox, int* out_id,
            float* out_depth, int n_chunks, int height, int width, int layers, int y_offset,
            const Offsets& off) {
  raster_kernel<S, K, Winner><<<blocks, threads, 0, stream>>>(
      tri_data, tri_bbox, chunk_bbox, group_bbox, out_id, out_depth, n_chunks, height, width,
      layers, y_offset, off);
}

template <int S, bool Winner>
int launch_layers(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
                  const float* tri_bbox, const float* chunk_bbox, const float* group_bbox,
                  int* out_id, float* out_depth, int n_chunks, int height, int width, int layers,
                  int y_offset, const Offsets& off) {
  if (layers == 1)
    launch<S, 1, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, group_bbox,
                         out_id, out_depth, n_chunks, height, width, layers, y_offset, off);
  else if (layers == 2)
    launch<S, 2, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, group_bbox,
                         out_id, out_depth, n_chunks, height, width, layers, y_offset, off);
  else if (layers <= 4)
    launch<S, 4, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, group_bbox,
                         out_id, out_depth, n_chunks, height, width, layers, y_offset, off);
  else if (layers <= 8)
    launch<S, 8, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, group_bbox,
                         out_id, out_depth, n_chunks, height, width, layers, y_offset, off);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

// Step 0 alone: group_bbox (4, n_groups_of(n_chunks)) from chunk_bbox
// (4, n_chunks).
int chunk_groups(const float* chunk_bbox, float* group_bbox, int n_chunks, cudaStream_t stream) {
  const int n_groups = n_groups_of(n_chunks);
  if (n_chunks <= 0 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  chunk_group_kernel<<<(n_groups + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      chunk_bbox, group_bbox, n_chunks, n_groups);
  return launch_status();
}

// The rows y_offset .. y_offset + height of the frame (y_offset a multiple
// of 16) in the planes form or the winner form: the group bboxes into
// group_bbox, then the raster, on one stream.
template <bool Winner>
int raster_band(const float* tri_data, const float* tri_bbox, const float* chunk_bbox,
                float* group_bbox, int* out_id, float* out_depth, int n_chunks, int height,
                int width, int samples, int layers, int y_offset, const float* offsets,
                cudaStream_t stream) {
  if (layers < 1 || y_offset < 0 || y_offset % kBlock) return (int)cudaErrorInvalidValue;
  if (samples != 1 && samples != 2 && samples != 4 && samples != 8)
    return (int)cudaErrorInvalidValue;
  const int status = chunk_groups(chunk_bbox, group_bbox, n_chunks, stream);
  if (status) return status;
  Offsets off = {};
  for (int s = 0; s < samples; ++s) {
    off.v[s][0] = offsets[2 * s];
    off.v[s][1] = offsets[2 * s + 1];
  }
  const dim3 threads(kBlock, kBlock);
  const dim3 blocks((width + kBlock - 1) / kBlock, (height + kBlock - 1) / kBlock);
  switch (samples) {
    case 1:
      return launch_layers<1, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox,
                                      group_bbox, out_id, out_depth, n_chunks, height, width,
                                      layers, y_offset, off);
    case 2:
      return launch_layers<2, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox,
                                      group_bbox, out_id, out_depth, n_chunks, height, width,
                                      layers, y_offset, off);
    case 4:
      return launch_layers<4, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox,
                                      group_bbox, out_id, out_depth, n_chunks, height, width,
                                      layers, y_offset, off);
    default:
      return launch_layers<8, Winner>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox,
                                      group_bbox, out_id, out_depth, n_chunks, height, width,
                                      layers, y_offset, off);
  }
}

}  // namespace

// The group bboxes of a stream's chunk bboxes (the raster entries launch
// the same kernel first): group_bbox (4, ceil(n_chunks / 32)) f32.
VKTF_EXPORT int vktf_raster_groups(const float* chunk_bbox, float* group_bbox, int n_chunks,
                                   cudaStream_t stream) {
  return chunk_groups(chunk_bbox, group_bbox, n_chunks, stream);
}

// The planes of the rows y_offset .. y_offset + height of the frame;
// vktf_raster is the whole frame from row 0. group_bbox (4, ceil(n_chunks /
// 32)) f32 is written, then read by the raster.
VKTF_EXPORT int vktf_raster_band(const float* tri_data, const float* tri_bbox,
                                 const float* chunk_bbox, float* group_bbox, int* out_id,
                                 float* out_depth, int n_chunks, int height, int width,
                                 int samples, int layers, int y_offset, const float* offsets,
                                 cudaStream_t stream) {
  return raster_band<false>(tri_data, tri_bbox, chunk_bbox, group_bbox, out_id, out_depth,
                            n_chunks, height, width, samples, layers, y_offset, offsets, stream);
}

VKTF_EXPORT int vktf_raster(const float* tri_data, const float* tri_bbox, const float* chunk_bbox,
                            float* group_bbox, int* out_id, float* out_depth, int n_chunks,
                            int height, int width, int samples, int layers, const float* offsets,
                            cudaStream_t stream) {
  return vktf_raster_band(tri_data, tri_bbox, chunk_bbox, group_bbox, out_id, out_depth, n_chunks,
                          height, width, samples, layers, 0, offsets, stream);
}

// The winner form of the same rows: out_tri (layers, height * width) i32,
// out_frac (height * width) f32.
VKTF_EXPORT int vktf_raster_winner(const float* tri_data, const float* tri_bbox,
                                   const float* chunk_bbox, float* group_bbox, int* out_tri,
                                   float* out_frac, int n_chunks, int height, int width,
                                   int samples, int layers, int y_offset, const float* offsets,
                                   cudaStream_t stream) {
  return raster_band<true>(tri_data, tri_bbox, chunk_bbox, group_bbox, out_tri, out_frac,
                           n_chunks, height, width, samples, layers, y_offset, offsets, stream);
}
