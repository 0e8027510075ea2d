// Streaming visibility raster with a K-layer depth peel (ops/raster.py).
//
// Replaces vktf_tpu/ops/raster_pallas.py `_raster_kernel`, K = 1..8 layers.
// One 256-thread block per 16x16-pixel block; each thread owns one pixel
// and keeps, for each of its S samples, the K lexicographically nearest
// (depth, id) fragments in registers, sorted, so every sample has exactly
// one writer and nothing races. The block walks the stream's chunks in
// rounds of 256: each thread tests one chunk bbox against the block, the
// hits are listed in shared memory, and for each hit chunk the block stages
// its 24 stream rows and 8 bbox rows (32 KB) in shared memory, then skips
// groups whose bbox misses the block, then triangles whose bbox misses it,
// and each thread tests its pixel against the triangle's bbox before
// evaluating the samples. A passing fragment is inserted into the sample's
// sorted list as raster_pallas.py:831-852 does (it bubbles down, and each
// entry it displaces continues down in its place); the list is a set of the
// K smallest (depth, draw-order id) keys, so the order in which chunks are
// visited does not change the output. The list length is a template
// parameter rounded up to 1, 2, 4 or 8 (the first K entries of a longer
// sorted list are the K nearest); fully unrolled, the S x K x 2 words stay
// in registers.
#include "common.cuh"

namespace {

constexpr int kBlock = 16;
constexpr int kThreads = kBlock * kBlock;
constexpr int kChunk = 256;
constexpr int kGroup = 8;
constexpr int kRows = 24;  // tri_data rows
constexpr int kBoxRows = 8;

// MSAA sample offsets (config.SAMPLE_OFFSETS), passed by value
struct Offsets {
  float v[8][2];
};

// anchored plane a*dx + b*dy + c, contracted as ops/raster.py _plane
__device__ __forceinline__ float plane(const float* r, float dxx, float dyy) {
  return fma_rn(r[kChunk], dyy, r[0] * dxx) + r[2 * kChunk];
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads) raster_kernel(
    const float* __restrict__ tri_data, const float* __restrict__ tri_bbox,
    const float* __restrict__ chunk_bbox, int* __restrict__ out_id,
    float* __restrict__ out_depth, int n_chunks, int height, int width, int layers,
    Offsets off) {
  __shared__ float rows[kRows + kBoxRows][kChunk];
  __shared__ int hit_list[kThreads];
  __shared__ int hit_count;

  const int tid = threadIdx.y * kBlock + threadIdx.x;
  const int bx0 = blockIdx.x * kBlock, by0 = blockIdx.y * kBlock;
  const int px = bx0 + threadIdx.x, py = by0 + threadIdx.y;
  const float fbx0 = (float)bx0, fby0 = (float)by0;
  const float fbx1 = fbx0 + kBlock, fby1 = fby0 + kBlock;
  const float fpx = (float)px, fpy = (float)py;
  const size_t t_pad = (size_t)n_chunks * kChunk;

  // per sample, K (depth, id) slots sorted nearest first; clear (1.0, -1)
  float best_d[S][K];
  int best_i[S][K];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      best_d[s][l] = 1.0f;
      best_i[s][l] = -1;
    }
  }

  for (int base = 0; base < n_chunks; base += kThreads) {
    if (tid == 0) hit_count = 0;
    __syncthreads();
    const int c = base + tid;
    if (c < n_chunks) {
      const bool hit = chunk_bbox[c] < fbx1 && chunk_bbox[n_chunks + c] < fby1 &&
                       chunk_bbox[2 * n_chunks + c] > fbx0 &&
                       chunk_bbox[3 * n_chunks + c] > fby0;
      if (hit) hit_list[atomicAdd(&hit_count, 1)] = c;
    }
    __syncthreads();
    const int hits = hit_count;
    for (int h = 0; h < hits; ++h) {
      const size_t col = (size_t)hit_list[h] * kChunk + tid;
#pragma unroll
      for (int r = 0; r < kRows; ++r) rows[r][tid] = tri_data[r * t_pad + col];
#pragma unroll
      for (int r = 0; r < kBoxRows; ++r) rows[kRows + r][tid] = tri_bbox[r * t_pad + col];
      __syncthreads();
      for (int g = 0; g < kChunk / kGroup; ++g) {
        const int k0 = g * kGroup;
        // group bbox (rows 4..7 of tri_bbox), block-uniform
        if (!(rows[kRows + 4][k0] < fbx1 && rows[kRows + 6][k0] > fbx0 &&
              rows[kRows + 5][k0] < fby1 && rows[kRows + 7][k0] > fby0))
          continue;
        const bool slim = rows[19][k0] > 0.0f;  // group-uniform flag
        for (int kk = k0; kk < k0 + kGroup; ++kk) {
          const float tx0 = rows[kRows + 0][kk], ty0 = rows[kRows + 1][kk];
          const float tx1 = rows[kRows + 2][kk], ty1 = rows[kRows + 3][kk];
          if (!(rows[15][kk] >= 0.0f && tx0 < fbx1 && tx1 > fbx0 && ty0 < fby1 && ty1 > fby0))
            continue;
          if (!(fpx >= tx0 && fpx < tx1 && fpy >= ty0 && fpy < ty1)) continue;
          const int id = (int)rows[15][kk];
          const int thr0 = (int)rows[16][kk], thr1 = (int)rows[17][kk], thr2 = (int)rows[18][kk];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float dxx = (fpx + off.v[s][0]) - tx0;
            const float dyy = (fpy + off.v[s][1]) - ty0;
            bool ok = __float_as_int(plane(&rows[0][kk], dxx, dyy)) > thr0 &&
                      __float_as_int(plane(&rows[3][kk], dxx, dyy)) > thr1 &&
                      __float_as_int(plane(&rows[6][kk], dxx, dyy)) > thr2;
            const float depth = plane(&rows[9][kk], dxx, dyy);
            if (!slim) {
              const float w_recip = plane(&rows[12][kk], dxx, dyy);
              ok = ok && w_recip > 0.0f && __float_as_uint(depth) <= 0x3F800000u;
            }
            // sorted insertion: the candidate bubbles down, a displaced
            // entry continues down in its place (nothing moves unless the
            // candidate is nearer than the last slot)
            if (ok && (depth < best_d[s][K - 1] ||
                       (depth == best_d[s][K - 1] && id < best_i[s][K - 1]))) {
              float cd = depth;
              int ci = id;
#pragma unroll
              for (int l = 0; l < K; ++l) {
                const float dl = best_d[s][l];
                const int il = best_i[s][l];
                const bool swap = cd < dl || (cd == dl && ci < il);
                best_d[s][l] = swap ? cd : dl;
                best_i[s][l] = swap ? ci : il;
                cd = swap ? dl : cd;
                ci = swap ? il : ci;
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }
  // output (layers, S, height, width): layer-major, layers <= K
  if (px < width && py < height) {
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l >= layers) break;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t o = (((size_t)l * S + s) * height + py) * width + px;
        out_id[o] = best_i[s][l];
        out_depth[o] = best_d[s][l];
      }
    }
  }
}

template <int S, int K>
void launch(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
            const float* tri_bbox, const float* chunk_bbox, int* out_id, float* out_depth,
            int n_chunks, int height, int width, int layers, const Offsets& off) {
  raster_kernel<S, K><<<blocks, threads, 0, stream>>>(tri_data, tri_bbox, chunk_bbox, out_id,
                                                      out_depth, n_chunks, height, width,
                                                      layers, off);
}

template <int S>
int launch_layers(dim3 blocks, dim3 threads, cudaStream_t stream, const float* tri_data,
                  const float* tri_bbox, const float* chunk_bbox, int* out_id, float* out_depth,
                  int n_chunks, int height, int width, int layers, const Offsets& off) {
  if (layers == 1)
    launch<S, 1>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, off);
  else if (layers == 2)
    launch<S, 2>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, off);
  else if (layers <= 4)
    launch<S, 4>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, off);
  else if (layers <= 8)
    launch<S, 8>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id, out_depth,
                 n_chunks, height, width, layers, off);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}

}  // namespace

VKTF_EXPORT int vktf_raster(const float* tri_data, const float* tri_bbox, const float* chunk_bbox,
                            int* out_id, float* out_depth, int n_chunks, int height, int width,
                            int samples, int layers, const float* offsets, cudaStream_t stream) {
  if (layers < 1) return (int)cudaErrorInvalidValue;
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
                              out_depth, n_chunks, height, width, layers, off);
    case 2:
      return launch_layers<2>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, off);
    case 4:
      return launch_layers<4>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, off);
    case 8:
      return launch_layers<8>(blocks, threads, stream, tri_data, tri_bbox, chunk_bbox, out_id,
                              out_depth, n_chunks, height, width, layers, off);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
