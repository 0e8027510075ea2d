// Per-triangle shade table (ops/shade_table.py).
//
// Replaces vktf_tpu/ops/shade_table.py `_table_build_kernel` (the Pallas
// call in build_shade_table_pallas). One thread per triangle: reads its
// component-major columns (coalesced across the warp), computes the 64 f32
// columns — w plane, uv / world-position / normal / tangent attribute
// planes (cofactor edge planes x world corners), 15 static material
// columns, the plane anchor — and writes its (64,) row. The TPU kernel's
// u16 hi|lo split exists for the TPU's gather unit; this table stays f32.
#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr int kStatic = 15;

__global__ void table_kernel(const float* __restrict__ edge9, const float* __restrict__ tc,
                             const float* __restrict__ stat, const float* __restrict__ anchor2,
                             const float* __restrict__ mrt, float* __restrict__ table, int t) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= t) return;
  auto E = [&](int i, int c) { return edge9[(size_t)(3 * i + c) * t + k]; };
  auto TC = [&](int r) { return tc[(size_t)r * t + k]; };
  auto M = [&](int r) { return mrt[(size_t)r * t + k]; };

  float e[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c) e[i][c] = E(i, c);

  float* out = table + (size_t)k * kRow;
  int col = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[col++] = e[0][c] + e[1][c] + e[2][c];

  // plane of one attribute channel from its 3 corner values
  auto planes = [&](float a0, float a1, float a2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[col++] = fma_rn(e[2][c], a2, fma_rn(e[0][c], a0, e[1][c] * a1));
  };
  // uv: rows 0..5 (channel ch of corner i at ch * 3 + i)
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) planes(TC(ch * 3 + 0), TC(ch * 3 + 1), TC(ch * 3 + 2));
  // world position (translated), normal, tangent xyz (rotated), tangent w
  const int bases[3] = {6, 15, 24};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int base = bases[a];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v[i] = fma_rn(M(ch * 4 + 2), TC(base + 6 + i),
                      fma_rn(M(ch * 4 + 0), TC(base + i), M(ch * 4 + 1) * TC(base + 3 + i)));
        if (a == 0) v[i] = v[i] + M(ch * 4 + 3);
      }
      planes(v[0], v[1], v[2]);
    }
  }
  planes(TC(33), TC(34), TC(35));
#pragma unroll
  for (int r = 0; r < kStatic; ++r) out[col++] = stat[(size_t)r * t + k];
  out[col++] = anchor2[k];
  out[col++] = anchor2[(size_t)t + k];
  while (col < kRow) out[col++] = 0.0f;
}

}  // namespace

VKTF_EXPORT int vktf_shade_table(const float* edge9, const float* tri_corner,
                                 const float* static_cols, const float* anchor2,
                                 const float* mrowsT, float* table, int t, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (t + threads - 1) / threads;
  table_kernel<<<blocks, threads, 0, stream>>>(edge9, tri_corner, static_cols, anchor2, mrowsT,
                                               table, t);
  return launch_status();
}
