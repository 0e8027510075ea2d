// Per-triangle shade table (ops/shade_table.py).
//
// Replaces vktf_tpu/ops/shade_table.py `_table_build_kernel` (the Pallas
// call in build_shade_table_pallas). Each triangle's (64,) f32 row: w plane,
// uv / world-position / normal / tangent attribute planes (cofactor edge
// planes x world corners), 15 static material columns, the plane anchor,
// eight zeros. The TPU kernel's u16 hi|lo split exists for the TPU's gather
// unit; this table stays f32.
//
// Bound by bytes: 62 input floats, a 4-byte instance index and 64 output
// floats per triangle, against ~600 flops. A block owns kBlock consecutive
// triangles, one thread each, and their rows form one contiguous span of
// the table. A thread reads its component-major inputs (coalesced across
// the warp) and its instance's matrix (three 16-byte loads from the (I, 16)
// rows, which stay in cache), and writes each column into a shared tile as
// soon as it is computed. The tile is XOR-swizzled, column c of row r at
// r * 64 + (c ^ (r & 31)): a warp's column writes (32 rows, one column) hit
// 32 banks, and the 16-byte row reads (eight lanes per 128 bytes of one
// row) hit distinct 16-byte slots. After one barrier the block writes its
// span with 16-byte stores by consecutive threads.
#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr int kStatic = 15;
constexpr int kBlock = 128;  // triangles (and threads) per block: a 32 KB tile

__device__ __forceinline__ int swizzle(int r, int c) { return r * kRow + (c ^ (r & 31)); }

__global__ void __launch_bounds__(kBlock)
    table_kernel(const float* __restrict__ edge9, const float* __restrict__ tc,
                 const float* __restrict__ stat, const float* __restrict__ anchor2,
                 const float4* __restrict__ inst_rows, const int* __restrict__ tri_instance,
                 float* __restrict__ table, int t) {
  __shared__ __align__(16) float tile[kBlock * kRow];
  const int r = threadIdx.x;
  const int k0 = blockIdx.x * kBlock;
  const int k = k0 + r;
  if (k < t) {
    auto E = [&](int i, int c) { return edge9[(size_t)(3 * i + c) * t + k]; };
    auto TC = [&](int row) { return tc[(size_t)row * t + k]; };
    int col = 0;
    auto put = [&](float v) { tile[swizzle(r, col++)] = v; };

    float e[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) e[i][c] = E(i, c);
#pragma unroll
    for (int c = 0; c < 3; ++c) put(e[0][c] + e[1][c] + e[2][c]);

    // plane of one attribute channel from its 3 corner values
    auto planes = [&](float a0, float a1, float a2) {
#pragma unroll
      for (int c = 0; c < 3; ++c) put(fma_rn(e[2][c], a2, fma_rn(e[0][c], a0, e[1][c] * a1)));
    };
    // uv: rows 0..5 (channel ch of corner i at ch * 3 + i)
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) planes(TC(ch * 3 + 0), TC(ch * 3 + 1), TC(ch * 3 + 2));
    // the instance matrix's first three rows (row ch: m[0..3])
    const float4* m4 = inst_rows + (size_t)tri_instance[k] * 4;
    const float4 mr[3] = {__ldg(m4), __ldg(m4 + 1), __ldg(m4 + 2)};
    // world position (translated), normal, tangent xyz (rotated), tangent w
    const int bases[3] = {6, 15, 24};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int base = bases[a];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float4 m = mr[ch];
        float v[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v[i] = fma_rn(m.z, TC(base + 6 + i), fma_rn(m.x, TC(base + i), m.y * TC(base + 3 + i)));
          if (a == 0) v[i] = v[i] + m.w;
        }
        planes(v[0], v[1], v[2]);
      }
    }
    planes(TC(33), TC(34), TC(35));
#pragma unroll
    for (int s = 0; s < kStatic; ++s) put(stat[(size_t)s * t + k]);
    put(anchor2[k]);
    put(anchor2[(size_t)t + k]);
    while (col < kRow) put(0.0f);
  }
  __syncthreads();

  // the span: rows k0 .. k0 + rows - 1, as float4s in table order
  const int rows = min(kBlock, t - k0);
  float4* dst = reinterpret_cast<float4*>(table + (size_t)k0 * kRow);
  for (int i = threadIdx.x; i < rows * (kRow / 4); i += kBlock) {
    const int rr = i / (kRow / 4);
    const int c = (i % (kRow / 4)) * 4;
    const int m = rr & 3;  // slot p of the 16-byte group holds column c + (p ^ m)
    float4 v = *reinterpret_cast<const float4*>(&tile[rr * kRow + (c ^ (rr & 28))]);
    if (m & 1) {
      const float x = v.x, z = v.z;
      v.x = v.y; v.y = x; v.z = v.w; v.w = z;
    }
    if (m & 2) {
      const float x = v.x, y = v.y;
      v.x = v.z; v.y = v.w; v.z = x; v.w = y;
    }
    dst[i] = v;
  }
}

}  // namespace

VKTF_EXPORT int vktf_shade_table(const float* edge9, const float* tri_corner,
                                 const float* static_cols, const float* anchor2,
                                 const float* inst_rows, const int* tri_instance, float* table,
                                 int t, cudaStream_t stream) {
  const int blocks = (t + kBlock - 1) / kBlock;
  table_kernel<<<blocks, kBlock, 0, stream>>>(edge9, tri_corner, static_cols, anchor2,
                                              reinterpret_cast<const float4*>(inst_rows),
                                              tri_instance, table, t);
  return launch_status();
}
