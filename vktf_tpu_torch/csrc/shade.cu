// Deferred shade: MSAA resolve form and depth-peel layer form
// (ops/shade_kernel.py).
//
// Replaces vktf_tpu/ops/shade_kernel.py `_shade_resolve_kernel` and
// `_shade_layer_kernel` (body `_shade_block_body`, fused-pool branch, one
// tap), launched by `_shade_final_call` via `shade_final_chunk`. One thread
// per pixel (per layer and pixel in the layer form): it
// reads its winning triangle's 256-byte shade-table row and the one
// fused-mip pool row that holds both trilinear levels of all three material
// textures, evaluates the planes at the pixel centre, filters, shades over
// the lights, then either writes the resolved, sRGB-encoded pixel as
// r | g<<8 | b<<16 (resolve form) or its linear radiance and alpha (layer
// form). Both row gathers happen here, so no per-pixel phase-boundary
// tensor exists.
#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr int kSlotU32 = 27;
constexpr float kPi = 3.1415927f;
constexpr float kEpsilon = 1.0e-7f;
constexpr float kPointLightRadius = 0.1f;

// shade-table columns (ops/shade_table.py)
constexpr int C_UV = 3, C_WPOS = 9, C_NRM = 18, C_TAN = 27, C_BASE = 39, C_MR = 43,
              C_NSCALE = 45, C_MROW = 46, C_MW0 = 47, C_MLEVELS = 48, C_SAMP0 = 49,
              C_AMODE = 52, C_ACUT = 53, C_AX = 54, C_AY = 55;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 rnorm(float x, float y, float z) {
  const float r = rsqrtf(tmax(fma_rn(z, z, fma_rn(x, x, y * y)), 1e-20f));
  return V3{x * r, y * r, z * r};
}
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return fma_rn(a.z, b.z, fma_rn(a.x, b.x, a.y * b.y));
}
__device__ __forceinline__ float srgb_to_linear(float c) {
  return c <= 0.04045f ? c / 12.92f : powf((c + 0.055f) / 1.055f, 2.4f);
}
__device__ __forceinline__ int wrap_coord(int i, int size, int mode) {
  size = max(size, 1);
  const int repeat = i & (size - 1);
  const int clamp = min(max(i, 0), size - 1);
  const int m = i & (2 * size - 1);
  const int mirror = m >= size ? 2 * size - 1 - m : m;
  return mode == 0 ? repeat : (mode == 1 ? clamp : mirror);
}

struct TexParams {
  float u, v, lfrac;
  int l0, l1, base_row, w0, max_level, wrap_u, wrap_v;
  bool nearest;
};

struct LevelAddr {
  int row, x0, y0;
  float fx, fy;
};

__device__ __forceinline__ LevelAddr level_addr(const TexParams& tp, int level) {
  const int wl = max(tp.w0 >> level, 1);
  const float wlf = (float)wl;
  const float x = fma_rn(tp.u, wlf, -0.5f);
  const float y = fma_rn(tp.v, wlf, -0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  float fx = x - x0f, fy = y - y0f;
  if (tp.nearest) {
    fx = fx >= 0.5f ? 1.0f : 0.0f;
    fy = fy >= 0.5f ? 1.0f : 0.0f;
  }
  LevelAddr a;
  a.x0 = wrap_coord((int)x0f, wl, tp.wrap_u);
  a.y0 = wrap_coord((int)y0f, wl, tp.wrap_v);
  a.fx = fx;
  a.fy = fy;
  const int b0 = max(tp.w0 >> 1, 1);
  const int bl = max(b0 >> level, 1);
  const int extra = (level == tp.max_level && tp.max_level > 0) ? 1 : 0;
  const int offset = 4 * (b0 * b0 - bl * bl) / 3 + extra;
  const int bw = max(tp.w0 >> (level + 1), 1);
  a.row = tp.base_row + offset + (a.y0 >> 1) * bw + (a.x0 >> 1);
  return a;
}

struct Texels {  // the 2x2 window of one level: base + lane offset per tap
  const uint32_t* row;
  int base, cx, cy;
  __device__ __forceinline__ uint32_t at(int slot, int i, int j) const {
    return row[base + slot * 9 + (i + cy) * 3 + (j + cx)];
  }
};

__device__ __forceinline__ void filter_slot(const Texels& tx, int slot, float fx, float fy,
                                            bool srgb, float out[4]) {
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const uint32_t taps[4] = {tx.at(slot, 0, 0), tx.at(slot, 0, 1), tx.at(slot, 1, 0),
                            tx.at(slot, 1, 1)};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = (float)((taps[q] >> (8 * ch)) & 0xFFu) / 255.0f;
      if (srgb && ch < 3) v[q] = srgb_to_linear(v[q]);
    }
    out[ch] = fma_rn(v[3], w11, fma_rn(v[2], w01, fma_rn(v[0], w00, v[1] * w10)));
  }
}

__device__ __forceinline__ void material_brdf(const float base[3], float metallic,
                                              float roughness, V3 l, V3 n, V3 v, float out[3]) {
  const V3 h = rnorm(l.x + v.x, l.y + v.y, l.z + v.z);
  const float alpha = roughness * roughness;
  const float alpha2 = alpha * alpha;
  const float h_dot_v = dot3(h, v), h_dot_l = dot3(h, l);
  const float n_dot_l = dot3(n, l), n_dot_v = dot3(n, v), n_dot_h = dot3(n, h);
  const float one_minus_metal = 1.0f - metallic;
  const float fres_pow = powf(1.0f - fabsf(h_dot_v), 5.0f);
  auto smith_half = [&](float nd) {
    return (fabsf(nd) + sqrtf(fma_rn((1.0f - alpha2) * nd, nd, alpha2))) + kEpsilon;
  };
  const float visibility = ((h_dot_l >= 0.0f ? 1.0f : 0.0f) / smith_half(n_dot_l) *
                            (h_dot_v >= 0.0f ? 1.0f : 0.0f)) /
                           smith_half(n_dot_v);
  const float d_denom = fma_rn(n_dot_h * n_dot_h, alpha2 - 1.0f, 1.0f);
  const float distribution =
      ((n_dot_h >= 0.0f ? 1.0f : 0.0f) * alpha2) / fma_rn(kPi * d_denom, d_denom, kEpsilon);
  const float spec_scale = visibility * distribution;
  const float diffuse_scale = one_minus_metal / kPi;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = fma_rn(0.04f, one_minus_metal, base[c] * metallic);
    const float fresnel = fma_rn(1.0f - f0, fres_pow, f0);
    out[c] = fma_rn((1.0f - fresnel) * diffuse_scale, base[c], fresnel * spec_scale);
  }
}

// The fragment body shared by both forms: the pixel's radiance over the
// lights and its effective alpha (0 when uncovered). The math is
// ops/shade_kernel.py _fragment_plain op for op.
__device__ __forceinline__ void shade_fragment(int t, float sx, float sy,
                                               const float* __restrict__ table,
                                               const uint32_t* __restrict__ pool,
                                               const float* __restrict__ params, int num_lights,
                                               int pool_rows, float max_anisotropy,
                                               float max_anisotropy2, float radiance[3],
                                               float* alpha_out) {
  const bool covered = t >= 0;
  const float* row = table + (size_t)max(t, 0) * kRow;
  auto col = [&](int c) { return __ldg(row + c); };

  const float sxa = sx - col(C_AX);
  const float sya = sy - col(C_AY);
  const float w = fma_rn(col(0), sxa, col(1) * sya) + col(2);
  const float inv_w = 1.0f / (fabsf(w) < 1e-30f ? 1e-30f : w);
  auto attr = [&](int c0) { return (fma_rn(col(c0), sxa, col(c0 + 1) * sya) + col(c0 + 2)) * inv_w; };

  // sampler LOD stage (per texture slot: only the sampler code differs)
  const float u = attr(C_UV), v = attr(C_UV + 3);
  const float du_dx = fma_rn(-u, col(0), col(C_UV)) * inv_w;
  const float du_dy = fma_rn(-u, col(1), col(C_UV + 1)) * inv_w;
  const float dv_dx = fma_rn(-v, col(0), col(C_UV + 3)) * inv_w;
  const float dv_dy = fma_rn(-v, col(1), col(C_UV + 4)) * inv_w;
  const float w0f = col(C_MW0);
  const float max_level = col(C_MLEVELS) - 1.0f;
  const float pxd = du_dx * w0f, qxd = dv_dx * w0f;
  const float pyd = du_dy * w0f, qyd = dv_dy * w0f;
  const float ddx2 = fma_rn(pxd, pxd, qxd * qxd);
  const float ddy2 = fma_rn(pyd, pyd, qyd * qyd);
  const float tiny = 1e-24f;
  const float rho_max2 = tmax(tmax(ddx2, ddy2), tiny);
  float lod;
  if (max_anisotropy > 1.0f) {
    const float rho_min2 = tmax(tmin(ddx2, ddy2), tiny);
    const float limit2 = rho_min2 * max_anisotropy2;
    lod = 0.5f * log2f(tmax(tmin(rho_max2, limit2), tiny));
  } else {
    lod = 0.5f * log2f(rho_max2);
  }
  lod = tmin(tmax(lod, 0.0f), max_level);
  const float level0 = floorf(lod);
  TexParams tp[3];
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    TexParams& q = tp[slot];
    q.u = u;
    q.v = v;
    q.base_row = (int)col(C_MROW);
    q.w0 = (int)w0f;
    q.max_level = (int)max_level;
    const int code = (int)col(C_SAMP0 + slot);
    const float lfrac = lod - level0;
    q.lfrac = (code & 64) ? (lfrac >= 0.5f ? 1.0f : 0.0f) : lfrac;
    const bool is_mag = lod <= 0.0f;
    q.nearest = (is_mag && (code & 16)) || (!is_mag && (code & 32));
    q.l0 = (int)level0;
    q.l1 = min(q.l0 + 1, (int)max_level);
    q.wrap_u = code & 3;
    q.wrap_v = (code >> 2) & 3;
  }

  // fused-mip addressing: one pool row serves both levels
  const LevelAddr a0 = level_addr(tp[0], tp[0].l0);
  const LevelAddr a1 = level_addr(tp[0], tp[0].l1);
  const bool l1_eq = tp[0].l1 == tp[0].l0;
  const uint32_t* prow = pool + (size_t)min(max(a0.row, 0), pool_rows - 1) * kRow;
  const Texels tex0{prow, 0, a0.x0 & 1, a0.y0 & 1};
  const Texels tex_b{prow, kSlotU32, a1.x0 == (a0.x0 >> 1) ? 1 : 0, a1.y0 == (a0.y0 >> 1) ? 1 : 0};
  const Texels tex1 = l1_eq ? tex0 : tex_b;

  float slot_tex[3][4];
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const LevelAddr s0a = level_addr(tp[slot], tp[slot].l0);
    const LevelAddr s1a = level_addr(tp[slot], tp[slot].l1);
    float s0[4], s1[4];
    filter_slot(tex0, slot, s0a.fx, s0a.fy, slot == 0, s0);
    filter_slot(tex1, slot, s1a.fx, s1a.fy, slot == 0, s1);
    const float lfrac = tp[slot].lfrac;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) slot_tex[slot][ch] = fma_rn(s0[ch], 1.0f - lfrac, s1[ch] * lfrac);
  }

  // TBN + normal mapping
  const V3 wp{attr(C_WPOS), attr(C_WPOS + 3), attr(C_WPOS + 6)};
  const float nr[3] = {attr(C_NRM), attr(C_NRM + 3), attr(C_NRM + 6)};
  const float tg[4] = {attr(C_TAN), attr(C_TAN + 3), attr(C_TAN + 6), attr(C_TAN + 9)};
  float base_rgba[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) base_rgba[c] = col(C_BASE + c) * slot_tex[0][c];
  const float metallic = col(C_MR) * slot_tex[1][2];
  const float roughness = col(C_MR + 1) * slot_tex[1][1];
  const V3 nrm = rnorm(nr[0], nr[1], nr[2]);
  const V3 tang = rnorm(tg[0], tg[1], tg[2]);
  const V3 bn = rnorm(fma_rn(nrm.y, tang.z, -(nrm.z * tang.y)),
                      fma_rn(nrm.z, tang.x, -(nrm.x * tang.z)),
                      fma_rn(nrm.x, tang.y, -(nrm.y * tang.x)));
  const V3 bit{bn.x * tg[3], bn.y * tg[3], bn.z * tg[3]};
  const float ns = col(C_NSCALE);
  const float snx = fma_rn(2.0f, slot_tex[2][0], -1.0f) * ns;
  const float sny = fma_rn(2.0f, slot_tex[2][1], -1.0f) * ns;
  const float snz = fma_rn(2.0f, slot_tex[2][2], -1.0f);
  const V3 normal = rnorm(fma_rn(nrm.x, snz, fma_rn(tang.x, snx, bit.x * sny)),
                          fma_rn(nrm.y, snz, fma_rn(tang.y, snx, bit.y * sny)),
                          fma_rn(nrm.z, snz, fma_rn(tang.z, snx, bit.z * sny)));
  const V3 view = rnorm(params[0] - wp.x, params[1] - wp.y, params[2] - wp.z);

  // BRDF over the lights (fragment.glsl's light loop)
  radiance[0] = radiance[1] = radiance[2] = 0.0f;
  for (int i = 0; i < num_lights; ++i) {
    const float* light = params + 8 + 8 * i;
    const float hp = light[3] != 0.0f ? 1.0f : 0.0f;
    const float lvx = fma_rn(-hp, wp.x, light[0]);
    const float lvy = fma_rn(-hp, wp.y, light[1]);
    const float lvz = fma_rn(-hp, wp.z, light[2]);
    const float dist = tmax(sqrtf(tmax(fma_rn(lvz, lvz, fma_rn(lvx, lvx, lvy * lvy)), 1e-20f)),
                            kPointLightRadius);
    const float attenuation = (1.0f - hp) + hp / (dist * dist);
    const float inv = 1.0f / dist;
    const V3 l{lvx * inv, lvy * inv, lvz * inv};
    float brdf[3];
    material_brdf(base_rgba, metallic, roughness, l, normal, view, brdf);
    const float scale = attenuation * tmax(dot3(normal, l), 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float term = scale * light[4 + c];
      radiance[c] = i == 0 ? term * brdf[c] : fma_rn(term, brdf[c], radiance[c]);
    }
  }

  // glTF alpha mode
  const float a = base_rgba[3];
  const float amode = col(C_AMODE);
  const float alpha = amode == 0.0f ? 1.0f : (amode == 1.0f ? (a >= col(C_ACUT) ? 1.0f : 0.0f) : a);
  *alpha_out = covered ? alpha : 0.0f;
}

// sRGB encode and u8 quantization of a value in [0, 1]
__device__ __forceinline__ int srgb_u8(float v) {
  const float srgb =
      v <= 0.0031308f ? v * 12.92f : fma_rn(1.055f, powf(v, (float)(1.0 / 2.4)), -0.055f);
  return (int)fma_rn(srgb, 255.0f, 0.5f);
}

// Resolve form (one layer): composite over the clear colour, coverage
// resolve, sRGB encode, packed r | g << 8 | b << 16.
__global__ void shade_kernel(const int* __restrict__ tri, const float* __restrict__ sx_in,
                             const float* __restrict__ sy_in, const float* __restrict__ frac_in,
                             const float* __restrict__ table, const uint32_t* __restrict__ pool,
                             const float* __restrict__ params, int* __restrict__ out, int n,
                             int num_lights, int pool_rows, float max_anisotropy,
                             float max_anisotropy2) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int t = tri[p];
  float radiance[3], alpha;
  shade_fragment(t, sx_in[p], sy_in[p], table, pool, params, num_lights, pool_rows,
                 max_anisotropy, max_anisotropy2, radiance, &alpha);
  const bool covered = t >= 0;
  const float frac = frac_in[p];
  int packed = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bg = params[4 + c];
    const float rgb = covered ? radiance[c] : 0.0f;
    const float comp = fma_rn(rgb, alpha, bg * (1.0f - alpha));
    const float resolved = fma_rn(comp, frac, bg * (1.0f - frac));
    packed |= srgb_u8(tmin(tmax(resolved, 0.0f), 1.0f)) << (8 * c);
  }
  out[p] = packed;
}

// Layer form: every (layer, pixel) of a (K, N) id array, one thread each;
// linear radiance (K, 3, N) and effective alpha (K, N) for the host-side
// composite. An uncovered entry writes zeros and returns.
__global__ void shade_layer_kernel(const int* __restrict__ tri, const float* __restrict__ sx_in,
                                   const float* __restrict__ sy_in,
                                   const float* __restrict__ table,
                                   const uint32_t* __restrict__ pool,
                                   const float* __restrict__ params, float* __restrict__ out_rgb,
                                   float* __restrict__ out_alpha, int n, int layers,
                                   int num_lights, int pool_rows, float max_anisotropy,
                                   float max_anisotropy2) {
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (size_t)n * layers) return;
  const size_t l = q / n;
  const size_t p = q - l * n;
  const int t = tri[q];
  float radiance[3] = {0.0f, 0.0f, 0.0f}, alpha = 0.0f;
  if (t >= 0)
    shade_fragment(t, sx_in[p], sy_in[p], table, pool, params, num_lights, pool_rows,
                   max_anisotropy, max_anisotropy2, radiance, &alpha);
#pragma unroll
  for (int c = 0; c < 3; ++c) out_rgb[(l * 3 + c) * n + p] = radiance[c];
  out_alpha[q] = alpha;
}

}  // namespace

VKTF_EXPORT int vktf_shade_resolve(const int* tri, const float* sx, const float* sy,
                                   const float* frac, const float* table, const uint32_t* pool,
                                   const float* params, int* out, int n, int num_lights,
                                   int pool_rows, float max_anisotropy, float max_anisotropy2,
                                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  shade_kernel<<<blocks, threads, 0, stream>>>(tri, sx, sy, frac, table, pool, params, out, n,
                                               num_lights, pool_rows, max_anisotropy,
                                               max_anisotropy2);
  return launch_status();
}

VKTF_EXPORT int vktf_shade_layer(const int* tri, const float* sx, const float* sy,
                                 const float* table, const uint32_t* pool, const float* params,
                                 float* out_rgb, float* out_alpha, int n, int layers,
                                 int num_lights, int pool_rows, float max_anisotropy,
                                 float max_anisotropy2, cudaStream_t stream) {
  const int threads = 128;
  const long long total = (long long)n * layers;
  const int blocks = (int)((total + threads - 1) / threads);
  shade_layer_kernel<<<blocks, threads, 0, stream>>>(tri, sx, sy, table, pool, params, out_rgb,
                                                     out_alpha, n, layers, num_lights, pool_rows,
                                                     max_anisotropy, max_anisotropy2);
  return launch_status();
}
