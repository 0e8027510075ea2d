// Deferred shade: the MSAA resolve form and the depth-peel layer form of
// every texture configuration (ops/shade_kernel.py).
//
// Replaces vktf_tpu/ops/shade_kernel.py `_shade_resolve_kernel` and
// `_shade_layer_kernel` (body `_shade_block_body`: the fused-pool branch
// with one tap or N taps, and the two-gather `q1` branch),
// `_attrs_resolve_kernel` and `_attrs_layer_kernel` (body
// `_attrs_block_body`), all launched by `_shade_final_call`, and the XLA
// form shade_table.shade_table_layer the JAX package runs for per-slot
// samplers and for the taps of a two-gather scene. A fragment is
//   * an input stage: the triangle's shade-table row (ColsShade), read with
//     16-byte loads in two parts (what the sampler needs, then after the
//     texture fetches what the tail needs) and evaluated at the pixel
//     centre, or phase A's 28 attribute floats (AttrsShade, rows strided by
//     N: coalesced);
//   * the sampler state, computed once per fragment: the mip pair's level
//     geometry (common to the three slots) and each slot's filter and wrap;
//   * a texel source, the template parameter kSource: one fused-mip pool
//     row (slot A for l0, slot B for l1), the classic l0 and l1 rows, or
//     that pair per texture slot, addressed once per (slot, level) and tap,
//     one slot at a time; with kMultiTap the source runs once per tap at
//     the tap-shifted uv (a runtime count; 1/N is exact for 2, 4, 8) and
//     the samples are averaged;
//   * texel decode by lookup: two 256-entry tables in shared memory, u8/255
//     and its sRGB-to-linear value, filled per block with the very
//     expressions the inline decode used, so the lookup is bit-equal to it;
//   * the tail: TBN normal mapping, the BRDF over the lights, alpha mode;
// then either the resolved, sRGB-encoded pixel as r | g<<8 | b<<16
// (resolve form) or its linear radiance and alpha (layer form; an
// uncovered entry is written as zeros). One thread per pixel in both
// forms: in the layer form it walks the pixel's K layers, so a block's
// warps stay busy wherever any of their pixels has a covered layer.
//
// Bound on the card: float32 work per covered entry (the BRDF over the
// lights, the addressing and filtering of 24 texels per tap) behind a chain
// of dependent gathers (tri -> table row -> pool rows -> texels) that L2
// mostly serves. No matrix product occurs, so wgmma does not apply; the
// design cuts instructions (decode tables, addressing once) and registers
// (the row's tail columns read after sampling, one slot's state at a time),
// and ptxas keeps every instantiation at 56-104 registers with no spill.
// The alternatives measured against these choices (decode tables in global
// memory, 4-byte row loads, a thread per (layer, pixel), other block sizes
// and launch bounds) are recorded in PERF.md.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // ptxas chooses the registers
constexpr int kRow = 64;
constexpr int kRowUsed = 56;  // columns 0..55 of a table row are read
constexpr int kSlotU32 = 27;
constexpr float kPi = 3.1415927f;
constexpr float kEpsilon = 1.0e-7f;
constexpr float kPointLightRadius = 0.1f;

// texel sources (ops/shade_kernel.py TEXELS)
constexpr int kFused = 0, kClassic = 1, kPerSlot = 2;

// shade-table columns (ops/shade_table.py)
constexpr int C_UV = 3, C_WPOS = 9, C_NRM = 18, C_TAN = 27, C_BASE = 39, C_MR = 43,
              C_NSCALE = 45, C_MROW = 46, C_MW0 = 47, C_MLEVELS = 48, C_SAMP0 = 49,
              C_AMODE = 52, C_ACUT = 53, C_AX = 54, C_AY = 55;

// attrs-boundary rows (ops/shade_kernel.py A_*)
constexpr int A_FX0 = 0, A_FY0 = 1, A_FX1 = 2, A_FY1 = 3, A_LFRAC = 4, A_CX0 = 5, A_CY0 = 6,
              A_CX1 = 7, A_CY1 = 8, A_WPOS = 9, A_NRM = 12, A_TAN = 15, A_BASE = 19, A_MR = 23,
              A_NSCALE = 25, A_AMODE = 26, A_ACUT = 27, kAttrRows = 28;

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

// ---- texel decode -----------------------------------------------------------

// dec[b] = b / 255 and dec[256 + b] = its sRGB-to-linear value: the inline
// decode's own expressions, evaluated once per table entry. Every thread of
// the block calls this before any early return.
__device__ __forceinline__ const float* decode_table(float* dec) {
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    const float v = (float)(uint32_t)b / 255.0f;
    dec[b] = v;
    dec[256 + b] = srgb_to_linear(v);
  }
  __syncthreads();
  return dec;
}

// ---- sampler state and addressing -------------------------------------------

// One mip level's geometry, common to the three slots (one chain per
// material): its width and the pool row of block (0, 0).
struct LevelGeom {
  int wl, bw, row0;
  float wlf;
};

__device__ __forceinline__ LevelGeom level_geom(int w0, int base_row, int max_level, int level) {
  LevelGeom g;
  g.wl = max(w0 >> level, 1);
  g.wlf = (float)g.wl;
  const int b0 = max(w0 >> 1, 1);
  const int bl = max(b0 >> level, 1);
  const int extra = (level == max_level && max_level > 0) ? 1 : 0;
  g.row0 = base_row + 4 * (b0 * b0 - bl * bl) / 3 + extra;
  g.bw = max(w0 >> (level + 1), 1);
  return g;
}

// One slot's filter state: its lerp weight, nearest flag and wrap modes.
struct SlotSampler {
  float lfrac;
  bool nearest;
  int wrap_u, wrap_v;
};

struct LevelAddr {
  int row, x0, y0;
  float fx, fy;
};

// The footprint corner's block row and the bilinear fractions of one
// (slot, level) at (u, v).
__device__ __forceinline__ LevelAddr level_addr(const LevelGeom& g, const SlotSampler& sp,
                                                float u, float v) {
  const float x = fma_rn(u, g.wlf, -0.5f);
  const float y = fma_rn(v, g.wlf, -0.5f);
  const float x0f = floorf(x), y0f = floorf(y);
  float fx = x - x0f, fy = y - y0f;
  if (sp.nearest) {
    fx = fx >= 0.5f ? 1.0f : 0.0f;
    fy = fy >= 0.5f ? 1.0f : 0.0f;
  }
  LevelAddr a;
  a.x0 = wrap_coord((int)x0f, g.wl, sp.wrap_u);
  a.y0 = wrap_coord((int)y0f, g.wl, sp.wrap_v);
  a.fx = fx;
  a.fy = fy;
  a.row = g.row0 + (a.y0 >> 1) * g.bw + (a.x0 >> 1);
  return a;
}

// A pool row, its index clamped into the pool.
__device__ __forceinline__ const uint32_t* pool_row(const uint32_t* pool, int row,
                                                    int pool_rows) {
  return pool + (size_t)min(max(row, 0), pool_rows - 1) * kRow;
}

struct Texels {  // the 2x2 window of one level: base + lane offset per tap
  const uint32_t* row;
  int base, cx, cy;
  __device__ __forceinline__ uint32_t at(int slot, int i, int j) const {
    return row[base + slot * 9 + (i + cy) * 3 + (j + cx)];
  }
};

__device__ __forceinline__ void filter_slot(const Texels& tx, int slot, float fx, float fy,
                                            bool srgb, const float* dec, float out[4]) {
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const uint32_t taps[4] = {tx.at(slot, 0, 0), tx.at(slot, 0, 1), tx.at(slot, 1, 0),
                            tx.at(slot, 1, 1)};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float* table = dec + ((srgb && ch < 3) ? 256 : 0);
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = table[(taps[q] >> (8 * ch)) & 0xFFu];
    out[ch] = fma_rn(v[3], w11, fma_rn(v[2], w01, fma_rn(v[0], w00, v[1] * w10)));
  }
}

// One texture's trilinear sample from its l0 and l1 windows.
__device__ __forceinline__ void trilinear(const Texels& t0, const Texels& t1, int slot,
                                          float fx0, float fy0, float fx1, float fy1,
                                          float lfrac, const float* dec, float out[4]) {
  float s0[4], s1[4];
  filter_slot(t0, slot, fx0, fy0, slot == 0, dec, s0);
  filter_slot(t1, slot, fx1, fy1, slot == 0, dec, s1);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) out[ch] = fma_rn(s0[ch], 1.0f - lfrac, s1[ch] * lfrac);
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

// What the tail reads besides the texture samples.
struct SurfaceInputs {
  float base_f[4], mr_f[2], normal_scale, amode, acut;
  V3 wp;
  float nr[3], tg[4];
};

// The fragment body after texturing (ops/shade_kernel.py _fragment_tail):
// factors, TBN normal mapping, the BRDF over the lights (fragment.glsl's
// light loop), the glTF alpha mode.
__device__ __forceinline__ void shade_tail(const float slot_tex[3][4], const SurfaceInputs& s,
                                           const float* __restrict__ params, int num_lights,
                                           float radiance[3], float* alpha_out) {
  float base_rgba[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) base_rgba[c] = s.base_f[c] * slot_tex[0][c];
  const float metallic = s.mr_f[0] * slot_tex[1][2];
  const float roughness = s.mr_f[1] * slot_tex[1][1];
  const V3 nrm = rnorm(s.nr[0], s.nr[1], s.nr[2]);
  const V3 tang = rnorm(s.tg[0], s.tg[1], s.tg[2]);
  const V3 bn = rnorm(fma_rn(nrm.y, tang.z, -(nrm.z * tang.y)),
                      fma_rn(nrm.z, tang.x, -(nrm.x * tang.z)),
                      fma_rn(nrm.x, tang.y, -(nrm.y * tang.x)));
  const V3 bit{bn.x * s.tg[3], bn.y * s.tg[3], bn.z * s.tg[3]};
  const float ns = s.normal_scale;
  const float snx = fma_rn(2.0f, slot_tex[2][0], -1.0f) * ns;
  const float sny = fma_rn(2.0f, slot_tex[2][1], -1.0f) * ns;
  const float snz = fma_rn(2.0f, slot_tex[2][2], -1.0f);
  const V3 normal = rnorm(fma_rn(nrm.x, snz, fma_rn(tang.x, snx, bit.x * sny)),
                          fma_rn(nrm.y, snz, fma_rn(tang.y, snx, bit.y * sny)),
                          fma_rn(nrm.z, snz, fma_rn(tang.z, snx, bit.z * sny)));
  const V3 wp = s.wp;
  const V3 view = rnorm(params[0] - wp.x, params[1] - wp.y, params[2] - wp.z);

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

  const float a = base_rgba[3];
  *alpha_out = s.amode == 0.0f ? 1.0f : (s.amode == 1.0f ? (a >= s.acut ? 1.0f : 0.0f) : a);
}

// ---- the table-row input stage -------------------------------------------

// Columns 4i..4i+3 of a triangle's row: one 16-byte load (rows are 256
// bytes and the wrapper checks the table's 16-byte alignment).
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int i,
                                          float c[kRowUsed]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(row) + i);
  c[4 * i] = q.x;
  c[4 * i + 1] = q.y;
  c[4 * i + 2] = q.z;
  c[4 * i + 3] = q.w;
}

// The row's planes evaluated at the pixel: anchored, perspective-correct.
struct RowFrag {
  const float* c;
  float sxa, sya, inv_w;
  __device__ __forceinline__ float attr(int c0) const {
    return (fma_rn(c[c0], sxa, c[c0 + 1] * sya) + c[c0 + 2]) * inv_w;
  }
};

__device__ __forceinline__ RowFrag row_frag(const float* c, float sx, float sy) {
  RowFrag f;
  f.c = c;
  f.sxa = sx - c[C_AX];
  f.sya = sy - c[C_AY];
  const float w = fma_rn(c[0], f.sxa, c[1] * f.sya) + c[2];
  f.inv_w = 1.0f / (fabsf(w) < 1e-30f ? 1e-30f : w);
  return f;
}

// The sampler's LOD stage, common to the three slots and every tap
// (ops/shade_kernel.py _texture_params): uv, the clamped lod, and for
// taps the major footprint axis and its clamped length.
struct Footprint {
  float u, v, lod, level0, max_level, adu, adv, scale;
};

template <bool kMultiTap>
__device__ __forceinline__ Footprint footprint(const RowFrag& f, float max_anisotropy,
                                               float max_anisotropy2) {
  const float* c = f.c;
  Footprint fp;
  fp.u = f.attr(C_UV);
  fp.v = f.attr(C_UV + 3);
  const float du_dx = fma_rn(-fp.u, c[0], c[C_UV]) * f.inv_w;
  const float du_dy = fma_rn(-fp.u, c[1], c[C_UV + 1]) * f.inv_w;
  const float dv_dx = fma_rn(-fp.v, c[0], c[C_UV + 3]) * f.inv_w;
  const float dv_dy = fma_rn(-fp.v, c[1], c[C_UV + 4]) * f.inv_w;
  const float w0f = c[C_MW0];
  fp.max_level = c[C_MLEVELS] - 1.0f;
  const float pxd = du_dx * w0f, qxd = dv_dx * w0f;
  const float pyd = du_dy * w0f, qyd = dv_dy * w0f;
  const float ddx2 = fma_rn(pxd, pxd, qxd * qxd);
  const float ddy2 = fma_rn(pyd, pyd, qyd * qyd);
  const float tiny = 1e-24f;
  if (kMultiTap) {
    const bool major_x = ddx2 >= ddy2;
    fp.adu = major_x ? du_dx : du_dy;
    fp.adv = major_x ? dv_dx : dv_dy;
    const float rho_maj = sqrtf(tmax(tmax(ddx2, ddy2), tiny));
    const float rho_min = sqrtf(tmax(tmin(ddx2, ddy2), tiny));
    fp.scale = tmin(1.0f, max_anisotropy * rho_min / rho_maj);
  }
  const float rho_max2 = tmax(tmax(ddx2, ddy2), tiny);
  float lod;
  if (max_anisotropy > 1.0f) {
    const float rho_min2 = tmax(tmin(ddx2, ddy2), tiny);
    const float limit2 = rho_min2 * max_anisotropy2;
    lod = 0.5f * log2f(tmax(tmin(rho_max2, limit2), tiny));
  } else {
    lod = 0.5f * log2f(rho_max2);
  }
  fp.lod = tmin(tmax(lod, 0.0f), fp.max_level);
  fp.level0 = floorf(fp.lod);
  return fp;
}

// The tap-invariant sampler state of a fragment: both levels' geometry and
// each slot's filter and wrap.
struct Sampler {
  LevelGeom g0, g1;
  bool same_level;  // l1 == l0: the chain top
  SlotSampler slot[3];
};

__device__ __forceinline__ Sampler sampler_state(const Footprint& fp, const float* c) {
  Sampler s;
  const int base_row = (int)c[C_MROW];
  const int w0 = (int)c[C_MW0];
  const int max_level = (int)fp.max_level;
  const int l0 = (int)fp.level0;
  const int l1 = min(l0 + 1, max_level);
  s.g0 = level_geom(w0, base_row, max_level, l0);
  s.g1 = level_geom(w0, base_row, max_level, l1);
  s.same_level = l1 == l0;
  const float lfrac = fp.lod - fp.level0;
  const bool is_mag = fp.lod <= 0.0f;
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const int code = (int)c[C_SAMP0 + slot];
    SlotSampler& q = s.slot[slot];
    q.lfrac = (code & 64) ? (lfrac >= 0.5f ? 1.0f : 0.0f) : lfrac;
    q.nearest = (is_mag && (code & 16)) || (!is_mag && (code & 32));
    q.wrap_u = code & 3;
    q.wrap_v = (code >> 2) & 3;
  }
  return s;
}

// ---- texel sources ----------------------------------------------------------

// The three slots' trilinear samples at one (possibly tap-shifted)
// position (u, v), from the texel source kSource, one slot at a time so
// only that slot's addresses and windows are live. Each (slot, level) is
// addressed once; the fused and classic sources read their rows at slot
// 0's address, the per-slot source each slot's own.
template <int kSource>
__device__ __forceinline__ void sample_slots(const Sampler& sm, float u, float v,
                                             const uint32_t* pool, int pool_rows,
                                             const float* dec, float out[3][4]) {
  const LevelAddr b0 = level_addr(sm.g0, sm.slot[0], u, v);
  const LevelAddr b1 = level_addr(sm.g1, sm.slot[0], u, v);
  Texels t0, t1;
  if (kSource == kFused) {
    // one row serves both levels: slot A for l0, slot B (l1, anchored at
    // the l0 block minus one) for l1, slot A again at the chain top
    const uint32_t* prow = pool_row(pool, b0.row, pool_rows);
    t0 = Texels{prow, 0, b0.x0 & 1, b0.y0 & 1};
    t1 = sm.same_level ? t0
                       : Texels{prow, kSlotU32, b1.x0 == (b0.x0 >> 1) ? 1 : 0,
                                b1.y0 == (b0.y0 >> 1) ? 1 : 0};
  }
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const LevelAddr a0 = slot == 0 ? b0 : level_addr(sm.g0, sm.slot[slot], u, v);
    const LevelAddr a1 = slot == 0 ? b1 : level_addr(sm.g1, sm.slot[slot], u, v);
    // classic: the l0 row and the l1 row of slot 0's sampler, each in slot
    // A with its own fold case; per-slot: that pair at each slot's wrap
    if (kSource == kPerSlot || (kSource == kClassic && slot == 0)) {
      t0 = Texels{pool_row(pool, a0.row, pool_rows), 0, a0.x0 & 1, a0.y0 & 1};
      t1 = Texels{pool_row(pool, a1.row, pool_rows), 0, a1.x0 & 1, a1.y0 & 1};
    }
    trilinear(t0, t1, slot, a0.fx, a0.fy, a1.fx, a1.fy, sm.slot[slot].lfrac, dec, out[slot]);
  }
}

// ---- fragment stages --------------------------------------------------------

struct ColsArgs {
  const float* table;
  const uint32_t* pool;
  const float* sx;
  const float* sy;
  const float* params;
  int num_lights, pool_rows, taps;
  float max_anisotropy, max_anisotropy2;
};

// A fragment from its shade-table row, texels from kSource, kMultiTap: the
// average of a.taps samples along the major footprint axis.
template <int kSource, bool kMultiTap>
struct ColsShade {
  ColsArgs a;
  __device__ __forceinline__ void operator()(int t, int /*layer*/, size_t p, const float* dec,
                                             float radiance[3], float* alpha) const {
    // the row in two reads: what sampling needs (columns 0..11, 44..55),
    // then after sampling what the tail needs (12..43), so the tail's
    // columns do not hold registers across the texture fetches
    const float* row = a.table + (size_t)t * kRow;
    float c[kRowUsed];
#pragma unroll
    for (int i = 0; i < 3; ++i) load_cols(row, i, c);
#pragma unroll
    for (int i = 11; i < kRowUsed / 4; ++i) load_cols(row, i, c);
    const RowFrag f = row_frag(c, a.sx[p], a.sy[p]);
    const Footprint fp = footprint<kMultiTap>(f, a.max_anisotropy, a.max_anisotropy2);
    const Sampler sm = sampler_state(fp, c);
    float slot_tex[3][4];
    if (!kMultiTap) {
      sample_slots<kSource>(sm, fp.u, fp.v, a.pool, a.pool_rows, dec, slot_tex);
    } else {
      for (int i = 0; i < a.taps; ++i) {
        const float step = ((i + 0.5f) / a.taps - 0.5f) * fp.scale;
        float st[3][4];
        sample_slots<kSource>(sm, fma_rn(step, fp.adu, fp.u), fma_rn(step, fp.adv, fp.v),
                              a.pool, a.pool_rows, dec, st);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
            slot_tex[k][ch] = i == 0 ? st[k][ch] : slot_tex[k][ch] + st[k][ch];
      }
      const float inv = 1.0f / a.taps;
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) slot_tex[k][ch] *= inv;
    }
#pragma unroll
    for (int i = 3; i < 11; ++i) load_cols(row, i, c);
    SurfaceInputs s;
#pragma unroll
    for (int k = 0; k < 4; ++k) s.base_f[k] = c[C_BASE + k];
    s.mr_f[0] = c[C_MR];
    s.mr_f[1] = c[C_MR + 1];
    s.normal_scale = c[C_NSCALE];
    s.amode = c[C_AMODE];
    s.acut = c[C_ACUT];
    s.wp = V3{f.attr(C_WPOS), f.attr(C_WPOS + 3), f.attr(C_WPOS + 6)};
#pragma unroll
    for (int k = 0; k < 3; ++k) s.nr[k] = f.attr(C_NRM + 3 * k);
#pragma unroll
    for (int k = 0; k < 4; ++k) s.tg[k] = f.attr(C_TAN + 3 * k);
    shade_tail(slot_tex, s, a.params, a.num_lights, radiance, alpha);
  }
};

// A fragment from phase A's attribute rows (AttrsShade: rows strided by n
// within a layer) and its two pool rows: one footprint for all slots.
struct AttrsShade {
  const float* attrs;
  const int* r0;
  const int* r1;
  const uint32_t* pool;
  const float* params;
  int num_lights, pool_rows, n;
  __device__ __forceinline__ void operator()(int /*t*/, int layer, size_t p, const float* dec,
                                             float radiance[3], float* alpha) const {
    const float* a = attrs + (size_t)layer * kAttrRows * n + p;
    auto row = [&](int i) { return __ldg(a + (size_t)i * n); };
    const size_t q = (size_t)layer * n + p;
    const Texels t0{pool_row(pool, r0[q], pool_rows), 0, row(A_CX0) != 0.0f ? 1 : 0,
                    row(A_CY0) != 0.0f ? 1 : 0};
    const Texels t1{pool_row(pool, r1[q], pool_rows), 0, row(A_CX1) != 0.0f ? 1 : 0,
                    row(A_CY1) != 0.0f ? 1 : 0};
    const float fx0 = row(A_FX0), fy0 = row(A_FY0), fx1 = row(A_FX1), fy1 = row(A_FY1);
    const float lfrac = row(A_LFRAC);
    float slot_tex[3][4];
#pragma unroll
    for (int slot = 0; slot < 3; ++slot)
      trilinear(t0, t1, slot, fx0, fy0, fx1, fy1, lfrac, dec, slot_tex[slot]);
    SurfaceInputs s;
#pragma unroll
    for (int c = 0; c < 4; ++c) s.base_f[c] = row(A_BASE + c);
    s.mr_f[0] = row(A_MR);
    s.mr_f[1] = row(A_MR + 1);
    s.normal_scale = row(A_NSCALE);
    s.amode = row(A_AMODE);
    s.acut = row(A_ACUT);
    s.wp = V3{row(A_WPOS), row(A_WPOS + 1), row(A_WPOS + 2)};
#pragma unroll
    for (int c = 0; c < 3; ++c) s.nr[c] = row(A_NRM + c);
#pragma unroll
    for (int c = 0; c < 4; ++c) s.tg[c] = row(A_TAN + c);
    shade_tail(slot_tex, s, params, num_lights, radiance, alpha);
  }
};

// ---- kernels ----------------------------------------------------------------

// sRGB encode and u8 quantization of a value in [0, 1]
__device__ __forceinline__ int srgb_u8(float v) {
  const float srgb =
      v <= 0.0031308f ? v * 12.92f : fma_rn(1.055f, powf(v, (float)(1.0 / 2.4)), -0.055f);
  return (int)fma_rn(srgb, 255.0f, 0.5f);
}

// Resolve form (one layer): composite over the clear colour, coverage
// resolve, sRGB encode, packed r | g << 8 | b << 16. An uncovered pixel
// composites nothing (rgb 0, alpha 0) and is not shaded.
template <class Shade>
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(Shade shade, const int* __restrict__ tri, const float* __restrict__ frac_in,
                   const float* __restrict__ params, int* __restrict__ out, int n) {
  __shared__ float dec_smem[512];
  const float* dec = decode_table(dec_smem);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int t = tri[p];
  float radiance[3] = {0.0f, 0.0f, 0.0f}, alpha = 0.0f;
  if (t >= 0) shade(t, 0, p, dec, radiance, &alpha);
  const float frac = frac_in[p];
  int packed = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float bg = params[4 + c];
    const float comp = fma_rn(radiance[c], alpha, bg * (1.0f - alpha));
    const float resolved = fma_rn(comp, frac, bg * (1.0f - frac));
    packed |= srgb_u8(tmin(tmax(resolved, 0.0f), 1.0f)) << (8 * c);
  }
  out[p] = packed;
}

// Layer form: linear radiance (K, 3, N) and effective alpha (K, N) of a
// (K, N) id array, for the host-side composite; an uncovered entry is
// rgb 0, alpha 0.
template <class Shade>
__global__ void __launch_bounds__(kThreads)
    layer_kernel(Shade shade, const int* __restrict__ tri, float* __restrict__ out_rgb,
                 float* __restrict__ out_alpha, int n, int layers) {
  __shared__ float dec_smem[512];
  const float* dec = decode_table(dec_smem);
  // a thread per pixel, walking its layers
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  for (int l = 0; l < layers; ++l) {
    const size_t q = (size_t)l * n + p;
    const int t = tri[q];
    float radiance[3] = {0.0f, 0.0f, 0.0f}, alpha = 0.0f;
    if (t >= 0) shade(t, l, p, dec, radiance, &alpha);
#pragma unroll
    for (int c = 0; c < 3; ++c) out_rgb[((size_t)l * 3 + c) * n + p] = radiance[c];
    out_alpha[q] = alpha;
  }
}

template <class Shade>
int launch_resolve(const Shade& shade, const int* tri, const float* frac, const float* params,
                   int* out, int n, cudaStream_t stream) {
  resolve_kernel<Shade><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      shade, tri, frac, params, out, n);
  return launch_status();
}

template <class Shade>
int launch_layer(const Shade& shade, const int* tri, float* out_rgb, float* out_alpha, int n,
                 int layers, cudaStream_t stream) {
  layer_kernel<Shade><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      shade, tri, out_rgb, out_alpha, n, layers);
  return launch_status();
}

template <int kSource, bool kMultiTap>
int cols_resolve(const ColsArgs& a, const int* tri, const float* frac, int* out, int n,
                 cudaStream_t stream) {
  return launch_resolve(ColsShade<kSource, kMultiTap>{a}, tri, frac, a.params, out, n, stream);
}

template <int kSource, bool kMultiTap>
int cols_layer(const ColsArgs& a, const int* tri, float* out_rgb, float* out_alpha, int n,
               int layers, cudaStream_t stream) {
  return launch_layer(ColsShade<kSource, kMultiTap>{a}, tri, out_rgb, out_alpha, n, layers,
                      stream);
}

}  // namespace

// texels: 0 fused, 1 classic, 2 per-slot; taps: 1, 2, 4 or 8.
VKTF_EXPORT int vktf_shade_resolve(int texels, int taps, const int* tri, const float* sx,
                                   const float* sy, const float* frac, const float* table,
                                   const uint32_t* pool, const float* params, int* out, int n,
                                   int num_lights, int pool_rows, float max_anisotropy,
                                   float max_anisotropy2, cudaStream_t stream) {
  const ColsArgs a{table, pool, sx, sy, params, num_lights, pool_rows, taps, max_anisotropy,
                   max_anisotropy2};
  const bool multi = taps > 1;
  switch (texels) {
    case kFused:
      return multi ? cols_resolve<kFused, true>(a, tri, frac, out, n, stream)
                   : cols_resolve<kFused, false>(a, tri, frac, out, n, stream);
    case kClassic:
      return multi ? cols_resolve<kClassic, true>(a, tri, frac, out, n, stream)
                   : cols_resolve<kClassic, false>(a, tri, frac, out, n, stream);
    case kPerSlot:
      return multi ? cols_resolve<kPerSlot, true>(a, tri, frac, out, n, stream)
                   : cols_resolve<kPerSlot, false>(a, tri, frac, out, n, stream);
  }
  return (int)cudaErrorInvalidValue;
}

VKTF_EXPORT int vktf_shade_layer(int texels, int taps, const int* tri, const float* sx,
                                 const float* sy, const float* table, const uint32_t* pool,
                                 const float* params, float* out_rgb, float* out_alpha, int n,
                                 int layers, int num_lights, int pool_rows, float max_anisotropy,
                                 float max_anisotropy2, cudaStream_t stream) {
  const ColsArgs a{table, pool, sx, sy, params, num_lights, pool_rows, taps, max_anisotropy,
                   max_anisotropy2};
  const bool multi = taps > 1;
  switch (texels) {
    case kFused:
      return multi ? cols_layer<kFused, true>(a, tri, out_rgb, out_alpha, n, layers, stream)
                   : cols_layer<kFused, false>(a, tri, out_rgb, out_alpha, n, layers, stream);
    case kClassic:
      return multi ? cols_layer<kClassic, true>(a, tri, out_rgb, out_alpha, n, layers, stream)
                   : cols_layer<kClassic, false>(a, tri, out_rgb, out_alpha, n, layers, stream);
    case kPerSlot:
      return multi ? cols_layer<kPerSlot, true>(a, tri, out_rgb, out_alpha, n, layers, stream)
                   : cols_layer<kPerSlot, false>(a, tri, out_rgb, out_alpha, n, layers, stream);
  }
  return (int)cudaErrorInvalidValue;
}

VKTF_EXPORT int vktf_shade_attrs_resolve(const float* attrs, const int* r0, const int* r1,
                                         const int* tri, const float* frac, const uint32_t* pool,
                                         const float* params, int* out, int n, int num_lights,
                                         int pool_rows, cudaStream_t stream) {
  return launch_resolve(AttrsShade{attrs, r0, r1, pool, params, num_lights, pool_rows, n}, tri,
                        frac, params, out, n, stream);
}

VKTF_EXPORT int vktf_shade_attrs_layer(const float* attrs, const int* r0, const int* r1,
                                       const int* tri, const uint32_t* pool, const float* params,
                                       float* out_rgb, float* out_alpha, int n, int layers,
                                       int num_lights, int pool_rows, cudaStream_t stream) {
  return launch_layer(AttrsShade{attrs, r0, r1, pool, params, num_lights, pool_rows, n}, tri,
                      out_rgb, out_alpha, n, layers, stream);
}
