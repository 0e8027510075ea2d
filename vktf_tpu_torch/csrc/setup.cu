// Per-triangle setup + stream-row pack (ops/setup_kernel.py).
//
// Replaces vktf_tpu/ops/setup_kernel.py `_kernel` / `_flat_valid` (the
// Pallas call in setup_pack_kernel). One thread per triangle; inputs and
// outputs are component-major (C, T) rows, so each warp's load or store of
// one row is one 128-byte line. The instance matrix comes from the (I, 16)
// row-major rows by the triangle's int32 instance index, as three 16-byte
// loads that stay in cache. Bound by bytes (36 bytes of corners and the
// index read, 157 bytes written per triangle). The arithmetic is
// vktf_tpu_torch/ops/vertex.py's setup_from_corners op for op: fma_rn
// exactly where that plain version calls fma, plain rounded operations
// (IEEE divisions included) everywhere else.
#include "common.cuh"

namespace {

constexpr float kEps12 = 1e-12f;
constexpr float kInf = 3e38f;
constexpr float kTiny = 1e-30f;
constexpr int kTriRows = 24;

__device__ __forceinline__ float no_negzero(float c) { return c == 0.0f ? 0.0f : c; }

struct Plane {
  float a, b, c;
};

__global__ void setup_kernel(const float* __restrict__ tc, const float4* __restrict__ inst_rows,
                             const int* __restrict__ tri_instance, const float* __restrict__ vp,
                             const float* __restrict__ ids, float* __restrict__ tri_data,
                             float* __restrict__ bbox_rows, float* __restrict__ edge9,
                             float* __restrict__ anchor2, uint8_t* __restrict__ valid_out, int t,
                             int width, int height) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= t) return;
  auto TC = [&](int r) { return tc[(size_t)r * t + k]; };
  const float4* m4 = inst_rows + (size_t)tri_instance[k] * 4;
  const float4 mr[3] = {__ldg(m4), __ldg(m4 + 1), __ldg(m4 + 2)};

  // world corners (rows 6..14: channel c of corner i at 6 + 3c + i), clip
  float wc[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      wc[c][i] = fma_rn(mr[c].z, TC(12 + i), fma_rn(mr[c].x, TC(6 + i), mr[c].y * TC(9 + i))) +
                 mr[c].w;
  float clip[4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      clip[r][i] = fma_rn(vp[r * 4 + 2], wc[2][i],
                          fma_rn(vp[r * 4 + 0], wc[0][i], vp[r * 4 + 1] * wc[1][i])) +
                   vp[r * 4 + 3];
  const float* x = clip[0];
  const float* y = clip[1];
  const float* z = clip[2];
  const float* w = clip[3];

  float xs[3], ys[3];
  const float half_w = 0.5f * (float)width, half_h = 0.5f * (float)height;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xs[i] = (x[i] + w[i]) * half_w;
    ys[i] = (y[i] + w[i]) * half_h;
  }
  auto cross = [&](int i, int j, float* out) {
    out[0] = fma_rn(ys[i], w[j], -(w[i] * ys[j]));
    out[1] = fma_rn(w[i], xs[j], -(xs[i] * w[j]));
    out[2] = fma_rn(xs[i], ys[j], -(ys[i] * xs[j]));
  };
  float cof[3][3];
  cross(2, 1, cof[0]);
  cross(0, 2, cof[1]);
  cross(1, 0, cof[2]);
  const float det = fma_rn(w[0], cof[0][2], fma_rn(xs[0], cof[0][0], ys[0] * cof[0][1]));

  const bool b0 = w[0] <= kEps12, b1 = w[1] <= kEps12, b2 = w[2] <= kEps12;
  const bool all_behind = b0 && b1 && b2;
  const bool any_behind = b0 || b1 || b2;
  bool valid = (det > kEps12) && !all_behind;
  const float inv_det = valid ? 1.0f / det : 0.0f;

  float safe_w[3], px[3], py[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    safe_w[i] = tmax(w[i], kEps12);
    px[i] = xs[i] / safe_w[i];
    py[i] = ys[i] / safe_w[i];
  }
  const float pxmin = tmin(tmin(px[0], px[1]), px[2]);
  const float pymin = tmin(tmin(py[0], py[1]), py[2]);
  const float pxmax = tmax(tmax(px[0], px[1]), px[2]);
  const float pymax = tmax(tmax(py[0], py[1]), py[2]);

  bool sane = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) sane = sane && fabsf(px[i]) <= 32768.0f && fabsf(py[i]) <= 32768.0f;
  const bool use_screen = !any_behind && sane;
  // both products rounded (a repeated corner gives exactly 0)
  const float area2 = (px[1] - px[0]) * (py[2] - py[0]) - (py[1] - py[0]) * (px[2] - px[0]);
  valid = valid && (!use_screen || area2 < 0.0f);

  // near-plane crossers: bbox of the part with 0 <= depth <= 1. Only a
  // triangle with a corner behind the eye reads it, so the others skip its
  // 18 divisions (warps are mostly uniform: the stream is in world Morton
  // order).
  const float lim_x = 2.0f * (float)width + 16.0f, lim_y = 2.0f * (float)height + 16.0f;
  float cxmin = kInf, cymin = kInf, cxmax = kInf, cymax = kInf;  // vmin accumulators
  if (any_behind) {
    int n = 0;
    auto add_cand = [&](float vx, float vy, bool ok) {
      const float cx = ok ? tclamp(vx, -lim_x, lim_x) : kInf;
      const float cy = ok ? tclamp(vy, -lim_y, lim_y) : kInf;
      const float nx = cx >= kInf ? kInf : -cx;
      const float ny = cy >= kInf ? kInf : -cy;
      if (n == 0) {
        cxmin = cx; cymin = cy; cxmax = nx; cymax = ny;
      } else {
        cxmin = tmin(cxmin, cx); cymin = tmin(cymin, cy);
        cxmax = tmin(cxmax, nx); cymax = tmin(cymax, ny);
      }
      ++n;
    };
#pragma unroll
    for (int i = 0; i < 3; ++i) add_cand(px[i], py[i], (z[i] >= 0.0f) && (z[i] <= w[i]));
    const int pairs[3][2] = {{0, 1}, {1, 2}, {2, 0}};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int i = pairs[p][0], j = pairs[p][1];
#pragma unroll
      for (int near = 1; near >= 0; --near) {
        const float fi = near ? z[i] : w[i] - z[i];
        const float fj = near ? z[j] : w[j] - z[j];
        const bool crossing = (fi > 0.0f) != (fj > 0.0f);
        const float denom = fi - fj;
        const float tt = fi / (fabsf(denom) < kTiny ? kTiny : denom);
        const float xt = fma_rn(tt, xs[j] - xs[i], xs[i]);
        const float yt = fma_rn(tt, ys[j] - ys[i], ys[i]);
        const float zt = fma_rn(tt, z[j] - z[i], z[i]);
        float wt = fma_rn(tt, w[j] - w[i], w[i]);
        const bool other = near ? (zt <= wt) : (zt >= 0.0f);
        const bool ok = crossing && other && (wt > kEps12);
        wt = tmax(wt, kEps12);
        add_cand(xt / wt, yt / wt, ok);
      }
    }
  }
  const bool has_cand = cxmin < kInf;
  const float cx0 = has_cand ? floorf(cxmin) - 1.0f : 0.0f;
  const float cy0 = has_cand ? floorf(cymin) - 1.0f : 0.0f;
  const float cx1 = has_cand ? ceilf(-cxmax) + 2.0f : 0.0f;
  const float cy1 = has_cand ? ceilf(-cymax) + 2.0f : 0.0f;
  const float fx0 = any_behind ? cx0 : floorf(pxmin);
  const float fy0 = any_behind ? cy0 : floorf(pymin);
  const float fx1 = any_behind ? cx1 : ceilf(pxmax) + 1.0f;
  const float fy1 = any_behind ? cy1 : ceilf(pymax) + 1.0f;
  const float wf = (float)width, hf = (float)height;
  int bb[4] = {(int)tclamp(fx0, 0.0f, wf), (int)tclamp(fy0, 0.0f, hf),
               (int)tclamp(fx1, 0.0f, wf), (int)tclamp(fy1, 0.0f, hf)};
  if (!valid) bb[0] = bb[1] = bb[2] = bb[3] = 0;

  // anchored plane constants (at the clipped bbox corner)
  const float ax = (float)bb[0], ay = (float)bb[1];
  const float det_w0 = det / safe_w[0];
  const float dx0 = ax - px[0], dy0 = ay - py[0];
  auto anchored = [&](float a, float b, float c_raw, bool has_v0, float v0) {
    const float raw = fma_rn(b, ay, fma_rn(a, ax, c_raw));
    const float via = has_v0 ? fma_rn(b, dy0, fma_rn(a, dx0, v0)) : fma_rn(a, dx0, b * dy0);
    return Plane{a, b, any_behind ? raw : via};
  };
  Plane edges[3] = {anchored(cof[0][0], cof[0][1], cof[0][2], true, det_w0),
                    anchored(cof[1][0], cof[1][1], cof[1][2], false, 0.0f),
                    anchored(cof[2][0], cof[2][1], cof[2][2], false, 0.0f)};
  auto screen_edge = [&](int j, int kk) {
    const float a = py[kk] - py[j];
    const float b = px[j] - px[kk];
    return Plane{a, b, fma_rn(a, ax - px[kk], b * (ay - py[kk]))};
  };
  const Plane sedges[3] = {screen_edge(1, 2), screen_edge(2, 0), screen_edge(0, 1)};
  Plane er[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) er[e] = use_screen ? sedges[e] : edges[e];

  // depth plane: the homogeneous form (cofactor x clip z, which cancels by
  // ~1e5) for near-plane crossers and insane projections; on the
  // screen-space path the slopes from the corners' NDC-z differences over
  // the screen positions, whose error scales with the triangle's depth range
  const float d0 = z[0] / safe_w[0], d1 = z[1] / safe_w[1], d2 = z[2] / safe_w[2];
  const float z_ndc0 = d0;
  float zc[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk)
    zc[kk] = fma_rn(cof[2][kk], z[2], fma_rn(cof[0][kk], z[0], cof[1][kk] * z[1])) * inv_det;
  const Plane zh = anchored(zc[0], zc[1], zc[2], true, z_ndc0);
  Plane zp = zh;
  if (use_screen) {
    const float ex1 = px[1] - px[0], ey1 = py[1] - py[0];
    const float ex2 = px[2] - px[0], ey2 = py[2] - py[0];
    const float ez1 = d1 - z_ndc0, ez2 = d2 - z_ndc0;
    float sarea = fma_rn(ex1, ey2, -(ex2 * ey1));
    if (sarea == 0.0f) sarea = 1.0f;  // culled: any finite plane
    const float sa = fma_rn(ez1, ey2, -(ez2 * ey1)) / sarea;
    const float sb = fma_rn(ex1, ez2, -(ex2 * ez1)) / sarea;
    zp = Plane{sa, sb, fma_rn(sb, dy0, fma_rn(sa, dx0, z_ndc0))};
  }
  const Plane wp = anchored(cof[0][0] + cof[1][0] + cof[2][0], cof[0][1] + cof[1][1] + cof[2][1],
                            cof[0][2] + cof[1][2] + cof[2][2], true, det_w0);

  // slim-body safety: w > 0 and 0 <= depth <= 1 hold at every covered
  // sample with a 2^-16 margin over plane-evaluation rounding
  const float bw_f = (float)(bb[2] - bb[0]) + 2.0f;
  const float bh_f = (float)(bb[3] - bb[1]) + 2.0f;
  const float tol = 1.52587890625e-05f;  // 2^-16
  const float werr = (fma_rn(fabsf(wp.a), bw_f, fabsf(wp.b) * bh_f) + fabsf(wp.c)) * tol;
  const float wmax = tmax(tmax(w[0], w[1]), w[2]);
  const float wr_min = det / tmax(wmax, kEps12);
  const float dmin = tmin(tmin(d0, d1), d2);
  const float dmax = tmax(tmax(d0, d1), d2);
  // the homogeneous coefficients, as in the plain version (its comment)
  const float derr = (fma_rn(fabsf(zh.a), bw_f, fabsf(zh.b) * bh_f) + fabsf(zh.c)) * tol;
  const bool safe = valid && !any_behind && (wr_min > werr) && (dmin > derr) &&
                    (dmax < 1.0f - derr);

  // ---- pack (raster_pallas.py:39-57 row layout) ----
  const bool v2 = valid && (bb[2] > bb[0]) && (bb[3] > bb[1]);
  float rows[kTriRows];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    rows[3 * e] = er[e].a;
    rows[3 * e + 1] = er[e].b;
    rows[3 * e + 2] = no_negzero(er[e].c);
  }
  rows[9] = zp.a; rows[10] = zp.b; rows[11] = no_negzero(zp.c);
  rows[12] = wp.a; rows[13] = wp.b; rows[14] = no_negzero(wp.c);
  rows[15] = v2 ? (ids ? ids[k] : (float)k) : -1.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const bool tl = (er[e].a > 0.0f) || (er[e].a == 0.0f && er[e].b > 0.0f);
    rows[16 + e] = tl ? -1.0f : 0.0f;
  }
  rows[19] = (safe || !v2) ? 1.0f : 0.0f;
#pragma unroll
  for (int r = 20; r < kTriRows; ++r) rows[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < kTriRows; ++r) tri_data[(size_t)r * t + k] = rows[r];

  const float big = 1073741824.0f;  // 2^30
  bbox_rows[k] = v2 ? (float)bb[0] : big;
  bbox_rows[(size_t)t + k] = v2 ? (float)bb[1] : big;
  bbox_rows[(size_t)2 * t + k] = v2 ? (float)bb[2] : -big;
  bbox_rows[(size_t)3 * t + k] = v2 ? (float)bb[3] : -big;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    edge9[(size_t)(3 * e) * t + k] = edges[e].a;
    edge9[(size_t)(3 * e + 1) * t + k] = edges[e].b;
    edge9[(size_t)(3 * e + 2) * t + k] = edges[e].c;
  }
  anchor2[k] = ax;
  anchor2[(size_t)t + k] = ay;
  valid_out[k] = v2 ? 1 : 0;
}

}  // namespace

VKTF_EXPORT int vktf_setup_pack(const float* tc, const float* inst_rows,
                                const int* tri_instance, const float* vp, const float* ids,
                                float* tri_data, float* bbox_rows, float* edge9, float* anchor2,
                                uint8_t* valid, int t, int width, int height,
                                cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (t + threads - 1) / threads;
  setup_kernel<<<blocks, threads, 0, stream>>>(
      tc, reinterpret_cast<const float4*>(inst_rows), tri_instance, vp, ids, tri_data, bbox_rows,
      edge9, anchor2, valid, t, width, height);
  return launch_status();
}
