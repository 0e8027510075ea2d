"""Deferred shade, resolve and layer forms: CUDA kernels and their plain
versions.

Replaces ``vktf_tpu/ops/shade_kernel.py`` ``_shade_resolve_kernel`` and
``_shade_layer_kernel`` (body ``_shade_block_body``, fused-pool branch,
one tap), launched by ``_shade_final_call`` via ``shade_final_chunk``. Per
pixel, from its triangle's shade-table row and one fused-mip pool row:

  * plane evaluation at the pixel centre (anchored, perspective-correct);
  * the sampler's LOD stage: analytic uv derivatives, anisotropic LOD
    sharpening, the mip pair (l0, l1) and lerp weight (_texture_params);
  * addressing (fused_window_addr): the l0 block row, its 2x2 fold case,
    and the l1 fold case inside slot B (slot A again when l1 == l0);
  * bilinear taps with per-texel sRGB decode, trilinear lerp, for base
    color, metallic-roughness and normal (one row serves all three);
  * TBN normal mapping and the GGX / Smith / Schlick BRDF over the lights
    (``vktf_tpu/ops/shade_cf.py:37-105``), the glTF alpha mode;
  * resolve form (one peel layer, ``shade_resolve``): composite over the
    clear colour, coverage-fraction resolve, sRGB encode and u8
    quantization, packed r | g << 8 | b << 16;
  * layer form (K > 1, ``shade_layer``): the linear radiance and effective
    alpha of every (layer, pixel), for the front-to-back composite in
    ``ops/pipeline.composite_resolve``. An uncovered entry is rgb 0,
    alpha 0 (the TPU kernel shades table row 0 there; only its alpha 0
    reaches the composite).

Both forms share one fragment body: ``_fragment_plain`` in the plain
versions, ``shade_fragment`` in ``csrc/shade.cu``.

The TPU kernel received its table columns and pool rows from separate XLA
gathers (its two-program phase split exists because its VMEM could not
hold both operands); here the kernels gather both rows themselves, so no
(2*ROW, N) phase-boundary tensor exists.

CUDA design (``csrc/shade.cu``): one thread per pixel (resolve form) or
per (layer, pixel) over all K layers in one launch (layer form, whose
uncovered entries write zeros and return at once). Bound on the card: the
two dependent row gathers (a 256-byte table row and up to 54 lanes of a
256-byte pool row per pixel) and ~1.6k float32 operations per shaded
pixel with five lights (~30 powf); rows of neighbouring pixels mostly
coincide, so the gathers hit L2. Measured on an NVIDIA H100 80GB HBM3 at a
700 W power limit (chip_smoke.py): resolve form 0.53 ms over the 2,088,960
pixels of sponza 1080p (least possible 0.047 ms, operations), plain
version 71.8 ms; layer form 1.13 ms over the translucent sponza's 8 x
2,088,960 entries, 3,657,626 of them covered (least possible 0.126 ms,
bytes), plain version 612 ms.

Arithmetic follows the JAX package's XLA form: the same fused
multiply-adds (``ops/fmath.py``). Transcendentals (pow, log2, rsqrt) are
each library's own and differ by ULPs, which can move a u8 by one step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vktf_tpu_torch.ops import _cuda
from vktf_tpu_torch.ops.fmath import f32, fma
from vktf_tpu_torch.ops.shade_table import (
    C_ACUT, C_AMODE, C_AX, C_AY, C_BASE, C_MLEVELS, C_MR, C_MROW, C_MW0,
    C_NRM, C_NSCALE, C_SAMP0, C_TAN, C_UV, C_WPOS, ROW,
)
from vktf_tpu_torch.ops.texture_pack import SLOT_U32, WRAP_CLAMP, WRAP_REPEAT

PI = 3.1415927
EPSILON = 1.0e-7
POINT_LIGHT_RADIUS = 0.1

KERNEL = _cuda.Kernel(
    "shade", "shade.cu",
    "vktf_tpu/ops/shade_kernel.py:267 (_shade_resolve_kernel via _shade_final_call, pallas_call :646)",
)
KERNEL_LAYER = _cuda.Kernel(
    "shade_layer", "shade.cu",
    "vktf_tpu/ops/shade_kernel.py:216 (_shade_layer_kernel via _shade_final_call, pallas_call :646)",
)


def _rnorm(cf, x, y, z):
    r = torch.rsqrt(torch.maximum(fma(z, z, fma(x, x, y * y)), cf(1e-20)))
    return x * r, y * r, z * r


def _dot3(a, b):
    return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))


def _srgb_to_linear(cf, c):
    return torch.where(c <= cf(0.04045), c / cf(12.92),
                       torch.pow((c + cf(0.055)) / cf(1.055), 2.4))


def _wrap_coord(i, size, mode):
    size = torch.clamp(size, min=1)
    repeat = i & (size - 1)
    clamp = torch.minimum(torch.maximum(i, torch.zeros_like(i)), size - 1)
    m = i & (2 * size - 1)
    mirror = torch.where(m >= size, 2 * size - 1 - m, m)
    return torch.where(mode == WRAP_REPEAT, repeat,
                       torch.where(mode == WRAP_CLAMP, clamp, mirror))


def _texture_params(cf, col, sxa, sya, inv_w, max_anisotropy: float, slot: int):
    def attr(c0):
        return (fma(col(c0), sxa, col(c0 + 1) * sya) + col(c0 + 2)) * inv_w

    u = attr(C_UV)
    v = attr(C_UV + 3)
    du_dx = fma(-u, col(0), col(C_UV)) * inv_w
    du_dy = fma(-u, col(1), col(C_UV + 1)) * inv_w
    dv_dx = fma(-v, col(0), col(C_UV + 3)) * inv_w
    dv_dy = fma(-v, col(1), col(C_UV + 4)) * inv_w
    base_row_i = col(C_MROW).to(torch.int32)
    w0_i = col(C_MW0).to(torch.int32)
    max_level = col(C_MLEVELS) - cf(1.0)
    max_level_i = max_level.to(torch.int32)
    w0f = col(C_MW0)
    px, qx = du_dx * w0f, dv_dx * w0f
    py, qy = du_dy * w0f, dv_dy * w0f
    ddx2 = fma(px, px, qx * qx)
    ddy2 = fma(py, py, qy * qy)
    tiny = cf(1e-24)
    rho_max2 = torch.maximum(torch.maximum(ddx2, ddy2), tiny)
    if max_anisotropy > 1.0:
        rho_min2 = torch.maximum(torch.minimum(ddx2, ddy2), tiny)
        limit2 = rho_min2 * cf(max_anisotropy * max_anisotropy)
        lod = cf(0.5) * torch.log2(torch.maximum(torch.minimum(rho_max2, limit2), tiny))
    else:
        lod = cf(0.5) * torch.log2(rho_max2)
    lod = torch.minimum(torch.maximum(lod, cf(0.0)), max_level)
    level0 = torch.floor(lod)
    lfrac = lod - level0
    code = col(C_SAMP0 + slot).to(torch.int32)
    mip_n = (code & 64) != 0
    lfrac = torch.where(mip_n, (lfrac >= cf(0.5)).to(torch.float32), lfrac)
    is_mag = lod <= cf(0.0)
    nearest = (is_mag & ((code & 16) != 0)) | (~is_mag & ((code & 32) != 0))
    l0 = level0.to(torch.int32)
    l1 = torch.minimum(l0 + 1, max_level.to(torch.int32))
    return {
        "u": u, "v": v, "l0": l0, "l1": l1, "lfrac": lfrac,
        "nearest": nearest, "base_row_i": base_row_i, "w0_i": w0_i,
        "max_level_i": max_level_i, "wrap_u": code & 3,
        "wrap_v": (code >> 2) & 3,
    }


def _level_addr(cf, tp, level):
    w0_i = tp["w0_i"]
    wl = torch.clamp(w0_i >> level, min=1)
    wlf = wl.to(torch.float32)
    x = fma(tp["u"], wlf, cf(-0.5))
    y = fma(tp["v"], wlf, cf(-0.5))
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    nearest = tp["nearest"]
    fx = torch.where(nearest, (fx >= cf(0.5)).to(torch.float32), fx)
    fy = torch.where(nearest, (fy >= cf(0.5)).to(torch.float32), fy)
    x0 = _wrap_coord(x0f.to(torch.int32), wl, tp["wrap_u"])
    y0 = _wrap_coord(y0f.to(torch.int32), wl, tp["wrap_v"])
    b0 = torch.clamp(w0_i >> 1, min=1)
    bl = torch.clamp(b0 >> level, min=1)
    n_last = tp["max_level_i"]
    extra = ((level == n_last) & (n_last > 0)).to(torch.int32)
    offset = torch.div(4 * (b0 * b0 - bl * bl), 3, rounding_mode="floor") + extra
    bw = torch.clamp(w0_i >> (level + 1), min=1)
    row = tp["base_row_i"] + offset + (y0 >> 1) * bw + (x0 >> 1)
    return row, fx, fy, x0, y0


def _filter_slot(cf, texel, slot, fx, fy, srgb):
    """Bilinear tap of one texture from its 2x2 window; texel(slot, i, j)
    returns the packed RGBA8 u32 (as int64) at window texel (i, j)."""
    one = cf(1.0)
    w00 = (one - fx) * (one - fy)
    w10 = fx * (one - fy)
    w01 = (one - fx) * fy
    w11 = fx * fy
    taps = [texel(slot, 0, 0), texel(slot, 0, 1), texel(slot, 1, 0), texel(slot, 1, 1)]
    out = []
    for shift in (0, 8, 16, 24):
        vals = [((t >> shift) & 0xFF).to(torch.float32) / cf(255.0) for t in taps]
        if srgb and shift < 24:
            vals = [_srgb_to_linear(cf, v) for v in vals]
        out.append(fma(vals[3], w11, fma(vals[2], w01, fma(vals[0], w00, vals[1] * w10))))
    return tuple(out)


def _material_brdf(cf, base_rgb, metallic, roughness, l, n, v):
    h = _rnorm(cf, l[0] + v[0], l[1] + v[1], l[2] + v[2])
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    h_dot_v = _dot3(h, v)
    h_dot_l = _dot3(h, l)
    n_dot_l = _dot3(n, l)
    n_dot_v = _dot3(n, v)
    n_dot_h = _dot3(n, h)
    one, zero = cf(1.0), cf(0.0)
    one_minus_metal = one - metallic
    f0 = [fma(cf(0.04), one_minus_metal, c * metallic) for c in base_rgb]
    fres_pow = torch.pow(one - h_dot_v.abs(), 5.0)
    fresnel = [fma(one - f, fres_pow, f) for f in f0]

    def smith_half(nd):
        return (nd.abs() + torch.sqrt(fma((one - alpha2) * nd, nd, alpha2))
                + cf(EPSILON))

    visibility = (torch.where(h_dot_l >= zero, one, zero) / smith_half(n_dot_l)
                  * torch.where(h_dot_v >= zero, one, zero)) / smith_half(n_dot_v)
    d_denom = fma(n_dot_h * n_dot_h, alpha2 - one, one)
    distribution = (torch.where(n_dot_h >= zero, one, zero) * alpha2) / fma(
        cf(PI) * d_denom, d_denom, cf(EPSILON))
    spec_scale = visibility * distribution
    diffuse_scale = one_minus_metal / cf(PI)
    return [fma((one - fresnel[c]) * diffuse_scale, base_rgb[c], fresnel[c] * spec_scale)
            for c in range(3)]


def _shade_lights(cf, wp, normal, view, base_rgb, metallic, roughness, lights):
    r = None
    one, zero = cf(1.0), cf(0.0)
    for i in range(lights.shape[0]):
        light = lights[i]
        has_position = torch.where(light[3] != zero, one, zero)
        lv = [fma(-has_position, wp[k], light[k]) for k in range(3)]
        dist = torch.maximum(
            torch.sqrt(torch.maximum(fma(lv[2], lv[2], fma(lv[0], lv[0], lv[1] * lv[1])),
                                     cf(1e-20))),
            cf(POINT_LIGHT_RADIUS))
        attenuation = (one - has_position) + has_position / (dist * dist)
        inv = one / dist
        l = [lv[k] * inv for k in range(3)]
        brdf = _material_brdf(cf, base_rgb, metallic, roughness, l, normal, view)
        cos_theta = torch.maximum(_dot3(normal, l), zero)
        scale = attenuation * cos_theta
        terms = [scale * light[4 + c] for c in range(3)]
        if r is None:
            r = [terms[c] * brdf[c] for c in range(3)]
        else:
            r = [fma(terms[c], brdf[c], r[c]) for c in range(3)]
    if r is None:
        r = [torch.zeros_like(wp[0]) for _ in range(3)]
    return r


def _fragment_plain(tri, sx, sy, table, pool, camera_position, lights,
                    max_anisotropy: float):
    """The fragment body shared by the resolve and layer forms: per pixel,
    (radiance [r, g, b], effective alpha, covered). Uncovered pixels shade
    table row 0 and get alpha 0."""
    def cf(v):  # float32 constants on the pixels' device
        return f32(v, sx)

    n = tri.shape[0]
    covered = tri >= 0
    rows = table[torch.clamp(tri, min=0).long()]  # (N, 64)

    def col(c):
        return rows[:, c]

    sxa = sx - col(C_AX)
    sya = sy - col(C_AY)
    w = fma(col(0), sxa, col(1) * sya) + col(2)
    inv_w = cf(1.0) / torch.where(w.abs() < cf(1e-30), cf(1e-30), w)

    tps = [_texture_params(cf, col, sxa, sya, inv_w, max_anisotropy, s) for s in range(3)]
    tp0 = tps[0]
    row0, _fx, _fy, x0, y0 = _level_addr(cf, tp0, tp0["l0"])
    _r1, _fx1, _fy1, x1, y1 = _level_addr(cf, tp0, tp0["l1"])
    cx0, cy0 = x0 & 1, y0 & 1
    dx1 = (x1 == (x0 >> 1)).to(torch.int32)
    dy1 = (y1 == (y0 >> 1)).to(torch.int32)
    l1_eq = tp0["l1"] == tp0["l0"]
    prow = pool[torch.clamp(row0, 0, pool.shape[0] - 1).long()].to(torch.int64) & 0xFFFFFFFF
    lanes = torch.arange(n, device=tri.device)

    def texel_at(base_lane, cx, cy):
        def texel(slot, i, j):
            lane = base_lane + slot * 9 + (i + cy) * 3 + (j + cx)
            return prow[lanes, lane.long()]
        return texel

    texel0 = texel_at(0, cx0, cy0)
    texel_b = texel_at(SLOT_U32, dx1, dy1)

    def texel1(slot, i, j):
        return torch.where(l1_eq, texel0(slot, i, j), texel_b(slot, i, j))

    slot_tex = []
    for slot, srgb in ((0, True), (1, False), (2, False)):
        tp = tps[slot]
        _r, fx0, fy0, _x, _y = _level_addr(cf, tp, tp["l0"])
        _r, fx1, fy1, _x, _y = _level_addr(cf, tp, tp["l1"])
        s0 = _filter_slot(cf, texel0, slot, fx0, fy0, srgb)
        s1 = _filter_slot(cf, texel1, slot, fx1, fy1, srgb)
        lfrac = tp["lfrac"]
        slot_tex.append([fma(a, cf(1.0) - lfrac, b * lfrac) for a, b in zip(s0, s1)])
    base_tex, mr_tex, nrm_tex = slot_tex

    def attr(c0):
        return (fma(col(c0), sxa, col(c0 + 1) * sya) + col(c0 + 2)) * inv_w

    wp = [attr(C_WPOS + 3 * c) for c in range(3)]
    nr = [attr(C_NRM + 3 * c) for c in range(3)]
    tg = [attr(C_TAN + 3 * c) for c in range(4)]
    base_rgba = [col(C_BASE + c) * base_tex[c] for c in range(4)]
    metallic = col(C_MR) * mr_tex[2]
    roughness = col(C_MR + 1) * mr_tex[1]
    nrm = _rnorm(cf, *nr)
    tang = _rnorm(cf, tg[0], tg[1], tg[2])
    bx = fma(nrm[1], tang[2], -(nrm[2] * tang[1]))
    by = fma(nrm[2], tang[0], -(nrm[0] * tang[2]))
    bz = fma(nrm[0], tang[1], -(nrm[1] * tang[0]))
    bit = [c * tg[3] for c in _rnorm(cf, bx, by, bz)]
    ns = col(C_NSCALE)
    two, minus_one = cf(2.0), cf(-1.0)
    snx = fma(two, nrm_tex[0], minus_one) * ns
    sny = fma(two, nrm_tex[1], minus_one) * ns
    snz = fma(two, nrm_tex[2], minus_one)
    normal = _rnorm(cf, *[fma(nrm[k], snz, fma(tang[k], snx, bit[k] * sny)) for k in range(3)])
    cam = camera_position.to(torch.float32)
    view = _rnorm(cf, cam[0] - wp[0], cam[1] - wp[1], cam[2] - wp[2])
    radiance = _shade_lights(cf, wp, normal, view, base_rgba[:3], metallic, roughness,
                             lights.to(torch.float32))
    a = base_rgba[3]
    amode = col(C_AMODE)
    alpha = torch.where(amode == cf(0.0), cf(1.0),
                        torch.where(amode == cf(1.0), (a >= col(C_ACUT)).to(torch.float32), a))
    # uncovered pixels composite nothing
    alpha = torch.where(covered, alpha, cf(0.0))
    return radiance, alpha, covered


def linear_to_srgb_u8(v):
    """Resolve-time sRGB encode and u8 quantization of a value already
    clamped to [0, 1] (int32 out)."""
    srgb = torch.where(v <= f32(0.0031308, v), v * f32(12.92, v),
                       fma(f32(1.055, v), torch.pow(v, 1.0 / 2.4), f32(-0.055, v)))
    return fma(srgb, f32(255.0, v), f32(0.5, v)).to(torch.int32)


def shade_resolve_plain(tri, sx, sy, frac, table, pool, camera_position, lights,
                        background, max_anisotropy: float):
    """Plain-torch version: packed (N,) i32 pixels."""
    radiance, alpha, covered = _fragment_plain(tri, sx, sy, table, pool, camera_position,
                                               lights, max_anisotropy)
    zero, one = f32(0.0, sx), f32(1.0, sx)
    packed = torch.zeros_like(tri)
    for c in range(3):
        bg = background[c].to(torch.float32)
        rgb = torch.where(covered, radiance[c], zero)
        comp = fma(rgb, alpha, bg * (one - alpha))
        resolved = fma(comp, frac, bg * (one - frac))
        v = torch.minimum(torch.maximum(resolved, zero), one)
        packed = packed | (linear_to_srgb_u8(v) << (8 * c))
    return packed


def shade_layer_plain(tri, sx, sy, table, pool, camera_position, lights,
                      max_anisotropy: float):
    """Plain-torch version of shade_layer, one layer at a time."""
    zero = f32(0.0, sx)
    rgb, alpha = [], []
    for layer in tri:
        radiance, a, covered = _fragment_plain(layer, sx, sy, table, pool, camera_position,
                                               lights, max_anisotropy)
        rgb.append(torch.stack([torch.where(covered, r, zero) for r in radiance]))
        alpha.append(a)
    return torch.stack(rgb), torch.stack(alpha)


def _check_shade_operands(tri, sx, sy, table, pool):
    n = tri.shape[-1]
    dev = tri.device
    _cuda.require(tri, "tri", torch.int32, tri.shape)
    _cuda.require(sx, "sx", torch.float32, (n,), dev)
    _cuda.require(sy, "sy", torch.float32, (n,), dev)
    if table.dim() != 2 or table.shape[1] != ROW:
        raise ValueError(f"table must be (T, {ROW}), got {tuple(table.shape)}")
    _cuda.require(table, "table", torch.float32, device=dev)
    if pool.dim() != 2 or pool.shape[1] != 64 or pool.shape[0] == 0:
        raise ValueError(f"pool must be (P, 64) u32 lanes, got {tuple(pool.shape)}")
    _cuda.require(pool, "pool", torch.int32, device=dev)


def _params(camera_position, lights, background, dev):
    """The kernels' small constant block: camera (0:3), background (4:7),
    then the lights' 8 values each."""
    params = torch.zeros(8 + 8 * lights.shape[0], dtype=torch.float32, device=dev)
    params[0:3] = camera_position.to(device=dev, dtype=torch.float32)
    if background is not None:
        params[4:7] = background.to(device=dev, dtype=torch.float32)[:3]
    params[8:] = lights.to(device=dev, dtype=torch.float32).reshape(-1)
    return params


def shade_resolve(tri, sx, sy, frac, table, pool, camera_position, lights,
                  background, max_anisotropy: float):
    """Packed (N,) i32 pixels r | g << 8 | b << 16 (module docstring).

    tri (N,) i32 winning triangle (-1 none), sx/sy (N,) f32 pixel centres,
    frac (N,) f32 sample coverage, table (T, 64) f32, pool (P, 64) i32
    (u32 lanes), camera_position (3,), lights (L, 8), background (3,).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not tri.is_cuda:
        return shade_resolve_plain(tri, sx, sy, frac, table, pool,
                                   camera_position, lights, background,
                                   max_anisotropy)
    if tri.dim() != 1:
        raise ValueError(f"tri must be (N,), got {tuple(tri.shape)}")
    n = tri.shape[0]
    dev = tri.device
    _check_shade_operands(tri, sx, sy, table, pool)
    _cuda.require(frac, "frac", torch.float32, (n,), dev)
    num_lights = lights.shape[0]
    params = _params(camera_position, lights, background, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _cuda.library(KERNEL.source)
    fn = lib.vktf_shade_resolve
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if n:
        KERNEL.launches += 1
        _cuda.check(fn(_cuda.ptr(tri), _cuda.ptr(sx), _cuda.ptr(sy),
                       _cuda.ptr(frac), _cuda.ptr(table), _cuda.ptr(pool),
                       _cuda.ptr(params), _cuda.ptr(out), n, num_lights,
                       pool.shape[0], float(max_anisotropy),
                       float(np.float32(max_anisotropy * max_anisotropy)),
                       _cuda.stream_of(tri)), "shade kernel")
    return out


def shade_layer(tri, sx, sy, table, pool, camera_position, lights,
                max_anisotropy: float):
    """Layer form, one launch for every layer: (rgb, alpha) of each
    (layer, pixel), linear radiance and effective alpha for the depth-peel
    composite. tri (K, N) i32 (-1 uncovered); rgb (K, 3, N) f32, alpha
    (K, N) f32. An uncovered entry is rgb 0, alpha 0. Other operands as
    shade_resolve. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if tri.dim() != 2:
        raise ValueError(f"tri must be (K, N), got {tuple(tri.shape)}")
    if not tri.is_cuda:
        return shade_layer_plain(tri, sx, sy, table, pool, camera_position, lights,
                                 max_anisotropy)
    layers, n = tri.shape
    dev = tri.device
    _check_shade_operands(tri, sx, sy, table, pool)
    num_lights = lights.shape[0]
    params = _params(camera_position, lights, None, dev)
    rgb = torch.empty((layers, 3, n), dtype=torch.float32, device=dev)
    alpha = torch.empty(tri.shape, dtype=torch.float32, device=dev)
    lib = _cuda.library(KERNEL_LAYER.source)
    fn = lib.vktf_shade_layer
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if n:
        KERNEL_LAYER.launches += 1
        _cuda.check(fn(_cuda.ptr(tri), _cuda.ptr(sx), _cuda.ptr(sy), _cuda.ptr(table),
                       _cuda.ptr(pool), _cuda.ptr(params), _cuda.ptr(rgb),
                       _cuda.ptr(alpha), n, layers, num_lights, pool.shape[0],
                       float(max_anisotropy),
                       float(np.float32(max_anisotropy * max_anisotropy)),
                       _cuda.stream_of(tri)), "shade layer kernel")
    return rgb, alpha
