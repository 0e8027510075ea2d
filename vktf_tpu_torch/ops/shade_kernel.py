"""Deferred shade, resolve and layer forms of every texture configuration:
CUDA kernels and their plain versions.

Replaces ``vktf_tpu/ops/shade_kernel.py`` ``_shade_resolve_kernel`` and
``_shade_layer_kernel`` (body ``_shade_block_body``: the fused-pool branch
with one tap or N taps, and the two-gather ``q1`` branch),
``_attrs_resolve_kernel`` and ``_attrs_layer_kernel`` (body
``_attrs_block_body``), all launched by ``_shade_final_call``, and the XLA
form ``shade_table.shade_table_layer`` that the JAX package runs for
per-slot (mixed) samplers and for taps on a two-gather scene. Per pixel,
from its triangle's shade-table row:

  * plane evaluation at the pixel centre (anchored, perspective-correct);
  * the sampler's LOD stage: analytic uv derivatives, anisotropic LOD
    sharpening, the mip pair (l0, l1) and lerp weight (_texture_params);
    with ``taps`` N > 1, N positions along the major footprint axis
    (``tap_shift``), each sampled on its own and averaged before the BRDF;
  * texels from one of three sources (``texels``):
      - "fused": one pool row serves both levels, slot A for l0 and slot B
        for l1 (slot A again when l1 == l0); exact for REPEAT/CLAMP wrap
        with one sampler per material;
      - "classic": the l0 row and the l1 row, each read in slot A with its
        own 2x2 fold case (mirror-wrap scenes, or ``shade_fused_pool``
        off);
      - "per_slot": the classic pair for each of the three textures, at
        that texture's own wrap (mixed-sampler scenes);
  * bilinear taps with per-texel sRGB decode, trilinear lerp, for base
    color, metallic-roughness and normal;
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

The attrs boundary (``shade_attrs_boundary``) splits the same work in two:
``fragment_attrs`` (plain torch on any device, the XLA phase A of the JAX
package) evaluates the planes and the addressing once per pixel into 28
rows and the two pool rows; ``shade_attrs_resolve`` / ``shade_attrs_layer``
filter and shade from them (two-gather pool, one sampler per material, one
tap). Both boundaries compute every value with the same helpers, so their
frames are bit-identical.

Every form shares one fragment tail (``_fragment_tail`` in the plain
versions, ``shade_tail`` in ``csrc/shade.cu``) and one sampling body
(``_slot_tex`` / ``sample_slots``); the texel source is a template
parameter of the CUDA kernels and the tap count a runtime loop.

The TPU kernel received its table columns and pool rows from separate XLA
gathers (its two-program phase split exists because its VMEM could not
hold both operands); here the kernels gather both rows themselves, so no
(2*ROW, N) phase-boundary tensor exists.

CUDA design (``csrc/shade.cu``): one thread per pixel, in the layer form
walking that pixel's K layers in one launch; an uncovered pixel or entry
writes its clear result at once. Bound on the card: float32 work per
covered entry (~1.6k operations with five lights) behind a chain of
dependent gathers (tri, the 256-byte table row, one to six 256-byte pool
rows per tap) that L2 mostly serves. The body is built to issue fewer
instructions and hold fewer registers: texel bytes decode through two
256-entry shared-memory tables (u8/255 and its sRGB-to-linear value,
filled with the inline decode's own expressions, so bit-equal to it) in
place of 96 divisions and 24 ``powf`` per tap; each (slot, level) is
addressed once per tap from a level geometry computed once per fragment;
the table row comes in 16-byte loads, the tail's columns after the texture
fetches. ptxas keeps every instantiation between 56 and 104 registers
with no spill at 128-thread blocks. Times on the card, against the
previous design and the bound, for all 14 records: PERF.md (kernel_ab.py,
chip_smoke.py).

Arithmetic follows the JAX package's XLA form: the same fused
multiply-adds (``ops/fmath.py``). Transcendentals (pow, log2, rsqrt) are
each library's own and differ by ULPs, which can move a u8 by one step.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vktf_tpu_torch.config import ANISO_TAPS as TAPS
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

# texel sources (the kernels' template parameter)
TEXELS = ("fused", "classic", "per_slot")

# attrs-boundary rows (vktf_tpu/ops/shade_table.py:691-695): per pixel, the
# footprint fractions and lerp weight, the window fold cases as 0.0 / 1.0,
# the interpolated world position, normal and tangent, and the material
# factors
A_FX0, A_FY0, A_FX1, A_FY1, A_LFRAC = 0, 1, 2, 3, 4
A_CX0, A_CY0, A_CX1, A_CY1 = 5, 6, 7, 8
A_WPOS, A_NRM, A_TAN = 9, 12, 15
A_BASE, A_MR, A_NSCALE, A_AMODE, A_ACUT = 19, 23, 25, 26, 27
ATTR_ROWS = 28

_SHADE_CALL = "via _shade_final_call, pallas_call :646"
KERNEL = _cuda.Kernel(
    "shade", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:267 (_shade_resolve_kernel {_SHADE_CALL})",
)
KERNEL_LAYER = _cuda.Kernel(
    "shade_layer", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:216 (_shade_layer_kernel {_SHADE_CALL})",
)
KERNEL_TAPS = _cuda.Kernel(
    "shade_taps", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:148 (multi-tap branch of _shade_resolve_kernel {_SHADE_CALL})",
)
KERNEL_LAYER_TAPS = _cuda.Kernel(
    "shade_layer_taps", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:148 (multi-tap branch of _shade_layer_kernel {_SHADE_CALL})",
)
KERNEL_CLASSIC = _cuda.Kernel(
    "shade_classic", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:197 (two-gather q1 branch of _shade_resolve_kernel {_SHADE_CALL})",
)
KERNEL_LAYER_CLASSIC = _cuda.Kernel(
    "shade_layer_classic", "shade.cu",
    f"vktf_tpu/ops/shade_kernel.py:197 (two-gather q1 branch of _shade_layer_kernel {_SHADE_CALL})",
)
KERNEL_PER_SLOT = _cuda.Kernel(
    "shade_per_slot", "shade.cu",
    "vktf_tpu/ops/shade_table.py:836 (shade_table_layer per_slot_samplers, XLA; no pallas_call)",
)
KERNEL_LAYER_PER_SLOT = _cuda.Kernel(
    "shade_layer_per_slot", "shade.cu",
    "vktf_tpu/ops/shade_table.py:836 (shade_table_layer per_slot_samplers, XLA; no pallas_call)",
)
_XLA_TAPS = "vktf_tpu/ops/shade_table.py:817 (multi-tap shade_table_layer"
KERNEL_CLASSIC_TAPS = _cuda.Kernel(
    "shade_classic_taps", "shade.cu", f"{_XLA_TAPS}, two-gather rows, XLA; no pallas_call)",
)
KERNEL_LAYER_CLASSIC_TAPS = _cuda.Kernel(
    "shade_layer_classic_taps", "shade.cu",
    f"{_XLA_TAPS}, two-gather rows, XLA; no pallas_call)",
)
KERNEL_PER_SLOT_TAPS = _cuda.Kernel(
    "shade_per_slot_taps", "shade.cu",
    f"{_XLA_TAPS} per_slot_samplers, XLA; no pallas_call)",
)
KERNEL_LAYER_PER_SLOT_TAPS = _cuda.Kernel(
    "shade_layer_per_slot_taps", "shade.cu",
    f"{_XLA_TAPS} per_slot_samplers, XLA; no pallas_call)",
)
KERNEL_ATTRS = _cuda.Kernel(
    "shade_attrs", "shade.cu",
    "vktf_tpu/ops/shade_kernel.py:355 (_attrs_resolve_kernel via shade_final_attrs_chunk, pallas_call :646)",
)
KERNEL_ATTRS_LAYER = _cuda.Kernel(
    "shade_attrs_layer", "shade.cu",
    "vktf_tpu/ops/shade_kernel.py:341 (_attrs_layer_kernel via shade_final_attrs_chunk, pallas_call :646)",
)
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_cuda.declare("shade.cu", "vktf_shade_resolve", [_I] * 2 + [_P] * 8 + [_I] * 3 + [_F] * 2 + [_P])
_cuda.declare("shade.cu", "vktf_shade_layer", [_I] * 2 + [_P] * 8 + [_I] * 4 + [_F] * 2 + [_P])
_cuda.declare("shade.cu", "vktf_shade_attrs_resolve", [_P] * 8 + [_I] * 3 + [_P])
_cuda.declare("shade.cu", "vktf_shade_attrs_layer", [_P] * 8 + [_I] * 4 + [_P])
# (texels, taps > 1) -> (resolve record, layer record): one record for each
# compiled instantiation of the CUDA template
_COLS_KERNELS = {
    ("fused", False): (KERNEL, KERNEL_LAYER),
    ("fused", True): (KERNEL_TAPS, KERNEL_LAYER_TAPS),
    ("classic", False): (KERNEL_CLASSIC, KERNEL_LAYER_CLASSIC),
    ("classic", True): (KERNEL_CLASSIC_TAPS, KERNEL_LAYER_CLASSIC_TAPS),
    ("per_slot", False): (KERNEL_PER_SLOT, KERNEL_LAYER_PER_SLOT),
    ("per_slot", True): (KERNEL_PER_SLOT_TAPS, KERNEL_LAYER_PER_SLOT_TAPS),
}
KERNELS = (KERNEL, KERNEL_LAYER, KERNEL_TAPS, KERNEL_LAYER_TAPS, KERNEL_CLASSIC,
           KERNEL_LAYER_CLASSIC, KERNEL_PER_SLOT, KERNEL_LAYER_PER_SLOT, KERNEL_CLASSIC_TAPS,
           KERNEL_LAYER_CLASSIC_TAPS, KERNEL_PER_SLOT_TAPS, KERNEL_LAYER_PER_SLOT_TAPS,
           KERNEL_ATTRS, KERNEL_ATTRS_LAYER)


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


def _anchored(cf, col, sx, sy):
    """(1/w, attr): the anchored perspective-correct plane evaluation of a
    table-row accessor at the pixel centres."""
    sxa = sx - col(C_AX)
    sya = sy - col(C_AY)
    w = fma(col(0), sxa, col(1) * sya) + col(2)
    inv_w = cf(1.0) / torch.where(w.abs() < cf(1e-30), cf(1e-30), w)

    def attr(c0):
        return (fma(col(c0), sxa, col(c0 + 1) * sya) + col(c0 + 2)) * inv_w

    return inv_w, attr


def _texture_params(cf, col, inv_w, attr, max_anisotropy: float, slot: int,
                    tap_shift=None):
    """uv and the mip selection of one texture slot; with tap_shift (a
    float in [-0.5, 0.5]) the sample moves that fraction of the major
    footprint axis, clamped to max_anisotropy minor axes."""
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
    if tap_shift is not None:
        major_x = ddx2 >= ddy2
        rho_maj = torch.sqrt(torch.maximum(torch.maximum(ddx2, ddy2), tiny))
        rho_min = torch.sqrt(torch.maximum(torch.minimum(ddx2, ddy2), tiny))
        scale = torch.minimum(cf(1.0), cf(max_anisotropy) * rho_min / rho_maj)
        step = cf(tap_shift) * scale
        u = fma(step, torch.where(major_x, du_dx, du_dy), u)
        v = fma(step, torch.where(major_x, dv_dx, dv_dy), v)
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
    """(pool row, fx, fy, x0, y0) of one mip level: the block row holding
    the wrapped footprint corner (x0, y0), and the bilinear fractions."""
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


def pool_window_addr(cf, tp):
    """Both mip levels' (pool row, fx, fy, x0, y0) for one sampler
    (vktf_tpu/ops/shade_table.py pool_window_addr; the rows are its
    pool_row_indices)."""
    return _level_addr(cf, tp, tp["l0"]), _level_addr(cf, tp, tp["l1"])


def _texel_reader(pool, row, cx, cy, base: int = 0):
    """texel(slot, i, j): the packed RGBA8 texel (as int64) at window (i, j)
    of texture `slot`'s 3x3 block in the level slot at u32 lane `base` of
    pool row `row` (clamped into the pool); (cx, cy) is the 2x2 fold case."""
    start = torch.clamp(row, 0, pool.shape[0] - 1).long() * pool.shape[1] + base
    flat = pool.reshape(-1)

    def texel(slot, i, j):
        return flat[start + (slot * 9 + (i + cy) * 3 + (j + cx))].to(torch.int64) & 0xFFFFFFFF

    return texel


def _fused_texels(cf, pool, tps):
    """One row per pixel: slot A for l0, slot B for l1 (slot A again where
    l1 == l0, the chain top); vktf_tpu/ops/shade_table.py fused_window_addr."""
    tp0 = tps[0]
    (row0, _fx, _fy, x0, y0), (_r1, _fx1, _fy1, x1, y1) = pool_window_addr(cf, tp0)
    texel0 = _texel_reader(pool, row0, x0 & 1, y0 & 1)
    texel_b = _texel_reader(pool, row0, (x1 == (x0 >> 1)).to(torch.int32),
                            (y1 == (y0 >> 1)).to(torch.int32), base=SLOT_U32)
    l1_eq = tp0["l1"] == tp0["l0"]

    def texel1(slot, i, j):
        return torch.where(l1_eq, texel0(slot, i, j), texel_b(slot, i, j))

    return texel0, texel1


def _classic_texels(cf, pool, tps):
    """The l0 row and the l1 row, each in slot A with its own fold case,
    addressed at slot 0's sampler (one sampler per material)."""
    (row0, _fx, _fy, x0, y0), (row1, _fx1, _fy1, x1, y1) = pool_window_addr(cf, tps[0])
    return (_texel_reader(pool, row0, x0 & 1, y0 & 1),
            _texel_reader(pool, row1, x1 & 1, y1 & 1))


def _per_slot_texels(cf, pool, tps):
    """The classic pair for each texture at its own sampler's wrap."""
    pairs = [_classic_texels(cf, pool, [tp]) for tp in tps]

    def texel0(slot, i, j):
        return pairs[slot][0](slot, i, j)

    def texel1(slot, i, j):
        return pairs[slot][1](slot, i, j)

    return texel0, texel1


_TEXEL_SOURCES = {"fused": _fused_texels, "classic": _classic_texels,
                  "per_slot": _per_slot_texels}


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
    return out


def _trilinear(cf, texel0, texel1, slot, fx0, fy0, fx1, fy1, lfrac):
    """One texture's trilinear sample (channel list)."""
    srgb = slot == 0
    s0 = _filter_slot(cf, texel0, slot, fx0, fy0, srgb)
    s1 = _filter_slot(cf, texel1, slot, fx1, fy1, srgb)
    return [fma(a, cf(1.0) - lfrac, b * lfrac) for a, b in zip(s0, s1)]


def _slot_tex(cf, tps, texel0, texel1):
    """[base, metallic-roughness, normal] samples at one (possibly
    tap-shifted) position, each texture at its own sampler's fractions."""
    out = []
    for slot, tp in enumerate(tps):
        (_r0, fx0, fy0, _x0, _y0), (_r1, fx1, fy1, _x1, _y1) = pool_window_addr(cf, tp)
        out.append(_trilinear(cf, texel0, texel1, slot, fx0, fy0, fx1, fy1, tp["lfrac"]))
    return out


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


def _fragment_tail(cf, slot_tex, base_f, mr_f, normal_scale, wp, nr, tg, amode, acut,
                   camera_position, lights, covered):
    """The fragment body after texturing (vktf_tpu/ops/shade_table.py
    fragment_brdf_alpha): factors, TBN normal mapping, the BRDF over the
    lights and the glTF alpha mode; (radiance [r, g, b], alpha, covered)
    with alpha 0 where uncovered."""
    base_tex, mr_tex, nrm_tex = slot_tex
    base_rgba = [base_f[c] * base_tex[c] for c in range(4)]
    metallic = mr_f[0] * mr_tex[2]
    roughness = mr_f[1] * mr_tex[1]
    nrm = _rnorm(cf, *nr)
    tang = _rnorm(cf, tg[0], tg[1], tg[2])
    bx = fma(nrm[1], tang[2], -(nrm[2] * tang[1]))
    by = fma(nrm[2], tang[0], -(nrm[0] * tang[2]))
    bz = fma(nrm[0], tang[1], -(nrm[1] * tang[0]))
    bit = [c * tg[3] for c in _rnorm(cf, bx, by, bz)]
    two, minus_one = cf(2.0), cf(-1.0)
    snx = fma(two, nrm_tex[0], minus_one) * normal_scale
    sny = fma(two, nrm_tex[1], minus_one) * normal_scale
    snz = fma(two, nrm_tex[2], minus_one)
    normal = _rnorm(cf, *[fma(nrm[k], snz, fma(tang[k], snx, bit[k] * sny)) for k in range(3)])
    cam = camera_position.to(torch.float32)
    view = _rnorm(cf, cam[0] - wp[0], cam[1] - wp[1], cam[2] - wp[2])
    radiance = _shade_lights(cf, wp, normal, view, base_rgba[:3], metallic, roughness,
                             lights.to(torch.float32))
    a = base_rgba[3]
    alpha = torch.where(amode == cf(0.0), cf(1.0),
                        torch.where(amode == cf(1.0), (a >= acut).to(torch.float32), a))
    # uncovered pixels composite nothing
    alpha = torch.where(covered, alpha, cf(0.0))
    return radiance, alpha, covered


def _check_form(texels: str, taps: int) -> None:
    if texels not in TEXELS:
        raise ValueError(f"texels must be one of {TEXELS}, got {texels!r}")
    if taps not in TAPS:
        raise ValueError(f"taps must be one of {TAPS}, got {taps}")


def _fragment_plain(tri, sx, sy, table, pool, camera_position, lights,
                    max_anisotropy: float, texels: str = "fused", taps: int = 1):
    """The fragment body of the table-row forms: per pixel, (radiance
    [r, g, b], effective alpha, covered). Uncovered pixels shade table row
    0 and get alpha 0. With taps N > 1 the N texture samples are summed in
    tap order and scaled by 1/N before the BRDF."""
    def cf(v):  # float32 constants on the pixels' device
        return f32(v, sx)

    rows = table[torch.clamp(tri, min=0).long()]  # (N, 64)

    def col(c):
        return rows[:, c]

    inv_w, attr = _anchored(cf, col, sx, sy)
    source = _TEXEL_SOURCES[texels]

    def sample(tap_shift):
        tps = [_texture_params(cf, col, inv_w, attr, max_anisotropy, s, tap_shift)
               for s in range(3)]
        return _slot_tex(cf, tps, *source(cf, pool, tps))

    if taps == 1:
        slot_tex = sample(None)
    else:
        acc = None
        for i in range(taps):
            st = sample((i + 0.5) / taps - 0.5)
            acc = st if acc is None else [[a + b for a, b in zip(sa, sb)]
                                          for sa, sb in zip(acc, st)]
        inv = cf(1.0 / taps)
        slot_tex = [[c * inv for c in st] for st in acc]
    return _fragment_tail(
        cf, slot_tex, [col(C_BASE + c) for c in range(4)], (col(C_MR), col(C_MR + 1)),
        col(C_NSCALE), [attr(C_WPOS + 3 * c) for c in range(3)],
        [attr(C_NRM + 3 * c) for c in range(3)], [attr(C_TAN + 3 * c) for c in range(4)],
        col(C_AMODE), col(C_ACUT), camera_position, lights, tri >= 0)


def _attrs_rows(tri, sx, sy, table, max_anisotropy: float):
    def cf(v):
        return f32(v, sx)

    rows = table[torch.clamp(tri, min=0).long()]

    def col(c):
        return rows[:, c]

    inv_w, attr = _anchored(cf, col, sx, sy)
    tp = _texture_params(cf, col, inv_w, attr, max_anisotropy, 0)
    (r0, fx0, fy0, x0, y0), (r1, fx1, fy1, x1, y1) = pool_window_addr(cf, tp)
    out = [fx0, fy0, fx1, fy1, tp["lfrac"]]
    out += [(c & 1).to(torch.float32) for c in (x0, y0, x1, y1)]
    out += [attr(C_WPOS + 3 * c) for c in range(3)]
    out += [attr(C_NRM + 3 * c) for c in range(3)]
    out += [attr(C_TAN + 3 * c) for c in range(4)]
    out += [col(C_BASE + c) for c in range(4)]
    out += [col(C_MR), col(C_MR + 1), col(C_NSCALE), col(C_AMODE), col(C_ACUT)]
    return torch.stack(out), r0, r1


def fragment_attrs(tri, sx, sy, table, max_anisotropy: float):
    """Phase A of the attrs boundary (vktf_tpu/ops/shade_kernel.py
    shade_attrs_chunk; XLA in the JAX package, plain torch here on either
    device): per pixel the ATTR_ROWS rows of the A_* layout and the pool
    rows of the two mip levels, from the same helpers as the table-row
    forms. tri (N,) -> (attrs (28, N) f32, r0 (N,) i32, r1 (N,) i32);
    tri (K, N) -> (K, 28, N), (K, N), (K, N), filled one layer at a time
    (only one layer's table rows are gathered at once)."""
    if tri.dim() == 1:
        return _attrs_rows(tri, sx, sy, table, max_anisotropy)
    layers, n = tri.shape
    attrs = torch.empty((layers, ATTR_ROWS, n), dtype=torch.float32, device=tri.device)
    r0 = torch.empty(tri.shape, dtype=torch.int32, device=tri.device)
    r1 = torch.empty_like(r0)
    for l in range(layers):
        attrs[l], r0[l], r1[l] = _attrs_rows(tri[l], sx, sy, table, max_anisotropy)
    return attrs, r0, r1


def _fragment_from_attrs(attrs, r0, r1, tri, pool, camera_position, lights):
    """shade_from_attrs (vktf_tpu/ops/shade_table.py:724): the fragment body
    from phase A's rows; one footprint serves the three textures."""
    def cf(v):
        return f32(v, attrs)

    a = attrs
    texel0 = _texel_reader(pool, r0, (a[A_CX0] != 0).to(torch.int32),
                           (a[A_CY0] != 0).to(torch.int32))
    texel1 = _texel_reader(pool, r1, (a[A_CX1] != 0).to(torch.int32),
                           (a[A_CY1] != 0).to(torch.int32))
    slot_tex = [_trilinear(cf, texel0, texel1, slot, a[A_FX0], a[A_FY0], a[A_FX1],
                           a[A_FY1], a[A_LFRAC]) for slot in range(3)]
    return _fragment_tail(
        cf, slot_tex, [a[A_BASE + c] for c in range(4)], (a[A_MR], a[A_MR + 1]),
        a[A_NSCALE], [a[A_WPOS + c] for c in range(3)], [a[A_NRM + c] for c in range(3)],
        [a[A_TAN + c] for c in range(4)], a[A_AMODE], a[A_ACUT], camera_position, lights,
        tri >= 0)


def linear_to_srgb_u8(v):
    """Resolve-time sRGB encode and u8 quantization of a value already
    clamped to [0, 1] (int32 out)."""
    srgb = torch.where(v <= f32(0.0031308, v), v * f32(12.92, v),
                       fma(f32(1.055, v), torch.pow(v, 1.0 / 2.4), f32(-0.055, v)))
    return fma(srgb, f32(255.0, v), f32(0.5, v)).to(torch.int32)


def _resolve_pack(radiance, alpha, covered, frac, background):
    """Composite over the clear colour, coverage resolve, sRGB encode:
    packed (N,) i32 r | g << 8 | b << 16."""
    zero, one = f32(0.0, frac), f32(1.0, frac)
    packed = torch.zeros(covered.shape, dtype=torch.int32, device=frac.device)
    for c in range(3):
        bg = background[c].to(torch.float32)
        rgb = torch.where(covered, radiance[c], zero)
        comp = fma(rgb, alpha, bg * (one - alpha))
        resolved = fma(comp, frac, bg * (one - frac))
        v = torch.minimum(torch.maximum(resolved, zero), one)
        packed = packed | (linear_to_srgb_u8(v) << (8 * c))
    return packed


def _layer_out(radiance, alpha, covered):
    zero = f32(0.0, alpha)
    return torch.stack([torch.where(covered, r, zero) for r in radiance]), alpha


def shade_resolve_plain(tri, sx, sy, frac, table, pool, camera_position, lights,
                        background, max_anisotropy: float, texels: str = "fused",
                        taps: int = 1):
    """Plain-torch version: packed (N,) i32 pixels."""
    _check_form(texels, taps)
    radiance, alpha, covered = _fragment_plain(tri, sx, sy, table, pool, camera_position,
                                               lights, max_anisotropy, texels, taps)
    return _resolve_pack(radiance, alpha, covered, frac, background)


def shade_layer_plain(tri, sx, sy, table, pool, camera_position, lights,
                      max_anisotropy: float, texels: str = "fused", taps: int = 1):
    """Plain-torch version of shade_layer, one layer at a time."""
    _check_form(texels, taps)
    outs = [_layer_out(*_fragment_plain(layer, sx, sy, table, pool, camera_position,
                                        lights, max_anisotropy, texels, taps))
            for layer in tri]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def shade_attrs_resolve_plain(attrs, r0, r1, tri, frac, pool, camera_position, lights,
                              background):
    """Plain-torch version of shade_attrs_resolve."""
    radiance, alpha, covered = _fragment_from_attrs(attrs, r0, r1, tri, pool,
                                                    camera_position, lights)
    return _resolve_pack(radiance, alpha, covered, frac, background)


def shade_attrs_layer_plain(attrs, r0, r1, tri, pool, camera_position, lights):
    """Plain-torch version of shade_attrs_layer, one layer at a time."""
    outs = [_layer_out(*_fragment_from_attrs(attrs[l], r0[l], r1[l], tri[l], pool,
                                             camera_position, lights))
            for l in range(tri.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _check_pool(pool, dev):
    if pool.dim() != 2 or pool.shape[1] != 64 or pool.shape[0] == 0:
        raise ValueError(f"pool must be (P, 64) u32 lanes, got {tuple(pool.shape)}")
    _cuda.require(pool, "pool", torch.int32, device=dev)


def _check_shade_operands(tri, sx, sy, table, pool):
    n = tri.shape[-1]
    dev = tri.device
    _cuda.require(tri, "tri", torch.int32, tri.shape)
    _cuda.require(sx, "sx", torch.float32, (n,), dev)
    _cuda.require(sy, "sy", torch.float32, (n,), dev)
    if table.dim() != 2 or table.shape[1] != ROW:
        raise ValueError(f"table must be (T, {ROW}), got {tuple(table.shape)}")
    _cuda.require(table, "table", torch.float32, device=dev)
    _cuda.require_aligned(table, "table")
    _check_pool(pool, dev)


def _check_attrs_operands(attrs, r0, r1, tri, pool):
    dev = tri.device
    _cuda.require(tri, "tri", torch.int32, tri.shape)
    _cuda.require(attrs, "attrs", torch.float32,
                  (*tri.shape[:-1], ATTR_ROWS, tri.shape[-1]), dev)
    _cuda.require(r0, "r0", torch.int32, tri.shape, dev)
    _cuda.require(r1, "r1", torch.int32, tri.shape, dev)
    _check_pool(pool, dev)


def _params(camera_position, lights, background, dev):
    """The kernels' small constant block: camera (0:3), background (4:7),
    then the lights' 8 values each."""
    params = torch.zeros(8 + 8 * lights.shape[0], dtype=torch.float32, device=dev)
    params[0:3] = camera_position.to(device=dev, dtype=torch.float32)
    if background is not None:
        params[4:7] = background.to(device=dev, dtype=torch.float32)[:3]
    params[8:] = lights.to(device=dev, dtype=torch.float32).reshape(-1)
    return params


def _aniso_args(max_anisotropy: float):
    return float(max_anisotropy), float(np.float32(max_anisotropy * max_anisotropy))


def shade_resolve(tri, sx, sy, frac, table, pool, camera_position, lights,
                  background, max_anisotropy: float, texels: str = "fused",
                  taps: int = 1):
    """Packed (N,) i32 pixels r | g << 8 | b << 16 (module docstring).

    tri (N,) i32 winning triangle (-1 none), sx/sy (N,) f32 pixel centres,
    frac (N,) f32 sample coverage, table (T, 64) f32, pool (P, 64) i32
    (u32 lanes), camera_position (3,), lights (L, 8), background (3,);
    texels one of TEXELS, taps one of TAPS. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_form(texels, taps)
    if not tri.is_cuda:
        return shade_resolve_plain(tri, sx, sy, frac, table, pool, camera_position, lights,
                                   background, max_anisotropy, texels, taps)
    if tri.dim() != 1:
        raise ValueError(f"tri must be (N,), got {tuple(tri.shape)}")
    n = tri.shape[0]
    dev = tri.device
    _check_shade_operands(tri, sx, sy, table, pool)
    _cuda.require(frac, "frac", torch.float32, (n,), dev)
    params = _params(camera_position, lights, background, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _cuda.launch(_COLS_KERNELS[(texels, taps > 1)][0], "vktf_shade_resolve",
                (TEXELS.index(texels), taps, _cuda.ptr(tri), _cuda.ptr(sx), _cuda.ptr(sy),
                 _cuda.ptr(frac), _cuda.ptr(table), _cuda.ptr(pool), _cuda.ptr(params),
                 _cuda.ptr(out), n, lights.shape[0], pool.shape[0],
                 *_aniso_args(max_anisotropy), _cuda.stream_of(tri)),
                "shade kernel", tri.device)
    return out


def shade_layer(tri, sx, sy, table, pool, camera_position, lights,
                max_anisotropy: float, texels: str = "fused", taps: int = 1):
    """Layer form, one launch for every layer: (rgb, alpha) of each
    (layer, pixel), linear radiance and effective alpha for the depth-peel
    composite. tri (K, N) i32 (-1 uncovered); rgb (K, 3, N) f32, alpha
    (K, N) f32. An uncovered entry is rgb 0, alpha 0. Other operands as
    shade_resolve. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check_form(texels, taps)
    if tri.dim() != 2:
        raise ValueError(f"tri must be (K, N), got {tuple(tri.shape)}")
    if not tri.is_cuda:
        return shade_layer_plain(tri, sx, sy, table, pool, camera_position, lights,
                                 max_anisotropy, texels, taps)
    layers, n = tri.shape
    dev = tri.device
    _check_shade_operands(tri, sx, sy, table, pool)
    params = _params(camera_position, lights, None, dev)
    rgb = torch.empty((layers, 3, n), dtype=torch.float32, device=dev)
    alpha = torch.empty(tri.shape, dtype=torch.float32, device=dev)
    if n:
        _cuda.launch(_COLS_KERNELS[(texels, taps > 1)][1], "vktf_shade_layer",
                (TEXELS.index(texels), taps, _cuda.ptr(tri), _cuda.ptr(sx), _cuda.ptr(sy),
                 _cuda.ptr(table), _cuda.ptr(pool), _cuda.ptr(params), _cuda.ptr(rgb),
                 _cuda.ptr(alpha), n, layers, lights.shape[0], pool.shape[0],
                 *_aniso_args(max_anisotropy), _cuda.stream_of(tri)),
                "shade layer kernel", tri.device)
    return rgb, alpha


def shade_attrs_resolve(attrs, r0, r1, tri, frac, pool, camera_position, lights,
                        background):
    """Resolve form of the attrs boundary: packed (N,) i32 pixels from
    fragment_attrs' rows. attrs (28, N) f32, r0/r1 (N,) i32 pool rows of
    the two levels, tri/frac/pool and the rest as shade_resolve. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not tri.is_cuda:
        return shade_attrs_resolve_plain(attrs, r0, r1, tri, frac, pool, camera_position,
                                         lights, background)
    if tri.dim() != 1:
        raise ValueError(f"tri must be (N,), got {tuple(tri.shape)}")
    n = tri.shape[0]
    dev = tri.device
    _check_attrs_operands(attrs, r0, r1, tri, pool)
    _cuda.require(frac, "frac", torch.float32, (n,), dev)
    params = _params(camera_position, lights, background, dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _cuda.launch(KERNEL_ATTRS, "vktf_shade_attrs_resolve",
                (_cuda.ptr(attrs), _cuda.ptr(r0), _cuda.ptr(r1), _cuda.ptr(tri),
                 _cuda.ptr(frac), _cuda.ptr(pool), _cuda.ptr(params), _cuda.ptr(out), n,
                 lights.shape[0], pool.shape[0], _cuda.stream_of(tri)),
                "shade attrs kernel", tri.device)
    return out


def shade_attrs_layer(attrs, r0, r1, tri, pool, camera_position, lights):
    """Layer form of the attrs boundary, one launch for every layer:
    attrs (K, 28, N), r0/r1/tri (K, N) -> rgb (K, 3, N), alpha (K, N) as
    shade_layer. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if tri.dim() != 2:
        raise ValueError(f"tri must be (K, N), got {tuple(tri.shape)}")
    if not tri.is_cuda:
        return shade_attrs_layer_plain(attrs, r0, r1, tri, pool, camera_position, lights)
    layers, n = tri.shape
    dev = tri.device
    _check_attrs_operands(attrs, r0, r1, tri, pool)
    params = _params(camera_position, lights, None, dev)
    rgb = torch.empty((layers, 3, n), dtype=torch.float32, device=dev)
    alpha = torch.empty(tri.shape, dtype=torch.float32, device=dev)
    if n:
        _cuda.launch(KERNEL_ATTRS_LAYER, "vktf_shade_attrs_layer",
                (_cuda.ptr(attrs), _cuda.ptr(r0), _cuda.ptr(r1), _cuda.ptr(tri),
                 _cuda.ptr(pool), _cuda.ptr(params), _cuda.ptr(rgb), _cuda.ptr(alpha), n,
                 layers, lights.shape[0], pool.shape[0], _cuda.stream_of(tri)),
                "shade attrs layer kernel", tri.device)
    return rgb, alpha
