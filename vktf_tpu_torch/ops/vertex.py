"""Vertex stage in plain torch: node transform propagation and the
homogeneous triangle setup.

Counterpart of ``vktf_tpu/ops/vertex.py``. ``setup_from_corners`` is the
math of ``_setup_from_corners(flat_out=True)`` (2D-homogeneous, Olano-Greer
edge functions anchored at the clipped bbox corner, screen-space coverage
planes for sane projections, near-plane-clipped conservative bboxes, the
slim-body safety proof), written with the fused multiply-adds XLA forms
(``ops/fmath.py``); ``csrc/setup.cu`` is the same sequence per thread. One
deliberate difference: on the screen-space path the depth plane comes from
the corners' NDC depths over their screen positions, not from the JAX
package's cofactor sums, which cancel (its depth is off float64 by up to
~1e-3, this one by ~1e-7: tests/test_torch_setup.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from vktf_tpu_torch.ops.fmath import f32, fma


def propagate_transforms(node_local: torch.Tensor, node_parent: torch.Tensor,
                         level_slices: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Compose local transforms level by level: global = parent @ local."""
    node_global = node_local
    for start, end in level_slices[1:]:  # level 0 = roots: global == local
        composed = torch.bmm(node_global[node_parent[start:end]],
                             node_local[start:end])
        node_global = torch.cat(
            [node_global[:start], composed, node_global[end:]], dim=0)
    return node_global


def world_corners(mrt, tc, base: int, translate: bool):
    """Per channel c, per corner i: rotate (+ translate) the object-space
    corners of a vec3 attribute. mrt (16, T) instance-matrix rows, tc the
    (36, T) corner table."""
    out = []
    for c in range(3):
        row = []
        for i in range(3):
            v = fma(mrt[c * 4 + 2], tc[base + 6 + i],
                    fma(mrt[c * 4 + 0], tc[base + i],
                        mrt[c * 4 + 1] * tc[base + 3 + i]))
            if translate:
                v = v + mrt[c * 4 + 3]
            row.append(v)
        out.append(row)
    return out


def clip_corners(tri_corner, mrowsT, view_projection):
    """Clip-space x, y, z, w of the 3 corners: lists of 3 (T,) tensors."""
    wc = world_corners(mrowsT, tri_corner, 6, translate=True)
    vp = view_projection

    def clip_row(k, i):
        return fma(vp[k, 2], wc[2][i],
                   fma(vp[k, 0], wc[0][i], vp[k, 1] * wc[1][i])) + vp[k, 3]

    return [[clip_row(k, i) for i in range(3)] for k in range(4)]


def setup_from_corners(x, y, z, w, width: int, height: int) -> dict:
    """Flat triangle setup from per-corner clip components (lists of 3
    (T,) f32 tensors). Returns the flat_out dict of the JAX package."""
    t = x[0]
    c0 = f32(0.0, t)
    c1 = f32(1.0, t)
    eps12 = f32(1e-12, t)
    xs = [(x[i] + w[i]) * f32(0.5 * width, t) for i in range(3)]
    ys = [(y[i] + w[i]) * f32(0.5 * height, t) for i in range(3)]

    def cross(i, j):  # rows r_i x r_j, r = (xs, ys, w)
        return (
            fma(ys[i], w[j], -(w[i] * ys[j])),
            fma(w[i], xs[j], -(xs[i] * w[j])),
            fma(xs[i], ys[j], -(ys[i] * xs[j])),
        )

    cof0 = cross(2, 1)
    cof1 = cross(0, 2)
    cof2 = cross(1, 0)
    det = fma(w[0], cof0[2], fma(xs[0], cof0[0], ys[0] * cof0[1]))

    behind = [w[i] <= eps12 for i in range(3)]
    all_behind = behind[0] & behind[1] & behind[2]
    any_behind = behind[0] | behind[1] | behind[2]
    valid = (det > eps12) & ~all_behind
    inv_det = torch.where(valid, c1 / torch.where(valid, det, c1), c0)

    safe_w = [torch.maximum(w[i], eps12) for i in range(3)]
    px = [xs[i] / safe_w[i] for i in range(3)]
    py = [ys[i] / safe_w[i] for i in range(3)]
    pxmin = torch.minimum(torch.minimum(px[0], px[1]), px[2])
    pymin = torch.minimum(torch.minimum(py[0], py[1]), py[2])
    pxmax = torch.maximum(torch.maximum(px[0], px[1]), px[2])
    pymax = torch.maximum(torch.maximum(py[0], py[1]), py[2])

    # screen-space coverage only for sane projections; their f32 area sign
    # culls zero-area slivers (vktf_tpu/ops/vertex.py has the derivation)
    sane_lim = f32(32768.0, t)
    sane = torch.ones_like(valid)
    for i in range(3):
        sane = sane & (px[i].abs() <= sane_lim) & (py[i].abs() <= sane_lim)
    use_screen = ~any_behind & sane
    # both products rounded: a repeated corner gives exactly 0 (culled), as
    # the JAX setup kernel does (a fused form leaves the product's rounding
    # residue, whose sign is noise)
    area2 = (px[1] - px[0]) * (py[2] - py[0]) - (py[1] - py[0]) * (px[2] - px[0])
    valid = valid & (~use_screen | (area2 < c0))

    # near-plane crossers: bbox of the part with 0 <= depth <= 1
    inf = f32(3e38, t)
    lim_x = f32(2.0 * width + 16.0, t)
    lim_y = f32(2.0 * height + 16.0, t)

    def cand(v, lim, ok):
        return torch.where(ok, torch.clamp(v, -lim, lim), inf)

    cand_x, cand_y = [], []
    for i in range(3):
        ok = (z[i] >= c0) & (z[i] <= w[i])
        cand_x.append(cand(px[i], lim_x, ok))
        cand_y.append(cand(py[i], lim_y, ok))
    tiny = f32(1e-30, t)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        for plane in ("near", "far"):
            if plane == "near":
                fi, fj = z[i], z[j]
            else:
                fi, fj = w[i] - z[i], w[j] - z[j]
            crossing = (fi > c0) != (fj > c0)
            denom = fi - fj
            tt = fi / torch.where(denom.abs() < tiny, tiny, denom)
            xt = fma(tt, xs[j] - xs[i], xs[i])
            yt = fma(tt, ys[j] - ys[i], ys[i])
            zt = fma(tt, z[j] - z[i], z[i])
            wt = fma(tt, w[j] - w[i], w[i])
            other = (zt <= wt) if plane == "near" else (zt >= c0)
            ok = crossing & other & (wt > eps12)
            wt = torch.maximum(wt, eps12)
            cand_x.append(cand(xt / wt, lim_x, ok))
            cand_y.append(cand(yt / wt, lim_y, ok))

    def vmin(vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = torch.minimum(acc, v)
        return acc

    cxmin = vmin(cand_x)
    cymin = vmin(cand_y)
    cxmax = vmin([torch.where(v >= inf, inf, -v) for v in cand_x])
    cymax = vmin([torch.where(v >= inf, inf, -v) for v in cand_y])
    has_cand = cxmin < inf
    one, two = f32(1.0, t), f32(2.0, t)
    cx0 = torch.where(has_cand, torch.floor(cxmin) - one, c0)
    cy0 = torch.where(has_cand, torch.floor(cymin) - one, c0)
    cx1 = torch.where(has_cand, torch.ceil(-cxmax) + two, c0)
    cy1 = torch.where(has_cand, torch.ceil(-cymax) + two, c0)

    x0 = torch.where(any_behind, cx0, torch.floor(pxmin))
    y0 = torch.where(any_behind, cy0, torch.floor(pymin))
    x1 = torch.where(any_behind, cx1, torch.ceil(pxmax) + one)
    y1 = torch.where(any_behind, cy1, torch.ceil(pymax) + one)
    wmax_f, hmax_f = f32(float(width), t), f32(float(height), t)
    bbox_cols = [
        torch.clamp(x0, c0, wmax_f), torch.clamp(y0, c0, hmax_f),
        torch.clamp(x1, c0, wmax_f), torch.clamp(y1, c0, hmax_f),
    ]
    zero_i = torch.zeros_like(det, dtype=torch.int32)
    bbox_cols = [torch.where(valid, c.to(torch.int32), zero_i) for c in bbox_cols]

    # ---- anchored plane constants (at the clipped bbox corner) -------------
    ax = bbox_cols[0].to(torch.float32)
    ay = bbox_cols[1].to(torch.float32)
    det_w0 = det / safe_w[0]
    dx0 = ax - px[0]
    dy0 = ay - py[0]

    def anchored(a, b, c_raw, value_at_v0):
        """(a, b, f(anchor)): via vertex 0 normally, via the raw constant
        for near-plane crossers. value_at_v0 None means exactly 0 (XLA
        drops the zero addend before contracting)."""
        raw = fma(b, ay, fma(a, ax, c_raw))
        if value_at_v0 is None:
            via_v0 = fma(a, dx0, b * dy0)
        else:
            via_v0 = fma(b, dy0, fma(a, dx0, value_at_v0))
        return a, b, torch.where(any_behind, raw, via_v0)

    edges = (
        anchored(cof0[0], cof0[1], cof0[2], det_w0),
        anchored(cof1[0], cof1[1], cof1[2], None),
        anchored(cof2[0], cof2[1], cof2[2], None),
    )

    def screen_edge(j, k):
        a = py[k] - py[j]
        b = px[j] - px[k]
        return a, b, fma(a, ax - px[k], b * (ay - py[k]))

    sedges = [screen_edge(1, 2), screen_edge(2, 0), screen_edge(0, 1)]
    edges_raster = tuple(
        tuple(torch.where(use_screen, s, c) for s, c in zip(se, ce))
        for se, ce in zip(sedges, edges)
    )

    dverts = [z[i] / safe_w[i] for i in range(3)]
    z_ndc0 = dverts[0]

    def zcoef(k):
        return fma(cof2[k], z[2], fma(cof0[k], z[0], cof1[k] * z[1])) * inv_det

    # homogeneous depth plane (the JAX package's): its slopes are sums of
    # cofactor x clip z that cancel by ~1e5, since clip z is w less a
    # near-constant, so a covered sample's depth can be off by ~1e-3
    zplane_h = anchored(zcoef(0), zcoef(1), zcoef(2), z_ndc0)
    # on the screen-space path (no corner behind the eye, sane positions)
    # NDC depth is affine in the screen positions: solve its slopes from
    # the corners' NDC-z differences, whose error scales with the
    # triangle's own depth range. Near-plane crossers and insane
    # projections keep the homogeneous plane (their corners do not
    # usefully project).
    ex1, ey1 = px[1] - px[0], py[1] - py[0]
    ex2, ey2 = px[2] - px[0], py[2] - py[0]
    ez1, ez2 = dverts[1] - z_ndc0, dverts[2] - z_ndc0
    sarea = fma(ex1, ey2, -(ex2 * ey1))
    sarea = torch.where(sarea == c0, c1, sarea)  # culled: any finite plane
    sa = fma(ez1, ey2, -(ez2 * ey1)) / sarea
    sb = fma(ex1, ez2, -(ex2 * ez1)) / sarea
    zplane_s = (sa, sb, fma(sb, dy0, fma(sa, dx0, z_ndc0)))
    zplane = tuple(torch.where(use_screen, s, h) for s, h in zip(zplane_s, zplane_h))
    wplane = anchored(cof0[0] + cof1[0] + cof2[0], cof0[1] + cof1[1] + cof2[1],
                      cof0[2] + cof1[2] + cof2[2], det_w0)

    # ---- slim-body safety: w > 0 and 0 <= depth <= 1 provably hold at
    # every covered sample, with a 2^-16 margin over plane-eval rounding
    bw_f = (bbox_cols[2] - bbox_cols[0]).to(torch.float32) + two
    bh_f = (bbox_cols[3] - bbox_cols[1]).to(torch.float32) + two
    tol = f32(2.0 ** -16, t)
    werr = (fma(wplane[0].abs(), bw_f, wplane[1].abs() * bh_f)
            + wplane[2].abs()) * tol
    wmax = torch.maximum(torch.maximum(w[0], w[1]), w[2])
    wr_min = det / torch.maximum(wmax, eps12)
    dmin = torch.minimum(torch.minimum(dverts[0], dverts[1]), dverts[2])
    dmax = torch.maximum(torch.maximum(dverts[0], dverts[1]), dverts[2])
    # the margin takes the homogeneous coefficients, as the JAX package
    # does, so the flag stays bit-equal to it: it only needs magnitudes
    # that bound the evaluation's rounding, |c| (the depth at the anchor)
    # dominates it, and both planes' |c| agree far inside the 2^8 headroom
    derr = (fma(zplane_h[0].abs(), bw_f, zplane_h[1].abs() * bh_f)
            + zplane_h[2].abs()) * tol
    safe = (valid & ~any_behind & (wr_min > werr) & (dmin > derr)
            & (dmax < one - derr))

    return {
        "safe": safe,
        "use_screen": use_screen,
        "edges": edges,
        "edges_raster": edges_raster,
        "zplane": zplane,
        "wplane": wplane,
        "anchor_x": ax,
        "anchor_y": ay,
        "inv_det": inv_det,
        "valid": valid,
        "bbox_cols": tuple(bbox_cols),
    }
