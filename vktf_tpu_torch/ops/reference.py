"""Slow, simple numpy reference renderer for golden-image testing.

The port's copy of ``vktf_tpu/ops/reference.py``, the package's
independent renderer: the same rendering semantics (glTF PBR MR per
src/game/shaders/fragment.glsl, Vulkan raster rules) written as plain
per-triangle scanline numpy in float64, the oracle the port's frames are
held to on the CPU and on the card (``tests/test_torch_cuda_paths.py``).

Deliberately structured differently from the production path (screen-space
barycentrics + per-triangle python loops vs homogeneous edge functions +
streaming raster) so shared bugs are unlikely. It reads vertex-level
arrays, which the port's device scene does not keep: ``reference_scene``
builds its input from the port's own flattening of the assets.
"""

from __future__ import annotations

import types
from typing import Sequence

import numpy as np

from vktf_tpu_torch.loaders.images import srgb_to_linear


def _node_globals(node_local, node_parent, levels):
    n = node_local.shape[0]
    out = node_local.copy()
    # levels: anything whose parent precedes it works with a simple pass
    for i in range(n):
        parent = node_parent[i]
        if parent != i:
            out[i] = out[parent] @ node_local[i]
    return out


def _sample_bilinear(level: np.ndarray, uv, wrap=("repeat", "repeat"), srgb=False):
    h, w = level.shape[:2]
    x = uv[0] * w - 0.5
    y = uv[1] * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0

    def wrap_coord(c, size, mode):
        if mode == "clamp_to_edge":
            return min(max(c, 0), size - 1)
        if mode == "mirrored_repeat":
            period = 2 * size
            m = c % period
            return period - 1 - m if m >= size else m
        return c % size

    def texel(xi, yi):
        xi = wrap_coord(xi, w, wrap[0])
        yi = wrap_coord(yi, h, wrap[1])
        t = level[yi, xi].astype(np.float64) / 255.0
        if srgb:
            t = np.concatenate([srgb_to_linear(t[:3]), t[3:]])
        return t

    c00, c10 = texel(x0, y0), texel(x0 + 1, y0)
    c01, c11 = texel(x0, y0 + 1), texel(x0 + 1, y0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c10 * fx * (1 - fy)
        + c01 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _sample_texture_ref(tex_levels, uv, duvdx, duvdy, wrap, srgb, filters,
                        max_anisotropy=1.0, aniso_taps=1):
    """Trilinear sampling with the same LOD rule as the production path.

    aniso_taps > 1: TRUE multi-tap anisotropic filtering — N taps evenly
    spaced along the major footprint axis (clamped to max_anisotropy minor
    axes), each trilinear at the minor-axis LOD, averaged — the same
    kernel as shade_table's multi-tap path (model.cppm:261-275)."""
    h0, w0 = tex_levels[0].shape[:2]
    ddx = np.asarray([duvdx[0] * w0, duvdx[1] * h0])
    ddy = np.asarray([duvdy[0] * w0, duvdy[1] * h0])
    if aniso_taps > 1:
        ddx2, ddy2 = float(ddx @ ddx), float(ddy @ ddy)
        major_uv = np.asarray(duvdx if ddx2 >= ddy2 else duvdy, np.float64)
        rho_maj = np.sqrt(max(max(ddx2, ddy2), 1e-24))
        rho_min = np.sqrt(max(min(ddx2, ddy2), 1e-24))
        scale = min(1.0, max_anisotropy * rho_min / rho_maj)
        acc = None
        for i in range(aniso_taps):
            f = (i + 0.5) / aniso_taps - 0.5
            s = _sample_texture_ref(
                tex_levels, np.asarray(uv) + f * scale * major_uv,
                duvdx, duvdy, wrap, srgb, filters,
                max_anisotropy=max_anisotropy, aniso_taps=1,
            )
            acc = s if acc is None else acc + s
        return acc / aniso_taps
    rho_max2 = max(max(float(ddx @ ddx), float(ddy @ ddy)), 1e-24)
    if max_anisotropy > 1.0:
        # anisotropy as LOD sharpening (matches ops.shade_table)
        rho_min2 = max(min(float(ddx @ ddx), float(ddy @ ddy)), 1e-24)
        rho_max2 = max(min(rho_max2, rho_min2 * max_anisotropy ** 2), 1e-24)
    lod = 0.5 * np.log2(rho_max2)
    lod = min(max(lod, 0.0), len(tex_levels) - 1)
    l0 = int(np.floor(lod))
    lfrac = lod - l0
    if filters.get("mipmap_mode", "linear") == "nearest":
        lfrac = float(lfrac >= 0.5)
    l1 = min(l0 + 1, len(tex_levels) - 1)
    nearest_key = "mag_filter" if lod <= 0.0 else "min_filter"
    if filters.get(nearest_key, "linear") == "nearest":
        # nearest = snap bilinear weights; emulate by sampling at texel center
        def snap(level, uv_):
            h, w = level.shape[:2]
            xi = int(np.floor(uv_[0] * w)) % max(w, 1)
            yi = int(np.floor(uv_[1] * h)) % max(h, 1)
            xi, yi = min(max(xi, 0), w - 1), min(max(yi, 0), h - 1)
            t = level[yi, xi].astype(np.float64) / 255.0
            if srgb:
                t = np.concatenate([srgb_to_linear(t[:3]), t[3:]])
            return t

        s0, s1 = snap(tex_levels[l0], uv), snap(tex_levels[l1], uv)
    else:
        s0 = _sample_bilinear(tex_levels[l0], uv, wrap, srgb)
        s1 = _sample_bilinear(tex_levels[l1], uv, wrap, srgb)
    return s0 * (1 - lfrac) + s1 * lfrac


def _brdf_ref(base_rgb, metallic, roughness, l, n, v):
    """glTF PBR MR BRDF, straight from the equations (fragment.glsl:90-128)."""
    h = l + v
    h = h / max(np.linalg.norm(h), 1e-10)
    alpha = roughness * roughness
    a2 = alpha * alpha
    hv, hl = float(h @ v), float(h @ l)
    nl, nv, nh = float(n @ l), float(n @ v), float(n @ h)
    f0 = 0.04 * (1 - metallic) + base_rgb * metallic
    F = f0 + (1 - f0) * (1 - abs(hv)) ** 5
    eps = 1e-7
    vis = (
        (1.0 if hl >= 0 else 0.0) / (abs(nl) + np.sqrt(a2 + (1 - a2) * nl * nl) + eps)
        * (1.0 if hv >= 0 else 0.0) / (abs(nv) + np.sqrt(a2 + (1 - a2) * nv * nv) + eps)
    )
    d = nh * nh * (a2 - 1) + 1
    D = (1.0 if nh >= 0 else 0.0) * a2 / (np.pi * d * d + eps)
    diffuse = (1 - F) / np.pi * (base_rgb * (1 - metallic))
    return diffuse + F * vis * D


class ReferenceScene:
    """Numpy copy of a flattened scene + texture levels for sampling.

    scene: any object with the JAX RenderScene's vertex-level fields
    (positions, indices, vertex_instance, mat_* ...), as ``reference_scene``
    builds them; texture_levels: each texture's mip chain; texture_meta:
    each texture's sampler dict with its "srgb" flag."""

    def __init__(self, scene, meta, texture_levels, texture_meta):
        as_np = lambda x: np.asarray(x)
        self.node_local = as_np(scene.node_local)
        self.node_parent = as_np(scene.node_parent)
        self.positions = as_np(scene.positions)
        self.normals = as_np(scene.normals)
        self.tangents = as_np(scene.tangents)
        self.uvs = as_np(scene.uvs)
        self.indices = as_np(scene.indices)
        self.tri_material = as_np(scene.tri_material)
        self.vertex_instance = as_np(scene.vertex_instance)
        self.inst_node = as_np(scene.inst_node)
        self.mat_base_color = as_np(scene.mat_base_color)
        self.mat_mr = as_np(scene.mat_metallic_roughness)
        self.mat_normal_scale = as_np(scene.mat_normal_scale)
        self.mat_alpha = as_np(scene.mat_alpha)  # (M,2): (mode, cutoff)
        self.mat_textures = as_np(scene.mat_textures)
        self.light_node = as_np(scene.light_node)
        self.light_type = as_np(scene.light_type)
        self.light_color = as_np(scene.light_color)
        self.meta = meta
        self.texture_levels = texture_levels  # list of list[np.ndarray]
        self.texture_meta = texture_meta  # list of dicts: wrap/srgb/filters


def reference_scene(assets: Sequence, log=None) -> ReferenceScene:
    """The ReferenceScene of loader Assets, from the port's own flattening
    (``scene/flatten.py``): the arrays ``flatten`` packs into its
    per-triangle tables, before packing, every texture slot's decoded mip
    chain and sampler, and the SceneMeta (``.meta``)."""
    from vktf_tpu_torch.scene.flatten import _flatten

    _leaves, meta, entries, arrays = _flatten(assets, log, None, oracle=True)
    texture_meta = [dict(sampler, srgb=data.srgb) for data, sampler in entries]
    return ReferenceScene(types.SimpleNamespace(**arrays), meta,
                          [data.levels for data, _ in entries], texture_meta)


def render_reference(
    ref: ReferenceScene,
    view_projection,
    camera_position,
    width,
    height,
    sample_offsets,
    background=(0.0, 0.0, 0.0, 1.0),
    max_anisotropy: float = 1.0,
    peel_layers: int = 2,
    aniso_taps: int = 1,
):
    """Render; returns (H, W, 4) uint8 sRGB, matching the production output."""
    vp = np.asarray(view_projection, np.float64)
    node_global = _node_globals(ref.node_local, ref.node_parent, None)
    inst_matrix = node_global[ref.inst_node]
    vert_matrix = inst_matrix[ref.vertex_instance]
    rot = vert_matrix[:, :3, :3]
    world_pos = np.einsum("vij,vj->vi", rot, ref.positions) + vert_matrix[:, :3, 3]
    world_normal = np.einsum("vij,vj->vi", rot, ref.normals)
    world_tan = np.concatenate(
        [np.einsum("vij,vj->vi", rot, ref.tangents[:, :3]), ref.tangents[:, 3:4]], axis=1
    )
    ones = np.ones((world_pos.shape[0], 1))
    clip = np.concatenate([world_pos, ones], axis=1) @ vp.T  # (V,4)

    # lights (same WorldLight packing)
    lights = []
    for li in range(ref.light_node.shape[0]):
        m = node_global[ref.light_node[li]]
        if ref.light_type[li] == 0:
            d = m[:3, 2]
            lights.append((d / np.linalg.norm(d), 0.0, ref.light_color[li]))
        else:
            lights.append((m[:3, 3].copy(), 1.0, ref.light_color[li]))

    S = len(sample_offsets)
    accum = np.zeros((height, width, 3), np.float64)
    bg = np.asarray(background, np.float64)

    K = peel_layers
    for (ox, oy) in sample_offsets:
        # K-layer depth peel: the K nearest fragments per sample, matching
        # the production kernel's alpha MASK/BLEND semantics (ties keep the
        # earlier-drawn triangle, i.e. lexicographic (depth, draw order)).
        depth_buf = np.ones((K, height, width), np.float64)
        layer_rgb = np.zeros((K, height, width, 3), np.float64)
        layer_a = np.zeros((K, height, width), np.float64)
        num_tris = ref.indices.shape[0]
        for t in range(num_tris):
            i0, i1, i2 = ref.indices[t]
            c = clip[[i0, i1, i2]]
            if np.any(c[:, 3] <= 1e-9):
                continue  # reference path skips near-plane crossers
            ndc = c[:, :3] / c[:, 3:4]
            sx = (ndc[:, 0] + 1) * 0.5 * width
            sy = (ndc[:, 1] + 1) * 0.5 * height
            area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
            if area2 >= -1e-12:
                continue  # back-face (front faces are CW in y-down screen)
            x0 = max(int(np.floor(min(sx))), 0)
            x1 = min(int(np.ceil(max(sx))) + 1, width)
            y0 = max(int(np.floor(min(sy))), 0)
            y1 = min(int(np.ceil(max(sy))) + 1, height)
            if x0 >= x1 or y0 >= y1:
                continue
            material = ref.tri_material[t]
            base_factor = ref.mat_base_color[material]
            mr_factor = ref.mat_mr[material]
            nscale = ref.mat_normal_scale[material]
            alpha_mode, alpha_cutoff = ref.mat_alpha[material]
            tex_ids = ref.mat_textures[material]
            wps = world_pos[[i0, i1, i2]]
            wns = world_normal[[i0, i1, i2]]
            wts = world_tan[[i0, i1, i2]]
            uvs3 = ref.uvs[[i0, i1, i2]]
            inv_w = 1.0 / c[:, 3]
            for py in range(y0, y1):
                for px in range(x0, x1):
                    p = np.asarray([px + ox, py + oy])
                    w0 = (sx[1] - p[0]) * (sy[2] - p[1]) - (sy[1] - p[1]) * (sx[2] - p[0])
                    w1 = (sx[2] - p[0]) * (sy[0] - p[1]) - (sy[2] - p[1]) * (sx[0] - p[0])
                    w2 = (sx[0] - p[0]) * (sy[1] - p[1]) - (sy[0] - p[1]) * (sx[1] - p[0])
                    if not ((w0 <= 0 and w1 <= 0 and w2 <= 0)):
                        continue
                    lam_s = np.asarray([w0, w1, w2]) / area2
                    depth = float(lam_s @ ndc[:, 2])
                    if depth < 0.0 or depth > 1.0:
                        continue
                    # insertion index into the sorted layer list; equal
                    # depths go AFTER incumbents (earlier draw order wins)
                    layer = int(np.searchsorted(
                        depth_buf[:, py, px], depth, side="right"
                    ))
                    if layer >= K:
                        continue
                    # perspective-correct barycentrics
                    lw = lam_s * inv_w
                    lam = lw / lw.sum()
                    fpos = lam @ wps
                    fnormal = lam @ wns
                    ftan = lam @ wts
                    fuv = lam @ uvs3
                    # uv derivative via finite differences of screen barycentrics
                    def uv_at(ppx, ppy):
                        q = np.asarray([ppx, ppy])
                        a0 = (sx[1] - q[0]) * (sy[2] - q[1]) - (sy[1] - q[1]) * (sx[2] - q[0])
                        a1 = (sx[2] - q[0]) * (sy[0] - q[1]) - (sy[2] - q[1]) * (sx[0] - q[0])
                        a2_ = (sx[0] - q[0]) * (sy[1] - q[1]) - (sy[0] - q[1]) * (sx[1] - q[0])
                        ls = np.asarray([a0, a1, a2_]) / area2
                        lw_ = ls * inv_w
                        return (lw_ / lw_.sum()) @ uvs3

                    duvdx = uv_at(p[0] + 1, p[1]) - fuv
                    duvdy = uv_at(p[0], p[1] + 1) - fuv

                    def sample(slot, srgb_slot):
                        ti = tex_ids[slot]
                        tm = ref.texture_meta[ti]
                        return _sample_texture_ref(
                            ref.texture_levels[ti],
                            fuv,
                            duvdx,
                            duvdy,
                            (tm.get("wrap_u", "repeat"), tm.get("wrap_v", "repeat")),
                            tm.get("srgb", srgb_slot),
                            tm,
                            max_anisotropy=max_anisotropy,
                            aniso_taps=aniso_taps,
                        )

                    base = base_factor * sample(0, True)
                    mr = sample(1, False)
                    metallic = mr_factor[0] * mr[2]
                    roughness = mr_factor[1] * mr[1]
                    nsmp = sample(2, False)

                    n = fnormal / max(np.linalg.norm(fnormal), 1e-10)
                    tan = ftan[:3] / max(np.linalg.norm(ftan[:3]), 1e-10)
                    bitan = np.cross(n, tan)
                    bitan = bitan / max(np.linalg.norm(bitan), 1e-10) * ftan[3]
                    ns = 2.0 * nsmp[:3] - 1.0
                    ns[:2] *= nscale
                    normal = tan * ns[0] + bitan * ns[1] + n * ns[2]
                    normal = normal / max(np.linalg.norm(normal), 1e-10)

                    v = camera_position - fpos
                    v = v / max(np.linalg.norm(v), 1e-10)

                    radiance = np.zeros(3)
                    for (pos_or_dir, has_pos, color) in lights:
                        lvec = pos_or_dir - has_pos * fpos
                        dist = max(np.linalg.norm(lvec), 0.1)
                        atten = (1 - has_pos) + has_pos / (dist * dist)
                        l = lvec / dist
                        brdf = _brdf_ref(base[:3], metallic, roughness, l, normal, v)
                        radiance += atten * color * brdf * max(float(normal @ l), 0.0)

                    # effective alpha by glTF alphaMode (OPAQUE/MASK/BLEND)
                    if alpha_mode == 1:
                        alpha = 1.0 if base[3] >= alpha_cutoff else 0.0
                    elif alpha_mode == 2:
                        alpha = float(base[3])
                    else:
                        alpha = 1.0
                    # shift deeper incumbents down one layer, insert
                    depth_buf[layer + 1:, py, px] = (
                        depth_buf[layer:-1, py, px].copy()
                    )
                    layer_rgb[layer + 1:, py, px] = (
                        layer_rgb[layer:-1, py, px].copy()
                    )
                    layer_a[layer + 1:, py, px] = (
                        layer_a[layer:-1, py, px].copy()
                    )
                    depth_buf[layer, py, px] = depth
                    layer_rgb[layer, py, px] = radiance
                    layer_a[layer, py, px] = alpha
        # front-to-back over() of the K layers onto the clear color
        color_buf = np.broadcast_to(bg[:3], (height, width, 3))
        for l in reversed(range(K)):
            color_buf = (
                layer_a[l, ..., None] * layer_rgb[l]
                + (1.0 - layer_a[l, ..., None]) * color_buf
            )
        accum += color_buf
    accum /= S
    c = np.clip(accum, 0.0, 1.0)
    srgb = np.where(c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1 / 2.4) - 0.055)
    rgb = (srgb * 255 + 0.5).astype(np.uint8)
    out = np.concatenate([rgb, np.full((height, width, 1), 255, np.uint8)], axis=-1)
    return out
