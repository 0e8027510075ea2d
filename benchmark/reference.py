"""The plain reference renderer the benchmark holds the program's frames to.

Plain PyTorch, float64 by default, on whatever device it is given. It
imports nothing of the program and works every frame out again from the
scene description (``scene_gen``) and the camera pose:

  * the scene is flattened here: each mesh node's corners go to world
    space once (the scene is static), normals and tangents by the node's
    3x3 block as the renderer's shader does, lights from their nodes'
    +z column (directional) or translation (point);
  * the camera: a right-handed look-at view and a perspective projection
    with depth in [0, 1] and the Vulkan y-flip;
  * raster: 2D-homogeneous barycentrics per sample at the Vulkan standard
    sample positions (no corner needs to lie in front of the eye), front
    faces only, a sample covered where its three barycentrics are >= 0,
    the reciprocal w is > 0 and its depth lies in [0, 1]; each sample keeps
    its nearest fragment (ties to the lower triangle index), found by an
    atomic minimum over a 64-bit key of the quantised depth and the index.
    Candidates are the pixels of each triangle's bounding box, where the
    box is of the part of the triangle in front of the near plane;
  * pixel-rate shading: per pixel the winner is the nearest of its
    samples' fragments and the coverage is the share of its samples
    covered; the winner's attributes are interpolated perspective-correct
    at the pixel centre, with analytic uv derivatives;
  * texturing: the LOD of the larger footprint axis, sharpened to at most
    max_anisotropy minor axes, trilinear between the two mip levels, each
    level bilinear with per-texel sRGB decode of the base colour;
  * TBN normal mapping, the glTF metallic-roughness BRDF (GGX, Smith,
    Schlick) over every light, the coverage resolve over the clear colour,
    the sRGB encode and the u8 quantisation (half up).

``shade_dtype`` sets the precision of everything after the raster; the
benchmark's control computes it in bfloat16 (with the raster in float32).
"""

from __future__ import annotations

import numpy as np
import torch

# Vulkan standard sample locations (pixel-relative)
SAMPLE_OFFSETS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: ((0.5625, 0.3125), (0.4375, 0.6875), (0.8125, 0.5625), (0.3125, 0.1875),
        (0.1875, 0.8125), (0.0625, 0.4375), (0.6875, 0.9375), (0.9375, 0.0625)),
}
EPSILON = 1.0e-7
POINT_LIGHT_RADIUS = 0.1
TRI_BITS = 23          # triangle index bits of a raster key (8,388,607 triangles)
DEPTH_SCALE = 2.0 ** 39  # depth quantum of a raster key (depth 1 still fits)
_WRAP = {"repeat": 0, "clamp_to_edge": 1, "mirrored_repeat": 2}


def look_at_view(position, direction) -> np.ndarray:
    """World -> view: right-handed, the eye looking down -z, +y up."""
    p = np.asarray(position, np.float64)
    f = np.asarray(direction, np.float64)
    f = f / np.linalg.norm(f)
    right = np.cross(f, (0.0, 1.0, 0.0))
    right /= np.linalg.norm(right)
    up = np.cross(right, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = right, up, -f
    view[:3, 3] = -view[:3, :3] @ p
    return view


def perspective(fov_y: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """Depth in [0, 1], Vulkan y-flip."""
    t = np.tan(fov_y / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / (aspect * t)
    proj[1, 1] = -1.0 / t
    proj[2, 2] = z_far / (z_near - z_far)
    proj[2, 3] = -(z_far * z_near) / (z_far - z_near)
    proj[3, 2] = -1.0
    return proj


def view_projection(camera: dict, width: int, height: int, position, direction) -> np.ndarray:
    proj = perspective(np.radians(camera["fov_y_deg"]), width / height, camera["z_near"],
                       camera["z_far"])
    return proj @ look_at_view(position, direction)


class ReferenceScene:
    """The flattened scene on `device`: world-space corners per triangle,
    materials, the texture levels in one flat byte buffer, world lights."""

    def __init__(self, assets: list, device):
        dev = torch.device(device)
        corners = {k: [] for k in ("pos", "nrm", "tan", "uv")}
        tri_mat, mats, textures = [], [], []
        lights = []
        for asset in assets:
            base_mat = len(mats)
            for m in asset["materials"]:
                ids = []
                for tex in m["textures"]:
                    ids.append(len(textures))
                    textures.append(tex)
                mats.append((m, ids))
            for node in asset["nodes"]:
                xf = np.asarray(node["transform"], np.float64)
                if node["light"] is not None:
                    light = asset["lights"][node["light"]]
                    if light["type"] == "directional":
                        d = xf[:3, 2] / np.linalg.norm(xf[:3, 2])
                        lights.append(np.concatenate([d, [0.0], light["color"]]))
                    else:
                        lights.append(np.concatenate([xf[:3, 3], [1.0], light["color"]]))
                if node["mesh"] is None:
                    continue
                mesh = asset["meshes"][node["mesh"]]
                g = mesh["geometry"]
                idx = g["indices"].astype(np.int64)
                rot, trans = xf[:3, :3], xf[:3, 3]
                corners["pos"].append(g["positions"].astype(np.float64)[idx] @ rot.T + trans)
                corners["nrm"].append(g["normals"].astype(np.float64)[idx] @ rot.T)
                tan = g["tangents"].astype(np.float64)[idx]
                corners["tan"].append(np.concatenate([tan[..., :3] @ rot.T, tan[..., 3:]], -1))
                corners["uv"].append(g["uvs"].astype(np.float64)[idx])
                tri_mat.append(np.full(idx.shape[0], base_mat + mesh["material"], np.int64))
        self.device = dev
        self.num_triangles = sum(c.shape[0] for c in corners["pos"])
        if self.num_triangles >= 1 << TRI_BITS:
            raise ValueError(f"{self.num_triangles} triangles exceed the raster key's "
                             f"{TRI_BITS} index bits")
        f64 = lambda a: torch.as_tensor(np.concatenate(a), dtype=torch.float64, device=dev)
        self.pos, self.nrm = f64(corners["pos"]), f64(corners["nrm"])
        self.tan, self.uv = f64(corners["tan"]), f64(corners["uv"])
        self.tri_mat = torch.as_tensor(np.concatenate(tri_mat), device=dev)
        self.mat_base = torch.tensor(np.stack([m["base_color_factor"] for m, _ in mats]),
                                     dtype=torch.float64, device=dev)
        self.mat_mr = torch.tensor([[m["metallic_factor"], m["roughness_factor"]]
                                    for m, _ in mats], dtype=torch.float64, device=dev)
        self.mat_nscale = torch.tensor([m["normal_scale"] for m, _ in mats],
                                       dtype=torch.float64, device=dev)
        self.mat_tex = torch.tensor([ids for _, ids in mats], dtype=torch.int64, device=dev)
        # texture levels: one flat RGBA8 buffer; per texture its level count
        # and filters, per (texture, level) the texel offset and size
        max_levels = max(len(t["levels"]) for t in textures)
        offsets = np.zeros((len(textures), max_levels), np.int64)
        sizes = np.ones((len(textures), max_levels, 2), np.int64)
        chunks, at = [], 0
        for i, tex in enumerate(textures):
            for lv, level in enumerate(tex["levels"]):
                offsets[i, lv] = at
                sizes[i, lv] = level.shape[1], level.shape[0]
                chunks.append(level.reshape(-1, 4))
                at += level.shape[0] * level.shape[1]
        self.texels = torch.as_tensor(np.concatenate(chunks), device=dev)  # (n, 4) u8
        self.tex_offset = torch.as_tensor(offsets, device=dev)
        self.tex_size = torch.as_tensor(sizes, device=dev)
        self.tex_levels = torch.tensor([len(t["levels"]) for t in textures], device=dev)
        self.tex_srgb = [t["srgb"] for t in textures]
        samp = [t["sampler"] for t in textures]
        self.tex_wrap = torch.tensor([[_WRAP[s["wrap_u"]], _WRAP[s["wrap_v"]]] for s in samp],
                                     device=dev)
        self.tex_nearest = torch.tensor(
            [[s["mag_filter"] == "nearest", s["min_filter"] == "nearest",
              s["mipmap_mode"] == "nearest"] for s in samp], device=dev)
        self.lights = torch.tensor(np.stack(lights), dtype=torch.float64, device=dev)


# ---------------------------------------------------------------------------
# raster
# ---------------------------------------------------------------------------


def setup(ref: ReferenceScene, vp: np.ndarray, width: int, height: int, dtype=torch.float64):
    """Per triangle: the barycentric planes (T, 3, 3) as (a, b, c) with
    lambda_i = a sx + b sy + c, the depth plane (T, 3), whether it can
    cover a sample (front-facing, partly in front of the near plane, a
    non-empty box on screen) and its clamped pixel box (T, 4) int64."""
    m = torch.as_tensor(vp, dtype=dtype, device=ref.device)
    pos = ref.pos.to(dtype)
    clip = pos @ m[:, :3].T + m[:, 3]  # (T, 3 corners, 4)
    x, y, z, w = clip.unbind(-1)
    rows = torch.stack([(x + w) * (0.5 * width), (y + w) * (0.5 * height), w], dim=-1)
    r0, r1, r2 = rows.unbind(1)
    cof = torch.stack([torch.cross(r2, r1, dim=-1), torch.cross(r0, r2, dim=-1),
                       torch.cross(r1, r0, dim=-1)], dim=1)  # (T, 3, 3)
    det = (r0 * cof[:, 0]).sum(-1)
    front = det > 1e-12
    planes = cof / torch.where(front, det, torch.ones_like(det))[:, None, None]
    zplane = (planes * z[..., None]).sum(1)
    # the box of the part in front of the near plane (depth >= 0): the
    # corners with z >= 0 and the edges' crossings of z = 0
    pts, ok = [], []
    for i in range(3):
        pts.append(rows[:, i])
        ok.append(z[:, i] >= 0)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        zi, zj = z[:, i], z[:, j]
        cross = (zi >= 0) != (zj >= 0)
        t = zi / torch.where(cross, zi - zj, torch.ones_like(zi))
        pts.append(rows[:, i] + t[:, None] * (rows[:, j] - rows[:, i]))
        ok.append(cross)
    pts = torch.stack(pts, 1)
    ok = torch.stack(ok, 1) & (pts[..., 2] > 0)
    safe_w = torch.where(ok, pts[..., 2], torch.ones_like(pts[..., 2]))
    big = torch.tensor(1e30, dtype=dtype, device=ref.device)
    sx = torch.where(ok, pts[..., 0] / safe_w, big)
    sy = torch.where(ok, pts[..., 1] / safe_w, big)
    lim = torch.tensor(4.0 * max(width, height), dtype=dtype, device=ref.device)
    x0 = torch.floor(sx.amin(1).clamp(-lim, lim))
    y0 = torch.floor(sy.amin(1).clamp(-lim, lim))
    x1 = torch.ceil(torch.where(ok, sx, -big).amax(1).clamp(-lim, lim))
    y1 = torch.ceil(torch.where(ok, sy, -big).amax(1).clamp(-lim, lim))
    box = torch.stack([x0.clamp(0, width), y0.clamp(0, height),
                       x1.clamp(0, width), y1.clamp(0, height)], 1).long()
    live = front & ok.any(1) & (box[:, 2] > box[:, 0]) & (box[:, 3] > box[:, 1])
    return planes, zplane, live, box


def raster(ref: ReferenceScene, vp: np.ndarray, width: int, height: int, samples: int,
           dtype=torch.float64, chunk: int = 1 << 22):
    """(keys (S, H*W) int64, the nearest fragment's key per sample or the
    int64 maximum, and the setup's (live, box))."""
    planes, zplane, live, box = setup(ref, vp, width, height, dtype)
    dev = ref.device
    empty = torch.iinfo(torch.int64).max
    keys = torch.full((samples * height * width,), empty, dtype=torch.int64, device=dev)
    tris = torch.nonzero(live).squeeze(1)
    bw = box[tris, 2] - box[tris, 0]
    area = bw * (box[tris, 3] - box[tris, 1])
    ends = torch.cumsum(area, 0)
    offsets = SAMPLE_OFFSETS[samples]
    start, done = 0, 0
    total = int(ends[-1]) if ends.numel() else 0
    while done < total:
        stop = int(torch.searchsorted(ends, done + chunk, right=True))
        stop = max(stop, start + 1)
        t = tris[start:stop]
        a = area[start:stop]
        n = int(a.sum())
        rep = torch.repeat_interleave(torch.arange(t.numel(), device=dev), a, output_size=n)
        first = torch.cumsum(a, 0) - a
        local = torch.arange(n, device=dev) - first[rep]
        tw = bw[start:stop][rep]
        tri = t[rep]
        px = box[tri, 0] + local % tw
        py = box[tri, 1] + torch.div(local, tw, rounding_mode="floor")
        pl = planes[tri]
        zp = zplane[tri]
        pix = py * width + px
        for s, (ox, oy) in enumerate(offsets):
            sx = px.to(dtype) + ox
            sy = py.to(dtype) + oy
            lam = pl[..., 0] * sx[:, None] + pl[..., 1] * sy[:, None] + pl[..., 2]
            depth = zp[:, 0] * sx + zp[:, 1] * sy + zp[:, 2]
            cov = ((lam >= 0).all(1) & (lam.sum(1) > 0) & (depth >= 0) & (depth <= 1))
            key = ((depth[cov].double() * DEPTH_SCALE).long() << TRI_BITS) | tri[cov]
            keys.scatter_reduce_(0, s * height * width + pix[cov], key, "amin")
        start, done = stop, int(ends[stop - 1])
    return keys.view(samples, height * width), planes, live, box


# ---------------------------------------------------------------------------
# shade
# ---------------------------------------------------------------------------


def _norm(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-10)


def _dot(a, b):
    return (a * b).sum(-1)


def _srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _wrap(i, size, mode):
    rep = torch.remainder(i, size)
    clamp = torch.minimum(torch.clamp(i, min=0), size - 1)
    m = torch.remainder(i, 2 * size)
    mirror = torch.where(m >= size, 2 * size - 1 - m, m)
    return torch.where(mode == 0, rep, torch.where(mode == 1, clamp, mirror))


def _level_sample(ref, tex, level, u, v, nearest, srgb_mask, texel_ids):
    """Bilinear (or nearest) RGBA of each fragment's texture `tex` at mip
    `level` (all (N,)), decoded to linear where srgb_mask; appends the flat
    texel indices it reads to texel_ids when that is a list."""
    size = ref.tex_size[tex, level]
    wl, hl = size[:, 0], size[:, 1]
    x = u * wl.to(u.dtype) - 0.5
    y = v * hl.to(v.dtype) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    fx = torch.where(nearest, (fx >= 0.5).to(fx.dtype), fx)
    fy = torch.where(nearest, (fy >= 0.5).to(fy.dtype), fy)
    x0, y0 = x0f.long(), y0f.long()
    wrap = ref.tex_wrap[tex]
    base = ref.tex_offset[tex, level]
    out = 0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yy = _wrap(y0 + dy, hl, wrap[:, 1])
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xx = _wrap(x0 + dx, wl, wrap[:, 0])
            flat = base + yy * wl + xx
            if texel_ids is not None:
                texel_ids.append(flat)
            t = ref.texels[flat].to(u.dtype) / 255.0
            t = torch.cat([torch.where(srgb_mask[:, None], _srgb_to_linear(t[:, :3]), t[:, :3]),
                           t[:, 3:]], 1)
            out = out + t * (wx * wy)[:, None]
    return out


def _sample(ref, tex, u, v, dudx, dvdx, dudy, dvdy, max_anisotropy, srgb_mask, texel_ids):
    size0 = ref.tex_size[tex, 0].to(u.dtype)
    px, qx = dudx * size0[:, 0], dvdx * size0[:, 1]
    py, qy = dudy * size0[:, 0], dvdy * size0[:, 1]
    ddx2, ddy2 = px * px + qx * qx, py * py + qy * qy
    rho_max2 = torch.clamp(torch.maximum(ddx2, ddy2), min=1e-24)
    if max_anisotropy > 1.0:
        rho_min2 = torch.clamp(torch.minimum(ddx2, ddy2), min=1e-24)
        rho_max2 = torch.clamp(torch.minimum(rho_max2, rho_min2 * max_anisotropy ** 2),
                               min=1e-24)
    top = (ref.tex_levels[tex] - 1).to(u.dtype)
    lod = torch.minimum(torch.clamp(0.5 * torch.log2(rho_max2), min=0.0), top)
    l0f = torch.floor(lod)
    lfrac = lod - l0f
    near = ref.tex_nearest[tex]
    lfrac = torch.where(near[:, 2], (lfrac >= 0.5).to(lfrac.dtype), lfrac)
    nearest = torch.where(lod <= 0, near[:, 0], near[:, 1])
    l0 = l0f.long()
    l1 = torch.minimum(l0 + 1, top.long())
    s0 = _level_sample(ref, tex, l0, u, v, nearest, srgb_mask, texel_ids)
    s1 = _level_sample(ref, tex, l1, u, v, nearest, srgb_mask, texel_ids)
    return s0 * (1 - lfrac)[:, None] + s1 * lfrac[:, None]


def _brdf(base, metallic, roughness, l, n, v):
    h = _norm(l + v)
    a2 = (roughness * roughness) ** 2
    hv, hl, nl, nv, nh = _dot(h, v), _dot(h, l), _dot(n, l), _dot(n, v), _dot(n, h)
    f0 = 0.04 * (1 - metallic)[:, None] + base * metallic[:, None]
    fres = f0 + (1 - f0) * ((1 - hv.abs()) ** 5)[:, None]
    vis = ((hl >= 0).to(nl.dtype) / (nl.abs() + torch.sqrt(a2 + (1 - a2) * nl * nl) + EPSILON)
           * (hv >= 0).to(nl.dtype) / (nv.abs() + torch.sqrt(a2 + (1 - a2) * nv * nv) + EPSILON))
    d = nh * nh * (a2 - 1) + 1
    dist = (nh >= 0).to(nl.dtype) * a2 / (np.pi * d * d + EPSILON)
    diffuse = (1 - fres) / np.pi * (base * (1 - metallic)[:, None])
    return diffuse + fres * (vis * dist)[:, None]


def shade_pixels(ref, planes, tri, px, py, camera_position, max_anisotropy, dtype,
                 texel_ids=None):
    """Linear RGB (N, 3) and alpha (N,) of the winners `tri` at the pixel
    centres (px + 0.5, py + 0.5)."""
    sx = px.to(planes.dtype) + 0.5
    sy = py.to(planes.dtype) + 0.5
    pl = planes[tri]
    lam = pl[..., 0] * sx[:, None] + pl[..., 1] * sy[:, None] + pl[..., 2]
    inv = 1.0 / lam.sum(1)
    b = lam * inv[:, None]
    uvc = ref.uv[tri].to(planes.dtype)
    uv = (b[..., None] * uvc).sum(1)
    # d(sum lam_i a_i / sum lam_i) / ds = (sum a_i' a_i - a sum a_i') / sum lam_i
    duv_dx = ((pl[..., 0:1] * uvc).sum(1) - uv * pl[..., 0].sum(1, keepdim=True)) * inv[:, None]
    duv_dy = ((pl[..., 1:2] * uvc).sum(1) - uv * pl[..., 1].sum(1, keepdim=True)) * inv[:, None]
    bq = b.to(dtype)
    wpos = (bq[..., None] * ref.pos[tri].to(dtype)).sum(1)
    nrm = (bq[..., None] * ref.nrm[tri].to(dtype)).sum(1)
    tan = (bq[..., None] * ref.tan[tri].to(dtype)).sum(1)
    uv, duv_dx, duv_dy = uv.to(dtype), duv_dx.to(dtype), duv_dy.to(dtype)
    mat = ref.tri_mat[tri]
    texs = ref.mat_tex[mat]
    samples = []
    for slot in range(3):
        tex = texs[:, slot]
        srgb = torch.full_like(tex, slot == 0, dtype=torch.bool)
        samples.append(_sample(ref, tex, uv[:, 0], uv[:, 1], duv_dx[:, 0], duv_dx[:, 1],
                               duv_dy[:, 0], duv_dy[:, 1], max_anisotropy, srgb, texel_ids))
    base = ref.mat_base[mat].to(dtype) * samples[0]
    mr = ref.mat_mr[mat].to(dtype)
    metallic = mr[:, 0] * samples[1][:, 2]
    roughness = mr[:, 1] * samples[1][:, 1]
    n = _norm(nrm)
    t = _norm(tan[:, :3])
    bt = _norm(torch.cross(n, t, dim=-1)) * tan[:, 3:4]
    ns = 2.0 * samples[2][:, :3] - 1.0
    scale = ref.mat_nscale[mat].to(dtype)
    normal = _norm(t * (ns[:, 0] * scale)[:, None] + bt * (ns[:, 1] * scale)[:, None]
                   + n * ns[:, 2:3])
    cam = torch.as_tensor(np.asarray(camera_position, np.float64), dtype=dtype,
                          device=ref.device)
    view = _norm(cam - wpos)
    radiance = torch.zeros_like(wpos)
    for light in ref.lights.to(dtype):
        has_pos = light[3]
        lvec = light[:3] - has_pos * wpos
        dist = torch.clamp(torch.linalg.vector_norm(lvec, dim=-1), min=POINT_LIGHT_RADIUS)
        atten = (1 - has_pos) + has_pos / (dist * dist)
        l = lvec / dist[:, None]
        brdf = _brdf(base[:, :3], metallic, roughness, l, normal, view)
        cos = torch.clamp(_dot(normal, l), min=0)
        radiance = radiance + (atten * cos)[:, None] * light[4:7] * brdf
    return radiance, torch.ones_like(metallic)


def _encode(c):
    c = torch.clamp(c, 0.0, 1.0)
    srgb = torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return torch.floor(srgb * 255.0 + 0.5).to(torch.uint8)


def render(ref: ReferenceScene, vp: np.ndarray, camera_position, width: int, height: int,
           samples: int, max_anisotropy: float, background=(0.0, 0.0, 0.0),
           shade_dtype=torch.float64, raster_dtype=torch.float64, block: int = 1 << 20,
           counts: bool = False):
    """The (3, H, W) uint8 frame, and with `counts` the work the frame
    needs (``work``)."""
    keys, planes, live, box = raster(ref, vp, width, height, samples, raster_dtype)
    covered = keys != torch.iinfo(torch.int64).max
    frac = covered.sum(0).to(shade_dtype) / samples
    win = keys.amin(0)
    pix = torch.nonzero(covered.any(0)).squeeze(1)
    bg = torch.tensor(background, dtype=shade_dtype, device=ref.device)
    out = bg.expand(height * width, 3).clone()
    texel_ids = [] if counts else None
    for i in range(0, pix.numel(), block):
        p = pix[i:i + block]
        tri = win[p] & ((1 << TRI_BITS) - 1)
        rgb, alpha = shade_pixels(ref, planes, tri, p % width, p // width, camera_position,
                                  max_anisotropy, shade_dtype, texel_ids)
        rgb = rgb * alpha[:, None] + bg * (1 - alpha[:, None])
        f = frac[p][:, None]
        out[p] = rgb * f + bg * (1 - f)
    frame = _encode(out.double()).T.reshape(3, height, width)
    if not counts:
        return frame
    winners = win[pix] & ((1 << TRI_BITS) - 1)
    texels = torch.unique(torch.cat(texel_ids)).numel() if texel_ids else 0
    return frame, {
        "live_triangles": int(live.sum()),
        "box_pixels": int(((box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1]))[live].sum()),
        "covered_pixels": int(pix.numel()),
        "shaded_triangles": int(torch.unique(winners).numel()),
        "texels_read": int(texels),
        "lights": int(ref.lights.shape[0]),
        "samples": samples, "width": width, "height": height,
    }
