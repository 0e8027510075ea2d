"""The scenes of the benchmark's configurations, as plain arrays.

A frozen copy of the port's procedural presets (``models/scenes.py`` and
``models/primitives.py``, the sponza courtyard, the curtains and the ivy of
the multi-asset fly-through) and of its linear-space box-filter mip chain.
The seed of a run seeds the texture noise and the clutter's colours; the
placement of the clutter and the ivy comes from a fixed layout seed, and
every count and size stays fixed, so every seed asks the same work of the
renderer. The result is a plain description: numpy arrays and dicts that the
harness hands to the program through its public asset types
(``port_assets``) and that the reference renders directly.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# mip chains (2x2 box filter in linear space, level n+1 of floor size)
# ---------------------------------------------------------------------------


def srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.power(c, 1.0 / 2.4) - 0.055)


def _quantize(v):
    return (np.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _halve(level):
    h, w = level.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    y0 = np.minimum(2 * np.arange(nh), h - 1)
    y1 = np.minimum(2 * np.arange(nh) + 1, h - 1)
    x0 = np.minimum(2 * np.arange(nw), w - 1)
    x1 = np.minimum(2 * np.arange(nw) + 1, w - 1)
    return 0.25 * (level[y0][:, x0] + level[y1][:, x0] + level[y0][:, x1] + level[y1][:, x1])


def mip_chain(base: np.ndarray, srgb: bool) -> list:
    levels = [np.ascontiguousarray(base, np.uint8)]
    current = base.astype(np.float32) / 255.0
    if srgb:
        current = np.concatenate([srgb_to_linear(current[..., :3]), current[..., 3:]], axis=-1)
    while current.shape[0] > 1 or current.shape[1] > 1:
        current = _halve(current)
        out = current
        if srgb:
            out = np.concatenate([linear_to_srgb(current[..., :3]), current[..., 3:]], axis=-1)
        levels.append(_quantize(out))
    return levels


# ---------------------------------------------------------------------------
# meshes (position vec3, normal vec3, tangent vec4, uv vec2; CCW outside)
# ---------------------------------------------------------------------------


def _mesh(positions, normals, tangents, uvs, indices):
    return {"positions": np.asarray(positions, np.float32),
            "normals": np.asarray(normals, np.float32),
            "tangents": np.asarray(tangents, np.float32),
            "uvs": np.asarray(uvs, np.float32),
            "indices": np.asarray(indices, np.uint32).reshape(-1, 3)}


def box_mesh(h: float = 0.5):
    faces = [((0, 0, 1), (1, 0, 0)), ((0, 0, -1), (-1, 0, 0)), ((1, 0, 0), (0, 0, -1)),
             ((-1, 0, 0), (0, 0, 1)), ((0, 1, 0), (1, 0, 0)), ((0, -1, 0), (1, 0, 0))]
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    for n, t in faces:
        n = np.asarray(n, np.float32)
        t = np.asarray(t, np.float32)
        b = np.cross(n, t)
        base = len(positions)
        for u, v in [(0, 0), (1, 0), (1, 1), (0, 1)]:
            positions.append(n * h + t * (2 * u - 1) * h + b * (2 * v - 1) * h)
            normals.append(n)
            tangents.append([t[0], t[1], t[2], 1.0])
            uvs.append([u, 1 - v])
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return _mesh(positions, normals, tangents, uvs, indices)


def plane_mesh(size: float = 1.0, segments: int = 1, normal_axis: str = "y"):
    s = segments
    grid = np.linspace(-size / 2, size / 2, s + 1, dtype=np.float32)
    uu, vv = np.meshgrid(grid, grid, indexing="xy")
    fu, fv = uu.reshape(-1), vv.reshape(-1)
    zeros = np.zeros_like(fu)
    if normal_axis == "y":
        positions, normal = np.stack([fu, zeros, -fv], axis=-1), [0, 1, 0]
    else:
        positions, normal = np.stack([fu, fv, zeros], axis=-1), [0, 0, 1]
    count = positions.shape[0]
    normals = np.tile(np.asarray(normal, np.float32), (count, 1))
    tangents = np.tile(np.asarray([1, 0, 0, 1], np.float32), (count, 1))
    uvs = np.stack([(fu / size + 0.5), (1.0 - (fv / size + 0.5))], axis=-1)
    a = (np.arange(s)[:, None] * (s + 1) + np.arange(s)[None, :]).reshape(-1)
    c = a + s + 1
    indices = np.stack([a, a + 1, c + 1, a, c + 1, c], axis=1)
    return _mesh(positions, normals, tangents, uvs, indices)


def cylinder_mesh(radius=0.5, height=1.0, sectors=32, stacks=1):
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    for si in range(sectors + 1):
        phi = 2.0 * np.pi * si / sectors
        n = np.asarray([np.cos(phi), 0.0, -np.sin(phi)], np.float32)
        t = np.asarray([-np.sin(phi), 0.0, -np.cos(phi)], np.float32)
        for st in range(stacks + 1):
            positions.append([n[0] * radius, height * (st / stacks - 0.5), n[2] * radius])
            normals.append(n)
            tangents.append([t[0], t[1], t[2], 1.0])
            uvs.append([si / sectors, 1.0 - st / stacks])
    stride = stacks + 1
    for si in range(sectors):
        for st in range(stacks):
            a = si * stride + st
            b = a + stride
            indices += [a, b, b + 1, a, b + 1, a + 1]
    for sign in (1.0, -1.0):
        n = np.asarray([0.0, sign, 0.0], np.float32)
        center = len(positions)
        positions.append([0.0, sign * height / 2, 0.0])
        normals.append(n)
        tangents.append([1.0, 0.0, 0.0, 1.0])
        uvs.append([0.5, 0.5])
        ring = len(positions)
        for si in range(sectors + 1):
            phi = 2.0 * np.pi * si / sectors
            x, z = np.cos(phi), -np.sin(phi)
            positions.append([x * radius, sign * height / 2, z * radius])
            normals.append(n)
            tangents.append([1.0, 0.0, 0.0, 1.0])
            uvs.append([0.5 + 0.5 * x, 0.5 + 0.5 * z * sign])
        for si in range(sectors):
            indices += ([center, ring + si, ring + si + 1] if sign > 0
                        else [center, ring + si + 1, ring + si])
    return _mesh(positions, normals, tangents, uvs, indices)


def uv_sphere_mesh(radius=0.5, rings=16, sectors=32):
    positions, normals, tangents, uvs = [], [], [], []
    for ri, theta in enumerate(np.linspace(0.0, np.pi, rings + 1)):
        for si, phi in enumerate(np.linspace(0.0, 2.0 * np.pi, sectors + 1)):
            n = np.asarray([np.sin(theta) * np.cos(phi), np.cos(theta),
                            -np.sin(theta) * np.sin(phi)], np.float32)
            positions.append(n * radius)
            normals.append(n)
            tangents.append([-np.sin(phi), 0.0, -np.cos(phi), 1.0])
            uvs.append([si / sectors, ri / rings])
    indices = []
    stride = sectors + 1
    for ri in range(rings):
        for si in range(sectors):
            a = ri * stride + si
            c = a + stride
            if ri > 0:
                indices += [a, c, a + 1]
            if ri < rings - 1:
                indices += [a + 1, c, c + 1]
    return _mesh(positions, normals, tangents, uvs, indices)


def _wavy_plane(size, segments, amplitude, waves):
    mesh = plane_mesh(size=size, segments=segments, normal_axis="y")
    pos = mesh["positions"].copy()
    pos[:, 1] = amplitude * np.sin(pos[:, 0] / size * waves * 2 * np.pi) * np.cos(
        pos[:, 2] / size * waves * np.pi)
    idx = mesh["indices"]
    face_n = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, idx[:, k], face_n)
    lengths = np.linalg.norm(normals, axis=-1, keepdims=True)
    lengths[lengths == 0] = 1
    mesh["positions"] = pos
    mesh["normals"] = (normals / lengths).astype(np.float32)
    return mesh


# ---------------------------------------------------------------------------
# textures and materials
# ---------------------------------------------------------------------------


def _value_noise(size, cells, rng):
    grid = rng.random((cells + 1, cells + 1)).astype(np.float32)
    ys = np.linspace(0, cells, size, endpoint=False)
    xs = np.linspace(0, cells, size, endpoint=False)
    y0, x0 = ys.astype(np.int32), xs.astype(np.int32)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    fy, fx = fy * fy * (3 - 2 * fy), fx * fx * (3 - 2 * fx)
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def _fbm(size, rng, octaves=4):
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        out += amp * _value_noise(size, 2 ** (o + 2), rng)
        total += amp
        amp *= 0.5
    return out / total


def _rgba(rgb, size):
    return np.concatenate([rgb, np.ones((size, size, 1), np.float32)], axis=-1)


def _checker(size, a, b, tiles=8):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * tiles // size) + (xx * tiles // size)) % 2
    rgb = np.where(mask[..., None].astype(bool), np.asarray(b, np.float32),
                   np.asarray(a, np.float32))
    return (_rgba(rgb, size) * 255 + 0.5).astype(np.uint8)


def _noise(size, base, tint, rng):
    n = _fbm(size, rng)[..., None]
    rgb = np.asarray(base, np.float32) * (1 - n) + np.asarray(tint, np.float32) * n
    return (np.clip(_rgba(rgb, size), 0, 1) * 255 + 0.5).astype(np.uint8)


def _brick(size, brick, mortar, rng, rows=8, cols=4):
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
                         indexing="ij")
    row = yy * rows / size
    col = xx * cols / size + (np.floor(row).astype(np.int32) % 2) * 0.5
    is_mortar = ((row - np.floor(row)) < 0.08) | ((col - np.floor(col)) < 0.04)
    n = _fbm(size, rng)[..., None] * 0.25
    rgb = np.where(is_mortar[..., None], np.asarray(mortar, np.float32),
                   np.asarray(brick, np.float32) * (0.85 + n))
    return (np.clip(_rgba(rgb, size), 0, 1) * 255 + 0.5).astype(np.uint8)


def _height_to_normal(height, strength=2.0):
    h = height.astype(np.float32)
    dx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    dy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-dx * strength, dy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgba = np.concatenate([(n * 0.5 + 0.5), np.ones(h.shape + (1,), np.float32)], axis=-1)
    return (rgba * 255 + 0.5).astype(np.uint8)


def _mr(size, roughness, metallic):
    out = np.zeros((size, size, 4), np.uint8)
    out[..., 1] = (np.clip(roughness, 0, 1) * 255 + 0.5).astype(np.uint8)
    out[..., 2] = (np.clip(metallic, 0, 1) * 255 + 0.5).astype(np.uint8)
    out[..., 3] = 255
    return out


def _texture(rgba, srgb):
    """Full mip chain; the default sampler (linear filters, repeat wrap)."""
    return {"levels": mip_chain(rgba, srgb), "srgb": srgb,
            "sampler": {"mag_filter": "linear", "min_filter": "linear",
                        "mipmap_mode": "linear", "wrap_u": "repeat", "wrap_v": "repeat"}}


def _material(name, rng, *, kind, base_rgb, tex_size=256, metallic=0.0, roughness=0.8,
              normal_strength=2.0):
    if kind == "checker":
        base = _checker(tex_size, base_rgb, tuple(c * 0.55 for c in base_rgb))
        height = _fbm(tex_size, rng)
    elif kind == "brick":
        base = _brick(tex_size, base_rgb, (0.72, 0.70, 0.66), rng)
        height = base[..., 0].astype(np.float32) / 255.0
    else:
        base = _noise(tex_size, base_rgb, tuple(c * 0.6 for c in base_rgb), rng)
        height = _fbm(tex_size, rng)
    rough = np.clip(roughness + (_fbm(tex_size, rng) - 0.5) * 0.3, 0.05, 1.0)
    metal = np.full((tex_size, tex_size), metallic, np.float32)
    return {"name": name, "base_color_factor": np.ones(4, np.float32),
            "metallic_factor": 1.0, "roughness_factor": 1.0, "normal_scale": 1.0,
            "textures": [_texture(base, True), _texture(_mr(tex_size, rough, metal), False),
                         _texture(_height_to_normal(height, normal_strength), False)]}


# ---------------------------------------------------------------------------
# assets
# ---------------------------------------------------------------------------


def _trs(translation=(0, 0, 0), rotation_y=0.0, scale=(1, 1, 1)):
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ np.diag(
        np.asarray(scale, np.float32))
    m[:3, 3] = translation
    return m


def _rot_x(angle):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _look_dir(direction):
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray([0, 1, 0], np.float32)
    x = np.cross(up, d)
    x /= np.linalg.norm(x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, np.cross(d, x), d
    return m


LAYOUT_SEED = 2024  # placement of the clutter (this seed) and the ivy (this + 1)


class _Builder:
    """An asset: materials, meshes (geometry + material index), root nodes
    (transform + mesh or light index) and lights."""

    def __init__(self, name):
        self.asset = {"name": name, "materials": [], "meshes": [], "nodes": [], "lights": []}

    def mesh(self, geom, material):
        mats = self.asset["materials"]
        if not any(m is material for m in mats):
            mats.append(material)
        index = next(i for i, m in enumerate(mats) if m is material)
        self.asset["meshes"].append({"geometry": geom, "material": index})
        return len(self.asset["meshes"]) - 1

    def node(self, transform, mesh=None, light=None):
        self.asset["nodes"].append({"transform": np.asarray(transform, np.float32),
                                    "mesh": mesh, "light": light})

    def light(self, kind, color, transform):
        self.asset["lights"].append({"type": kind, "color": np.asarray(color, np.float32)})
        self.node(transform, light=len(self.asset["lights"]) - 1)


def sponza(seed, *, columns_per_ring=14, clutter=96, curtains=16, tex_size=256,
           floor_segments=48, wall_segments=32, column_sectors=48, column_stacks=6,
           curtain_segments=24, ball_rings=24, ball_sectors=48):
    """The sponza-scale courtyard: tiled floor, brick walls, two rings of
    columns, wavy curtains, clutter spheres; one directional and four point
    lights (262,688 triangles at the defaults, the port's preset; the
    ``*_segments``, ``*_sectors``, ``*_stacks`` and ``ball_rings`` sizes
    tessellate the same shapes finer)."""
    rng = np.random.default_rng(seed)
    b = _Builder("sponza-like")
    floor_mat = _material("floor-tiles", rng, kind="checker", base_rgb=(0.65, 0.6, 0.55),
                          roughness=0.45, tex_size=tex_size)
    wall_mat = _material("brick-wall", rng, kind="brick", base_rgb=(0.55, 0.3, 0.2),
                         roughness=0.9, tex_size=tex_size)
    column_mats = [_material(f"column-stone-{i}", rng, kind="noise",
                             base_rgb=(0.6 + 0.05 * (i % 3), 0.58, 0.52), roughness=0.7,
                             tex_size=tex_size) for i in range(4)]
    curtain_mats = [_material(f"curtain-{i}", rng, kind="noise", base_rgb=rgb, roughness=0.85,
                              tex_size=tex_size)
                    for i, rgb in enumerate([(0.6, 0.1, 0.1), (0.1, 0.3, 0.55), (0.1, 0.45, 0.2)])]
    clutter_mats = [_material(f"clutter-{i}", rng, kind="noise",
                              base_rgb=tuple(rng.uniform(0.2, 0.8, 3)), metallic=float(i % 2),
                              roughness=float(rng.uniform(0.2, 0.9)), tex_size=tex_size)
                    for i in range(8)]
    b.node(_trs((0, 0, 0), scale=(24, 1, 12)),
           mesh=b.mesh(plane_mesh(size=1.0, segments=floor_segments), floor_mat))
    wall_mesh = b.mesh(plane_mesh(size=1.0, segments=wall_segments, normal_axis="z"),
                       wall_mat)
    for pos, rot, sc in [((0, 4, -6), 0.0, (24, 8, 1)), ((0, 4, 6), np.pi, (24, 8, 1)),
                         ((-12, 4, 0), np.pi / 2, (12, 8, 1)),
                         ((12, 4, 0), -np.pi / 2, (12, 8, 1))]:
        b.node(_trs(pos, rot, sc), mesh=wall_mesh)
    shaft = cylinder_mesh(0.35, 3.2, sectors=column_sectors, stacks=column_stacks)
    capital = box_mesh(0.5)
    for ring, (rx, rz, y) in enumerate([(9.5, 4.2, 1.6), (8.5, 3.4, 5.2)]):
        shaft_meshes = [b.mesh(shaft, m) for m in column_mats]
        cap_mesh = b.mesh(capital, column_mats[ring % 4])
        for i in range(columns_per_ring):
            a = 2 * np.pi * i / columns_per_ring
            x, z = rx * np.cos(a), rz * np.sin(a)
            b.node(_trs((x, y, z), rotation_y=a), mesh=shaft_meshes[i % len(shaft_meshes)])
            b.node(_trs((x, y + 1.85, z), a, (1.0, 0.5, 1.0)), mesh=cap_mesh)
            b.node(_trs((x, y - 1.85, z), a, (1.1, 0.4, 1.1)), mesh=cap_mesh)
    curtain = _wavy_plane(1.0, segments=curtain_segments, amplitude=0.12, waves=2.5)
    curtain_meshes = [b.mesh(curtain, m) for m in curtain_mats]
    for i in range(curtains):
        a = 2 * np.pi * (i + 0.5) / curtains
        x, z = 8.8 * np.cos(a), 3.7 * np.sin(a)
        b.node(_trs((x, 4.6, z), rotation_y=a) @ _rot_x(np.pi / 2) @ _trs(scale=(2.2, 1, 2.8)),
               mesh=curtain_meshes[i % len(curtain_meshes)])
    ball = uv_sphere_mesh(0.5, rings=ball_rings, sectors=ball_sectors)
    ball_meshes = [b.mesh(ball, m) for m in clutter_mats]
    layout = np.random.default_rng(LAYOUT_SEED)
    for i in range(clutter):
        x = float(layout.uniform(-10, 10))
        z = float(layout.uniform(-4.5, 4.5))
        s = float(layout.uniform(0.25, 0.8))
        b.node(_trs((x, s / 2, z), float(layout.uniform(0, np.pi)), (s, s, s)),
               mesh=ball_meshes[i % len(ball_meshes)])
    b.light("directional", (1.0, 0.96, 0.9), _look_dir((0.3, -0.75, 0.4)))
    for (x, z), color in zip([(-7, -3), (7, -3), (-7, 3), (7, 3)],
                             [(18, 14, 8), (14, 16, 18), (18, 10, 6), (12, 18, 12)]):
        b.light("point", color, _trs((x, 3.0, z)))
    return b.asset


def curtains(seed, *, drapes=12, drape_segments=32, tex_size=256):
    """Wavy drapes in a row above the courtyard (twelve at the preset's
    sizes)."""
    rng = np.random.default_rng(seed)
    b = _Builder("curtains")
    mats = [_material(f"drape-{i}", rng, kind="noise", base_rgb=rgb, roughness=0.9,
                      tex_size=tex_size)
            for i, rgb in enumerate([(0.55, 0.12, 0.15), (0.15, 0.25, 0.5)])]
    drape = _wavy_plane(1.0, segments=drape_segments, amplitude=0.18, waves=3.0)
    meshes = [b.mesh(drape, m) for m in mats]
    step = 24.0 / drapes
    for i in range(drapes):
        b.node(_trs((-12 + step * (i + 0.5), 6.2, 0), 0.0) @ _rot_x(np.pi / 2)
               @ _trs(scale=(0.9 * step, 1, 3.2)), mesh=meshes[i % 2])
    return b.asset


def ivy(seed, *, sprigs=160, leaf_segments=4, tex_size=128):
    """Many small leaf planes on the walls."""
    rng = np.random.default_rng(seed)
    b = _Builder("ivy")
    leaf_mat = _material("ivy-leaf", rng, kind="noise", base_rgb=(0.12, 0.4, 0.1),
                         roughness=0.8, tex_size=tex_size)
    leaf_mesh = b.mesh(plane_mesh(size=1.0, segments=leaf_segments, normal_axis="z"),
                       leaf_mat)
    layout = np.random.default_rng(LAYOUT_SEED + 1)
    for _ in range(sprigs):
        wall = int(layout.integers(0, 4))
        t = float(layout.uniform(-0.45, 0.45))
        y = float(layout.uniform(0.5, 7.5))
        s = float(layout.uniform(0.3, 0.9))
        pos, rot = [((t * 24, y, -5.9), 0.0), ((t * 24, y, 5.9), np.pi),
                    ((-11.9, y, t * 12), np.pi / 2), ((11.9, y, t * 12), -np.pi / 2)][wall]
        b.node(_trs(pos, rot + float(layout.uniform(-0.4, 0.4)), (s, s, s)), mesh=leaf_mesh)
    return b.asset


DRAPE_KEYS = ("drapes", "drape_segments")
IVY_KEYS = {"ivy_sprigs": "sprigs", "leaf_segments": "leaf_segments"}


def build(scene: dict, seed: int) -> list:
    """The assets of a configuration's ``scene`` block for a run's seed:
    each asset's generator takes its own seed drawn from the run's. The
    block's keys besides ``preset`` are sizes: ``drapes`` and
    ``drape_segments`` the curtains pack's, ``ivy_sprigs`` and
    ``leaf_segments`` the ivy pack's, the rest the courtyard's."""
    seeds = [int(s) for s in np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)]
    sizes = {k: v for k, v in scene.items() if k != "preset"}
    drape = {k: sizes.pop(k) for k in DRAPE_KEYS if k in sizes}
    leaves = {IVY_KEYS[k]: sizes.pop(k) for k in list(IVY_KEYS) if k in sizes}
    if scene["preset"] == "sponza" and not drape and not leaves:
        return [sponza(seeds[0], **sizes)]
    if scene["preset"] == "flythrough":
        tex = sizes["tex_size"]
        return [sponza(seeds[0], **sizes), curtains(seeds[1], tex_size=tex, **drape),
                ivy(seeds[2], tex_size=tex // 2, **leaves)]
    raise ValueError(f"unknown scene preset {scene['preset']!r} or sizes {sorted(scene)}")


def triangle_count(assets: list) -> int:
    return sum(int(a["meshes"][n["mesh"]]["geometry"]["indices"].shape[0])
               for a in assets for n in a["nodes"] if n["mesh"] is not None)
