"""Procedural benchmark scenes: the five presets of the bench (box, duck,
helmet, sponza and the multi-asset flythrough).

Counterpart of ``vktf_tpu/models/scenes.py``, same generators and the same
seeds, so the geometry, materials, lights and texels are identical to the
JAX package's. The one difference: textures keep their decoded mip chains
(``generate_mips``) instead of a zstd-supercompressed KTX2 round trip, which
is lossless, so the texels are the same without needing a zstd codec.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vktf_tpu_torch.loaders.gltf import (
    CLAMP_TO_EDGE,
    MIRRORED_REPEAT,
    NEAREST,
    REPEAT,
    Asset,
    Light,
    Material,
    Mesh,
    Node,
    PbrMetallicRoughness,
    Primitive,
    Sampler,
    Scene,
    Texture,
)
from vktf_tpu_torch.loaders.images import TextureData, generate_mips
from vktf_tpu_torch.models.primitives import box_mesh, cylinder_mesh, plane_mesh, uv_sphere_mesh

# ---------------------------------------------------------------------------
# Procedural textures (deterministic)
# ---------------------------------------------------------------------------


def _value_noise(size: int, cells: int, rng: np.random.Generator) -> np.ndarray:
    """Smooth value noise in [0, 1] via bilinear-upsampled random grids."""
    grid = rng.random((cells + 1, cells + 1)).astype(np.float32)
    ys = np.linspace(0, cells, size, endpoint=False)
    xs = np.linspace(0, cells, size, endpoint=False)
    y0 = ys.astype(np.int32)
    x0 = xs.astype(np.int32)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    fy = fy * fy * (3 - 2 * fy)
    fx = fx * fx * (3 - 2 * fx)
    g = grid
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x0 + 1] * fx
    bot = g[y0 + 1][:, x0] * (1 - fx) + g[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def _fbm(size: int, rng: np.random.Generator, octaves: int = 4) -> np.ndarray:
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        out += amp * _value_noise(size, 2 ** (o + 2), rng)
        total += amp
        amp *= 0.5
    return out / total


def checker_texture(size: int, color_a, color_b, tiles: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * tiles // size) + (xx * tiles // size)) % 2
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    rgb = np.where(mask[..., None].astype(bool), b, a)
    rgba = np.concatenate([rgb, np.ones((size, size, 1), np.float32)], axis=-1)
    return (rgba * 255 + 0.5).astype(np.uint8)


def noise_texture(size: int, base, tint, rng: np.random.Generator) -> np.ndarray:
    n = _fbm(size, rng)[..., None]
    rgb = np.asarray(base, np.float32) * (1 - n) + np.asarray(tint, np.float32) * n
    rgba = np.concatenate([rgb, np.ones((size, size, 1), np.float32)], axis=-1)
    return (np.clip(rgba, 0, 1) * 255 + 0.5).astype(np.uint8)


def brick_texture(size: int, brick, mortar, rng: np.random.Generator,
                  rows: int = 8, cols: int = 4) -> np.ndarray:
    yy, xx = np.meshgrid(
        np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
        indexing="ij",
    )
    row = yy * rows / size
    shift = (np.floor(row).astype(np.int32) % 2) * 0.5
    col = xx * cols / size + shift
    fy = row - np.floor(row)
    fx = col - np.floor(col)
    is_mortar = (fy < 0.08) | (fx < 0.04)
    n = _fbm(size, rng)[..., None] * 0.25
    rgb = np.where(
        is_mortar[..., None],
        np.asarray(mortar, np.float32),
        np.asarray(brick, np.float32) * (0.85 + n),
    )
    rgba = np.concatenate([rgb, np.ones((size, size, 1), np.float32)], axis=-1)
    return (np.clip(rgba, 0, 1) * 255 + 0.5).astype(np.uint8)


def height_to_normal(height: np.ndarray, strength: float = 2.0) -> np.ndarray:
    """Sobel height -> tangent-space normal map, RGBA8 ([0.5,0.5,1] = flat)."""
    h = height.astype(np.float32)
    dx = np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)
    dy = np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)
    n = np.stack([-dx * strength, dy * strength, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgba = np.concatenate(
        [(n * 0.5 + 0.5), np.ones(h.shape + (1,), np.float32)], axis=-1
    )
    return (rgba * 255 + 0.5).astype(np.uint8)


def mr_texture(size: int, roughness: np.ndarray, metallic: np.ndarray) -> np.ndarray:
    """glTF metallic-roughness map: roughness in G, metallic in B."""
    out = np.zeros((size, size, 4), np.uint8)
    out[..., 1] = (np.clip(roughness, 0, 1) * 255 + 0.5).astype(np.uint8)
    out[..., 2] = (np.clip(metallic, 0, 1) * 255 + 0.5).astype(np.uint8)
    out[..., 3] = 255
    return out


def _texture(name: str, rgba: np.ndarray, srgb: bool, sampler: Sampler) -> Texture:
    """A texture holding its full decoded mip chain."""
    data = TextureData(levels=generate_mips(rgba, srgb), srgb=srgb)
    return Texture(name=name, decoded=data, sampler=sampler)


# ---------------------------------------------------------------------------
# Material library
# ---------------------------------------------------------------------------


def _make_material(
    name: str,
    rng: np.random.Generator,
    *,
    kind: str,
    base_rgb,
    tex_size: int = 256,
    metallic: float = 0.0,
    roughness: float = 0.8,
    normal_strength: float = 2.0,
) -> Material:
    sampler = Sampler(name=f"{name}-sampler")
    if kind == "checker":
        base = checker_texture(tex_size, base_rgb, tuple(c * 0.55 for c in base_rgb))
        height = _fbm(tex_size, rng)
    elif kind == "brick":
        base = brick_texture(tex_size, base_rgb, (0.72, 0.70, 0.66), rng)
        height = base[..., 0].astype(np.float32) / 255.0
    else:  # "noise"
        base = noise_texture(tex_size, base_rgb, tuple(c * 0.6 for c in base_rgb), rng)
        height = _fbm(tex_size, rng)
    rough_map = np.clip(roughness + (_fbm(tex_size, rng) - 0.5) * 0.3, 0.05, 1.0)
    metal_map = np.full((tex_size, tex_size), metallic, np.float32)
    pbr = PbrMetallicRoughness(
        base_color_factor=np.ones(4, np.float32),
        base_color_texture=_texture(f"{name}-base", base, True, sampler),
        metallic_factor=1.0,
        roughness_factor=1.0,
        metallic_roughness_texture=_texture(
            f"{name}-mr", mr_texture(tex_size, rough_map, metal_map), False, sampler
        ),
    )
    return Material(
        name=name,
        pbr_metallic_roughness=pbr,
        normal_scale=1.0,
        normal_texture=_texture(
            f"{name}-normal", height_to_normal(height, normal_strength), False, sampler
        ),
    )


def _flat_material(name: str, rgba, metallic: float = 0.0, roughness: float = 0.9) -> Material:
    return Material(
        name=name,
        pbr_metallic_roughness=PbrMetallicRoughness(
            base_color_factor=np.asarray(rgba, np.float32),
            metallic_factor=metallic,
            roughness_factor=roughness,
        ),
    )


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def _trs(translation=(0, 0, 0), rotation_y: float = 0.0, scale=(1, 1, 1)) -> np.ndarray:
    c, s = np.cos(rotation_y), np.sin(rotation_y)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray(
        [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32
    ) @ np.diag(np.asarray(scale, np.float32))
    m[:3, 3] = translation
    return m


def _rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _wavy_plane(size: float, segments: int, amplitude: float, waves: float):
    """A curtain-like plane (in xz, +y up) displaced by sine waves, with
    recomputed smooth normals."""
    mesh = plane_mesh(size=size, segments=segments, normal_axis="y")
    pos = mesh["positions"].copy()
    pos[:, 1] = amplitude * np.sin(pos[:, 0] / size * waves * 2 * np.pi) * np.cos(
        pos[:, 2] / size * waves * np.pi
    )
    idx = mesh["indices"]
    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, idx[:, k], face_n)
    lengths = np.linalg.norm(normals, axis=-1, keepdims=True)
    lengths[lengths == 0] = 1
    mesh["positions"] = pos
    mesh["normals"] = (normals / lengths).astype(np.float32)
    return mesh


def _primitive(geom: dict, material: Material | None) -> Primitive:
    pos = geom["positions"]
    return Primitive(
        positions=pos,
        indices=geom["indices"].astype(np.uint32),
        normals=geom.get("normals"),
        tangents=geom.get("tangents"),
        uvs=geom.get("uvs"),
        material=material,
        aabb=np.stack([pos.min(axis=0), pos.max(axis=0)]),
    )


class _AssetBuilder:
    def __init__(self, name: str):
        self.asset = Asset(name=name, scenes=[Scene(name="scene", root_nodes=[])],
                           default_scene=0)

    def add_mesh(self, geom: dict, material: Material | None, name: str) -> int:
        if material is not None and material not in self.asset.materials:
            self.asset.materials.append(material)
        self.asset.meshes.append(
            Mesh(name=name, primitives=[_primitive(geom, material)])
        )
        return len(self.asset.meshes) - 1

    def add_node(self, *, mesh: int | None = None, light: int | None = None,
                 transform: np.ndarray | None = None, name: str | None = None) -> int:
        node = Node(
            name=name,
            local_transform=np.asarray(
                transform if transform is not None else np.eye(4), np.float32
            ),
            mesh=mesh,
            light=light,
        )
        self.asset.nodes.append(node)
        idx = len(self.asset.nodes) - 1
        self.asset.scenes[0].root_nodes.append(idx)
        return idx

    def add_light(self, type: str, color, transform: np.ndarray) -> int:
        self.asset.lights.append(Light(name=f"light{len(self.asset.lights)}",
                                       color=np.asarray(color, np.float32), type=type))
        return self.add_node(light=len(self.asset.lights) - 1, transform=transform)


def _look_dir_transform(direction) -> np.ndarray:
    """Node transform whose +z column is `direction` (lights read the z-axis
    column)."""
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray([0, 1, 0], np.float32)
    if abs(float(d @ up)) > 0.99:
        up = np.asarray([1, 0, 0], np.float32)
    x = np.cross(up, d)
    x /= np.linalg.norm(x)
    y = np.cross(d, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, d
    return m


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------


def box_asset() -> Asset:
    """One box, baseColorFactor only."""
    b = _AssetBuilder("box")
    mesh = b.add_mesh(box_mesh(0.5), _flat_material("red", (0.8, 0.05, 0.05, 1.0)), "box")
    b.add_node(mesh=mesh, transform=_trs((0, 0, 0), rotation_y=0.6))
    b.add_light("directional", (1, 1, 1),
                _look_dir_transform((0.3, -0.8, 0.5)))
    return b.asset


def duck_asset() -> Asset:
    """One textured mesh (the Duck stand-in: a textured sphere)."""
    rng = np.random.default_rng(7)
    b = _AssetBuilder("duck")
    mat = _make_material("duck-skin", rng, kind="checker",
                         base_rgb=(0.9, 0.75, 0.1), roughness=0.6)
    mesh = b.add_mesh(uv_sphere_mesh(0.5, rings=32, sectors=64), mat, "duck")
    b.add_node(mesh=mesh)
    b.add_light("directional", (1, 1, 1), _look_dir_transform((0.2, -0.7, 0.6)))
    return b.asset


def helmet_asset() -> Asset:
    """Full PBR metallic-roughness with normal mapping (the DamagedHelmet
    stand-in); one directional and one point light."""
    rng = np.random.default_rng(11)
    b = _AssetBuilder("helmet")
    metal = _make_material("helmet-metal", rng, kind="noise",
                           base_rgb=(0.35, 0.33, 0.3), metallic=1.0,
                           roughness=0.35, normal_strength=3.0)
    glass = _flat_material("visor", (0.05, 0.05, 0.08, 1.0), metallic=0.9, roughness=0.1)
    b.add_node(mesh=b.add_mesh(uv_sphere_mesh(0.5, rings=48, sectors=96), metal, "shell"))
    b.add_node(mesh=b.add_mesh(cylinder_mesh(0.25, 0.2, sectors=48), glass, "visor"),
               transform=_trs((0, 0, 0.35), rotation_y=0.0, scale=(1, 1, 0.5)))
    b.add_light("directional", (1, 1, 1), _look_dir_transform((0.4, -0.6, 0.6)))
    b.add_light("point", (8, 7.5, 7), _trs((2, 2, 2)))
    return b.asset


def sponza_like_asset(
    *,
    seed: int = 42,
    columns_per_ring: int = 14,
    clutter: int = 96,
    curtains: int = 16,
    tex_size: int = 256,
    name: str = "sponza-like",
) -> Asset:
    """A Sponza-scale courtyard (~263k triangles at the defaults): tiled
    floor, brick walls, two rings of columns, wavy curtains, clutter
    spheres; one directional + four point lights. The keyword sizes build
    smaller courtyards with the same layout (the CPU parity tests use one).
    """
    rng = np.random.default_rng(seed)
    b = _AssetBuilder(name)

    floor_mat = _make_material("floor-tiles", rng, kind="checker",
                               base_rgb=(0.65, 0.6, 0.55), roughness=0.45,
                               tex_size=tex_size)
    wall_mat = _make_material("brick-wall", rng, kind="brick",
                              base_rgb=(0.55, 0.3, 0.2), roughness=0.9,
                              tex_size=tex_size)
    column_mats = [
        _make_material(f"column-stone-{i}", rng, kind="noise",
                       base_rgb=(0.6 + 0.05 * (i % 3), 0.58, 0.52),
                       roughness=0.7, tex_size=tex_size)
        for i in range(4)
    ]
    curtain_mats = [
        _make_material(f"curtain-{i}", rng, kind="noise", base_rgb=rgb,
                       roughness=0.85, tex_size=tex_size)
        for i, rgb in enumerate([(0.6, 0.1, 0.1), (0.1, 0.3, 0.55), (0.1, 0.45, 0.2)])
    ]
    clutter_mats = [
        _make_material(f"clutter-{i}", rng, kind="noise",
                       base_rgb=tuple(rng.uniform(0.2, 0.8, 3)),
                       metallic=float(i % 2), roughness=float(rng.uniform(0.2, 0.9)),
                       tex_size=tex_size)
        for i in range(8)
    ]

    floor = plane_mesh(size=1.0, segments=48)
    b.add_node(mesh=b.add_mesh(floor, floor_mat, "floor"),
               transform=_trs((0, 0, 0), scale=(24, 1, 12)))

    wall = plane_mesh(size=1.0, segments=32, normal_axis="z")
    wall_mesh = b.add_mesh(wall, wall_mat, "wall")
    for (pos, rot, sc) in [
        ((0, 4, -6), 0.0, (24, 8, 1)),
        ((0, 4, 6), np.pi, (24, 8, 1)),
        ((-12, 4, 0), np.pi / 2, (12, 8, 1)),
        ((12, 4, 0), -np.pi / 2, (12, 8, 1)),
    ]:
        b.add_node(mesh=wall_mesh, transform=_trs(pos, rot, sc))

    shaft = cylinder_mesh(0.35, 3.2, sectors=48, stacks=6)
    capital = box_mesh(0.5)
    for ring, (rx, rz, y) in enumerate([(9.5, 4.2, 1.6), (8.5, 3.4, 5.2)]):
        shaft_meshes = [b.add_mesh(shaft, m, f"shaft-r{ring}") for m in column_mats]
        cap_mesh = b.add_mesh(capital, column_mats[ring % 4], f"capital-r{ring}")
        for i in range(columns_per_ring):
            a = 2 * np.pi * i / columns_per_ring
            x, z = rx * np.cos(a), rz * np.sin(a)
            b.add_node(mesh=shaft_meshes[i % len(shaft_meshes)],
                       transform=_trs((x, y, z), rotation_y=a))
            b.add_node(mesh=cap_mesh,
                       transform=_trs((x, y + 1.85, z), a, (1.0, 0.5, 1.0)))
            b.add_node(mesh=cap_mesh,
                       transform=_trs((x, y - 1.85, z), a, (1.1, 0.4, 1.1)))

    curtain = _wavy_plane(1.0, segments=24, amplitude=0.12, waves=2.5)
    curtain_meshes = [b.add_mesh(curtain, m, "curtain") for m in curtain_mats]
    for i in range(curtains):
        a = 2 * np.pi * (i + 0.5) / curtains
        x, z = 8.8 * np.cos(a), 3.7 * np.sin(a)
        b.add_node(
            mesh=curtain_meshes[i % len(curtain_meshes)],
            transform=(
                _trs((x, 4.6, z), rotation_y=a)
                @ _rot_x(np.pi / 2) @ _trs(scale=(2.2, 1, 2.8))
            ),
        )

    ball = uv_sphere_mesh(0.5, rings=24, sectors=48)
    ball_meshes = [b.add_mesh(ball, m, "ball") for m in clutter_mats]
    for i in range(clutter):
        x = float(rng.uniform(-10, 10))
        z = float(rng.uniform(-4.5, 4.5))
        s = float(rng.uniform(0.25, 0.8))
        b.add_node(mesh=ball_meshes[i % len(ball_meshes)],
                   transform=_trs((x, s / 2, z), float(rng.uniform(0, np.pi)),
                                  (s, s, s)))

    b.add_light("directional", (1.0, 0.96, 0.9), _look_dir_transform((0.3, -0.75, 0.4)))
    for (x, z), color in zip(
        [(-7, -3), (7, -3), (-7, 3), (7, 3)],
        [(18, 14, 8), (14, 16, 18), (18, 10, 6), (12, 18, 12)],
    ):
        b.add_light("point", color, _trs((x, 3.0, z)))
    return b.asset


def curtains_asset(seed: int = 5) -> Asset:
    """The flythrough's second asset: twelve wavy drapes above the
    courtyard."""
    rng = np.random.default_rng(seed)
    b = _AssetBuilder("curtains")
    mats = [
        _make_material(f"drape-{i}", rng, kind="noise", base_rgb=rgb, roughness=0.9)
        for i, rgb in enumerate([(0.55, 0.12, 0.15), (0.15, 0.25, 0.5)])
    ]
    curtain = _wavy_plane(1.0, segments=32, amplitude=0.18, waves=3.0)
    meshes = [b.add_mesh(curtain, m, "drape") for m in mats]
    for i in range(12):
        x = -11 + 2 * i
        b.add_node(
            mesh=meshes[i % 2],
            transform=_trs((x, 6.2, 0), 0.0) @ _rot_x(np.pi / 2)
            @ _trs(scale=(1.8, 1, 3.2)),
        )
    return b.asset


def ivy_asset(seed: int = 9, sprigs: int = 160) -> Asset:
    """The flythrough's third asset: many small leaf planes on the walls."""
    rng = np.random.default_rng(seed)
    b = _AssetBuilder("ivy")
    leaf_mat = _make_material("ivy-leaf", rng, kind="noise",
                              base_rgb=(0.12, 0.4, 0.1), roughness=0.8, tex_size=128)
    leaf = plane_mesh(size=1.0, segments=4, normal_axis="z")
    leaf_mesh = b.add_mesh(leaf, leaf_mat, "leaf")
    for _ in range(sprigs):
        wall = int(rng.integers(0, 4))
        t = float(rng.uniform(-0.45, 0.45))
        y = float(rng.uniform(0.5, 7.5))
        s = float(rng.uniform(0.3, 0.9))
        if wall == 0:
            pos, rot = (t * 24, y, -5.9), 0.0
        elif wall == 1:
            pos, rot = (t * 24, y, 5.9), np.pi
        elif wall == 2:
            pos, rot = (-11.9, y, t * 12), np.pi / 2
        else:
            pos, rot = (11.9, y, t * 12), -np.pi / 2
        b.add_node(mesh=leaf_mesh,
                   transform=_trs(pos, rot + float(rng.uniform(-0.4, 0.4)),
                                  (s, s, s)))
    return b.asset


def set_blend(assets):
    """The translucent sponza: make the curtain and clutter materials BLEND
    with base-colour alpha 0.5 (16 + 96 instances in the full preset, so the
    scene's peel estimate clamps to 8). In place; returns assets."""
    for asset in assets:
        for material in asset.materials:
            if material.name and material.name.startswith(("curtain-", "clutter-")):
                material.alpha_mode = "BLEND"
                pbr = material.pbr_metallic_roughness
                factor = np.array(pbr.base_color_factor, np.float32)
                factor[3] = 0.5
                pbr.base_color_factor = factor
    return assets


def set_samplers(assets, base=None, mr=None, normal=None):
    """Give each material's base-colour, metallic-roughness and normal
    textures their own sampler: each argument is a dict of the Sampler
    fields to set on that slot (wrap_u, wrap_v, mag_filter, min_filter,
    mipmap_mode), or None to leave it. New Sampler objects replace the one
    a material's textures share, so slots never alias. Touches only fields
    the JAX package's Sampler has too, so it edits its assets as well. In
    place; returns assets."""
    for asset in assets:
        for material in asset.materials:
            pbr = material.pbr_metallic_roughness
            slots = ((pbr.base_color_texture if pbr else None, base),
                     (pbr.metallic_roughness_texture if pbr else None, mr),
                     (material.normal_texture, normal))
            for texture, fields in slots:
                if texture is None or fields is None:
                    continue
                texture.sampler = (Sampler(**fields) if texture.sampler is None
                                   else dataclasses.replace(texture.sampler, **fields))
    return assets


# Sampler presets of set_samplers: every sampler MIRRORED_REPEAT (mirror
# sponza: the two-gather pool), and per-slot samplers that differ (mixed
# sponza: base REPEAT, metallic-roughness CLAMP_TO_EDGE, normal
# MIRRORED_REPEAT with NEAREST magnification; tests/test_textures.py:219-226)
_MIRROR = {"wrap_u": MIRRORED_REPEAT, "wrap_v": MIRRORED_REPEAT}
SAMPLER_PRESETS = {
    "mirror": {"base": _MIRROR, "mr": _MIRROR, "normal": _MIRROR},
    "mixed": {"base": {"wrap_u": REPEAT, "wrap_v": REPEAT},
              "mr": {"wrap_u": CLAMP_TO_EDGE, "wrap_v": CLAMP_TO_EDGE},
              "normal": {**_MIRROR, "mag_filter": NEAREST}},
}


PRESETS = {
    "box": lambda: [box_asset()],
    "duck": lambda: [duck_asset()],
    "helmet": lambda: [helmet_asset()],
    "sponza": lambda: [sponza_like_asset()],
    "flythrough": lambda: [sponza_like_asset(), curtains_asset(), ivy_asset()],
}


def build_preset(name: str) -> list[Asset]:
    """Build a named preset as a list of Assets."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; choose from "
                         f"{sorted(PRESETS)}")
    return PRESETS[name]()
