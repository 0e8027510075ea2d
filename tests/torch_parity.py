"""Shared inputs of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages build the same procedural scene from the same seed: the box
preset, or a small sponza courtyard (the production preset's layout at
columns_per_ring=4, clutter=8, curtains=2, 64 px textures: 38k triangles,
so the JAX interpret-mode kernels stay inside the CPU test budget). The
JAX side runs the production frame program with Pallas in interpret mode
(``backend="pallas"``, ``pallas_interpret=True``) and no empty-chunk
skipping, which takes the same branches as the 1080p sponza frame: the
two-phase shade, the fused pool, one peel layer, the pre-permuted stream.
Stage outputs cross to the port as numpy arrays.

Texels: the JAX package generates mip chains with its native library when
that builds (``vktf_tpu/native.py``: g++ ``-ffast-math -march=native``,
whose vectorized ``powf`` depends on the host CPU) and with numpy
otherwise. The port implements the numpy definition, so scenes built for
exact comparison use the JAX package's numpy path (``native=False``); the
native chains are held to it within one u8 step (test_torch_scene.py).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

WIDTH, HEIGHT = 256, 128
SMALL_SPONZA = dict(columns_per_ring=4, clutter=8, curtains=2, tex_size=64)
# bench.py's sponza camera: inside the courtyard, looking down its length
CAMERA_POSITION = (-9.0, 1.7, 0.0)
CAMERA_DIRECTION = (1.0, 0.05, 0.0)


def limit_threads() -> None:
    """The suite runs files in parallel workers; keep each one narrow."""
    torch.set_num_threads(2)


@contextlib.contextmanager
def _jax_native_mips(enabled: bool):
    from vktf_tpu import native

    if enabled:
        yield
        return
    load = native._load
    native._load = lambda: None  # the JAX package's numpy fallbacks
    try:
        yield
    finally:
        native._load = load


def _small_sponza_variant(name: str, sponza_like_asset):
    """The small courtyard named `name`: "sponza_small" plus any of
    "_blend" (set_blend) and "_mirror" or "_mixed" (set_samplers presets),
    or None for another name. set_blend and set_samplers touch only the
    glTF fields both packages share, so they edit the JAX assets too."""
    from vktf_tpu_torch.models.scenes import SAMPLER_PRESETS, set_blend, set_samplers

    if not name.startswith("sponza_small"):
        return None
    assets = [sponza_like_asset(**SMALL_SPONZA)]
    for variant in name[len("sponza_small"):].split("_")[1:]:
        if variant == "blend":
            set_blend(assets)
        else:
            set_samplers(assets, **SAMPLER_PRESETS[variant])
    return assets


def jax_assets(name: str, native: bool = False):
    from vktf_tpu.models.scenes import build_preset, sponza_like_asset

    with _jax_native_mips(native):
        return _small_sponza_variant(name, sponza_like_asset) or build_preset(name)


def torch_assets(name: str):
    from vktf_tpu_torch.models.scenes import build_preset, sponza_like_asset

    return _small_sponza_variant(name, sponza_like_asset) or build_preset(name)


@functools.lru_cache(maxsize=None)
def jax_scene(name: str, native: bool = False):
    """(RenderScene, SceneMeta) of the JAX package."""
    from vktf_tpu.scene.flatten import flatten_assets

    assets = jax_assets(name, native)
    with _jax_native_mips(native):
        scene, meta, _aux = flatten_assets(assets)
    return scene, meta


@functools.lru_cache(maxsize=None)
def torch_leaves(name: str):
    """(leaves dict of numpy arrays, SceneMeta) of the port."""
    from vktf_tpu_torch.scene.flatten import flatten_assets_numpy

    return flatten_assets_numpy(torch_assets(name))


def jax_leaves(name: str, native: bool = False) -> dict:
    """The JAX scene's leaves the port reads, as numpy arrays."""
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES

    scene, _meta = jax_scene(name, native)
    return {f: np.asarray(getattr(scene, f)) for f in SCENE_LEAVES}


def jax_config(msaa: int = 4, width: int = WIDTH, height: int = HEIGHT,
               peel_layers=None, **kw):
    from vktf_tpu.config import RenderConfig

    return RenderConfig(width=width, height=height, msaa_samples=msaa,
                        backend="pallas", pallas_interpret=True,
                        shade_skip_mode=False, peel_layers=peel_layers, **kw)


def cameras(width: int = WIDTH, height: int = HEIGHT):
    """(JAX camera, port camera) at the same pose."""
    from vktf_tpu.mathx import Camera as JCamera, ViewFrustumParams as JVF
    from vktf_tpu_torch.mathx import Camera as TCamera, ViewFrustumParams as TVF

    args = (np.radians(45.0), width / height, 0.1, 1.0e6)
    return (JCamera(CAMERA_POSITION, CAMERA_DIRECTION, JVF(*args)),
            TCamera(CAMERA_POSITION, CAMERA_DIRECTION, TVF(*args)))


@functools.lru_cache(maxsize=None)
def jax_program(name: str, msaa: int = 4, peel_layers=None, **kw):
    from vktf_tpu.ops.pipeline import PallasFrameProgram

    _scene, meta = jax_scene(name)
    return PallasFrameProgram(meta, jax_config(msaa, peel_layers=peel_layers, **kw))


def port_meta(jmeta):
    """The port's SceneMeta carrying the JAX scene's static facts."""
    from vktf_tpu_torch.scene.flatten import SceneMeta

    return SceneMeta(**{f: getattr(jmeta, f) for f in (
        "level_slices", "num_lights", "num_instances", "num_triangles",
        "num_vertices", "peel_layers", "mixed_samplers", "mirror_wrap")})


@functools.lru_cache(maxsize=None)
def jax_setup(name: str, msaa: int = 4):
    """The production program's prepare stage: (packed setup, lights) as
    numpy, plus the view projection it ran with."""
    scene, _meta = jax_scene(name)
    jcam, _ = cameras()
    vp = jcam.view_projection_transform
    setup, lights = jax_program(name, msaa)._prepare(scene, vp, jcam.position)
    return {k: np.asarray(v) for k, v in setup.items()}, np.asarray(lights), vp


def identity_instance(t: int):
    """One identity instance for t triangles: (inst_rows (1, 16) f32,
    tri_instance (T,) i32)."""
    return np.eye(4, dtype=np.float32).reshape(1, 16), np.zeros(t, np.int32)


def gathered_rowsT(inst_rows, tri_instance) -> np.ndarray:
    """The (16, T) per-triangle instance-matrix rows the JAX kernels take
    (mrowsT): inst_rows (I, 16) gathered by tri_instance (T,)."""
    return np.ascontiguousarray(np.asarray(inst_rows)[np.asarray(tri_instance)].T)


def instances_of(mrows, tri_instance, num_instances: int):
    """(inst_rows (I, 16) f32, tri_instance (T,) i32) whose gather is the
    per-triangle rows mrows (T, 16) bit for bit (an instance without
    triangles keeps a zero row)."""
    mrows = np.asarray(mrows, np.float32)
    idx = np.asarray(tri_instance).astype(np.int32)
    inst_rows = np.zeros((num_instances, 16), np.float32)
    inst_rows[idx[::-1]] = mrows[::-1]  # the first triangle of each instance wins
    assert np.array_equal(inst_rows[idx].view(np.int32), mrows.view(np.int32))
    return inst_rows, idx


def seeded_instances(t: int, count: int = 7, seed: int = 5):
    """`count` random rigid instances about the sponza camera (a rotation
    of up to 0.3 rad about a random axis through the eye, then a shift of
    ~0.5) and a random instance for each of t triangles: (inst_rows
    (count, 16) f32, tri_instance (T,) i32)."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(CAMERA_POSITION, np.float64)
    rows = []
    for _ in range(count):
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        angle = rng.uniform(-0.3, 0.3)
        k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
        m = np.eye(4)
        m[:3, :3] = rot
        m[:3, 3] = eye - rot @ eye + rng.normal(0, 0.5, 3)
        rows.append(m.reshape(16))
    return (np.asarray(rows, np.float32),
            rng.integers(0, count, t).astype(np.int32))


def seeded_triangles(count: int = 1536, seed: int = 3):
    """(tri_corner (36, T), inst_rows (1, 16), tri_instance (T,)) in world
    space (one identity instance) around the sponza camera, by category: ordinary,
    back-facing, near-plane crossers, all behind the eye, degenerate
    (collinear or a repeated corner), off screen, huge (screen coordinates
    beyond 32768 px), pixel-sized slivers."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(CAMERA_POSITION, np.float64)
    fwd = np.asarray(CAMERA_DIRECTION, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    kinds = count // 8
    corners = []

    def at(dist, lateral, vertical):
        return eye + fwd * dist + right * lateral + up * vertical

    for _ in range(kinds):  # ordinary small triangles in view
        c = at(rng.uniform(1, 30), rng.uniform(-8, 8), rng.uniform(-4, 4))
        corners.append(c + rng.normal(0, 0.4, (3, 3)))
    for _ in range(kinds):  # back-facing: the same, winding reversed
        c = at(rng.uniform(1, 30), rng.uniform(-8, 8), rng.uniform(-4, 4))
        corners.append((c + rng.normal(0, 0.4, (3, 3)))[::-1])
    for _ in range(kinds):  # near-plane crossers (corners behind the eye)
        tri = [at(rng.uniform(-2, 0.09), rng.uniform(-1, 1), rng.uniform(-1, 1)),
               at(rng.uniform(0.11, 3), rng.uniform(-1, 1), rng.uniform(-1, 1)),
               at(rng.uniform(-1, 3), rng.uniform(-1, 1), rng.uniform(-1, 1))]
        corners.append(np.asarray(tri)[rng.permutation(3)])
    for _ in range(kinds):  # all corners behind the eye
        corners.append(np.asarray([at(rng.uniform(-5, -0.2), rng.uniform(-3, 3),
                                      rng.uniform(-3, 3)) for _ in range(3)]))
    for _ in range(kinds):  # degenerate: collinear, or a repeated corner
        a = at(rng.uniform(1, 20), rng.uniform(-5, 5), rng.uniform(-3, 3))
        b = a + rng.normal(0, 0.5, 3)
        if rng.random() < 0.5:
            corners.append(np.asarray([a, b, a + (b - a) * rng.uniform(-1, 2)]))
        else:
            corners.append(np.asarray([a, b, b]))
    for _ in range(kinds):  # off screen: beside, above or past the far side
        c = at(rng.uniform(2, 30), rng.choice([-1, 1]) * rng.uniform(40, 80),
               rng.uniform(-3, 3))
        corners.append(c + rng.normal(0, 0.5, (3, 3)))
    for _ in range(kinds):  # huge: screen coordinates beyond 32768 px
        c = at(rng.uniform(0.2, 2), rng.uniform(-1, 1), rng.uniform(-1, 1))
        corners.append(c + rng.normal(0, 400, (3, 3)))
    while len(corners) < count:  # pixel-sized slivers
        c = at(rng.uniform(5, 40), rng.uniform(-6, 6), rng.uniform(-3, 3))
        d = rng.normal(0, 1, 3)
        corners.append(np.asarray([c, c + d, c + d * 1.001 + rng.normal(0, 1e-3, 3)]))
    pos = np.asarray(corners, np.float32)  # (T, 3 corners, 3 channels)
    t = pos.shape[0]
    tri_corner = rng.normal(0, 1, (36, t)).astype(np.float32)
    for c in range(3):
        for i in range(3):
            tri_corner[6 + c * 3 + i] = pos[:, i, c]
    return (tri_corner, *identity_instance(t))


def setup_px(tris, width, height, z=0.5):
    """Packed setup rows from PIXEL-space corners (w = 1, constant depth per
    triangle: z is one depth or one per triangle): dyadic coordinates, exact
    through the clip -> screen round trip."""
    from vktf_tpu_torch.ops.setup_kernel import setup_pack

    t = len(tris)
    zs = np.broadcast_to(np.asarray(z, np.float32), (t,))
    tri_corner = np.zeros((36, t), np.float32)
    for k, corners in enumerate(tris):
        for i, (px, py) in enumerate(corners):
            tri_corner[6 + 0 * 3 + i, k] = px / width * 2 - 1
            tri_corner[6 + 1 * 3 + i, k] = py / height * 2 - 1
            tri_corner[6 + 2 * 3 + i, k] = zs[k]
    inst_rows, tri_instance = identity_instance(t)
    return setup_pack(torch.from_numpy(tri_corner), torch.from_numpy(inst_rows),
                      torch.from_numpy(tri_instance), torch.eye(4), width, height)


def port_camera(width: int = WIDTH, height: int = HEIGHT):
    """The port's camera at the parity tests' pose (no JAX import)."""
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams

    return Camera(CAMERA_POSITION, CAMERA_DIRECTION,
                  ViewFrustumParams(np.radians(45.0), width / height, 0.1, 1.0e6))


def as_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t if dtype is None else t.to(dtype)


def unpack_table(table_u16) -> np.ndarray:
    """The JAX (T, 128) u16 hi|lo shade table as (T, 64) f32."""
    t = np.asarray(table_u16).astype(np.uint32)
    return ((t[:, :64] << 16) | t[:, 64:]).view(np.float32)


def assert_bits_equal(actual, expected, what: str) -> None:
    a = np.ascontiguousarray(np.asarray(actual, np.float32))
    e = np.ascontiguousarray(np.asarray(expected, np.float32))
    assert a.shape == e.shape, (what, a.shape, e.shape)
    diff = a.view(np.int32) != e.view(np.int32)
    if diff.any():
        idx = np.argwhere(diff)[:5]
        raise AssertionError(
            f"{what}: {int(diff.sum())} of {diff.size} values differ in their "
            f"bits, first at {idx.tolist()}: "
            f"{[(float(a[tuple(i)]), float(e[tuple(i)])) for i in idx]}")


def ulp_diff(actual, expected) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    a = np.asarray(actual, np.float32).view(np.int32).astype(np.int64)
    e = np.asarray(expected, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    e = np.where(e < 0, -(e & 0x7FFFFFFF), e)
    return np.abs(a - e)


def checker_rgba(size, a, b, cell) -> np.ndarray:
    """(size, size, 4) u8 checkerboard (tests/helpers.checker_png_bytes'
    pattern, undecoded)."""
    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    img[mask] = a
    img[~mask] = b
    return img


# plane scenes (built with the port's classes; the JAX shade functions take their
# stage outputs): the mixed-sampler plane of tests/test_textures.py:211-235
# and the fused-mip edge-case plane of :255-283
MIXED_PLANE = dict(
    samplers=({}, {"wrap_u": "clamp_to_edge", "wrap_v": "clamp_to_edge"},
              {"wrap_u": "mirrored_repeat", "wrap_v": "mirrored_repeat", "mag_filter": "nearest"}),
    uv_scale=2.5, uv_offset=-0.75, plane_size=3.0, translation=(0.0, 0.0, -1.2),
    tex_size=32, cells=(8, 16, 16), camera=((0.0, 1.6, 1.8), (0.0, -0.7, -1.0)))
EDGE_PLANE = dict(
    samplers=({},) * 3, uv_scale=4.0, uv_offset=-1.5, plane_size=40.0,
    translation=(0.0, 0.0, -2.0), tex_size=8, cells=(2, 2, 2),
    camera=((0.0, 1.2, 6.0), (0.0, -0.18, -1.0)))


def byte_rgba(size, seed: int) -> np.ndarray:
    """(size, size, 4) u8 with size = 16: each channel a seeded permutation
    of 0..255, so the texture holds every byte value in every channel."""
    rng = np.random.default_rng(seed)
    assert size * size == 256
    return np.stack([rng.permutation(256).astype(np.uint8) for _ in range(4)],
                    axis=1).reshape(size, size, 4)


# a plane close to the camera, magnified, whose three textures hold every
# byte value in every channel (the base colour in sRGB, the others linear)
BYTE_PLANE = dict(
    samplers=({},) * 3, uv_scale=1.0, uv_offset=0.0, plane_size=2.0,
    translation=(0.0, 0.0, -1.0), tex_size=16, cells=(1, 1, 1),
    camera=((0.0, 2.5, 1.6), (0.0, -0.96, -1.0)), images="bytes")


def plane_asset(samplers, uv_scale, uv_offset, plane_size, translation, tex_size, cells,
                camera=None, blend=False, images=None):
    """A textured plane lit by one directional light, built with the port's
    dataclasses. samplers: three dicts of Sampler fields (base,
    metallic-roughness, normal). images "bytes": byte_rgba textures in place of
    the checkerboards. blend: the material BLENDs at alpha 0.5 and
    a smaller copy of the plane floats 0.3 above, so two layers cover the
    view's centre."""
    from vktf_tpu_torch.loaders.gltf import (
        Asset, Light, Material, Mesh, Node, PbrMetallicRoughness, Primitive, Sampler, Scene,
        Texture)
    from vktf_tpu_torch.loaders.images import TextureData, generate_mips
    from vktf_tpu_torch.mathx.quaternion import quat_to_matrix
    from vktf_tpu_torch.models.primitives import plane_mesh

    def texture(rgba, srgb, fields):
        return Texture(decoded=TextureData(levels=generate_mips(rgba, srgb), srgb=srgb),
                       sampler=Sampler(**fields))

    if images == "bytes":
        base, mr, nrm = (byte_rgba(tex_size, seed) for seed in (1, 2, 3))
    else:
        base = checker_rgba(tex_size, (220, 40, 40, 255), (40, 40, 220, 255), cells[0])
        mr = checker_rgba(tex_size, (40, 200, 120, 255), (200, 60, 60, 255), cells[1])
        nrm = checker_rgba(tex_size, (128, 128, 255, 255), (180, 100, 230, 255), cells[2])
    material = Material(
        pbr_metallic_roughness=PbrMetallicRoughness(
            base_color_factor=np.asarray((1.0, 1.0, 1.0, 0.5 if blend else 1.0), np.float32),
            base_color_texture=texture(base, True, samplers[0]), metallic_factor=0.4,
            roughness_factor=0.7, metallic_roughness_texture=texture(mr, False, samplers[1])),
        normal_texture=texture(nrm, False, samplers[2]),
        alpha_mode="BLEND" if blend else "OPAQUE")
    geom = plane_mesh(plane_size)
    pos = geom["positions"]
    mesh = Mesh(primitives=[Primitive(
        positions=pos, indices=geom["indices"].astype(np.uint32), normals=geom["normals"],
        tangents=geom["tangents"], uvs=(geom["uvs"] * uv_scale + uv_offset).astype(np.float32),
        material=material, aabb=np.stack([pos.min(axis=0), pos.max(axis=0)]))])
    light_m = np.eye(4, dtype=np.float32)
    light_m[:3, :3] = quat_to_matrix(np.asarray((0.9239, -0.3827, 0.0, 0.0), np.float32))
    place = np.eye(4, dtype=np.float32)
    place[:3, 3] = translation
    nodes = [Node(local_transform=place, mesh=0), Node(local_transform=light_m, light=0)]
    if blend:
        above = np.diag(np.asarray((0.5, 1.0, 0.5, 1.0), np.float32))
        above[:3, 3] = np.asarray(translation, np.float32) + (0.0, 0.3, 0.0)
        nodes.append(Node(local_transform=above, mesh=0))
    return Asset(name="plane", materials=[material], meshes=[mesh],
                 lights=[Light(color=np.asarray((2.5, 2.5, 2.5), np.float32))], nodes=nodes,
                 scenes=[Scene(root_nodes=list(range(len(nodes))))], default_scene=0)


def plane_camera(spec, width, height):
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams

    position, direction = spec["camera"]
    return Camera(position, direction,
                  ViewFrustumParams(np.radians(45.0), width / height, 0.1, 100.0))


def port_stages(scene):
    """The port's frame stages up to the shade for a Scene, on its device:
    dict(tri (K, N) or (N,), frac, sx, sy, table, pool, lights, cam, bg)."""
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel, shade_table

    rs, meta, cfg, prog = scene.render_scene, scene.meta, scene.config, scene.frame_program
    dev = rs.device
    vp = torch.as_tensor(np.asarray(scene.camera.view_projection_transform, np.float32),
                         device=dev)
    inst_rows, tri_instance, lights = pipeline.scene_update(rs, meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, cfg.width,
                                    cfg.height)
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"],
                                  raster.stream_perm(setup["bbox_rows"], setup["valid"]))
    ids, depth = raster.rasterize(*stream, cfg.padded_height, cfg.padded_width,
                                  cfg.msaa_samples, prog.layers)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner, rs.tri_static_cols,
                                          setup["anchor2"], inst_rows, tri_instance)
    tri, frac = pipeline.pixel_winner(ids, depth)
    sx, sy = pipeline.pixel_centers(cfg.padded_height, cfg.padded_width, dev)
    return dict(tri=tri, frac=frac, sx=sx, sy=sy, table=table, pool=rs.quad_pool,
                lights=lights,
                cam=torch.as_tensor(np.asarray(scene.camera.position, np.float32), device=dev),
                bg=torch.tensor(cfg.clear_color[:3], dtype=torch.float32, device=dev))


def pack_table(table) -> np.ndarray:
    """The port's (T, 64) f32 shade table as the JAX package's (T, 128) u16
    hi|lo halves."""
    bits = np.ascontiguousarray(np.asarray(table, np.float32)).view(np.uint32)
    return np.concatenate([(bits >> 16).astype(np.uint16), (bits & 0xFFFF).astype(np.uint16)],
                          axis=1)


def pool_u16(pool) -> np.ndarray:
    """The port's (P, 64) i32 texel pool as the JAX package's (P, 128) u16."""
    return np.ascontiguousarray(np.asarray(pool)).view(np.uint16)
