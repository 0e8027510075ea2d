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


def jax_assets(name: str, native: bool = False):
    from vktf_tpu.models.scenes import build_preset, sponza_like_asset
    # the translucent courtyard: set_blend touches only the glTF material
    # fields both packages share, so it edits the JAX assets too
    from vktf_tpu_torch.models.scenes import set_blend

    with _jax_native_mips(native):
        if name == "sponza_small":
            return [sponza_like_asset(**SMALL_SPONZA)]
        if name == "sponza_small_blend":
            return set_blend([sponza_like_asset(**SMALL_SPONZA)])
        return build_preset(name)


def torch_assets(name: str):
    from vktf_tpu_torch.models.scenes import build_preset, set_blend, sponza_like_asset

    if name == "sponza_small":
        return [sponza_like_asset(**SMALL_SPONZA)]
    if name == "sponza_small_blend":
        return set_blend([sponza_like_asset(**SMALL_SPONZA)])
    return build_preset(name)


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
               peel_layers=None):
    from vktf_tpu.config import RenderConfig

    return RenderConfig(width=width, height=height, msaa_samples=msaa,
                        backend="pallas", pallas_interpret=True,
                        shade_skip_mode=False, peel_layers=peel_layers)


def cameras(width: int = WIDTH, height: int = HEIGHT):
    """(JAX camera, port camera) at the same pose."""
    from vktf_tpu.mathx import Camera as JCamera, ViewFrustumParams as JVF
    from vktf_tpu_torch.mathx import Camera as TCamera, ViewFrustumParams as TVF

    args = (np.radians(45.0), width / height, 0.1, 1.0e6)
    return (JCamera(CAMERA_POSITION, CAMERA_DIRECTION, JVF(*args)),
            TCamera(CAMERA_POSITION, CAMERA_DIRECTION, TVF(*args)))


@functools.lru_cache(maxsize=None)
def jax_program(name: str, msaa: int = 4, peel_layers=None):
    from vktf_tpu.ops.pipeline import PallasFrameProgram

    _scene, meta = jax_scene(name)
    return PallasFrameProgram(meta, jax_config(msaa, peel_layers=peel_layers))


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


def seeded_triangles(count: int = 1536, seed: int = 3):
    """(tri_corner (36, T), mrowsT (16, T)) in world space (identity
    instance matrices) around the sponza camera, by category: ordinary,
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
    mrowsT = np.tile(np.eye(4, dtype=np.float32).reshape(16, 1), (1, t))
    return tri_corner, mrowsT


def setup_px(tris, width, height, z=0.5):
    """Packed setup rows from PIXEL-space corners (w = 1, constant depth):
    dyadic coordinates, exact through the clip -> screen round trip."""
    from vktf_tpu_torch.ops.setup_kernel import setup_pack

    t = len(tris)
    tri_corner = np.zeros((36, t), np.float32)
    for k, corners in enumerate(tris):
        for i, (px, py) in enumerate(corners):
            tri_corner[6 + 0 * 3 + i, k] = px / width * 2 - 1
            tri_corner[6 + 1 * 3 + i, k] = py / height * 2 - 1
            tri_corner[6 + 2 * 3 + i, k] = z
    mrowsT = np.tile(np.eye(4, dtype=np.float32).reshape(16, 1), (1, t))
    return setup_pack(torch.from_numpy(tri_corner), torch.from_numpy(mrowsT),
                      torch.eye(4), width, height)


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
