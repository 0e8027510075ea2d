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


def cameras(width: int = WIDTH, height: int = HEIGHT,
            pose=(CAMERA_POSITION, CAMERA_DIRECTION)):
    """(JAX camera, port camera) at the same pose (position, direction)."""
    from vktf_tpu.mathx import Camera as JCamera, ViewFrustumParams as JVF
    from vktf_tpu_torch.mathx import Camera as TCamera, ViewFrustumParams as TVF

    args = (np.radians(45.0), width / height, 0.1, 1.0e6)
    return JCamera(*pose, JVF(*args)), TCamera(*pose, TVF(*args))


@functools.lru_cache(maxsize=None)
def jax_program(name: str, msaa: int = 4, peel_layers=None, **kw):
    from vktf_tpu.ops.pipeline import PallasFrameProgram

    _scene, meta = jax_scene(name)
    return PallasFrameProgram(meta, jax_config(msaa, peel_layers=peel_layers, **kw))


@functools.lru_cache(maxsize=None)
def jax_frame(name: str, msaa: int = 4, peel_layers=None) -> np.ndarray:
    """The JAX program's (3, HEIGHT, WIDTH) u8 frame of name from the
    parity camera, rendered once per process."""
    scene, _meta = jax_scene(name)
    jcam, _ = cameras()
    prog = jax_program(name, msaa, peel_layers)
    return np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))


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


def depth_plane_bound(edge9, bbox_rows, inv_det, z, w) -> np.ndarray:
    """Per triangle, the bound on the port's and the JAX setup's depth at
    any point of its bbox (tests/test_torch_setup.py's docstring): 128
    roundings of the summand scale, |d_port - d_jax| <= 128 * 2^-24 *
    (S_a * bbox_w + S_b * bbox_h + S_c + 1), S_c and the anchor terms for
    near-plane crossers only. z, w: the three corners' clip z (float64) and
    w."""
    e9 = np.asarray(edge9).astype(np.float64)
    br = np.asarray(bbox_rows).astype(np.float64)
    bw, bh = br[2] - br[0], br[3] - br[1]
    inv_det = np.abs(np.asarray(inv_det).astype(np.float64))
    scale = [inv_det * sum(np.abs(e9[3 * i + k] * z[i]) for i in range(3))
             for k in range(3)]
    crosser = (w[0] <= 1e-12) | (w[1] <= 1e-12) | (w[2] <= 1e-12)
    return 2.0 ** -24 * 128 * (
        scale[0] * bw + scale[1] * bh + 1.0
        + np.where(crosser, scale[0] * br[0] + scale[1] * br[1] + scale[2], 0.0))


def clip_f64(tri_corner, mrowsT, vp):
    """The port's float32 clip corners as float64: x, y, z, w, each a list
    of the three corners' (T,) arrays."""
    from vktf_tpu_torch.ops.vertex import clip_corners

    return [[c.numpy().astype(np.float64) for c in row] for row in clip_corners(
        as_torch(tri_corner), as_torch(mrowsT), as_torch(np.asarray(vp, np.float32)))]


def float64_depth_planes(x, y, z, w, width: int, height: int):
    """Per triangle, the float64 depth plane through clip corners, as (T, 3)
    coefficients of depth = co . (sx, sy, 1) in pixels (2D homogeneous:
    depth = z^T M^-1 s, M's columns (xs, ys, w) of the corners), and the
    conditioning K of its screen-space solve, (|ex1 ey2| + |ex2 ey1|) /
    |ex1 ey2 - ex2 ey1| over the projected edges (inf where a corner is
    not in front of the eye)."""
    xs = [(x[i] + w[i]) * 0.5 * width for i in range(3)]
    ys = [(y[i] + w[i]) * 0.5 * height for i in range(3)]
    m = np.stack([np.stack(xs, -1), np.stack(ys, -1), np.stack(w, -1)], -2)
    ok = np.abs(np.linalg.det(m)) > 0
    minv = np.zeros_like(m)
    minv[ok] = np.linalg.inv(m[ok])
    co = np.einsum("ti,tij->tj", np.stack(z, -1), minv)
    front = (w[0] > 1e-12) & (w[1] > 1e-12) & (w[2] > 1e-12)
    with np.errstate(divide="ignore", invalid="ignore"):
        px = [np.where(front, xs[i] / w[i], 0.0) for i in range(3)]
        py = [np.where(front, ys[i] / w[i], 0.0) for i in range(3)]
        p1, p2 = (px[1] - px[0]) * (py[2] - py[0]), (px[2] - px[0]) * (py[1] - py[0])
        cond = (np.abs(p1) + np.abs(p2)) / np.abs(p1 - p2)
    return co, np.where(front & ok, cond, np.inf)


# The bound of a depth from the port's setup against the float64 depth
# at a point of its triangle, stated before the first run: 2^-20 (16
# float32 ulps at depths 0.5..1: the corners' NDC z and the evaluation
# round) plus 2^-16 of the plane's change across the triangle's bbox times
# the conditioning K of the screen-space solve (the corners' float32
# screen positions round, which tilts the plane by their error over the
# triangle's height, K ~ length / height). Where the port keeps the
# homogeneous plane (near-plane crossers, insane projections),
# depth_plane_bound takes the place of the second term.
F64_ABS, F64_REL = 2.0 ** -20, 2.0 ** -16


def float64_depth_bound(co, cond, homogeneous, edge9, bbox_rows, inv_det, z, w):
    """Per triangle, the bound above: co, cond from float64_depth_planes,
    homogeneous (T,) bool, the rest as depth_plane_bound's."""
    br = np.asarray(bbox_rows).astype(np.float64)
    bw, bh = br[2] - br[0], br[3] - br[1]
    with np.errstate(invalid="ignore"):
        screen = F64_REL * cond * (np.abs(co[:, 0]) * bw + np.abs(co[:, 1]) * bh)
    return F64_ABS + np.where(
        homogeneous, depth_plane_bound(edge9, bbox_rows, inv_det, z, w), screen)


@functools.lru_cache(maxsize=None)
def raster_pair(width: int, height: int, msaa: int, layers: int):
    """Both packages' per-sample visibility of the small courtyard's
    geometry (every sponza_small variant shares it) from the parity
    camera, each from its own setup: the JAX setup kernel and raster
    (interpret mode) and the port's plain versions. Returns (JAX ids, JAX
    depth, port ids, port depth), each (K, S, height, width), and the
    (T, 3) float64 depth planes (float64_depth_planes)."""
    import jax

    from vktf_tpu.ops.raster_pallas import rasterize_pallas, stream_perm as jax_perm
    from vktf_tpu_torch.ops.raster import rasterize, raster_stream, stream_perm
    from vktf_tpu_torch.ops.setup_kernel import setup_pack

    name = "sponza_small"
    scene, _meta = jax_scene(name)
    jcam, _ = cameras(width, height)
    vp = jcam.view_projection_transform
    cfg = jax_config(msaa, width=width, height=height, peel_layers=layers)
    setup, _lights = jax_program(name, msaa, peel_layers=layers, width=width,
                                 height=height)._prepare(scene, vp, jcam.position)
    setup = {k: np.asarray(v) for k, v in setup.items()}
    ph, pw = cfg.padded_height, cfg.padded_width
    jids, jdepth = (np.asarray(a) for a in jax.jit(lambda s: rasterize_pallas(
        s, ph, pw, tile_shape=cfg.tile_shape, msaa_samples=msaa, chunk=cfg.pallas_chunk,
        interpret=True, sort="none", perm=jax_perm(s, chunk=cfg.pallas_chunk),
        group_size=cfg.raster_group_size, interleave=cfg.resolved_interleave(),
        layers=layers))({k: setup[k] for k in ("tri_data", "bbox_rows", "valid")}))
    tri_corner = np.asarray(scene.tri_corner)
    inst_rows, tri_instance = instances_of(setup["mrows"], scene.tri_instance,
                                           scene.inst_node.shape[0])
    port = setup_pack(as_torch(tri_corner), as_torch(inst_rows), as_torch(tri_instance),
                      as_torch(np.asarray(vp, np.float32)), width, height)
    stream = raster_stream(port["tri_data"], port["bbox_rows"],
                           stream_perm(port["bbox_rows"], port["valid"]))
    pids, pdepth = (a.numpy() for a in rasterize(*stream, ph, pw, msaa, layers))
    co, _cond = float64_depth_planes(*clip_f64(tri_corner, setup["mrows"].T, vp),
                                     width, height)
    shape = (layers, msaa, ph, pw)
    return tuple(a.reshape(shape)[..., :height, :width]
                 for a in (jids, jdepth, pids, pdepth)) + (co,)


def _pixel_winners(ids, depth):
    """Each layer's pixel winner, (K, S, ...) -> (K, ...): min depth, then
    min id, among the covered samples (-1 when none), as pixel_winner."""
    ids = np.asarray(ids, np.int64)
    big = np.iinfo(np.int64).max
    d_min = np.where(ids >= 0, depth, np.inf).min(axis=1, keepdims=True)
    tri = np.where((depth == d_min) & (ids >= 0), ids, big).min(axis=1)
    return np.where(tri == big, -1, tri)


def jax_wrong_pixels(width: int, height: int, msaa: int, layers: int = 1,
                     rate: str = "pixel") -> set:
    """The pixels of the small courtyard whose winners the port gets right
    by float64 depth and the JAX package gets wrong: set of (y, x).

    The winners are each sample's K nearest (depth, id) fragments and, at
    pixel rate, each layer's pixel winner (its nearest sample's triangle).
    The float64 winners re-sort the fragments either package found at a
    sample by the float64 depth of their triangles there; a package is
    right where its winners equal them (raster_pair's inputs)."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS

    jids, jdepth, pids, pdepth, co = raster_pair(width, height, msaa, layers)
    differ = (jids != pids).any(axis=(0, 1))
    if rate == "pixel":  # the pixel winners follow the depths
        differ |= (_pixel_winners(jids, jdepth) != _pixel_winners(pids, pdepth)).any(axis=0)
    wrong = set()
    for y, x in np.argwhere(differ):
        true_ids = np.full((layers, msaa), -1)
        true_depth = np.ones((layers, msaa))
        for s, (ox, oy) in enumerate(SAMPLE_OFFSETS[msaa]):
            found = {int(t) for t in (*jids[:, s, y, x], *pids[:, s, y, x]) if t >= 0}
            frags = sorted((float(co[t] @ (x + ox, y + oy, 1.0)), t) for t in found)[:layers]
            for k, (d, t) in enumerate(frags):
                true_ids[k, s], true_depth[k, s] = t, d

        def right(ids, depth):
            same = np.array_equal(ids, true_ids)
            if rate == "pixel":
                same &= np.array_equal(_pixel_winners(ids, depth),
                                       _pixel_winners(true_ids, true_depth))
            return same

        if (right(pids[..., y, x], pdepth[..., y, x])
                and not right(jids[..., y, x], jdepth[..., y, x])):
            wrong.add((int(y), int(x)))
    return wrong


def checked_jax_wrong(listed, width: int, height: int, msaa: int, layers: int = 1,
                      rate: str = "pixel"):
    """listed, after asserting that JAX's winner is the wrong one by
    float64 depth at each of its pixels (jax_wrong_pixels)."""
    if listed:
        unproven = set(map(tuple, listed)) - jax_wrong_pixels(width, height, msaa, layers, rate)
        assert not unproven, f"JAX's winner is not proven wrong at {sorted(unproven)}"
    return listed


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


def assert_frames_close(got, want, shape, jax_wrong=()) -> None:
    """The frame budget of the port's frame parity tests: one u8 step on
    at most 0.5% of the pixels. jax_wrong: pixels (y, x) where the JAX
    package's winner is the wrong one by float64 depth (the test checks
    them with jax_wrong_pixels); the budget holds apart from them."""
    assert got.shape == want.shape == shape
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want).max(axis=0)
    for y, x in jax_wrong:
        diff[y, x] = 0
    assert diff.max() <= 1, (int(diff.max()), np.argwhere(diff > 1)[:40].tolist())
    assert (diff > 0).mean() <= 5e-3, float((diff > 0).mean())


def port_config(**kw):
    """The port's RenderConfig of the parity tests: WIDTH x HEIGHT at 4x
    MSAA, kw overriding."""
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(**{"width": WIDTH, "height": HEIGHT, "msaa_samples": 4, **kw})


@functools.lru_cache(maxsize=None)
def sponza_stages():
    """The small courtyard (the JAX package's scene) through the port's
    stages, as numpy."""
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = jax_scene("sponza_small")
    _jcam, tcam = cameras()
    scene = Scene.from_render_scene(scene_from_numpy(jax_leaves("sponza_small"), "cpu"),
                                    port_meta(jmeta), port_config(), camera=tcam)
    return {k: v.numpy() for k, v in port_stages(scene).items()}


def stage_tensors(st, *names) -> list:
    """The named numpy stage outputs of st as torch tensors."""
    return [torch.from_numpy(np.ascontiguousarray(st[n])) for n in names]


def jax_shade_args(st) -> tuple:
    """(tri, sx, sy, table, pool, cam, lights) of port stages as the JAX
    shade kernels take them."""
    return (st["tri"], st["sx"], st["sy"], pack_table(st["table"]), pool_u16(st["pool"]),
            st["cam"], st["lights"])


# resolved pixels: one u8 step on at most this share of the pixels
PACKED_STEP_SHARE = 1e-3


def u8_step(got, want) -> np.ndarray:
    """The largest u8 step of any channel between two packed RGB frames."""
    step = np.zeros(got.shape, np.int64)
    for c in range(3):
        step = np.maximum(step, np.abs(((got >> (8 * c)) & 0xFF).astype(np.int64)
                                       - ((want >> (8 * c)) & 0xFF)))
    return step


def assert_packed_close(got, want) -> None:
    assert got.shape == want.shape
    step = u8_step(got, want)
    assert step.max() <= 1, int(step.max())
    assert (step > 0).mean() <= PACKED_STEP_SHARE, float((step > 0).mean())


def sample_rate_frames(name: str, width: int, height: int, **kw):
    """(port Scene, its frame, the JAX program's frame) of one scene at
    sample rate and 4x MSAA, from the parity tests' camera; kw are
    RenderConfig fields both packages have."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    scene, _meta = jax_scene(name)
    jcam, tcam = cameras(width, height)
    prog = jax_program(name, 4, width=width, height=height, shading_rate="sample", **kw)
    want = np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))
    port = Scene(torch_assets(name),
                 RenderConfig(width=width, height=height, msaa_samples=4,
                              shading_rate="sample", **kw),
                 camera=tcam, device="cpu")
    return port, port.render_still(), want


def check_sample_frame(name, width, height, kw, form, layers, jax_wrong=()):
    """The port's sample-rate frame within the budget of JAX's, through
    the expected shade form at the expected K, and not the pixel-rate
    frame; jax_wrong as assert_frames_close's, checked."""
    port, got, want = sample_rate_frames(name, width, height, **kw)
    prog = port.frame_program
    assert (prog.form.texels, prog.form.taps, prog.layers) == (*form, layers)
    assert (want.max(axis=0) > 0).mean() > 0.5
    assert_frames_close(got, want, (3, height, width),
                        checked_jax_wrong(jax_wrong, width, height, 4, layers, "sample"))
    pixel = type(port).from_render_scene(
        port.render_scene, port.meta, port.config.replace(shading_rate="pixel"),
        camera=port.camera).render_still()
    assert (pixel != got).any(axis=0).mean() > 0.01
