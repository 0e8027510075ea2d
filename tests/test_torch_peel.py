"""Port parity of the depth peel's kernels: the K-layer raster and the
layer form of the deferred shade.

* Raster, K layers: the plain version against the JAX kernel
  (``rasterize_pallas(..., layers=K, interpret=True)``) on the JAX setup's
  stream rows of the small sponza frame at 256x128, K = 3: every layer's
  ids exactly and depths bit for bit.
* Sorted insertion: the plain version against a numpy sort of every
  fragment of every sample, on axis-aligned quads whose coverage numpy
  decides on its own (integer bounds, so no sample lies on an edge): a
  9-deep stack of equal-depth quads (ties break on draw order), fewer
  fragments than K, and K = 8 at 8x MSAA.
* Shade, layer form: ``shade_layer_plain`` against the JAX production
  program's ``shade_final_chunk(..., frac=None)`` fed the same pixels of
  the translucent courtyard (curtains and clutter BLEND at alpha 0.5),
  K = 3. Alpha bit for bit on all but ALPHA_ULP_SHARE of the entries and
  within ALPHA_ULP units in the last place on those: a textured alpha
  passes through the mip lerp, whose weight comes from log2 (measured: 1
  of 98,304 entries, 0.50000006 against 0.5). Radiance where the layer is
  covered within RGB_ULP float32 units in the last place on all but
  RGB_ULP_SHARE of the values and within RGB_ULP_MAX everywhere: the two
  sides evaluate pow, log2 and rsqrt with different libraries
  (test_torch_shade.py), and the light sum cancels, so an ULP there grows
  (measured: at most 0.52% of a layer's values above 64, at most 782,
  relative error at most 5.3e-5, far below one u8 step).
  Uncovered entries are rgb 0, alpha 0 in the port; the JAX kernel shades
  table row 0 there and only its alpha (0) is held to.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

PEEL_K = 3
RGB_ULP = 64
RGB_ULP_SHARE = 1e-2
RGB_ULP_MAX = 1024
ALPHA_ULP = 2
ALPHA_ULP_SHARE = 1e-4


@pytest.mark.parametrize("msaa", [1, 4])
def test_raster_layers_match_jax_kernel(msaa):
    from vktf_tpu.ops.raster_pallas import rasterize_pallas, stream_perm
    from vktf_tpu_torch.ops.raster import rasterize, raster_stream
    from vktf_tpu_torch.ops.raster import stream_perm as port_perm

    setup, _lights, _vp = tp.jax_setup("sponza_small")
    cfg = tp.jax_config(msaa)
    jsetup = {k: setup[k] for k in ("tri_data", "bbox_rows", "valid")}

    @jax.jit
    def reference(s):
        return rasterize_pallas(
            s, cfg.padded_height, cfg.padded_width, tile_shape=cfg.tile_shape,
            msaa_samples=msaa, chunk=cfg.pallas_chunk, interpret=True,
            sort="none", perm=stream_perm(s, chunk=cfg.pallas_chunk),
            group_size=cfg.raster_group_size, layers=PEEL_K,
            interleave=cfg.resolved_interleave(), assemble=True)

    want_ids, want_depth = (np.asarray(a) for a in reference(jsetup))
    tri_data, bbox_rows, valid = (tp.as_torch(setup[k]) for k in
                                  ("tri_data", "bbox_rows", "valid"))
    stream = raster_stream(tri_data, bbox_rows, port_perm(bbox_rows, valid))
    ids, depth = rasterize(*stream, cfg.padded_height, cfg.padded_width, msaa,
                           PEEL_K)
    assert ids.shape == want_ids.shape == (PEEL_K, msaa, tp.HEIGHT, tp.WIDTH)
    # the courtyard has surfaces behind surfaces: layer 1 is well covered
    assert (want_ids[1] >= 0).mean() > 0.1
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    tp.assert_bits_equal(depth.numpy(), want_depth, "depth")


# (x0, y0, x1, y1, z) axis-aligned quads in pixels, in draw order
_EQUAL_STACK = [(4 + q, 2, 40 + q, 20, 0.5) for q in range(9)]
_SHALLOW = [(10, 4, 50, 28, 0.75), (2, 2, 30, 30, 0.25), (20, 0, 64, 16, 0.5)]


def _random_quads(seed: int = 7, count: int = 14):
    rng = np.random.default_rng(seed)
    quads = []
    for _ in range(count):
        x0, y0 = int(rng.integers(0, 48)), int(rng.integers(0, 24))
        quads.append((x0, y0, x0 + int(rng.integers(4, 32)),
                      y0 + int(rng.integers(3, 16)),
                      float(rng.choice([0.125, 0.25, 0.375, 0.5, 0.625]))))
    return quads


def _numpy_layers(quads, layers, msaa, width, height):
    """Every sample's fragments sorted by (depth, quad), first `layers`:
    (quad index (K, S, H, W), depth); -1 / 1.0 where there are fewer."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS

    offsets = SAMPLE_OFFSETS[msaa]
    quad = np.full((layers, len(offsets), height, width), -1, np.int64)
    depth = np.ones(quad.shape, np.float32)
    for s, (ox, oy) in enumerate(offsets):
        for y in range(height):
            for x in range(width):
                sx, sy = x + ox, y + oy
                frags = sorted((z, q) for q, (x0, y0, x1, y1, z) in enumerate(quads)
                               if x0 <= sx < x1 and y0 <= sy < y1)
                for l, (z, q) in enumerate(frags[:layers]):
                    quad[l, s, y, x] = q
                    depth[l, s, y, x] = z
    return quad, depth


def _quad_setup(quads, width, height):
    """Setup rows of the quads, two triangles each (ids 2q and 2q + 1), at
    per-quad constant depth."""
    from vktf_tpu_torch.ops.setup_kernel import setup_pack

    tris, zs = [], []
    for x0, y0, x1, y1, z in quads:
        tris += [[(x0, y0), (x1, y1), (x1, y0)], [(x0, y0), (x0, y1), (x1, y1)]]
        zs += [z, z]
    t = len(tris)
    tri_corner = np.zeros((36, t), np.float32)
    for k, corners in enumerate(tris):
        for i, (px, py) in enumerate(corners):
            tri_corner[6 + i, k] = px / width * 2 - 1
            tri_corner[9 + i, k] = py / height * 2 - 1
            tri_corner[12 + i, k] = zs[k]
    inst_rows, tri_instance = tp.identity_instance(t)
    return setup_pack(torch.from_numpy(tri_corner), torch.from_numpy(inst_rows),
                      torch.from_numpy(tri_instance), torch.eye(4), width, height)


@pytest.mark.parametrize("case, layers, msaa", [
    ("equal_depth_9_deep", 8, 4),
    ("fewer_than_k", 8, 1),
    ("random_k8_msaa8", 8, 8),
    ("random_k3_msaa4", 3, 4),
])
def test_sorted_insertion_matches_numpy_sort(case, layers, msaa):
    from vktf_tpu_torch.ops.raster import rasterize, raster_stream, stream_perm

    quads = {"equal_depth_9_deep": _EQUAL_STACK, "fewer_than_k": _SHALLOW}.get(
        case) or _random_quads()
    width, height = 64, 32
    s = _quad_setup(quads, width, height)
    perm = stream_perm(s["bbox_rows"], s["valid"])
    stream = raster_stream(s["tri_data"], s["bbox_rows"], perm)
    ids, depth = rasterize(*stream, height, width, msaa, layers)
    want_quad, want_depth = _numpy_layers(quads, layers, msaa, width, height)
    ids = ids.numpy()
    np.testing.assert_array_equal(np.where(ids >= 0, ids // 2, -1), want_quad)
    tp.assert_bits_equal(depth.numpy(), want_depth, "depth")
    if case == "equal_depth_9_deep":  # all 9 cover (20, 10); the 9th is cut
        np.testing.assert_array_equal(ids[:, :, 10, 20] // 2,
                                      np.repeat(np.arange(8)[:, None], msaa, 1))
    if case == "fewer_than_k":
        assert (want_quad[2] >= 0).any() and (want_quad[3] == -1).all()


@functools.lru_cache(maxsize=None)
def _jax_blend_stages():
    """The translucent courtyard's production stages at K = 3, up to phase
    A, and phase B's layer outputs (numpy)."""
    from vktf_tpu.ops.shade_kernel import shade_final_chunk

    prog = tp.jax_program("sponza_small_blend", 4, PEEL_K)
    scene, meta = tp.jax_scene("sponza_small_blend")
    assert meta.peel_layers == 8  # 10 translucent instances, clamped
    jcam, _ = tp.cameras()
    vp = jcam.view_projection_transform
    setup, lights = prog._prepare(scene, vp, jcam.position)
    state = prog._maybe_restream(scene, setup, vp)
    tri_id, depth = prog._raster_stream(prog._stream_cam(*state, vp))
    table = prog._table(setup, scene)
    addr = prog._shade_addr(tri_id, depth, table)
    assert len(addr["ids"]) == PEEL_K
    cfg = tp.jax_config(4, peel_layers=PEEL_K)
    layer = jax.jit(lambda a, l, q, cam, lights: shade_final_chunk(
        a["trow"][l], a["r0"][l], None, a["ids"][l], a["sx"][0], a["sy"][0],
        q, cam, lights, max_anisotropy=cfg.max_anisotropy, interpret=True,
        fused_pool=True), static_argnums=1)
    outs = [layer(addr, l, scene.quad_pool, jcam.position, lights)
            for l in range(PEEL_K)]
    return dict(
        ids=np.stack([np.asarray(i) for i in addr["ids"]]),
        sx=np.asarray(addr["sx"][0]), sy=np.asarray(addr["sy"][0]),
        table=tp.unpack_table(table), cam=np.asarray(jcam.position),
        lights=np.asarray(lights),
        rgb=np.stack([np.asarray(o[0]) for o in outs]),
        alpha=np.stack([np.asarray(o[1]) for o in outs]))


def test_shade_layer_matches_jax():
    from vktf_tpu_torch.ops.shade_kernel import shade_layer
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    st = _jax_blend_stages()
    pool = scene_from_numpy(tp.jax_leaves("sponza_small_blend"), "cpu").quad_pool
    ids = st["ids"]
    rgb, alpha = shade_layer(
        tp.as_torch(ids), tp.as_torch(st["sx"]), tp.as_torch(st["sy"]),
        torch.from_numpy(st["table"]), pool, tp.as_torch(st["cam"]),
        tp.as_torch(st["lights"]), tp.jax_config(4).max_anisotropy)
    rgb, alpha = rgb.numpy(), alpha.numpy()
    assert rgb.shape == st["rgb"].shape == (PEEL_K, 3, ids.shape[1])
    covered = ids >= 0
    # translucent surfaces in front of others: layers 1 and 2 shade pixels
    assert covered[1].mean() > 0.1 and covered[2].any()
    blend = (alpha > 0) & (alpha < 1)
    assert blend[0].mean() > 0.05
    alpha_ulp = tp.ulp_diff(alpha, st["alpha"])
    assert alpha_ulp.max() <= ALPHA_ULP, int(alpha_ulp.max())
    assert (alpha_ulp > 0).mean() <= ALPHA_ULP_SHARE, float((alpha_ulp > 0).mean())
    for l in range(PEEL_K):
        assert (rgb[l][:, ~covered[l]] == 0).all()
        got, want = rgb[l][:, covered[l]], st["rgb"][l][:, covered[l]]
        ulp = tp.ulp_diff(got, want)
        assert ulp.max() <= RGB_ULP_MAX, (l, int(ulp.max()))
        assert (ulp > RGB_ULP).mean() <= RGB_ULP_SHARE, (l, float((ulp > RGB_ULP).mean()))
