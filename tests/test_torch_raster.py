"""Port parity: the streaming raster's plain version.

Against the JAX kernel: both rasterize the JAX setup's stream rows of the
small sponza frame (so setup rounding is not under test here) at 256x128,
in the production stream order, and must agree on every sample's winning
triangle id exactly and on its depth bit for bit wherever the ids agree
(they all do).

The CUDA kernel's staging counts (chip_smoke.staging_counts) against a
block-by-block count, and the plain group level of its chunk cull
(``chunk_group_bbox_plain``) against the union of each group's chunks.

The winner form's wrapper (``rasterize_winner``) on the CPU against the
JAX package's phase A (``vktf_tpu.ops.pipeline._tiled_winner``) of the same
plain planes laid out as one raster block: every pixel's winner per layer
exactly and its coverage bit for bit, at every MSAA count, at K = 1, 3 and
8 layers and in a band of rows, with the shapes and dtypes the shade
kernels take (tests/test_torch_cuda.py holds the kernel's winner form to
``pixel_winner`` of its planes on the card).

Against the hand: the Vulkan fill-rule cases of
tests/test_raster_pallas.py (TestFillRulesHandComputed), with their
expected coverage written out as literal arrays, on geometry whose screen
coordinates are exact in float32.
"""

import functools

import numpy as np
import jax
import pytest

import torch_parity as tp

tp.limit_threads()


def _port_raster(tri_data, bbox_rows, valid, height, width, msaa):
    from vktf_tpu_torch.ops.raster import rasterize, raster_stream, stream_perm

    perm = stream_perm(bbox_rows, valid, chunk=256)
    stream = raster_stream(tri_data, bbox_rows, perm, chunk=256, group_size=8)
    ids, depth = rasterize(*stream, height, width, msaa)
    return ids.numpy(), depth.numpy()


@pytest.mark.parametrize("msaa", [1, 2, 4, 8])
def test_raster_matches_jax_kernel(msaa):
    from vktf_tpu.ops.raster_pallas import rasterize_pallas, stream_perm

    setup, _lights, _vp = tp.jax_setup("sponza_small")
    cfg = tp.jax_config(msaa)
    jsetup = {k: setup[k] for k in ("tri_data", "bbox_rows", "valid")}

    @jax.jit
    def reference(s):
        return rasterize_pallas(
            s, cfg.padded_height, cfg.padded_width, tile_shape=cfg.tile_shape,
            msaa_samples=msaa, chunk=cfg.pallas_chunk, interpret=True,
            sort="none", perm=stream_perm(s, chunk=cfg.pallas_chunk),
            group_size=cfg.raster_group_size,
            interleave=cfg.resolved_interleave(), assemble=True)

    want_ids, want_depth = (np.asarray(a) for a in reference(jsetup))
    ids, depth = _port_raster(tp.as_torch(setup["tri_data"]),
                              tp.as_torch(setup["bbox_rows"]),
                              tp.as_torch(setup["valid"]),
                              cfg.padded_height, cfg.padded_width, msaa)
    assert ids.shape == want_ids.shape == (msaa, tp.HEIGHT, tp.WIDTH)
    covered = (want_ids >= 0).mean()
    assert 0.5 < covered < 1.0  # the courtyard fills most of the view
    np.testing.assert_array_equal(ids, want_ids)
    tp.assert_bits_equal(depth, want_depth, "depth")


def _raster_hand(tris, msaa, width=128, height=32):
    s = tp.setup_px(tris, width, height)
    ids, _depth = _port_raster(s["tri_data"], s["bbox_rows"], s["valid"],
                               height, width, msaa)
    return ids


class TestFillRulesHandComputed:
    """tests/test_raster_pallas.py's hand-derived cases (top-left rule,
    standard sample locations, shared-edge watertightness)."""

    def test_shared_diagonal_exactly_once_1x(self):
        # tri 0 owns the diagonal (a > 0: top-left, inclusive)
        ids = _raster_hand([[(2, 2), (10, 10), (10, 2)],
                            [(2, 2), (2, 10), (10, 10)]], msaa=1)
        expected = np.full((1, 32, 128), -1, np.int32)
        expected[0, 2:10, 2:10] = np.asarray([
            [0, 0, 0, 0, 0, 0, 0, 0],
            [1, 0, 0, 0, 0, 0, 0, 0],
            [1, 1, 0, 0, 0, 0, 0, 0],
            [1, 1, 1, 0, 0, 0, 0, 0],
            [1, 1, 1, 1, 0, 0, 0, 0],
            [1, 1, 1, 1, 1, 0, 0, 0],
            [1, 1, 1, 1, 1, 1, 0, 0],
            [1, 1, 1, 1, 1, 1, 1, 0],
        ], np.int32)
        np.testing.assert_array_equal(ids, expected)

    def test_shared_diagonal_exactly_once_4x(self):
        # per sample: id = 0 where sy < sx inside [2, 10)^2, else 1; the
        # standard 4x offsets (.375,.125) (.875,.375) (.125,.625)
        # (.625,.875) put no sample on the diagonal: samples 0 and 1 of a
        # diagonal pixel lie above it (tri 0), samples 2 and 3 below (tri 1)
        ids = _raster_hand([[(2, 2), (10, 10), (10, 2)],
                            [(2, 2), (2, 10), (10, 10)]], msaa=4)
        block = np.asarray([  # rows 2..9, cols 2..9, per sample
            [[0, 0, 0, 0, 0, 0, 0, 0],
             [1, 0, 0, 0, 0, 0, 0, 0],
             [1, 1, 0, 0, 0, 0, 0, 0],
             [1, 1, 1, 0, 0, 0, 0, 0],
             [1, 1, 1, 1, 0, 0, 0, 0],
             [1, 1, 1, 1, 1, 0, 0, 0],
             [1, 1, 1, 1, 1, 1, 0, 0],
             [1, 1, 1, 1, 1, 1, 1, 0]],
            [[0, 0, 0, 0, 0, 0, 0, 0],
             [1, 0, 0, 0, 0, 0, 0, 0],
             [1, 1, 0, 0, 0, 0, 0, 0],
             [1, 1, 1, 0, 0, 0, 0, 0],
             [1, 1, 1, 1, 0, 0, 0, 0],
             [1, 1, 1, 1, 1, 0, 0, 0],
             [1, 1, 1, 1, 1, 1, 0, 0],
             [1, 1, 1, 1, 1, 1, 1, 0]],
            [[1, 0, 0, 0, 0, 0, 0, 0],
             [1, 1, 0, 0, 0, 0, 0, 0],
             [1, 1, 1, 0, 0, 0, 0, 0],
             [1, 1, 1, 1, 0, 0, 0, 0],
             [1, 1, 1, 1, 1, 0, 0, 0],
             [1, 1, 1, 1, 1, 1, 0, 0],
             [1, 1, 1, 1, 1, 1, 1, 0],
             [1, 1, 1, 1, 1, 1, 1, 1]],
            [[1, 0, 0, 0, 0, 0, 0, 0],
             [1, 1, 0, 0, 0, 0, 0, 0],
             [1, 1, 1, 0, 0, 0, 0, 0],
             [1, 1, 1, 1, 0, 0, 0, 0],
             [1, 1, 1, 1, 1, 0, 0, 0],
             [1, 1, 1, 1, 1, 1, 0, 0],
             [1, 1, 1, 1, 1, 1, 1, 0],
             [1, 1, 1, 1, 1, 1, 1, 1]],
        ], np.int32)
        expected = np.full((4, 32, 128), -1, np.int32)
        expected[:, 2:10, 2:10] = block
        np.testing.assert_array_equal(ids, expected)

    def test_top_left_rule_edges_through_samples_1x(self):
        # borders through 1x sample centres: top/left inclusive,
        # right/bottom exclusive, the diagonal sample (4.5, 3.5) -> tri 0
        ids = _raster_hand([[(2.5, 2.5), (6.5, 4.5), (6.5, 2.5)],
                            [(2.5, 2.5), (2.5, 4.5), (6.5, 4.5)]], msaa=1)
        expected = np.full((1, 32, 128), -1, np.int32)
        expected[0, 2:4, 2:6] = np.asarray([[0, 0, 0, 0],
                                            [1, 1, 0, 0]], np.int32)
        np.testing.assert_array_equal(ids, expected)

    def test_standard_4x_sample_x_positions(self):
        # band x in [3.375, 3.625): sample 0 (x .375) in, sample 3 (x .625)
        # out, samples 1 and 2 beside it
        ids = _raster_hand([[(3.375, 0), (3.625, 32), (3.625, 0)],
                            [(3.375, 0), (3.375, 32), (3.625, 32)]], msaa=4)
        expected = np.zeros((4, 32, 128), bool)
        expected[0, :, 3] = True
        np.testing.assert_array_equal(ids >= 0, expected)

    def test_standard_4x_sample_y_positions(self):
        # band y in [2.375, 2.625): sample 1 (y .375) in, sample 2 (y .625)
        # out
        ids = _raster_hand([[(0, 2.375), (128, 2.625), (128, 2.375)],
                            [(0, 2.375), (0, 2.625), (128, 2.625)]], msaa=4)
        expected = np.zeros((4, 32, 128), bool)
        expected[1, 2, :] = True
        np.testing.assert_array_equal(ids >= 0, expected)


@pytest.mark.parametrize("n_chunks", [1, 32, 70])
def test_chunk_group_bbox_plain_is_the_union_of_its_chunks(n_chunks):
    """The group level of the raster's cull: group g is the union of chunks
    32 g .. 32 g + 31 (a ragged last group of the chunks it has), and a
    group of padding chunks is the empty bbox."""
    import torch

    from vktf_tpu_torch.ops.raster import CHUNK_GROUP, chunk_group_bbox, chunk_group_bbox_plain

    rng = np.random.default_rng(n_chunks)
    x0, y0 = rng.integers(0, 300, n_chunks), rng.integers(0, 200, n_chunks)
    box = np.stack([x0, y0, x0 + rng.integers(1, 90, n_chunks),
                    y0 + rng.integers(1, 90, n_chunks)]).astype(np.float32)
    big = np.float32(2.0 ** 30)
    box[:, 32:64] = np.array([big, big, -big, -big])[:, None]  # group 1: padding
    got = chunk_group_bbox(torch.from_numpy(box))
    n_groups = -(-n_chunks // CHUNK_GROUP)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, n_groups)
    assert torch.equal(got, chunk_group_bbox_plain(torch.from_numpy(box)))
    for g in range(n_groups):
        part = box[:, CHUNK_GROUP * g:CHUNK_GROUP * (g + 1)]
        want = np.concatenate([part[:2].min(axis=1), part[2:].max(axis=1)])
        np.testing.assert_array_equal(got[:, g].numpy(), want)
    if n_chunks > 32:
        np.testing.assert_array_equal(got[:, 1].numpy(), [big, big, -big, -big])


def _staging_stream(case):
    """600 seeded small and block-spanning triangles at 128x64, in stream
    order ("sorted": 3 chunks, one group), or the same order spread over 70
    chunks of padding, a third of the valid ones in each group ("padded": 3
    groups, the last ragged, the triangles at seeded positions of their
    group)."""
    import torch

    from vktf_tpu_torch.ops.raster import raster_stream, stream_perm

    rng = np.random.default_rng(11)
    tris = []
    for _ in range(600):
        x, y = 0.5 * rng.integers(2, 250, size=2)
        r = 0.5 * rng.integers(1, 40)
        tris.append([(x - r, y - r), (x + r, y + r), (x + r, y - r)])
    s = tp.setup_px(tris, 128, 64)
    perm = stream_perm(s["bbox_rows"], s["valid"])
    if case == "padded":
        t_pad, group = 70 * 256, 32 * 256
        # a third of the valid triangles a group, the invalid ones in the last
        parts = np.array_split(np.arange(int(s["valid"].sum())), 3)
        parts[2] = np.arange(parts[2][0], 600)
        at = np.concatenate([np.sort(rng.choice(np.arange(g * group, min(t_pad, g * group + group)),
                                                size=len(part), replace=False))
                             for g, part in enumerate(parts)])
        full = np.empty(t_pad, np.int64)
        full[at] = perm[:600].numpy()
        full[np.setdiff1d(np.arange(t_pad), at)] = np.arange(600, t_pad)
        perm = torch.from_numpy(full)
    return raster_stream(s["tri_data"], s["bbox_rows"], perm)


@pytest.mark.parametrize("case", ["sorted", "padded"])
def test_staging_counts_match_a_direct_count(case):
    """chip_smoke.staging_counts (what the CUDA raster lists per 16x16
    block: hit groups and chunks, the cull's bbox tests with and without
    the group level, touching triangles) against a block-by-block count."""
    import chip_smoke

    stream = _staging_stream(case)
    got = chip_smoke.staging_counts(stream, 64, 128)
    tri_data, tri_bbox, chunk_bbox = stream
    valid = tri_data[15] >= 0
    n_chunks = chunk_bbox.shape[1]
    n_groups = -(-n_chunks // 32)
    group_box = [(chunk_bbox[:2, 32 * g:32 * g + 32].amin(dim=1),
                  chunk_bbox[2:, 32 * g:32 * g + 32].amax(dim=1)) for g in range(n_groups)]
    hits, touches, group_hits, tests = [], [], [], []
    for by in range(0, 64, 16):
        for bx in range(0, 128, 16):
            hits.append(int(((chunk_bbox[0] < bx + 16) & (chunk_bbox[1] < by + 16)
                             & (chunk_bbox[2] > bx) & (chunk_bbox[3] > by)).sum()))
            touches.append(int((valid & (tri_bbox[0] < bx + 16) & (tri_bbox[1] < by + 16)
                                & (tri_bbox[2] > bx) & (tri_bbox[3] > by)).sum()))
            hit = [g for g, (lo, hi) in enumerate(group_box)
                   if lo[0] < bx + 16 and lo[1] < by + 16 and hi[0] > bx and hi[1] > by]
            group_hits.append(len(hit))
            tests.append(n_groups + sum(min(32, n_chunks - 32 * g) for g in hit))
    assert sum(touches) > 0 and max(hits) > 1
    assert got["block_chunk_hits"] == sum(hits)
    assert got["hit_chunks_per_block_max"] == max(hits)
    assert got["block_tri_touches"] == sum(touches)
    assert got["touching_tris_per_block_max"] == max(touches)
    assert got["staged_mb"] == round(sum(touches) * 96 / 1e6, 3)
    assert got["groups"] == n_groups == (1 if case == "sorted" else 3)
    assert got["hit_groups_per_block_mean"] == round(sum(group_hits) / 32, 3)
    assert got["hit_groups_per_block_max"] == max(group_hits)
    assert got["chunk_tests_per_block_flat"] == n_chunks
    assert got["chunk_tests_per_block"] == round(sum(tests) / 32, 3)
    if case == "padded":  # the ragged group and a block missing a group
        assert max(group_hits) == 3 and min(group_hits) < 3
        assert got["chunk_tests_per_block"] < n_chunks


WIN_W, WIN_H = 64, 48


@functools.lru_cache(maxsize=None)
def _winner_stream():
    """A stream of seeded triangles over part of a 64x48 frame, at four
    depths, so samples of a pixel tie in depth, overlap in layers, and
    leave pixels and samples empty."""
    from vktf_tpu_torch.ops.raster import raster_stream, stream_perm

    rng = np.random.default_rng(21)
    tris, z = [], []
    for _ in range(60):
        x, y = 0.25 * rng.integers(0, 4 * 44, size=2)
        r = 0.25 * rng.integers(4, 40)
        tris.append([(x, y), (x + r, y + r), (x + r, y)] if rng.integers(2)
                    else [(x, y), (x, y + r), (x + r, y + r)])
        z.append(rng.integers(1, 5) / 8.0)
    s = tp.setup_px(tris, WIN_W, WIN_H, z)
    return raster_stream(s["tri_data"], s["bbox_rows"], stream_perm(s["bbox_rows"], s["valid"]))


@pytest.mark.parametrize("y_offset, rows", [(0, WIN_H), (16, 32)], ids=["frame", "band"])
@pytest.mark.parametrize("layers", [1, 3, 8])
@pytest.mark.parametrize("msaa", [1, 2, 4, 8])
def test_rasterize_winner_is_pixel_winner_of_the_planes(msaa, layers, y_offset, rows):
    import torch

    import jax.numpy as jnp
    from vktf_tpu.config import RenderConfig
    from vktf_tpu.ops.pipeline import _tiled_winner
    from vktf_tpu_torch.ops.raster import rasterize_plain, rasterize_winner

    stream = _winner_stream()
    tri, frac = rasterize_winner(*stream, rows, WIN_W, msaa, layers, y_offset)
    n = rows * WIN_W
    assert tri.dtype == torch.int32 and frac.dtype == torch.float32
    assert tuple(tri.shape) == ((n,) if layers == 1 else (layers, n))
    assert tuple(frac.shape) == (n,)
    # the plain planes as one JAX raster block: (K, 1, H * S, W), row y * S + s
    planes = [p.reshape(layers, msaa, rows, WIN_W).permute(0, 2, 1, 3)
              .reshape(layers, 1, rows * msaa, WIN_W).numpy()
              for p in rasterize_plain(*stream, rows, WIN_W, msaa, layers, y_offset)]
    cfg = RenderConfig(width=WIN_W, height=rows, tile_shape=(rows, WIN_W), raster_interleave=1)
    want_tri, want_frac = _tiled_winner(*(jnp.asarray(p) for p in planes), cfg)
    np.testing.assert_array_equal(tri.reshape(layers, n).numpy(), np.asarray(want_tri))
    tp.assert_bits_equal(frac.numpy(), np.asarray(want_frac), "frac")
    # the scene reaches every case of the rule
    front = tri if layers == 1 else tri[0]
    assert bool((front == -1).any()) and bool((front >= 0).any())
    assert bool((frac == 0).any()) and bool((frac == 1).any())
    assert bool(((front == -1) == (frac == 0)).all())
    if msaa > 1:
        assert bool(((frac > 0) & (frac < 1)).any())
    if layers > 1:
        assert bool((tri[1] >= 0).any())
    if y_offset:
        full_tri, full_frac = rasterize_winner(*stream, WIN_H, WIN_W, msaa, layers)
        rows_of = slice(y_offset * WIN_W, (y_offset + rows) * WIN_W)
        assert torch.equal(tri, full_tri[..., rows_of])
        assert torch.equal(frac, full_frac[rows_of])
