"""Port parity: the per-triangle setup kernel's plain version and the raster
stream prologue against the JAX setup kernel (interpret mode).

Inputs: the small sponza scene as the production frame program prepares it,
and a seeded set of triangles that covers the setup's special cases —
near-plane crossers, corners behind the eye, degenerate (collinear and
repeated-corner) triangles, back-facing windings, triangles off screen and
triangles too large for screen-space coverage planes.

Every row but the depth plane is compared bit for bit: the plain version
writes out the fused multiply-adds where XLA's CPU build contracts them
(``vktf_tpu_torch/ops/fmath.py``). The depth plane (rows 9..11) is the
exception. Its slopes are sums of three products that cancel: with the far
plane at 1e6, clip z is w less a near-constant, so sum_i cof_i * z_i keeps
only ~1e-5 of its summands' magnitude (measured on sponza: median ratio
8.6e4). One rounding step in a summand then moves a slope by that ratio
times the float32 epsilon, and XLA fuses this sum in a way the port does
not reproduce bit for bit (each plausible contraction was tried). The test
therefore bounds the depth the two planes give anywhere on the triangle's
bbox by 128 roundings of the summand scale:
|d_port - d_jax| <= 128 * 2^-24 * (S_a * bbox_w + S_b * bbox_h + S_c + 1),
S_k = |inv_det| * sum_i |cof_i[k] * z_i| (S_c and the absolute anchor terms
only for near-plane crossers, whose constant comes from the raw plane).
"""

import numpy as np
import jax
import pytest

import torch_parity as tp

tp.limit_threads()

# stream row groups of tri_data (raster_pallas.py:39-57)
EDGE_W_ROWS = list(range(0, 9)) + [12, 13, 14]
ID_ROW, FILL_ROWS, SLIM_ROW = 15, [16, 17, 18], 19


def _jax_setup_kernel(tri_corner, mrowsT, vp):
    from vktf_tpu.ops.setup_kernel import setup_pack_kernel

    visf = np.ones((1, tri_corner.shape[1]), np.float32)
    out = jax.jit(lambda tc, m, v, p: setup_pack_kernel(
        tc, m, v, p, tp.WIDTH, tp.HEIGHT, interpret=True))(
            tri_corner, mrowsT, visf, vp)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_setup(tri_corner, inst_rows, tri_instance, vp):
    from vktf_tpu_torch.ops.setup_kernel import setup_pack
    from vktf_tpu_torch.ops.vertex import clip_corners, setup_from_corners

    corners, vp_t = tp.as_torch(tri_corner), tp.as_torch(np.asarray(vp, np.float32))
    out = {k: v.numpy() for k, v in
           setup_pack(corners, tp.as_torch(inst_rows), tp.as_torch(tri_instance), vp_t,
                      tp.WIDTH, tp.HEIGHT).items()}
    mrowsT = tp.as_torch(tp.gathered_rowsT(inst_rows, tri_instance))
    flat = setup_from_corners(*clip_corners(corners, mrowsT, vp_t), tp.WIDTH, tp.HEIGHT)
    out["inv_det"] = flat["inv_det"].numpy()
    return out


def _clip_z(tri_corner, mrowsT, vp):
    from vktf_tpu_torch.ops.vertex import clip_corners

    _x, _y, z, w = clip_corners(tp.as_torch(tri_corner), tp.as_torch(mrowsT),
                                tp.as_torch(np.asarray(vp, np.float32)))
    return ([zi.numpy().astype(np.float64) for zi in z],
            [wi.numpy() for wi in w])


def _assert_depth_planes_close(got, want, z, w, valid):
    """The depth-plane bound of the module docstring."""
    br = want["bbox_rows"].astype(np.float64)
    bw, bh = br[2] - br[0], br[3] - br[1]
    bound = tp.depth_plane_bound(want["edge9"], want["bbox_rows"], got["inv_det"], z, w)
    g = got["tri_data"][9:12].astype(np.float64)
    e = want["tri_data"][9:12].astype(np.float64)
    worst = np.zeros(valid.shape)
    for fx, fy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        dx, dy = fx * bw, fy * bh
        worst = np.maximum(worst, np.abs((g[0] - e[0]) * dx + (g[1] - e[1]) * dy
                                         + (g[2] - e[2])))
    bad = valid & (worst > bound)
    assert not bad.any(), (
        f"{int(bad.sum())} depth planes outside the bound, worst ratio "
        f"{float((worst / bound)[valid].max())}")


def _assert_setup_equal(got, want, z, w, max_inconsistent):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["bbox_rows"], want["bbox_rows"])
    tp.assert_bits_equal(got["anchor2"], want["anchor2"], "anchor2")
    # the table build reads the cofactor planes of every triangle
    tp.assert_bits_equal(got["edge9"], want["edge9"], "edge9")
    td_g, td_w = got["tri_data"], want["tri_data"]
    valid = want["valid"]
    # row 15 is where(valid, id, -1) by definition, and the port computes
    # validity once. The JAX kernel's fused build recomputes it per output
    # and contracts the screen-area product differently in each: at a
    # triangle whose area or det rounds at the threshold (degenerate ones,
    # mostly) its id row and its valid output can disagree. Such columns
    # are reference noise and are left out of the row comparisons; the
    # bbox rows (sentinel when invalid) keep them off the raster either way.
    ids = np.arange(valid.shape[0], dtype=np.float32)
    np.testing.assert_array_equal(td_g[ID_ROW], np.where(valid, ids, -1.0))
    inconsistent = (td_w[ID_ROW] >= 0) != valid
    assert inconsistent.sum() <= max_inconsistent, int(inconsistent.sum())
    cols = valid & ~inconsistent
    np.testing.assert_array_equal(td_g[FILL_ROWS][:, cols], td_w[FILL_ROWS][:, cols])
    np.testing.assert_array_equal(td_g[SLIM_ROW][cols], td_w[SLIM_ROW][cols])
    np.testing.assert_array_equal(td_g[20:], td_w[20:])
    # invalid triangles' plane rows are never read (id -1 never hits)
    tp.assert_bits_equal(td_g[EDGE_W_ROWS][:, cols], td_w[EDGE_W_ROWS][:, cols],
                         "edge and w-plane rows")
    _assert_depth_planes_close(got, want, z, w, cols)


def test_setup_matches_jax_on_sponza_small():
    setup, _lights, vp = tp.jax_setup("sponza_small")
    scene, _meta = tp.jax_scene("sponza_small")
    tri_corner = np.asarray(scene.tri_corner)
    inst_rows, tri_instance = tp.instances_of(setup["mrows"], scene.tri_instance,
                                              scene.inst_node.shape[0])
    got = _port_setup(tri_corner, inst_rows, tri_instance, vp)
    assert got["valid"].sum() > 1000
    _assert_setup_equal(got, setup, *_clip_z(tri_corner, setup["mrows"].T, vp),
                        max_inconsistent=1)


def test_setup_matches_jax_on_special_cases():
    _check_special_cases(*tp.seeded_triangles())


def test_setup_matches_jax_on_seven_rigid_instances():
    """The special cases under 7 random rigid instances, a random one per
    triangle: the port indexes the (I, 16) rows by the int32 index, the
    JAX kernel reads their gather as its mrowsT."""
    tri_corner, _rows, _idx = tp.seeded_triangles()
    _check_special_cases(tri_corner, *tp.seeded_instances(tri_corner.shape[1]))


def _check_special_cases(tri_corner, inst_rows, tri_instance):
    mrowsT = tp.gathered_rowsT(inst_rows, tri_instance)
    _jcam, tcam = tp.cameras()
    vp = tcam.view_projection_transform
    want = _jax_setup_kernel(tri_corner, mrowsT, vp)
    got = _port_setup(tri_corner, inst_rows, tri_instance, vp)
    # the categories really reach the setup's branches
    td = want["tri_data"]
    assert 0 < want["valid"].sum() < want["valid"].size
    assert (td[SLIM_ROW] == 0).any() and (td[SLIM_ROW] == 1).any()
    assert (td[FILL_ROWS] == -1).any() and (td[FILL_ROWS] == 0).any()
    _assert_setup_equal(got, want, *_clip_z(tri_corner, mrowsT, vp),
                        max_inconsistent=len(want["valid"]) // 50)


def test_stream_perm_matches_jax():
    from vktf_tpu.ops.raster_pallas import stream_perm as j_stream_perm
    from vktf_tpu_torch.ops.raster import stream_perm

    setup, _lights, _vp = tp.jax_setup("sponza_small")
    want = np.asarray(jax.jit(j_stream_perm)(
        {"valid": setup["valid"], "bbox_rows": setup["bbox_rows"]}))
    got = stream_perm(tp.as_torch(setup["bbox_rows"]),
                      tp.as_torch(setup["valid"]), chunk=256).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("msaa", [1, 4])
def test_raster_prologue_matches_jax(msaa, monkeypatch):
    """Stream-ordered rows, per-group slim flag and group bboxes against
    rasterize_pallas's own prologue (its kernel-input probe)."""
    from vktf_tpu.ops import raster_pallas
    from vktf_tpu_torch.ops.raster import raster_stream, stream_perm

    setup, _lights, _vp = tp.jax_setup("sponza_small")
    cfg = tp.jax_config(msaa)
    perm = stream_perm(tp.as_torch(setup["bbox_rows"]),
                       tp.as_torch(setup["valid"]), chunk=256)
    monkeypatch.setattr(raster_pallas, "_RETURN_KERNEL_INPUTS", True)
    jsetup = {k: setup[k] for k in ("tri_data", "bbox_rows", "valid")}
    (_counts, _lists), (want_td, want_bbox) = jax.jit(
        lambda s, p: raster_pallas.rasterize_pallas(
            s, cfg.padded_height, cfg.padded_width, tile_shape=cfg.tile_shape,
            msaa_samples=msaa, chunk=256, interpret=True, sort="none",
            perm=p, group_size=8, interleave=cfg.resolved_interleave(),
            assemble=False))(jsetup, perm.numpy().astype(np.int32))
    td, tri_bbox, chunk_bbox = raster_stream(
        tp.as_torch(setup["tri_data"]), tp.as_torch(setup["bbox_rows"]),
        perm, chunk=256, group_size=8)
    tp.assert_bits_equal(td.numpy(), np.asarray(want_td), "stream tri_data")
    np.testing.assert_array_equal(tri_bbox.numpy(), np.asarray(want_bbox))
    b = tri_bbox.numpy()[:4].reshape(4, -1, 256)
    np.testing.assert_array_equal(
        chunk_bbox.numpy(),
        np.concatenate([b[:2].min(axis=2), b[2:].max(axis=2)]))
