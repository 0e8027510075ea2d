"""The port's multi-device frame path against the JAX package's.

Both render the JAX package's flattened small courtyard at 128x64, 2x MSAA,
from the parity tests' camera on a (2, 2) mesh: the JAX package on four
virtual CPU devices (tests/conftest.py) with Pallas in interpret mode, the
port on four gloo ranks (``parallel.launch.run``, one spawn for the
module).

  * merged visibility: the port's merged (ids, depth) of every band
    against ``render_frame_sharded(debug_visibility=True)``: ids exact but
    at listed samples where JAX's is the wrong one by float64 depth; the
    depth of a triangle that keeps the homogeneous plane within
    tests/test_torch_setup.py's depth-plane bound of JAX's, of the others
    within the float64 bound of float64 (the port's screen-space depth
    plane), and every depth no farther from float64 than JAX's beyond it;
  * frames: the port's sharded frame against ``make_sharded_frame_fn``'s,
    within ``torch_parity.assert_frames_close``;
  * sample rate: the mixed-sampler courtyard at ``shading_rate="sample"``
    on the same mesh, the port's frame against ``make_sharded_frame_fn``'s,
    whose assembled branch honours the rate for mixed samplers, within the
    same budget;
  * the reference's fault: on its fused ``tiled_shade`` branch the JAX
    sharded frame at ``shading_rate="sample"`` equals the JAX single-chip
    frame at pixel rate bit for bit (that shade never reads the rate), and
    differs from the sample-rate frame (the port's, which
    tests/test_torch_sample.py holds to the JAX single-chip sample-rate
    frame, and which the port's mesh renders too: test_torch_parallel.py).
"""

from functools import partial

import numpy as np
import jax
import pytest
import torch

import torch_parity as tp
from vktf_tpu_torch.config import SAMPLE_OFFSETS

tp.limit_threads()

COURT = "sponza_small"
MIXED = COURT + "_mixed"
WIDTH, HEIGHT, MSAA = 128, 64, 2


def _jax_scene_leaves(name=COURT):
    """The JAX scene's leaves and the port's SceneMeta of it."""
    _scene, jmeta = tp.jax_scene(name)
    return tp.jax_leaves(name), tp.port_meta(jmeta)


def _port_scene(leaves, meta, mesh=None, **kw):
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=MSAA, **kw)
    return Scene.from_render_scene(scene_from_numpy(leaves, "cpu"), meta, config,
                                   camera=tp.port_camera(WIDTH, HEIGHT), mesh=mesh)


def _port_ranks(leaves, meta, mixed_leaves, mixed_meta):
    """On every rank: the (2, 2) frame, on rank 0 every band's merged
    (ids, depth) in band order (each rank records what its merge unpacks),
    and the mixed-sampler courtyard's (2, 2) frame at sample rate."""
    import torch.distributed as dist

    from vktf_tpu_torch.parallel import make_render_mesh, tiles

    tp.limit_threads()
    mesh = make_render_mesh(2, 2)
    merged = []
    unpack = tiles.unpack_keys

    def recording(keys):
        ids, depth = unpack(keys)
        merged.append((ids.numpy().copy(), depth.numpy().copy()))
        return ids, depth

    tiles.unpack_keys = recording
    try:
        frame = _port_scene(leaves, meta, mesh).render_async().numpy()
    finally:
        tiles.unpack_keys = unpack
    bands = [None] * dist.get_world_size()
    dist.all_gather_object(bands, merged[0])
    # rank (0, s) = rank s holds band s; every gp rank of a band merged it alike
    assert all(np.array_equal(bands[s][0], bands[g * 2 + s][0]) for g in range(2)
               for s in range(2))
    ids = np.concatenate([bands[s][0] for s in range(2)], axis=-2)
    depth = np.concatenate([bands[s][1] for s in range(2)], axis=-2)
    mixed = _port_scene(mixed_leaves, mixed_meta, mesh, shading_rate="sample").render_async()
    return frame, ids, depth, mixed.numpy()


@pytest.fixture(scope="module")
def port():
    from vktf_tpu_torch.parallel import launch

    return launch.run(_port_ranks, 4, *_jax_scene_leaves(), *_jax_scene_leaves(MIXED),
                      device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def jax_mesh():
    from vktf_tpu.parallel import make_render_mesh

    return make_render_mesh(jax.devices()[:4], gp=2, sp=2)


def _jax_inputs(name=COURT, **kw):
    scene, meta = tp.jax_scene(name)
    jcam, _ = tp.cameras(WIDTH, HEIGHT)
    return scene, meta, tp.jax_config(MSAA, width=WIDTH, height=HEIGHT, **kw), jcam


def _depth_bounds():
    """Per triangle of the port's whole-scene setup: (its depth-plane
    bound against JAX's, the port's float64 bound, whether it keeps the
    homogeneous plane, the (T, 3) float64 depth planes)."""
    from vktf_tpu_torch.ops import pipeline, setup_kernel
    from vktf_tpu_torch.ops.vertex import clip_corners, setup_from_corners

    scene = _port_scene(*_jax_scene_leaves())
    rs = scene.render_scene
    vp = torch.as_tensor(np.asarray(scene.camera.view_projection_transform, np.float32))
    inst_rows, tri_instance, _lights = pipeline.scene_update(rs, scene.meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, WIDTH, HEIGHT)
    corners = clip_corners(rs.tri_corner, setup_kernel.instance_rowsT(inst_rows, tri_instance),
                           vp)
    flat = setup_from_corners(*corners, WIDTH, HEIGHT)
    x, y, z, w = ([c.numpy().astype(np.float64) for c in row] for row in corners)
    co, cond = tp.float64_depth_planes(x, y, z, w, WIDTH, HEIGHT)
    homogeneous = ~flat["use_screen"].numpy()
    args = (setup["edge9"].numpy(), setup["bbox_rows"].numpy(), flat["inv_det"].numpy(), z, w)
    return (tp.depth_plane_bound(*args), tp.float64_depth_bound(co, cond, homogeneous, *args),
            homogeneous, co)


# Samples' pixels where the JAX package's nearest fragment is the wrong
# one by float64 depth (its depth planes' cancellation noise,
# tests/test_torch_setup.py), and the frames' pixels where the winners
# differ by more than one u8 step; checked by tp.checked_jax_wrong.
JAX_WRONG_SAMPLES = [(13, 63)]
JAX_WRONG = [(14, 38), (23, 97), (50, 30), (54, 56)]
JAX_WRONG_SAMPLE_RATE = [(13, 63)]


def test_merged_visibility_matches_jax_debug_visibility(port, jax_mesh):
    from vktf_tpu.parallel import render_frame_sharded

    scene, meta, cfg, jcam = _jax_inputs()
    vis = jax.jit(partial(render_frame_sharded, meta=meta, config=cfg, mesh=jax_mesh,
                          debug_visibility=True))(
        scene, jcam.view_projection_transform, jcam.position)
    want_ids, want_depth = np.asarray(vis[0]), np.asarray(vis[1])
    _frame, ids, depth, _mixed = port
    assert ids.shape == want_ids.shape == (MSAA, 128, 128)
    listed = np.zeros(ids.shape[1:], bool)
    for y, x in tp.checked_jax_wrong(JAX_WRONG_SAMPLES, WIDTH, HEIGHT, MSAA, 1, "sample"):
        listed[y, x] = True
    np.testing.assert_array_equal(ids[:, ~listed], want_ids[:, ~listed])
    assert 0.3 < (ids >= 0).mean() < 1.0
    covered = (ids >= 0) & (ids == want_ids)
    jax_bound, f64_bound, homogeneous, co = _depth_bounds()
    tri = ids[covered]
    err = np.abs(depth[covered].astype(np.float64) - want_depth[covered])
    # the homogeneous planes: within the bound of JAX's; the screen-space
    # ones: within the float64 bound of float64, and no farther than JAX's
    keep = homogeneous[tri]
    assert (err[keep] <= jax_bound[tri][keep]).all()
    s, py, px = np.nonzero(covered)
    sx = px + np.asarray([ox for ox, _ in SAMPLE_OFFSETS[MSAA]])[s]
    sy = py + np.asarray([oy for _, oy in SAMPLE_OFFSETS[MSAA]])[s]
    exact = co[tri, 0] * sx + co[tri, 1] * sy + co[tri, 2]
    f64_err = np.abs(depth[covered].astype(np.float64) - exact)
    jax_err = np.abs(want_depth[covered].astype(np.float64) - exact)
    assert (f64_err[~keep] <= f64_bound[tri][~keep]).all()
    assert (f64_err <= jax_err + f64_bound[tri]).all()
    # the background: depth 1.0 exactly on both
    np.testing.assert_array_equal(depth[ids < 0], 1.0)
    np.testing.assert_array_equal(want_depth[want_ids < 0], 1.0)


def test_sharded_frame_matches_jax_sharded_frame(port, jax_mesh):
    from vktf_tpu.parallel import make_sharded_frame_fn

    scene, meta, cfg, jcam = _jax_inputs()
    want = np.asarray(make_sharded_frame_fn(meta, cfg, jax_mesh)(
        scene, jcam.view_projection_transform, jcam.position))
    frame, _ids, _depth, _mixed = port
    tp.assert_frames_close(frame, want, (3, HEIGHT, WIDTH),
                           tp.checked_jax_wrong(JAX_WRONG, WIDTH, HEIGHT, MSAA))
    assert (frame.max(axis=0) > 0).mean() > 0.5


def test_sample_rate_mixed_frame_matches_jax_sharded_frame(port, jax_mesh):
    """Mixed samplers take the JAX sharded path's assembled branch, which
    shades at the sample rate: the port's mesh frame within the budget of
    the JAX sharded frame, and not the pixel-rate frame."""
    from vktf_tpu.parallel import make_sharded_frame_fn

    scene, meta, cfg, jcam = _jax_inputs(MIXED, shading_rate="sample")
    assert meta.mixed_samplers
    cam = (jcam.view_projection_transform, jcam.position)
    want = np.asarray(make_sharded_frame_fn(meta, cfg, jax_mesh)(scene, *cam))
    *_, mixed = port
    tp.assert_frames_close(mixed, want, (3, HEIGHT, WIDTH), tp.checked_jax_wrong(
        JAX_WRONG_SAMPLE_RATE, WIDTH, HEIGHT, MSAA, 1, "sample"))
    assert (mixed.max(axis=0) > 0).mean() > 0.5
    pixel = _port_scene(*_jax_scene_leaves(MIXED)).render_still()
    assert (pixel != mixed).any(axis=0).mean() > 0.01


def test_jax_sharded_frame_ignores_the_sample_rate(jax_mesh):
    """The reference's fault the port does not copy: on its fused
    ``tiled_shade`` branch, JAX's sharded frame at sample rate is its
    single-chip PIXEL-rate frame. The port's mesh renders the true
    sample-rate frame there (its single-device sample-rate frame, bit for
    bit: test_torch_parallel.py)."""
    from vktf_tpu.ops.pipeline import make_frame_fn
    from vktf_tpu.parallel import make_sharded_frame_fn

    scene, meta, cfg, jcam = _jax_inputs()
    cam = (jcam.view_projection_transform, jcam.position)
    sample_cfg = cfg.replace(shading_rate="sample")
    sharded_sample = np.asarray(make_sharded_frame_fn(meta, sample_cfg, jax_mesh)(scene, *cam))
    single_pixel = np.asarray(make_frame_fn(meta, cfg)(scene, *cam))
    np.testing.assert_array_equal(sharded_sample, single_pixel)
    port_sample = _port_scene(*_jax_scene_leaves(), shading_rate="sample").render_still()
    assert (port_sample != sharded_sample).any(axis=0).mean() > 0.05
