"""The port's multi-device frame path against the JAX package's.

Both render the JAX package's flattened small courtyard at 128x64, 2x MSAA,
from the parity tests' camera on a (2, 2) mesh: the JAX package on four
virtual CPU devices (tests/conftest.py) with Pallas in interpret mode, the
port on four gloo ranks (``parallel.launch.run``, one spawn for the
module).

  * merged visibility: the port's merged (ids, depth) of every band
    against ``render_frame_sharded(debug_visibility=True)``: ids exact,
    depth within tests/test_torch_setup.py's depth-plane bound of the
    sample's triangle (the two setups' depth planes may differ by it);
  * frames: the port's sharded frame against ``make_sharded_frame_fn``'s,
    within ``torch_parity.assert_frames_close``;
  * the reference's fault: the JAX sharded frame at
    ``shading_rate="sample"`` equals the JAX single-chip frame at pixel
    rate bit for bit (its sharded shade never reads the rate), and differs
    from the sample-rate frame (the port's, which tests/test_torch_sample.py
    holds to the JAX single-chip sample-rate frame). The port refuses a mesh
    at sample rate (test_torch_parallel.py).
"""

from functools import partial

import numpy as np
import jax
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

COURT = "sponza_small"
WIDTH, HEIGHT, MSAA = 128, 64, 2


def _jax_scene_leaves():
    """The JAX scene's leaves and the port's SceneMeta of it."""
    _scene, jmeta = tp.jax_scene(COURT)
    return tp.jax_leaves(COURT), tp.port_meta(jmeta)


def _port_scene(leaves, meta, mesh=None, **kw):
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=MSAA, **kw)
    return Scene.from_render_scene(scene_from_numpy(leaves, "cpu"), meta, config,
                                   camera=tp.port_camera(WIDTH, HEIGHT), mesh=mesh)


def _port_ranks(leaves, meta):
    """On every rank: the (2, 2) frame, and on rank 0 every band's merged
    (ids, depth) in band order (each rank records what its merge unpacks)."""
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
    return frame, ids, depth


@pytest.fixture(scope="module")
def port():
    from vktf_tpu_torch.parallel import launch

    return launch.run(_port_ranks, 4, *_jax_scene_leaves())


@pytest.fixture(scope="module")
def jax_mesh():
    from vktf_tpu.parallel import make_render_mesh

    return make_render_mesh(jax.devices()[:4], gp=2, sp=2)


def _jax_inputs(**kw):
    scene, meta = tp.jax_scene(COURT)
    jcam, _ = tp.cameras(WIDTH, HEIGHT)
    return scene, meta, tp.jax_config(MSAA, width=WIDTH, height=HEIGHT, **kw), jcam


def _depth_bounds():
    """Per triangle, the depth-plane bound of the port's whole-scene setup."""
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
    z = [zi.numpy().astype(np.float64) for zi in corners[2]]
    w = [wi.numpy() for wi in corners[3]]
    return tp.depth_plane_bound(setup["edge9"].numpy(), setup["bbox_rows"].numpy(),
                                flat["inv_det"].numpy(), z, w)


def test_merged_visibility_matches_jax_debug_visibility(port, jax_mesh):
    from vktf_tpu.parallel import render_frame_sharded

    scene, meta, cfg, jcam = _jax_inputs()
    vis = jax.jit(partial(render_frame_sharded, meta=meta, config=cfg, mesh=jax_mesh,
                          debug_visibility=True))(
        scene, jcam.view_projection_transform, jcam.position)
    want_ids, want_depth = np.asarray(vis[0]), np.asarray(vis[1])
    _frame, ids, depth = port
    assert ids.shape == want_ids.shape == (MSAA, 128, 128)
    np.testing.assert_array_equal(ids, want_ids)
    covered = ids >= 0
    assert 0.3 < covered.mean() < 1.0
    bound = _depth_bounds()[ids[covered]]
    err = np.abs(depth[covered].astype(np.float64) - want_depth[covered])
    assert (err <= bound).all(), float((err / bound).max())
    # the background: depth 1.0 exactly on both
    np.testing.assert_array_equal(depth[~covered], 1.0)
    np.testing.assert_array_equal(want_depth[~covered], 1.0)


def test_sharded_frame_matches_jax_sharded_frame(port, jax_mesh):
    from vktf_tpu.parallel import make_sharded_frame_fn

    scene, meta, cfg, jcam = _jax_inputs()
    want = np.asarray(make_sharded_frame_fn(meta, cfg, jax_mesh)(
        scene, jcam.view_projection_transform, jcam.position))
    frame, _ids, _depth = port
    tp.assert_frames_close(frame, want, (3, HEIGHT, WIDTH))
    assert (frame.max(axis=0) > 0).mean() > 0.5


def test_jax_sharded_frame_ignores_the_sample_rate(jax_mesh):
    """The reference's fault the port does not copy: JAX's sharded frame at
    sample rate is its single-chip PIXEL-rate frame."""
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
