"""Port parity: procedural scenes, flattening, camera and scene update.

The port's numpy scene builder must give the JAX package's scene leaf for
leaf, exactly — geometry, materials, lights and the fused-mip texel pool.
The JAX presets store textures as zstd-supercompressed KTX2 and decode them
at flatten time; the port keeps the decoded mip chains (the card's machine
has no zstd codec), so the pool comparison also pins that the two texel
paths agree. Mip chains follow the JAX package's numpy definition
(``loaders/images.generate_mips``); its optional native build differs from
that definition by one u8 step on a few texels, which
test_quad_pool_native_mips_within_one_step bounds.
"""

import numpy as np
import jax
import pytest
import torch

import torch_parity as tp

tp.limit_threads()


@pytest.mark.parametrize("name", ["box", "sponza_small", "duck", "helmet", "flythrough"])
def test_flatten_leaves_match_jax(name):
    leaves, _meta = tp.torch_leaves(name)
    expected = tp.jax_leaves(name)
    assert set(leaves) == set(expected)
    for field, want in expected.items():
        got = leaves[field]
        assert got.shape == want.shape, (field, got.shape, want.shape)
        assert got.dtype == want.dtype, (field, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=field)


@pytest.mark.parametrize("name", ["box", "sponza_small", "duck", "helmet", "flythrough"])
def test_scene_meta_matches_jax(name):
    _leaves, meta = tp.torch_leaves(name)
    _scene, want = tp.jax_scene(name)
    for field in ("level_slices", "num_lights", "num_instances",
                  "num_triangles", "num_vertices", "peel_layers",
                  "mixed_samplers", "mirror_wrap"):
        assert getattr(meta, field) == getattr(want, field), field


def test_quad_pool_native_mips_within_one_step():
    """Against the JAX scene as built with its native mip generator (when
    the native library builds here): every texel byte within one step, and
    at most 1e-4 of the pool's u32 texels touched."""
    leaves, _meta = tp.torch_leaves("sponza_small")
    want = tp.jax_leaves("sponza_small", native=True)["quad_pool"]
    got = leaves["quad_pool"]
    assert got.shape == want.shape
    g = got.view(np.uint32)
    w = want.view(np.uint32)
    step = np.zeros(g.shape, np.int64)
    for shift in (0, 8, 16, 24):
        d = np.abs(((g >> shift) & 0xFF).astype(np.int64)
                   - ((w >> shift) & 0xFF).astype(np.int64))
        step = np.maximum(step, d)
    assert step.max() <= 1
    assert (step > 0).mean() <= 1e-4


def test_sponza_small_takes_the_production_branches():
    _leaves, meta = tp.torch_leaves("sponza_small")
    assert meta.num_triangles > 32768  # two-phase shade without skipping
    assert meta.peel_layers == 1
    assert not meta.mixed_samplers and not meta.mirror_wrap
    assert meta.num_lights == 5


def test_texels_match_ktx2_roundtrip():
    """Every texture's decoded mip chain equals the JAX preset's KTX2
    payload decoded by the JAX loader (the round trip is lossless; the
    chains inside were generated by the numpy definition)."""
    from vktf_tpu.loaders.images import decode_texture

    jax_mats = tp.jax_assets("sponza_small")[0].materials
    torch_mats = tp.torch_assets("sponza_small")[0].materials
    assert len(jax_mats) == len(torch_mats) > 0
    for jm, tm in zip(jax_mats, torch_mats):
        pairs = [
            (jm.pbr_metallic_roughness.base_color_texture,
             tm.pbr_metallic_roughness.base_color_texture, "base_color"),
            (jm.pbr_metallic_roughness.metallic_roughness_texture,
             tm.pbr_metallic_roughness.metallic_roughness_texture,
             "metallic_roughness"),
            (jm.normal_texture, tm.normal_texture, "normal"),
        ]
        for jt, tt, kind in pairs:
            want = decode_texture(jt, kind)
            assert tt.decoded.srgb == want.srgb
            assert len(tt.decoded.levels) == len(want.levels)
            for got_level, want_level in zip(tt.decoded.levels, want.levels):
                np.testing.assert_array_equal(got_level, want_level)


@pytest.mark.parametrize("moves", [0, 1])
def test_view_projection_bit_equal(moves):
    jcam, tcam = tp.cameras()
    if moves:
        for cam in (jcam, tcam):
            cam.translate((0.3, -0.1, 0.7))
            cam.rotate(0.05, -0.2)
    tp.assert_bits_equal(tcam.view_projection_transform,
                         jcam.view_projection_transform, "view_projection")
    tp.assert_bits_equal(tcam.position, jcam.position, "position")


def test_scene_update_matches_jax():
    """Node transform propagation, world lights and the per-triangle
    instance-matrix rows against the JAX functions."""
    from vktf_tpu.ops.pipeline import gather_world_lights as j_lights
    from vktf_tpu.ops.vertex import propagate_transforms as j_propagate
    from vktf_tpu_torch.ops.pipeline import scene_update
    from vktf_tpu_torch.ops.vertex import propagate_transforms
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    scene, meta = tp.jax_scene("sponza_small")

    @jax.jit
    def reference(s):
        node_global = j_propagate(s.node_local, s.node_parent,
                                  meta.level_slices)
        lights = j_lights(node_global, s.light_node, s.light_type,
                          s.light_color)
        mrows = node_global[s.inst_node].reshape(-1, 16)[s.tri_instance]
        return node_global, lights, mrows

    want_global, want_lights, want_mrows = (np.asarray(a) for a in reference(scene))
    rs = scene_from_numpy(tp.jax_leaves("sponza_small"), "cpu")
    got_global = propagate_transforms(rs.node_local, rs.node_parent,
                                      meta.level_slices)
    tp.assert_bits_equal(got_global.numpy(), want_global, "node_global")
    inst_rows, tri_instance, lights = scene_update(rs, meta)
    assert inst_rows.shape == (meta.num_instances, 16) and tri_instance.dtype == torch.int32
    tp.assert_bits_equal(inst_rows[tri_instance.long()].numpy(), want_mrows, "mrows")
    np.testing.assert_allclose(lights.numpy(), want_lights, rtol=0, atol=1e-7)


@pytest.mark.parametrize("leaf", ["node_local", "light_color"])
def test_in_place_edit_rerenders(leaf):
    """An in-place edit of a scene tensor reaches the next frame: the frame
    equals a fresh Scene's over the same tensors on every pixel, and
    differs from the frame before the edit."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.scene.scene import Scene

    camera = Camera((-2.5, 0.8, 0.0), (1.0, -0.3, 0.0), ViewFrustumParams(0.8, 2.0, 0.1, 100.0))
    config = RenderConfig(width=64, height=32, msaa_samples=4)
    scene = Scene(build_preset("box"), config, camera=camera, device="cpu")
    before = scene.render_still()
    rs = scene.render_scene
    if leaf == "node_local":
        rs.node_local[:, 1, 3] += 0.7  # every node 0.7 up
    else:
        rs.light_color.mul_(0.5)
    after = scene.render_still()
    fresh = Scene.from_render_scene(rs, scene.meta, config, camera).render_still()
    np.testing.assert_array_equal(after, fresh)
    assert (after != before).any(axis=0).sum() > 100


def test_scene_from_numpy_dtypes():
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    leaves = tp.jax_leaves("box")
    rs = scene_from_numpy(leaves, torch.device("cpu"))
    assert rs.tri_corner.dtype == torch.float32
    assert rs.tri_instance.dtype == torch.int64
    pool = leaves["quad_pool"]
    assert rs.quad_pool.shape == (pool.shape[0], pool.shape[1] // 2)
    assert rs.quad_pool.dtype == torch.int32
    # lane k of the u32 view is u16 halves 2k (low) and 2k+1 (high)
    lanes = rs.quad_pool.numpy().view(np.uint32)
    np.testing.assert_array_equal(lanes & 0xFFFF, pool[:, 0::2])
    np.testing.assert_array_equal(lanes >> 16, pool[:, 1::2])


def test_frustum_matches_jax():
    """Frustum planes and the batched AABB test (host numpy in both)."""
    from vktf_tpu.mathx.frustum import (
        aabbs_intersect_frustum as j_intersect,
        frustum_planes as j_planes,
    )
    from vktf_tpu_torch.mathx import aabbs_intersect_frustum, frustum_planes

    jcam, tcam = tp.cameras()
    planes = frustum_planes(tcam.view_projection_transform)
    want = j_planes(jcam.view_projection_transform)
    np.testing.assert_array_equal(planes, want)
    rng = np.random.default_rng(5)
    lo = rng.uniform(-30, 30, (512, 3)).astype(np.float32)
    aabbs = np.stack([lo, lo + rng.uniform(0, 4, (512, 3)).astype(np.float32)], axis=1)
    got = aabbs_intersect_frustum(aabbs, planes)
    np.testing.assert_array_equal(got, j_intersect(aabbs, want))
    assert 0 < got.sum() < got.size
