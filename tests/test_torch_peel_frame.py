"""Port parity of whole translucent frames (the depth-peel path of
``FrameProgram``), and the configuration and device rules around it.

Frames against the JAX production program (``PallasFrameProgram``,
interpret mode) and against the golden production frame. Tolerance, as
tests/test_torch_frame.py: max difference one u8 step, on at most 0.5% of
the pixels (transcendental ULPs of the shade, test_torch_peel.py, and of
the sRGB encode pass through the composite).

* The translucent courtyard (curtains and clutter BLEND at alpha 0.5),
  K = 3 forced on both sides, 256x128, 4x MSAA: the JAX package's scene
  carried over, and the port's own builder.
* The golden frame: tests/test_golden_production.py's scene (one BLEND
  quad, K = 2), built by the JAX loader, carried over, rendered at that
  test's 256x128 / 4x MSAA / 32x64 tiles, against
  tests/golden/production_frame.png. The port streams 256-triangle chunks
  where the golden used 128; chunking cannot change the output.
* The clamp: tests/test_alpha.py's 9-deep BLEND stack, built with both
  packages' asset builders: K = 8 with a logged warning, frame against the
  JAX frame at 96x64, 1x MSAA.
* An opaque scene at a forced K = 2 renders the K = 1 frame exactly: an
  opaque layer 0 has alpha 1, so the composite returns it unchanged.
"""

import functools
import io
import pathlib

import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

PEEL_K = 3
GOLDEN = pathlib.Path(__file__).parent / "golden" / "production_frame.png"


# Pixels of the translucent courtyard's 256x128 4x frame at K = 3 where
# the JAX package's winner of a layer is the wrong one by float64 depth
# (its depth planes' cancellation noise, tests/test_torch_setup.py), and
# the two winners shade more than one u8 step apart; checked by
# tp.checked_jax_wrong.
JAX_WRONG = [
    (14, 58), (16, 77), (32, 76), (32, 130), (33, 130), (36, 130), (39, 179), (45, 171),
    (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130), (68, 125),
    (85, 78), (85, 177), (87, 139), (88, 174), (98, 218),
]


def _assert_frames_close(got, want, jax_wrong=()):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want).max(axis=0)
    for y, x in jax_wrong:
        diff[y, x] = 0
    assert diff.max() <= 1, (int(diff.max()), np.argwhere(diff > 1)[:40].tolist())
    assert (diff > 0).mean() <= 5e-3, float((diff > 0).mean())


def _assert_blend_frames_close(got, want):
    _assert_frames_close(got, want, tp.checked_jax_wrong(JAX_WRONG, tp.WIDTH, tp.HEIGHT, 4,
                                                          PEEL_K))


def _port_config(**kw):
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(**{"width": tp.WIDTH, "height": tp.HEIGHT,
                           "msaa_samples": 4, **kw})


@functools.lru_cache(maxsize=None)
def _jax_blend_frame():
    scene, _meta = tp.jax_scene("sponza_small_blend")
    jcam, _ = tp.cameras()
    prog = tp.jax_program("sponza_small_blend", 4, PEEL_K)
    return np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))


def test_translucent_frame_matches_jax_on_the_jax_scene():
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = tp.jax_scene("sponza_small_blend")
    _jcam, tcam = tp.cameras()
    scene = Scene.from_render_scene(
        scene_from_numpy(tp.jax_leaves("sponza_small_blend"), "cpu"),
        tp.port_meta(jmeta), _port_config(peel_layers=PEEL_K), camera=tcam)
    assert scene.frame_program.layers == PEEL_K
    want = _jax_blend_frame()
    opaque = Scene(tp.torch_assets("sponza_small"), _port_config(), camera=tcam,
                   device="cpu").render_still()
    # the blend shows: a visible share of pixels differs from the opaque frame
    assert (np.abs(want.astype(np.int16) - opaque).max(axis=0) > 8).mean() > 0.05
    _assert_blend_frames_close(scene.render_still(), want)


def test_translucent_scene_from_preset_matches_jax():
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    scene = Scene(tp.torch_assets("sponza_small_blend"),
                  _port_config(peel_layers=PEEL_K), camera=tcam, device="cpu")
    assert scene.meta.peel_layers == 8
    _assert_blend_frames_close(scene.render_still(), _jax_blend_frame())


def test_golden_production_frame(tmp_path):
    from PIL import Image

    from helpers import build_scene, default_camera
    from test_golden_production import _scene_path
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES, scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    with tp._jax_native_mips(False):
        jscene, jmeta, _aux = build_scene(_scene_path(tmp_path))
    assert (jmeta.peel_layers, jmeta.num_triangles) == (2, 976)
    assert not (jmeta.mixed_samplers or jmeta.mirror_wrap)
    jcam = default_camera(aspect=2.0, position=(0.0, 0.7, 2.4),
                          direction=(0.0, -0.25, -1.0))
    camera = Camera(np.asarray(jcam.position), (0.0, -0.25, -1.0),
                    ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 100.0))
    np.testing.assert_array_equal(camera.view_projection_transform,
                                  np.asarray(jcam.view_projection_transform))
    leaves = {f: np.asarray(getattr(jscene, f)) for f in SCENE_LEAVES}
    scene = Scene.from_render_scene(
        scene_from_numpy(leaves, "cpu"), tp.port_meta(jmeta),
        _port_config(tile_shape=(32, 64)), camera=camera)
    assert scene.frame_program.layers == 2
    got = scene.render_still()
    want = np.moveaxis(np.asarray(Image.open(GOLDEN).convert("RGB")), -1, 0)
    _assert_frames_close(got, want)


def _jax_stack_asset(tmp_path):
    from test_alpha import _stacked_blend_scene
    from vktf_tpu.loaders.gltf import load_gltf

    return load_gltf(_stacked_blend_scene(tmp_path, "stack9.gltf", n_quads=9,
                                          dz=0.05))


def _port_stack_asset(n_quads=9, dz=0.05):
    """tests/test_alpha.py _stacked_blend_scene with the port's builder."""
    from vktf_tpu_torch.loaders.gltf import (
        Asset, Light, Material, Mesh, Node, PbrMetallicRoughness, Primitive, Scene)
    from vktf_tpu_torch.mathx.quaternion import quat_to_matrix
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    colors = ((0.9, 0.2, 0.2, 0.45), (0.2, 0.3, 0.9, 0.5),
              (0.9, 0.8, 0.2, 0.4), (0.2, 0.9, 0.6, 0.5),
              (0.7, 0.2, 0.9, 0.45), (0.9, 0.5, 0.2, 0.5),
              (0.3, 0.8, 0.9, 0.4), (0.8, 0.3, 0.5, 0.5),
              (0.4, 0.6, 0.3, 0.45))

    def material(rgba, blend):
        return Material(pbr_metallic_roughness=PbrMetallicRoughness(
            base_color_factor=np.asarray(rgba, np.float32), metallic_factor=0.0,
            roughness_factor=0.5 if blend else 0.8),
            alpha_mode="BLEND" if blend else "OPAQUE")

    def node(translation=None, rotation=None, **kw):  # glTF TRS, (x, y, z, w)
        m = np.eye(4, dtype=np.float32)
        if rotation is not None:
            x, y, z, w = rotation
            m[:3, :3] = quat_to_matrix(np.asarray([w, x, y, z], np.float32))
        if translation is not None:
            m[:3, 3] = translation
        return Node(local_transform=m, **kw)

    def mesh(geom, mat):
        pos = geom["positions"]
        return Mesh(primitives=[Primitive(
            positions=pos, indices=geom["indices"].astype(np.uint32),
            normals=geom.get("normals"), tangents=geom.get("tangents"),
            uvs=geom.get("uvs"), material=mat,
            aabb=np.stack([pos.min(axis=0), pos.max(axis=0)]))])

    back = material((0.15, 0.6, 0.2, 1.0), False)
    quads = [material(c, True) for c in colors[:n_quads]]
    meshes = [mesh(box_mesh(0.6), back)] + [mesh(plane_mesh(0.9), m) for m in quads]
    nodes = [node((0.0, 0.3, -0.6), mesh=0),
             node((1.2, 1.5, 2.0), light=0),
             node(rotation=(0.2, 0.1, 0.0, 0.97), light=1)]
    for i in range(n_quads):
        nodes.append(node((0.1 - 0.05 * i, 0.35, 0.45 - dz * i),
                          (0.7071068, 0.0, 0.0, 0.7071068), mesh=1 + i))
    lights = [Light(color=np.asarray((6.0, 6.0, 6.0), np.float32), type="point"),
              Light(color=np.asarray((0.6, 0.6, 0.6), np.float32), type="directional")]
    return Asset(name="stack9", materials=[back] + quads, meshes=meshes, lights=lights,
                 nodes=nodes, scenes=[Scene(root_nodes=list(range(len(nodes))))],
                 default_scene=0)


def test_nine_deep_stack_clamps_to_eight_and_matches_jax(tmp_path):
    from helpers import default_camera
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu.ops.pipeline import make_frame_fn
    from vktf_tpu.scene.flatten import flatten_assets as jax_flatten
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.scene.scene import Scene

    width, height = 96, 64
    with tp._jax_native_mips(False):
        jscene, jmeta, _aux = jax_flatten([_jax_stack_asset(tmp_path)])
    jcam = default_camera(aspect=width / height)
    jconfig = JConfig(width=width, height=height, msaa_samples=1,
                      tile_shape=(32, 64), backend="pallas", pallas_chunk=128,
                      pallas_interpret=True)
    want = np.asarray(make_frame_fn(jmeta, jconfig)(
        jscene, jcam.view_projection_transform, jcam.position))

    camera = Camera(np.asarray(jcam.position), (0.0, -0.2, -1.0),
                    ViewFrustumParams(np.radians(45.0), width / height, 0.1, 100.0))
    warnings = io.StringIO()
    scene = Scene([_port_stack_asset()], _port_config(
        width=width, height=height, msaa_samples=1, tile_shape=(32, 64)),
        Log(io.StringIO(), warnings), camera=camera, device="cpu")
    assert jmeta.peel_layers == scene.meta.peel_layers == 8
    assert scene.frame_program.layers == 8
    assert "8-layer depth peel" in warnings.getvalue()
    got = scene.render_still()
    assert got.shape == want.shape == (3, height, width)
    _assert_frames_close(got, want)


@pytest.mark.parametrize("msaa", [1, 4])
def test_opaque_scene_at_forced_k2_equals_k1(msaa):
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    frames = {}
    for k in (1, 2):
        scene = Scene(tp.torch_assets("sponza_small"),
                      _port_config(msaa_samples=msaa, peel_layers=k), camera=tcam,
                      device="cpu")
        assert scene.meta.peel_layers == 1 and scene.frame_program.layers == k
        frames[k] = scene.render_still()
    np.testing.assert_array_equal(frames[2], frames[1])


@pytest.mark.parametrize("value", [0, 9])
def test_config_raises_on_peel_layers_outside_1_to_8(value):
    from vktf_tpu_torch.config import RenderConfig

    with pytest.raises(ValueError):
        RenderConfig(peel_layers=value)


@pytest.mark.parametrize("scene_layers, forced, want", [
    (2, None, 2), (8, None, 8), (8, 3, 3), (1, 2, 2)])
def test_frame_program_builds_for_peel_metas(scene_layers, forced, want):
    from vktf_tpu_torch.ops.pipeline import FrameProgram
    from vktf_tpu_torch.scene.flatten import SceneMeta

    meta = SceneMeta(level_slices=((0, 1),), num_lights=0, num_instances=1,
                     num_triangles=1, num_vertices=3, peel_layers=scene_layers)
    assert FrameProgram(meta, _port_config(peel_layers=forced)).layers == want


def test_pixel_winner_per_layer():
    """Per layer: min depth, then min id among covered samples; frac from
    layer 0 (vktf_tpu/ops/pipeline.py _tiled_winner)."""
    from vktf_tpu_torch.ops.pipeline import pixel_winner

    ids = torch.tensor([[[[3, 5]], [[4, -1]]],      # layer 0, samples 0/1
                        [[[7, -1]], [[6, -1]]]], dtype=torch.int32)
    depth = torch.tensor([[[[0.5, 0.25]], [[0.5, 1.0]]],
                          [[[0.75, 1.0]], [[0.6, 1.0]]]])
    tri, frac = pixel_winner(ids, depth)
    assert tri.tolist() == [[3, 5], [6, -1]]
    assert frac.tolist() == [1.0, 0.5]


def test_scene_without_device_needs_a_card():
    """Scene() renders on the card by default and never silently on the
    CPU: with no card it raises and names device="cpu"."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Scene() takes it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Scene(tp.torch_assets("box"), RenderConfig(width=64, height=32))
