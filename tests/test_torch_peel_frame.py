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
  JAX frame at 96x64, 1x MSAA; and the configuration's and the frame
  program's K rules (tests/test_torch_peel_stack.py).
* An opaque scene at a forced K = 2 renders the K = 1 frame exactly: an
  opaque layer 0 has alpha 1, so the composite returns it unchanged.
"""

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


def _assert_blend_frames_close(got, want):
    tp.assert_frames_close(got, want, want.shape,
                           tp.checked_jax_wrong(JAX_WRONG, tp.WIDTH, tp.HEIGHT, 4, PEEL_K))


def test_translucent_frame_matches_jax_on_the_jax_scene():
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = tp.jax_scene("sponza_small_blend")
    _jcam, tcam = tp.cameras()
    scene = Scene.from_render_scene(
        scene_from_numpy(tp.jax_leaves("sponza_small_blend"), "cpu"),
        tp.port_meta(jmeta), tp.port_config(peel_layers=PEEL_K), camera=tcam)
    assert scene.frame_program.layers == PEEL_K
    want = tp.jax_frame("sponza_small_blend", 4, PEEL_K)
    opaque = Scene(tp.torch_assets("sponza_small"), tp.port_config(), camera=tcam,
                   device="cpu").render_still()
    # the blend shows: a visible share of pixels differs from the opaque frame
    assert (np.abs(want.astype(np.int16) - opaque).max(axis=0) > 8).mean() > 0.05
    _assert_blend_frames_close(scene.render_still(), want)


def test_translucent_scene_from_preset_matches_jax():
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    scene = Scene(tp.torch_assets("sponza_small_blend"),
                  tp.port_config(peel_layers=PEEL_K), camera=tcam, device="cpu")
    assert scene.meta.peel_layers == 8
    _assert_blend_frames_close(scene.render_still(),
                               tp.jax_frame("sponza_small_blend", 4, PEEL_K))


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
        tp.port_config(tile_shape=(32, 64)), camera=camera)
    assert scene.frame_program.layers == 2
    got = scene.render_still()
    want = np.moveaxis(np.asarray(Image.open(GOLDEN).convert("RGB")), -1, 0)
    tp.assert_frames_close(got, want, want.shape)


@pytest.mark.parametrize("msaa", [1, 4])
def test_opaque_scene_at_forced_k2_equals_k1(msaa):
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    frames = {}
    for k in (1, 2):
        scene = Scene(tp.torch_assets("sponza_small"),
                      tp.port_config(msaa_samples=msaa, peel_layers=k), camera=tcam,
                      device="cpu")
        assert scene.meta.peel_layers == 1 and scene.frame_program.layers == k
        frames[k] = scene.render_still()
    np.testing.assert_array_equal(frames[2], frames[1])


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
