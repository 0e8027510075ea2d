"""The port's frames against the numpy oracle (``vktf_tpu/ops/reference.py``).

The oracle is an independent renderer: screen-space barycentrics in
float64 with per-triangle Python loops, float64 depth, its own texture
sampling and K-layer composite. The port's ``Scene(..., device="cpu")``
loads tests/test_alpha.py's glTF fixtures with its own loader and renders
them with its kernels' plain versions; the oracle renders the JAX
package's flattening of the same files (``helpers.make_reference``), as
``helpers.render_both`` does for the JAX frame program. Budget:
``helpers.assert_images_close`` at its defaults (mean absolute difference
at most 2.0, at most 1.5% of the pixels more than 8 steps apart).

At 4x MSAA the port shades every sample (``shading_rate="sample"``), as
the oracle does, so the default budget holds there too.
"""

import numpy as np
import pytest

import torch_parity as tp
from helpers import (SAMPLE_OFFSETS, assert_images_close, build_scene, default_camera,
                     make_reference)
from test_alpha import _quad_over_box, _stacked_blend_scene

tp.limit_threads()

WIDTH, HEIGHT = 96, 64
OPAQUE = dict(base_color_factor=(0.9, 0.25, 0.2, 1.0), metallic_factor=0.0,
              roughness_factor=0.5)
BLEND = dict(base_color_factor=(0.9, 0.25, 0.2, 0.45), metallic_factor=0.0,
             roughness_factor=0.5, alpha_mode="BLEND")


def _port_and_oracle(path, msaa):
    from vktf_tpu.ops.reference import render_reference
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.scene.scene import Scene

    jcam = default_camera(aspect=WIDTH / HEIGHT)
    camera = Camera((0.0, 0.6, 2.2), (0.0, -0.2, -1.0),
                    ViewFrustumParams(np.radians(45.0), WIDTH / HEIGHT, 0.1, 100.0))
    np.testing.assert_array_equal(camera.view_projection_transform,
                                  jcam.view_projection_transform)
    config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=msaa,
                          shading_rate="sample")
    port = Scene([load_gltf(path)], config, camera=camera, device="cpu")
    produced = np.moveaxis(port.render_still(), 0, -1)
    scene, meta, aux = build_scene(path)
    assert port.meta.peel_layers == meta.peel_layers
    expected = render_reference(
        make_reference(scene, meta, aux), jcam.view_projection_transform, jcam.position,
        WIDTH, HEIGHT, SAMPLE_OFFSETS[msaa], max_anisotropy=config.max_anisotropy,
        peel_layers=max(meta.peel_layers, 2))
    assert (expected[..., :3].max(axis=-1) > 0).mean() > 0.2  # the fixture is in view
    return produced, expected


@pytest.mark.parametrize("msaa", [1, 4])
def test_opaque_quad_over_box_matches_the_oracle(msaa, tmp_path):
    path = _quad_over_box(tmp_path, OPAQUE, "opaque.gltf")
    assert_images_close(*_port_and_oracle(path, msaa))


@pytest.mark.parametrize("msaa", [1, 4])
def test_blend_quad_over_box_matches_the_oracle(msaa, tmp_path):
    """tests/test_alpha.py's blend fixture (K = 2)."""
    path = _quad_over_box(tmp_path, BLEND, "blend.gltf")
    assert_images_close(*_port_and_oracle(path, msaa))


def test_three_deep_blend_stack_matches_the_oracle(tmp_path):
    """tests/test_alpha.py's stack of three BLEND quads over the box (K = 4)."""
    path = _stacked_blend_scene(tmp_path)
    assert_images_close(*_port_and_oracle(path, 1))
