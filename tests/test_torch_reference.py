"""The port's frames against the numpy oracles: the JAX package's
(``vktf_tpu/ops/reference.py``) and the port's own copy
(``vktf_tpu_torch/ops/reference.py``).

The oracle is an independent renderer: screen-space barycentrics in
float64 with per-triangle Python loops, float64 depth, its own texture
sampling and K-layer composite. The port's ``Scene(..., device="cpu")``
loads tests/test_alpha.py's glTF fixtures with its own loader and renders
them with its kernels' plain versions; the JAX oracle renders the JAX
package's flattening of the same files (``helpers.make_reference``), as
``helpers.render_both`` does for the JAX frame program, and the port's
oracle the port's flattening (``reference_scene``). The two oracles'
frames must be equal bit for bit. Budget of the port's frames against
either: ``helpers.assert_images_close`` at its defaults (mean absolute
difference at most 2.0, at most 1.5% of the pixels more than 8 steps
apart). The textured fixture is tests/test_textures.py's mixed-sampler
plane; the JAX flattening then runs with its numpy mips, which the
port's mips equal.

At 4x MSAA the port shades every sample (``shading_rate="sample"``), as
the oracle does, so the default budget holds there too.
"""

import numpy as np
import pytest

import torch_parity as tp
from helpers import (SAMPLE_OFFSETS, assert_images_close, build_scene, checker_png_bytes,
                     default_camera, make_reference)
from test_alpha import _quad_over_box, _stacked_blend_scene

tp.limit_threads()

WIDTH, HEIGHT = 96, 64
OPAQUE = dict(base_color_factor=(0.9, 0.25, 0.2, 1.0), metallic_factor=0.0,
              roughness_factor=0.5)
BLEND = dict(base_color_factor=(0.9, 0.25, 0.2, 0.45), metallic_factor=0.0,
             roughness_factor=0.5, alpha_mode="BLEND")


def _port_and_oracle(path, msaa, position=(0.0, 0.6, 2.2), direction=(0.0, -0.2, -1.0)):
    """(the port's CPU frame, the JAX oracle's frame) of one fixture; the
    port's oracle must render the JAX oracle's frame bit for bit, and the
    port's frame must lie within the budget of it."""
    from vktf_tpu.ops.reference import render_reference
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.ops import reference
    from vktf_tpu_torch.scene.scene import Scene

    jcam = default_camera(aspect=WIDTH / HEIGHT, position=position, direction=direction)
    camera = Camera(position, direction,
                    ViewFrustumParams(np.radians(45.0), WIDTH / HEIGHT, 0.1, 100.0))
    np.testing.assert_array_equal(camera.view_projection_transform,
                                  jcam.view_projection_transform)
    config = RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=msaa,
                          shading_rate="sample")
    port = Scene([load_gltf(path)], config, camera=camera, device="cpu")
    produced = np.moveaxis(port.render_still(), 0, -1)
    with tp._jax_native_mips(False):
        scene, meta, aux = build_scene(path)
    assert port.meta.peel_layers == meta.peel_layers
    expected = render_reference(
        make_reference(scene, meta, aux), jcam.view_projection_transform, jcam.position,
        WIDTH, HEIGHT, SAMPLE_OFFSETS[msaa], max_anisotropy=config.max_anisotropy,
        peel_layers=max(meta.peel_layers, 2))
    assert (expected[..., :3].max(axis=-1) > 0).mean() > 0.2  # the fixture is in view
    ref = reference.reference_scene([load_gltf(path)])
    assert ref.meta == port.meta
    port_expected = reference.render_reference(
        ref, camera.view_projection_transform, camera.position, WIDTH, HEIGHT,
        SAMPLE_OFFSETS[msaa], max_anisotropy=config.max_anisotropy,
        peel_layers=max(ref.meta.peel_layers, 2))
    np.testing.assert_array_equal(port_expected, expected)
    assert_images_close(produced, port_expected)
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


def test_mixed_sampler_plane_matches_the_oracle(tmp_path):
    """tests/test_textures.py's mixed-sampler plane: three PNG textures
    under repeat, clamp and mirrored-nearest samplers, uvs leaving [0, 1]."""
    from vktf_tpu.models.gltf_writer import GltfWriter
    from vktf_tpu.models.primitives import plane_mesh

    w = GltfWriter()
    images = [w.add_image_bytes(checker_png_bytes(32, **kw), "image/png") for kw in (
        dict(cell=8), dict(a=(40, 200, 120, 255), b=(200, 60, 60, 255), cell=16),
        dict(a=(128, 128, 255, 255), b=(180, 100, 230, 255), cell=16))]
    samplers = [w.add_sampler(wrap_s=10497, wrap_t=10497),
                w.add_sampler(wrap_s=33071, wrap_t=33071),
                w.add_sampler(mag=9728, wrap_s=33648, wrap_t=33648)]
    base, mr, normal = (w.add_texture(i, s) for i, s in zip(images, samplers))
    mat = w.add_material(base_color_texture=base, metallic_roughness_texture=mr,
                         normal_texture=normal, metallic_factor=0.4, roughness_factor=0.7)
    geom = plane_mesh(3.0)
    geom["uvs"] = geom["uvs"] * 2.5 - 0.75
    floor = w.add_mesh(geom, material=mat)
    sun = w.add_light("directional", color=(2.5, 2.5, 2.5))
    w.add_scene([w.add_node(mesh=floor, translation=(0.0, 0.0, -1.2)),
                 w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239))])
    path = w.write(tmp_path / "mixed.gltf")
    assert_images_close(*_port_and_oracle(path, 1, (0.0, 1.6, 1.8), (0.0, -0.7, -1.0)))


def test_the_card_tests_write_the_test_alpha_fixtures(tmp_path):
    """tests/torch_card.py rebuilds tests/test_alpha.py's fixtures with the
    port's writer (the card's machine has no jax): the same files, byte for
    byte, and the oracle's budget is assert_images_close's."""
    import inspect

    import torch_card as tc

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    pairs = [(_quad_over_box(tmp_path / "jax", front, name),
              tc.quad_over_box(tmp_path / "port", front, name))
             for front, name in ((OPAQUE, "opaque.gltf"), (BLEND, "blend.gltf"))]
    pairs.append((_stacked_blend_scene(tmp_path / "jax"),
                  tc.stacked_blend_scene(tmp_path / "port")))
    for want, got in pairs:
        assert got.read_bytes() == want.read_bytes(), got.name
    assert (tc.OPAQUE_FRONT, tc.BLEND_FRONT) == (OPAQUE, BLEND)
    assert [msaa for _, _, msaa in tc.ORACLE_FIXTURES] == [1, 4, 1, 4, 1]
    defaults = {k: v.default for k, v in
                inspect.signature(assert_images_close).parameters.items()}
    assert (defaults["max_mean"], defaults["max_outlier_frac"], defaults["tol"]) == (
        tc.ORACLE_MAX_MEAN, tc.ORACLE_MAX_OUTLIERS, tc.ORACLE_OUTLIER_STEP)
