"""Port parity of whole frames through the texture side paths of
``FrameProgram``, on the small courtyard at 256x128, 4x MSAA.

* Against the JAX production frame program (``PallasFrameProgram``,
  interpret mode) on the JAX package's scene, carried over: four taps on
  the fused pool; the mirror courtyard (every sampler MIRRORED_REPEAT:
  the two-gather kernel); the mixed courtyard (base REPEAT,
  metallic-roughness CLAMP_TO_EDGE, normal MIRRORED_REPEAT with NEAREST
  magnification: the per-slot form, the JAX package's XLA form); the attrs
  boundary; and, at K = 3, the translucent mixed courtyard. Tolerance as
  tests/test_torch_frame.py: max one u8 step on at most 0.5% of the
  pixels (transcendental ULPs of the shade and the sRGB encode).
* The attrs boundary against the table-row two-gather form on the port
  alone, bit for bit, at K = 1 and at K = 3 on the translucent courtyard:
  both evaluate every value with the same helpers.
"""

import functools

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()


def _port_config(**kw):
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(**{"width": tp.WIDTH, "height": tp.HEIGHT, "msaa_samples": 4, **kw})


@functools.lru_cache(maxsize=None)
def _port_scene(name: str, **kw):
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = tp.jax_scene(name)
    _jcam, tcam = tp.cameras()
    return Scene.from_render_scene(scene_from_numpy(tp.jax_leaves(name), "cpu"),
                                   tp.port_meta(jmeta), _port_config(**kw), camera=tcam)


# Per case, the pixels where the JAX package's winner (a sample's nearest
# fragments or a layer's pixel winner) is the wrong one by float64 depth
# (its depth planes' cancellation noise, tests/test_torch_setup.py) and
# the two winners shade more than one u8 step apart; checked by
# tp.checked_jax_wrong.
JAX_WRONG = {
    "taps4": [
        (11, 60), (14, 58), (16, 77), (28, 53), (33, 130), (36, 130), (39, 179), (45, 171),
        (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130), (68, 125),
        (85, 78), (85, 177), (86, 142), (87, 139), (88, 174), (98, 218), (106, 103), (107, 100),
        (112, 225), (114, 114),
    ],
    "mirror": [
        (11, 60), (14, 58), (16, 77), (28, 53), (32, 130), (33, 130), (36, 130), (39, 179),
        (45, 171), (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130),
        (68, 125), (80, 142), (83, 137), (85, 78), (85, 177), (86, 138), (86, 142), (87, 139),
        (88, 174), (98, 179), (98, 218), (107, 96), (107, 100), (114, 114),
    ],
    "mixed": [
        (11, 60), (14, 58), (16, 77), (28, 53), (32, 130), (33, 130), (36, 130), (39, 179),
        (45, 171), (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130),
        (68, 125), (80, 142), (83, 137), (85, 78), (85, 177), (86, 138), (86, 142), (87, 139),
        (88, 174), (98, 179), (98, 218), (107, 96), (107, 100), (114, 114),
    ],
    "attrs": [
        (11, 60), (14, 58), (16, 77), (28, 53), (32, 130), (33, 130), (36, 130), (39, 179),
        (45, 171), (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130),
        (68, 125), (83, 137), (85, 78), (85, 177), (86, 142), (87, 139), (88, 174), (98, 179),
        (98, 218), (107, 100), (114, 114),
    ],
    "mixed_blend_k3": [
        (14, 58), (16, 77), (32, 76), (32, 130), (33, 130), (36, 130), (39, 179), (45, 171),
        (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130), (68, 125),
        (85, 78), (85, 177), (87, 139), (88, 174), (98, 218),
    ],
}


@pytest.mark.parametrize("name, kw, form, case", [
    ("sponza_small", {"aniso_taps": 4}, ("fused", 4, False), "taps4"),
    ("sponza_small_mirror", {}, ("classic", 1, False), "mirror"),
    ("sponza_small_mixed", {}, ("per_slot", 1, False), "mixed"),
    ("sponza_small", {"shade_attrs_boundary": True}, ("classic", 1, True), "attrs"),
    ("sponza_small_blend_mixed", {"peel_layers": 3}, ("per_slot", 1, False),
     "mixed_blend_k3"),
], ids=["taps4", "mirror", "mixed", "attrs", "mixed_blend_k3"])
def test_texture_frame_matches_jax(name, kw, form, case):
    scene, _meta = tp.jax_scene(name)
    jcam, _ = tp.cameras()
    jkw = dict(kw)
    prog = tp.jax_program(name, 4, jkw.pop("peel_layers", None), **jkw)
    want = np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))
    port = _port_scene(name, **kw)
    got_form = port.frame_program.form
    assert (got_form.texels, got_form.taps, got_form.attrs) == form
    got = port.render_still()
    assert (want.max(axis=0) > 0).mean() > 0.5
    tp.assert_frames_close(got, want, (3, tp.HEIGHT, tp.WIDTH), tp.checked_jax_wrong(
        JAX_WRONG[case], tp.WIDTH, tp.HEIGHT, 4, kw.get("peel_layers", 1)))
    if kw.get("aniso_taps", 1) > 1:  # the taps act
        single = _port_scene(name).render_still()
        assert (np.abs(got.astype(np.int16) - single).max(axis=0) > 1).mean() > 0.01


@pytest.mark.parametrize("name, layers", [("sponza_small", None), ("sponza_small_blend", 3)])
def test_attrs_frame_equals_two_gather_frame(name, layers):
    attrs = _port_scene(name, peel_layers=layers, shade_attrs_boundary=True)
    cols = _port_scene(name, peel_layers=layers, shade_fused_pool=False)
    assert attrs.frame_program.form.attrs and cols.frame_program.form.texels == "classic"
    assert attrs.frame_program.layers == cols.frame_program.layers == (layers or 1)
    np.testing.assert_array_equal(attrs.render_still(), cols.render_still())
