"""Port parity of sample-rate shading (``shading_rate="sample"``).

The JAX frame program leaves its tiled path at sample rate and shades
every MSAA sample at its own position in the layer form, composites each
sample's layers over the clear colour and averages over the samples
(``vktf_tpu/ops/pipeline.py`` ``pallas_shade_resolve``, the branch after
the pixel-rate one). The port runs the same through its layer shade
kernels. Frames of the small courtyard at 4x MSAA, from bench.py's sponza
camera, are held to the JAX program's (Pallas in interpret mode) within
the frame budget of test_torch_frame.py: one u8 step on at most 0.5% of
the pixels, at 96x64: the opaque courtyard here and the translucent one
at a forced K = 2 (the interpret-mode program at the scene's own K = 8
takes over 90 s; test_torch_cuda_paths.py runs K = 8 on the card against
the CPU); the per-slot and two-tap courtyards in
test_torch_sample_texture.py.

Also: the routing. The sample path takes the layer record of the scene's
form at every K (K = 1 included), never the resolve record or the pixel
winner, and ignores the attrs boundary as the JAX sample path does.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()


# Per case, the pixels where the JAX package's nearest fragments of a
# sample are the wrong ones by float64 depth (its depth planes'
# cancellation noise, tests/test_torch_setup.py) and the frames differ by
# more than one u8 step; checked by tp.checked_jax_wrong.
JAX_WRONG = {"opaque": [(1, 21), (40, 54)], "blend": [(1, 21), (40, 54)]}


@pytest.mark.parametrize("name, kw, layers", [
    ("sponza_small", {}, 1),
    ("sponza_small_blend", {"peel_layers": 2}, 2),
], ids=["opaque", "blend"])
def test_sample_rate_frame_matches_jax(name, kw, layers):
    case = "opaque" if layers == 1 else "blend"
    tp.check_sample_frame(name, 96, 64, kw, ("fused", 1), layers, JAX_WRONG[case])


def test_sample_path_routing():
    """shade_form at sample rate: the scene's texel source and taps, never
    the attrs kernels; the frame program calls the layer shade once over
    the (K, S*N) samples at K = 1, and neither the resolve shade nor the
    pixel winner; the attrs boundary leaves the frame as it was."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops import pipeline, shade_kernel
    from vktf_tpu_torch.scene.flatten import SceneMeta
    from vktf_tpu_torch.scene.scene import Scene

    meta = SceneMeta(level_slices=((0, 1),), num_lights=0, num_instances=1,
                     num_triangles=1, num_vertices=3)
    cases = [  # (config fields, scene flags) -> (texels, taps, attrs)
        ({}, {}, ("fused", 1, False)),
        ({"shade_attrs_boundary": True}, {}, ("fused", 1, False)),
        ({"shade_fused_pool": False}, {}, ("classic", 1, False)),
        ({"aniso_taps": 4}, {}, ("fused", 4, False)),
        ({"aniso_taps": 2, "shade_attrs_boundary": True}, {}, ("fused", 2, False)),
        ({}, {"mirror_wrap": True}, ("classic", 1, False)),
        ({"aniso_taps": 2}, {"mirror_wrap": True}, ("classic", 2, False)),
        ({"shade_attrs_boundary": True}, {"mixed_samplers": True}, ("per_slot", 1, False)),
    ]
    for fields, flags, want in cases:
        cfg = RenderConfig(shading_rate="sample", **fields)
        got = pipeline.shade_form(cfg, dataclasses.replace(meta, **flags))
        assert (got.texels, got.taps, got.attrs) == want, (fields, flags)
    # the pixel path keeps its own routing
    assert pipeline.shade_form(RenderConfig(shade_attrs_boundary=True), meta).attrs

    calls = []
    layer, resolve, winner = shade_kernel.shade_layer, shade_kernel.shade_resolve, \
        pipeline.pixel_winner

    def counting_layer(tri, sx, *args):
        calls.append((tuple(tri.shape), tuple(sx.shape)))
        return layer(tri, sx, *args)

    def refused(*args, **kwargs):
        raise AssertionError("not on the sample path")

    shade_kernel.shade_layer, shade_kernel.shade_resolve = counting_layer, refused
    pipeline.pixel_winner = refused
    try:
        _jcam, tcam = tp.cameras(64, 32)
        frames = []
        for attrs in (False, True):
            cfg = RenderConfig(width=64, height=32, msaa_samples=4, shading_rate="sample",
                               shade_attrs_boundary=attrs)
            frames.append(Scene(tp.torch_assets("box"), cfg, camera=tcam,
                                device="cpu").render_still())
    finally:
        shade_kernel.shade_layer, shade_kernel.shade_resolve = layer, resolve
        pipeline.pixel_winner = winner
    n = 4 * 64 * 128  # S samples of the tile-padded 64x128 frame
    assert calls == [((1, n), (n,))] * 2
    np.testing.assert_array_equal(frames[0], frames[1])


def test_sample_centers_are_sample_major():
    """Entry s * H * W + y * W + x is pixel (x, y) plus sample s's offset,
    the order of the raster's flattened (S, H, W) ids."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS
    from vktf_tpu_torch.ops.pipeline import sample_centers

    for samples in (1, 2, 4, 8):
        sx, sy = sample_centers(3, 5, samples, torch.device("cpu"))
        assert sx.shape == sy.shape == (samples * 15,)
        for s, (ox, oy) in enumerate(SAMPLE_OFFSETS[samples]):
            for y in range(3):
                for x in range(5):
                    i = s * 15 + y * 5 + x
                    assert sx[i].item() == np.float32(x) + np.float32(ox)
                    assert sy[i].item() == np.float32(y) + np.float32(oy)
