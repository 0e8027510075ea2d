"""Port parity of sample-rate shading on the texture side paths: the
mixed-sampler courtyard (the per-slot layer record) and two anisotropic
taps (the taps layer record), at 96x64, 4x MSAA, held to the JAX sample-
rate frame within the frame budget (test_torch_sample.py holds the
opaque and translucent courtyards and the routing)."""

import pytest

import torch_parity as tp

tp.limit_threads()


# Per case (by texel source), the pixels where the JAX package's nearest
# fragment of a sample is the wrong one by float64 depth (its depth
# planes' cancellation noise, tests/test_torch_setup.py) and the frames
# differ by more than one u8 step; checked by tp.checked_jax_wrong.
JAX_WRONG = {"per_slot": [(1, 21), (40, 54)], "fused": [(1, 21), (40, 54)]}


@pytest.mark.parametrize("name, kw, form", [
    ("sponza_small_mixed", {}, ("per_slot", 1)),
    ("sponza_small", {"aniso_taps": 2}, ("fused", 2)),
], ids=["mixed", "taps2"])
def test_sample_rate_texture_frame_matches_jax(name, kw, form):
    tp.check_sample_frame(name, 96, 64, kw, form, 1, JAX_WRONG[form[0]])
