"""Port parity of the duck and helmet presets' whole frames: ``Scene`` of
the port's preset against the JAX production frame program
(``PallasFrameProgram``, interpret mode) on the JAX preset, within
tests/test_torch_frame.py's frame budget."""

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()


@pytest.mark.parametrize("preset", ["duck", "helmet"])
def test_preset_frame_matches_jax(preset):
    """The duck (bench.py's msaa 1) and helmet (msaa 4, a point light)
    presets at 96x64 from bench.py's camera of each, through the port's
    Scene, against the JAX production frame program on the JAX preset."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    msaa = {"duck": 1, "helmet": 4}[preset]
    pose = {"duck": ((0.0, 0.5, 2.0), (0.0, -0.2, -1.0)),
            "helmet": ((0.0, 0.4, 2.4), (0.0, -0.1, -1.0))}[preset]
    jcam, tcam = tp.cameras(96, 64, pose)
    scene, _meta = tp.jax_scene(preset)
    prog = tp.jax_program(preset, msaa, width=96, height=64)
    want = np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))
    got = Scene(tp.torch_assets(preset), RenderConfig(width=96, height=64, msaa_samples=msaa),
                camera=tcam, device="cpu").render_still()
    assert (want.max(axis=0) > 0).mean() > 0.1  # the object fills 13-15% of the view
    tp.assert_frames_close(got, want, (3, 64, 96))
