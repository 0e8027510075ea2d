"""Port parity of the whole slice: ``Scene.render_still()`` against the JAX
production frame program (``PallasFrameProgram``, interpret mode) on the
small sponza courtyard at 256x128, 4x MSAA, from bench.py's sponza camera.

Tolerance: max difference one u8 step, on at most 0.5% of the pixels. The
shade stage's transcendental ULPs (test_torch_shade.py) pass through, and
the port's depth planes differ from XLA's by float32 roundings of a
cancelling sum (test_torch_setup.py), which may move the winner of a
sample where two surfaces meet at equal depth.

Also here: the duck and helmet presets' frames against the JAX
program's, the port imports neither jax nor the JAX package, and its
configuration raises on every value it cannot honour.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()

REPO = Path(__file__).resolve().parent.parent


def _jax_frame(name: str):
    scene, _meta = tp.jax_scene(name)
    jcam, _ = tp.cameras()
    prog = tp.jax_program(name, 4)
    return np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))


def _assert_frames_close(got, want):
    tp.assert_frames_close(got, want, (3, tp.HEIGHT, tp.WIDTH))


def _port_config():
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4)


def test_frame_matches_jax_on_the_jax_scene():
    """Both packages render the JAX package's flattened scene."""
    from vktf_tpu_torch.scene.flatten import SceneMeta, scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = tp.jax_scene("sponza_small")
    meta = SceneMeta(**{f: getattr(jmeta, f) for f in (
        "level_slices", "num_lights", "num_instances", "num_triangles",
        "num_vertices", "peel_layers", "mixed_samplers", "mirror_wrap")})
    _jcam, tcam = tp.cameras()
    scene = Scene.from_render_scene(
        scene_from_numpy(tp.jax_leaves("sponza_small"), "cpu"), meta,
        _port_config(), camera=tcam)
    want = _jax_frame("sponza_small")
    assert (want.max(axis=0) > 0).mean() > 0.5
    _assert_frames_close(scene.render_still(), want)


def test_scene_from_preset_matches_jax():
    """The port's own builder (build_preset's sponza layout at the small
    sizes) through the user entry point."""
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    scene = Scene(tp.torch_assets("sponza_small"), _port_config(),
                  camera=tcam, device="cpu")
    _assert_frames_close(scene.render_still(), _jax_frame("sponza_small"))


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


def test_render_async_is_a_device_tensor():
    import torch

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.scene.scene import Scene

    scene = Scene(build_preset("box"), RenderConfig(width=64, height=32,
                                                    msaa_samples=2),
                  device="cpu")
    frame = scene.render_async()
    assert isinstance(frame, torch.Tensor)
    assert frame.shape == (3, 32, 64) and frame.dtype == torch.uint8
    np.testing.assert_array_equal(scene.render_still(), frame.numpy())


def test_plain_versions_count_no_launches():
    """CPU tensors take the plain versions, which launch nothing."""
    from vktf_tpu_torch.ops import raster, setup_kernel, shade_kernel, shade_table
    from vktf_tpu_torch.scene.scene import Scene

    kernels = (setup_kernel.KERNEL, raster.KERNEL, raster.KERNEL_LAYERS,
               shade_table.KERNEL, *shade_kernel.KERNELS)
    before = [k.launches for k in kernels]
    for layers in (1, 2):
        for texture in ({}, {"aniso_taps": 2}, {"shade_fused_pool": False},
                        {"shade_attrs_boundary": True}):
            scene = Scene(tp.torch_assets("box"),
                          _port_config().replace(peel_layers=layers, **texture),
                          device="cpu")
            scene.render_still()
    assert [k.launches for k in kernels] == before


def test_port_imports_no_jax():
    """A fresh interpreter renders a frame through the port without loading
    jax or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        from vktf_tpu_torch.config import RenderConfig
        from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
        from vktf_tpu_torch.models.scenes import build_preset
        from vktf_tpu_torch.scene.scene import Scene
        camera = Camera((-2.5, 0.8, 0.0), (1.0, -0.3, 0.0),
                        ViewFrustumParams(0.8, 2.0, 0.1, 100.0))
        scene = Scene(build_preset("box"),
                      RenderConfig(width=64, height=32, msaa_samples=4),
                      camera=camera, device="cpu")
        frame = scene.render_still()
        assert frame.shape == (3, 32, 64) and frame.max() > 0
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "vktf_tpu."))
                        or m == "vktf_tpu")
        print("LOADED", loaded)
        assert "jax" not in sys.modules and "vktf_tpu" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_port_sources_import_no_jax():
    pattern = ("import jax", "from jax", "import vktf_tpu\n", "import vktf_tpu.",
               "from vktf_tpu ", "from vktf_tpu.")
    files = [p for p in (REPO / "vktf_tpu_torch").rglob("*.py")
             if "_build" not in p.parts] + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    for path in files:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(pattern), f"{path}: {line}"


@pytest.mark.parametrize("field, value", [
    ("shading_rate", "quad"),
    ("present_format", "yuv444"),
    ("present_scale", 3),
    ("msaa_samples", 3),
    ("tile_shape", (64, 120)),
    ("pallas_chunk", 512),
])
def test_config_raises_on_what_it_cannot_honour(field, value):
    from vktf_tpu_torch.config import RenderConfig

    with pytest.raises(ValueError):
        RenderConfig(**{field: value})


def test_frame_program_raises_on_unported_scenes():
    """Mirror-wrap and mixed-sampler scenes render (tests/test_torch_texture.py
    routes them); a scene whose peel estimate lies outside the raster
    kernel's 1..8 layers does not, and raises."""
    from vktf_tpu_torch.ops.pipeline import FrameProgram
    from vktf_tpu_torch.scene.flatten import SceneMeta

    base = dict(level_slices=((0, 1),), num_lights=0, num_instances=1,
                num_triangles=1, num_vertices=3)
    for extra in ({"mixed_samplers": True}, {"mirror_wrap": True}):
        FrameProgram(SceneMeta(**base, **extra), _port_config())
    for layers in (0, 9):
        with pytest.raises(ValueError):
            FrameProgram(SceneMeta(**base, peel_layers=layers), _port_config())
