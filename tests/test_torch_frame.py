"""Port parity of the whole slice: ``Scene.render_still()`` against the JAX
production frame program (``PallasFrameProgram``, interpret mode) on the
small sponza courtyard at 256x128, 4x MSAA, from bench.py's sponza camera.

Tolerance: max difference one u8 step, on at most 0.5% of the pixels,
apart from listed pixels where the JAX package's winner is the wrong one
by float64 depth (checked at test time by tp.checked_jax_wrong). The
shade stage's transcendental ULPs (test_torch_shade.py) pass through; the
JAX package's depth planes are off by up to ~1e-3 (cancelling cofactor
sums), the port's by ~1e-7 (test_torch_setup.py), which moves JAX's
winner where two surfaces meet at nearly equal depth.

Also at 8x MSAA and at 200x120 (not a whole number of tiles), the frames
the earlier tests did not cover.

Also here: the port imports neither jax nor the JAX package, and its
configuration raises on every value it cannot honour. The duck and
helmet presets' frames are tests/test_torch_frame_presets.py's.
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


# Pixels of the 256x128 4x frame where the JAX package's pixel winner (its
# nearest sample's triangle) is the wrong one by float64 depth: its depth
# planes are off by up to ~1e-3 (cancelling cofactor sums), the port's by
# ~1e-7 (tests/test_torch_setup.py), and at these pixels the two winners
# shade more than one u8 step apart. Checked by tp.checked_jax_wrong.
JAX_WRONG = [
    (11, 60), (14, 58), (16, 77), (28, 53), (32, 130), (33, 130), (36, 130), (39, 179),
    (45, 171), (46, 171), (47, 171), (54, 130), (60, 125), (61, 125), (64, 130), (65, 130),
    (68, 125), (83, 137), (85, 78), (85, 177), (86, 142), (87, 139), (88, 174), (98, 179),
    (98, 218), (107, 100), (114, 114),
]


def _assert_frames_close(got, want):
    tp.assert_frames_close(got, want, (3, tp.HEIGHT, tp.WIDTH),
                           tp.checked_jax_wrong(JAX_WRONG, tp.WIDTH, tp.HEIGHT, 4))


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
        tp.port_config(), camera=tcam)
    want = tp.jax_frame("sponza_small")
    assert (want.max(axis=0) > 0).mean() > 0.5
    _assert_frames_close(scene.render_still(), want)


def test_scene_from_preset_matches_jax():
    """The port's own builder (build_preset's sponza layout at the small
    sizes) through the user entry point."""
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    scene = Scene(tp.torch_assets("sponza_small"), tp.port_config(),
                  camera=tcam, device="cpu")
    _assert_frames_close(scene.render_still(), tp.jax_frame("sponza_small"))


# as JAX_WRONG, for frames off the 4x, whole-tile grid the tests above
# hold: 8x MSAA, and a size that is not a whole number of 64x128 tiles
OFF_GRID_JAX_WRONG = {
    (256, 128, 8): [
        (13, 58), (20, 55), (21, 179), (27, 125), (32, 76), (46, 197), (50, 125), (52, 84),
        (56, 193), (64, 206), (69, 130), (77, 130), (80, 139), (80, 142), (82, 143), (83, 130),
        (85, 137), (85, 141), (85, 143), (86, 143), (92, 170), (92, 176), (94, 174), (97, 97),
        (97, 99), (97, 180), (98, 179), (99, 177), (102, 92), (103, 207), (113, 112),
        (114, 112), (114, 113), (119, 96),
    ],
    (200, 120, 4): [
        (0, 51), (43, 102), (44, 102), (44, 161), (45, 102), (54, 99), (54, 100), (54, 101),
        (54, 102), (54, 103), (54, 104), (63, 102), (68, 161), (69, 161), (73, 102), (86, 145),
        (93, 187), (93, 193), (94, 188), (101, 85), (102, 70), (109, 185),
    ],
}


@pytest.mark.parametrize("width, height, msaa", sorted(OFF_GRID_JAX_WRONG),
                         ids=["200x120_4x", "256x128_8x"])
def test_frame_matches_jax_off_the_tested_grid(width, height, msaa):
    """The small courtyard at 8x MSAA and at a size that pads to tiles,
    through the port's Scene, within the frame budget of the JAX
    program's frame, apart from the listed pixels."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    scene, _meta = tp.jax_scene("sponza_small")
    jcam, tcam = tp.cameras(width, height)
    prog = tp.jax_program("sponza_small", msaa, width=width, height=height)
    want = np.asarray(prog(scene, jcam.view_projection_transform, jcam.position))
    got = Scene(tp.torch_assets("sponza_small"),
                RenderConfig(width=width, height=height, msaa_samples=msaa),
                camera=tcam, device="cpu").render_still()
    assert (want.max(axis=0) > 0).mean() > 0.5
    listed = OFF_GRID_JAX_WRONG[(width, height, msaa)]
    tp.assert_frames_close(got, want, (3, height, width),
                           tp.checked_jax_wrong(listed, width, height, msaa))


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

    kernels = (setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, raster.KERNEL_GROUPS,
               raster.KERNEL_LAYERS, shade_table.KERNEL, *shade_kernel.KERNELS)
    before = [k.launches for k in kernels]
    for layers in (1, 2):
        for texture in ({}, {"aniso_taps": 2}, {"shade_fused_pool": False},
                        {"shade_attrs_boundary": True}):
            scene = Scene(tp.torch_assets("box"),
                          tp.port_config().replace(peel_layers=layers, **texture),
                          device="cpu")
            scene.render_still()
    assert [k.launches for k in kernels] == before


def test_port_imports_no_jax():
    """A fresh interpreter imports the port's package, touches every name
    it and its subpackages export (the lazy Engine, Window and Scene too),
    the native runtime (built and called) and the numpy oracle, and renders
    a frame without loading jax or the JAX package."""
    code = textwrap.dedent("""
        import importlib
        import sys
        import torch
        torch.set_num_threads(2)
        import vktf_tpu_torch
        for sub in ("", ".mathx", ".scene", ".models"):
            module = importlib.import_module("vktf_tpu_torch" + sub)
            for name in module.__all__:
                getattr(module, name)
        from vktf_tpu_torch import native
        from vktf_tpu_torch.config import RenderConfig
        from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
        from vktf_tpu_torch.models.scenes import build_preset
        from vktf_tpu_torch.ops import reference
        from vktf_tpu_torch.scene.scene import Scene
        assert native.compress_zstd(b"x" * 64) and reference.render_reference
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
             if "_build" not in p.parts] + [REPO / "chip_smoke.py", REPO / "bench_torch.py",
                                             *(REPO / "tests").glob("test_torch_cuda*.py"),
                                             REPO / "tests" / "torch_card.py"]
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
        FrameProgram(SceneMeta(**base, **extra), tp.port_config())
    for layers in (0, 9):
        with pytest.raises(ValueError):
            FrameProgram(SceneMeta(**base, peel_layers=layers), tp.port_config())
