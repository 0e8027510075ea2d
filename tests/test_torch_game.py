"""The port's viewer against the JAX viewer, end to end on the CPU.

One glTF file on disk (a textured box in front of the start camera, its
base colour a ZLIB KTX2 file, and a directional light), written by the
JAX package's GltfWriter and KTX2 writer, goes through both viewers'
``game.main`` at 64x48 for a 3-frame fly-through (5 presented frames),
each dumping its frames as PNGs (``--frame-dir``). The JAX viewer runs its
production frame program (``--backend pallas``, Pallas in interpret mode
on the CPU); the port runs its kernels' plain versions (``device="cpu"``).
Both engines get the same fixed frame time (1/30 s), so the fly-through
moves both cameras alike.

Tolerance: the frame budget of tests/test_torch_frame.py: at most one u8
step, on at most 0.5% of the pixels.
"""

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()


class _FixedDeltaTime:
    def update(self) -> float:
        return 1.0 / 30.0


def _textured_box(directory):
    from vktf_tpu.loaders.images import generate_mips
    from vktf_tpu.loaders.ktx import SUPERCOMPRESSION_ZLIB, write_ktx2
    from vktf_tpu.models.gltf_writer import GltfWriter
    from vktf_tpu.models.primitives import box_mesh

    directory.mkdir()
    rgba = np.random.default_rng(3).integers(0, 256, (16, 16, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    with tp._jax_native_mips(False):
        write_ktx2(directory / "base.ktx2", generate_mips(rgba, True), True,
                   SUPERCOMPRESSION_ZLIB)
    w = GltfWriter()
    texture = w.add_texture(w.add_image_uri("base.ktx2"), w.add_sampler())
    material = w.add_material(base_color_texture=texture, metallic_factor=0.1,
                              roughness_factor=0.6)
    mesh = w.add_mesh(box_mesh(), material=material)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(3, 1, 0), rotation=(0, 0.38, 0, 0.92)),
                 w.add_node(light=light, rotation=(-0.38, 0, 0, 0.92))])
    return w.write(directory / "box.gltf")


@pytest.mark.parametrize("msaa", [1, 4])
def test_game_main_frames_match_jax(msaa, tmp_path, monkeypatch):
    from PIL import Image

    import vktf_tpu.engine
    import vktf_tpu_torch.engine
    from vktf_tpu.game import main as jax_main
    from vktf_tpu_torch.game import main

    monkeypatch.setattr(vktf_tpu.engine, "DeltaTime", _FixedDeltaTime)
    monkeypatch.setattr(vktf_tpu_torch.engine, "DeltaTime", _FixedDeltaTime)
    path = str(_textured_box(tmp_path / "asset"))
    args = [path, "--width", "64", "--height", "48", "--msaa", str(msaa), "--frames", "3",
            "--display", "off"]
    assert main(args + ["--frame-dir", str(tmp_path / "port")], device="cpu") == 0
    with tp._jax_native_mips(False):
        assert jax_main(args + ["--backend", "pallas", "--frame-dir",
                                str(tmp_path / "jax")]) == 0
    got = sorted((tmp_path / "port").glob("frame_*.png"))
    want = sorted((tmp_path / "jax").glob("frame_*.png"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 5
    lit = []
    for g, w in zip(got, want):
        a = np.asarray(Image.open(g)).astype(np.int16)
        b = np.asarray(Image.open(w)).astype(np.int16)
        assert a.shape == b.shape == (48, 64, 4)
        diff = np.abs(a - b).max(axis=-1)
        assert diff.max() <= 1, (g.name, int(diff.max()))
        assert (diff > 0).mean() <= 5e-3, (g.name, float((diff > 0).mean()))
        lit.append((a[..., :3].max(axis=-1) > 0).mean())
    # the box is in view and the camera moves: the frames differ
    assert min(lit) > 0.05
    assert len({Image.open(g).tobytes() for g in got}) > 1


def test_still_key_writes_the_jax_viewers_rgb_still(tmp_path, monkeypatch):
    """'p' (KEY_P) saves still_00000.png at the start camera: an (H, W, 3)
    RGB PNG (colour type 2, no alpha plane), as the JAX viewer's, with the
    JAX viewer's pixels within the frame budget."""
    from PIL import Image

    import vktf_tpu.engine
    import vktf_tpu_torch.engine
    from vktf_tpu.config import RenderConfig as JaxConfig
    from vktf_tpu.game import start as jax_start
    from vktf_tpu.window import KEY_P as JAX_KEY_P, ScriptedInput as JaxScript
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.game import start
    from vktf_tpu_torch.window import KEY_P, ScriptedInput

    monkeypatch.setattr(vktf_tpu.engine, "DeltaTime", _FixedDeltaTime)
    monkeypatch.setattr(vktf_tpu_torch.engine, "DeltaTime", _FixedDeltaTime)
    path = str(_textured_box(tmp_path / "asset"))
    start([path], 64, 48, RenderConfig(width=64, height=48, msaa_samples=4),
          ScriptedInput([lambda window: window.press_key(KEY_P)]),
          frame_dir=tmp_path / "port", display=None, device="cpu")
    with tp._jax_native_mips(False):
        jax_start([path], 64, 48,
                  JaxConfig(width=64, height=48, msaa_samples=4, backend="pallas"),
                  JaxScript([lambda window: window.press_key(JAX_KEY_P)]),
                  frame_dir=tmp_path / "jax", display=None)
    got = Image.open(tmp_path / "port" / "still_00000.png")
    want = Image.open(tmp_path / "jax" / "still_00000.png")
    assert got.mode == want.mode == "RGB"
    a, b = np.asarray(got), np.asarray(want)
    assert a.shape == b.shape == (48, 64, 3)
    assert (a.max(axis=-1) > 0).mean() > 0.05  # the box is in view
    tp.assert_frames_close(np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0), (3, 48, 64))
