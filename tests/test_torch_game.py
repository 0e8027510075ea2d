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
