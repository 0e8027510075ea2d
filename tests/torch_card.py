"""Shared inputs of the port's card tests (tests/test_torch_cuda*.py), and
of the CPU tests that check them. Nothing here imports jax, so the card's
machine (no jax) can import it.

  * ``dev``: the card fixture (cuda:0), which skips where there is no
    CUDA device; the card test files import it;
  * ``quiet_log``: a Log that writes to memory;
  * ``FRAME_MISMATCH``: the budget of a small frame on the card against
    the CPU's plain versions, one u8 step on at most this share of pixels;
  * ``read_png``: the port's window's PNGs decoded with zlib (the card's
    machine has no PIL);
  * tests/test_alpha.py's fixtures written with the port's writer
    (``quad_over_box``, ``stacked_blend_scene``, ``ORACLE_FIXTURES``) and
    the oracle's budget, helpers.assert_images_close's defaults
    (``image_difference``, ``ORACLE_MAX_MEAN``, ``ORACLE_MAX_OUTLIERS``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest
import torch

FRAME_MISMATCH = 5e-3

ORACLE_MAX_MEAN = 2.0        # mean |diff| over the RGB values
ORACLE_MAX_OUTLIERS = 0.015  # share of pixels with a channel more than ...
ORACLE_OUTLIER_STEP = 8      # ... this many u8 steps apart
ORACLE_SIZE = (96, 64)
ORACLE_CAMERA = ((0.0, 0.6, 2.2), (0.0, -0.2, -1.0))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def quiet_log():
    import io

    from vktf_tpu_torch.log import Log

    return Log(io.StringIO(), io.StringIO())


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG as the port's window writes it (filter 0
    rows, window.write_png), decoded with zlib: (H, W, 3) or (H, W, 4)."""
    blob = path.read_bytes()
    pos, idat, size, channels = 8, b"", None, None
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        if kind == b"IHDR":
            size = struct.unpack(">II", blob[pos + 8:pos + 16])
            channels = {2: 3, 6: 4}[blob[pos + 17]]
        elif kind == b"IDAT":
            idat += blob[pos + 8:pos + 8 + length]
        pos += 12 + length
    width, height = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + channels * width)
    assert bool((rows[:, 0] == 0).all()), f"{path.name}: filtered rows"
    return rows[:, 1:].reshape(height, width, channels)


def quad_over_box(directory, front: dict, name: str):
    """tests/test_alpha.py's fixture, written with the port's writer: an
    alpha-tested or blended quad floating in front of an opaque box."""
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    w = GltfWriter()
    back = w.add_material(base_color_factor=(0.15, 0.6, 0.2, 1.0), metallic_factor=0.0,
                          roughness_factor=0.8)
    front_material = w.add_material(**front)
    mbox = w.add_mesh(box_mesh(0.6), material=back)
    mquad = w.add_mesh(plane_mesh(0.9), material=front_material)
    light = w.add_light("point", color=(6.0, 6.0, 6.0))
    sun = w.add_light("directional", color=(0.6, 0.6, 0.6))
    w.add_scene([
        w.add_node(mesh=mbox, translation=(0.0, 0.3, -0.6)),
        w.add_node(mesh=mquad, translation=(0.1, 0.35, 0.45),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        w.add_node(light=light, translation=(1.2, 1.5, 2.0)),
        w.add_node(light=sun, rotation=(0.2, 0.1, 0.0, 0.97)),
    ])
    return w.write(directory / name)


def stacked_blend_scene(directory, name: str = "stack.gltf", n_quads: int = 3,
                        dz: float = 0.2):
    """tests/test_alpha.py's stack of BLEND quads in front of an opaque box,
    written with the port's writer."""
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    w = GltfWriter()
    back = w.add_material(base_color_factor=(0.15, 0.6, 0.2, 1.0), metallic_factor=0.0,
                          roughness_factor=0.8)
    colors = ((0.9, 0.2, 0.2, 0.45), (0.2, 0.3, 0.9, 0.5), (0.9, 0.8, 0.2, 0.4),
              (0.2, 0.9, 0.6, 0.5), (0.7, 0.2, 0.9, 0.45), (0.9, 0.5, 0.2, 0.5),
              (0.3, 0.8, 0.9, 0.4), (0.8, 0.3, 0.5, 0.5), (0.4, 0.6, 0.3, 0.45))
    quads = [w.add_material(base_color_factor=c, metallic_factor=0.0, roughness_factor=0.5,
                            alpha_mode="BLEND") for c in colors[:n_quads]]
    mbox = w.add_mesh(box_mesh(0.6), material=back)
    meshes = [w.add_mesh(plane_mesh(0.9), material=m) for m in quads]
    light = w.add_light("point", color=(6.0, 6.0, 6.0))
    sun = w.add_light("directional", color=(0.6, 0.6, 0.6))
    nodes = [
        w.add_node(mesh=mbox, translation=(0.0, 0.3, -0.6)),
        w.add_node(light=light, translation=(1.2, 1.5, 2.0)),
        w.add_node(light=sun, rotation=(0.2, 0.1, 0.0, 0.97)),
    ]
    for i, mq in enumerate(meshes):
        nodes.append(w.add_node(mesh=mq, translation=(0.1 - 0.05 * i, 0.35, 0.45 - dz * i),
                                rotation=(0.7071068, 0.0, 0.0, 0.7071068)))
    w.add_scene(nodes)
    return w.write(directory / name)


# (tag, fixture, MSAA samples): tests/test_alpha.py's five frames
OPAQUE_FRONT = dict(base_color_factor=(0.9, 0.25, 0.2, 1.0), metallic_factor=0.0,
                    roughness_factor=0.5)
BLEND_FRONT = dict(base_color_factor=(0.9, 0.25, 0.2, 0.45), metallic_factor=0.0,
                   roughness_factor=0.5, alpha_mode="BLEND")
ORACLE_FIXTURES = (
    ("opaque_1x", lambda d: quad_over_box(d, OPAQUE_FRONT, "opaque.gltf"), 1),
    ("opaque_4x", lambda d: quad_over_box(d, OPAQUE_FRONT, "opaque.gltf"), 4),
    ("blend_1x", lambda d: quad_over_box(d, BLEND_FRONT, "blend.gltf"), 1),
    ("blend_4x", lambda d: quad_over_box(d, BLEND_FRONT, "blend.gltf"), 4),
    ("stack_1x", stacked_blend_scene, 1),
)


def image_difference(produced: np.ndarray, expected: np.ndarray) -> tuple[float, float]:
    """(mean |diff| of the RGB values, share of pixels with a channel more
    than ORACLE_OUTLIER_STEP apart) of two (H, W, >= 3) u8 images, as
    tests/helpers.assert_images_close measures them."""
    diff = np.abs(produced[..., :3].astype(np.int32) - expected[..., :3].astype(np.int32))
    return float(diff.mean()), float((diff.max(axis=-1) > ORACLE_OUTLIER_STEP).mean())
