"""Texture decode and mip-chain generation (numpy).

Counterpart of ``vktf_tpu/loaders/images.py``: glTF texture sources become
RGBA8 mip chains, KTX2 through ``loaders/ktx.py`` and PNG/JPEG through PIL.
Missing mip levels come from a 2x2 box filter in LINEAR space (sRGB
payloads are linearized, filtered and re-encoded), level n+1 sized
max(floor(dim / 2), 1).
"""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path
from typing import TYPE_CHECKING, Optional

import numpy as np

from vktf_tpu_torch import native
from vktf_tpu_torch.loaders.ktx import KtxCodecError, KtxError, parse_ktx2
from vktf_tpu_torch.log import Log, default_log

if TYPE_CHECKING:
    from vktf_tpu_torch.loaders.gltf import Texture

_KTX2_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"


@dataclasses.dataclass
class TextureData:
    """Decoded texture ready for pool packing."""

    levels: list[np.ndarray]  # RGBA8, level 0 first
    srgb: bool


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """sRGB EOTF (float in [0, 1])."""
    return np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(
        linear <= 0.0031308, linear * 12.92,
        1.055 * np.power(linear, 1.0 / 2.4) - 0.055,
    )


def quantize_u8(values: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> u8, rounded half up (values outside clamp)."""
    return (np.clip(values, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _halve(level: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample, edge-clamped taps, floor-sized output."""
    h, w = level.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    y0 = np.minimum(2 * np.arange(nh), h - 1)
    y1 = np.minimum(2 * np.arange(nh) + 1, h - 1)
    x0 = np.minimum(2 * np.arange(nw), w - 1)
    x1 = np.minimum(2 * np.arange(nw) + 1, w - 1)
    return 0.25 * (
        level[y0][:, x0] + level[y1][:, x0] + level[y0][:, x1]
        + level[y1][:, x1]
    )


def generate_mips(base: np.ndarray, srgb: bool) -> list[np.ndarray]:
    """Full mip chain from an RGBA8 base level, filtered in linear space:
    the native runtime's when it is built (``vktf_tpu_torch.native``, equal
    bit for bit), numpy's otherwise."""
    native_levels = native.generate_mips(base, srgb)
    if native_levels is not None:
        return native_levels
    levels = [np.ascontiguousarray(base, np.uint8)]
    current = base.astype(np.float32) / 255.0
    if srgb:
        rgb_linear = srgb_to_linear(current[..., :3])
        current = np.concatenate([rgb_linear, current[..., 3:]], axis=-1)
    while current.shape[0] > 1 or current.shape[1] > 1:
        current = _halve(current)
        quantized = current
        if srgb:
            quantized = np.concatenate(
                [linear_to_srgb(current[..., :3]), current[..., 3:]], axis=-1
            )
        levels.append(quantize_u8(quantized))
    return levels


_WHITE = np.full((1, 1, 4), 255, np.uint8)
_FLAT_NORMAL = np.asarray([[[128, 128, 255, 255]]], np.uint8)


def default_texture_data(kind: str) -> TextureData:
    """1x1 defaults for a material slot without a texture: white for base
    color / metallic-roughness, +z for normals."""
    if kind == "normal":
        return TextureData(levels=[_FLAT_NORMAL.copy()], srgb=False)
    return TextureData(levels=[_WHITE.copy()], srgb=kind == "base_color")


def decode_texture(texture: Optional["Texture"], kind: str,
                   log: Optional[Log] = None) -> Optional[TextureData]:
    """Decode a glTF texture source to an RGBA8 mip chain.

    kind: "base_color" (sRGB), "metallic_roughness" or "normal" (linear).
    A texture that already carries its decoded chain (``Texture.decoded``,
    as the procedural presets build them) returns it. Returns None, with a
    logged error, when the source is missing or undecodable; callers apply
    the reference's logged default (model.cppm:368-409). A codec this
    installation lacks (ZSTD without the native runtime or ``zstandard``,
    PNG/JPEG without PIL) raises instead: that is no fault of the file.
    """
    log = log or default_log()
    if texture is None:
        return None
    if texture.decoded is not None:
        return texture.decoded
    srgb_hint = kind == "base_color"

    blob: Optional[bytes] = None
    name = texture.name or "<texture>"
    if texture.data is not None:
        blob = texture.data
    elif texture.filepath is not None:
        name = str(texture.filepath)
        try:
            blob = Path(texture.filepath).read_bytes()
        except OSError:
            log.error(f"Failed to read texture file {name}")
            return None
    if blob is None:
        log.error(f"Texture {name} has no data source")
        return None

    if blob[:12] == _KTX2_IDENTIFIER:
        try:
            ktx = parse_ktx2(blob, name=name, log=log)
        except KtxCodecError:
            raise
        except KtxError as error:
            # a malformed .ktx2 inside a scene takes the logged default
            # (model.cppm:301-321) instead of aborting the whole load
            log.error(f"Failed to parse KTX texture {name}: {error}")
            return None
        if ktx is None:
            return None
        levels = ktx.levels
        if len(levels) == 1:
            levels = generate_mips(levels[0], ktx.srgb)
        return TextureData(levels=levels, srgb=ktx.srgb)

    try:
        from PIL import Image
    except ImportError as error:
        raise ModuleNotFoundError(
            f"texture {name} is PNG/JPEG, whose decode needs PIL (Pillow), "
            "which is not installed; KTX2 textures need no PIL") from error
    try:
        with Image.open(io.BytesIO(blob)) as img:
            base = np.asarray(img.convert("RGBA"), np.uint8)
    except Exception as error:  # PIL's decode errors have no common base
        log.error(f"Failed to decode texture image {name}: {error}")
        return None
    return TextureData(levels=generate_mips(base, srgb_hint), srgb=srgb_hint)
