"""Decoded textures and mip-chain generation (numpy).

Counterpart of the numpy half of ``vktf_tpu/loaders/images.py``: a 2x2 box
filter in LINEAR space (sRGB payloads are linearized, filtered and
re-encoded), level n+1 sized max(floor(dim / 2), 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
    """Full mip chain from an RGBA8 base level, filtered in linear space."""
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
        levels.append(
            (np.clip(quantized, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    return levels


_WHITE = np.full((1, 1, 4), 255, np.uint8)
_FLAT_NORMAL = np.asarray([[[128, 128, 255, 255]]], np.uint8)


def default_texture_data(kind: str) -> TextureData:
    """1x1 defaults for a material slot without a texture: white for base
    color / metallic-roughness, +z for normals."""
    if kind == "normal":
        return TextureData(levels=[_FLAT_NORMAL.copy()], srgb=False)
    return TextureData(levels=[_WHITE.copy()], srgb=kind == "base_color")
