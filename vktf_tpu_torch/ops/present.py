"""Present encoding: the exact planar RGB frame.

Counterpart of ``vktf_tpu/ops/present.py`` at ``present_format="rgb"``,
``present_scale=1`` (the only form the port renders): the shade kernel's
packed r | g << 8 | b << 16 pixels become a (3, H, W) uint8 frame, cropped
from the tile-padded framebuffer to the configured size.
"""

from __future__ import annotations

import torch

from vktf_tpu_torch.config import RenderConfig


def encode_rgb(packed: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """(padded_height * padded_width,) i32 packed pixels, row-major ->
    (3, height, width) uint8."""
    ph, pw = config.padded_height, config.padded_width
    img = packed.reshape(ph, pw)[:config.height, :config.width]
    return torch.stack([((img >> (8 * c)) & 0xFF).to(torch.uint8)
                        for c in range(3)])
