"""Present encoding: the frame as it leaves the device.

Counterpart of ``vktf_tpu/ops/present.py``. The shade kernel's packed
r | g << 8 | b << 16 pixels become the exact planar (3, H, W) uint8 frame,
cropped from the tile-padded framebuffer (``encode_rgb``). The frame program
then applies the configuration's encoder (``make_present_encoder``), on the
frame's device:

  * ``present_scale`` 2 or 4: a box downsample, the preview stream
    (``downsample_box``);
  * ``present_format="yuv420"``: BT.601 full-range YCbCr with 2x2-subsampled
    chroma, one flat uint8 tensor of 1.5 bytes per pixel
    (``encode_yuv420``).

Both halve or better the bytes a frame copies to the host. ``decode_present``
is the numpy inverse the Engine applies on the host before the window.
All of it is exact integer arithmetic (x256 fixed-point coefficients,
arithmetic right shifts on int32, floor division of non-negative sums, the
clip before the cast to uint8), so the device encode equals the JAX
package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vktf_tpu_torch.config import RenderConfig

# x256 fixed-point BT.601 full-range coefficients. Rows sum to 256 (luma) /
# 0 (chroma), so gray input yields Y == gray exactly and Cb == Cr == 128.
_YR, _YG, _YB = 77, 150, 29
_CBR, _CBG, _CBB = -43, -85, 128
_CRR, _CRG, _CRB = 128, -107, -21
# decode: x256 fixed point of 1.402 / (0.344136, 0.714136) / 1.772
_RCR = 359
_GCB, _GCR = 88, 183
_BCB = 454


def encode_rgb(packed: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """(padded_height * padded_width,) i32 packed pixels, row-major ->
    (3, height, width) uint8."""
    ph, pw = config.padded_height, config.padded_width
    img = packed.reshape(ph, pw)[:config.height, :config.width]
    return torch.stack([((img >> (8 * c)) & 0xFF).to(torch.uint8)
                        for c in range(3)])


def encoded_size(height: int, width: int) -> int:
    """Packed byte count of one yuv420 frame (H, W must be even)."""
    return height * width + 2 * (height // 2) * (width // 2)


def downsample_box(frame: torch.Tensor, scale: int) -> torch.Tensor:
    """Planar (3, H, W) uint8 -> (3, H/scale, W/scale) uint8 box average
    (exact integer, round half up) on the frame's device. scale must divide
    H and W."""
    if scale == 1:
        return frame
    c, h, w = frame.shape
    if h % scale or w % scale:
        raise ValueError(f"scale {scale} does not divide the frame {tuple(frame.shape)}")
    q = frame.to(torch.int32).reshape(c, h // scale, scale, w // scale, scale)
    n = scale * scale
    return torch.div(q.sum(dim=(2, 4), dtype=torch.int32) + n // 2, n,
                     rounding_mode="floor").to(torch.uint8)


def encode_yuv420(frame: torch.Tensor) -> torch.Tensor:
    """Planar (3, H, W) uint8 RGB -> packed (H*W*3//2,) uint8 [Y | Cb | Cr]
    on the frame's device. Chroma is computed from the 2x2 box-averaged RGB
    (rounding +2 >> 2), then converted."""
    c, h, w = frame.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"yuv420 needs a (3, even H, even W) frame, got {tuple(frame.shape)}")
    rgb = frame.to(torch.int32)
    r, g, b = rgb
    y = (_YR * r + _YG * g + _YB * b + 128) >> 8  # in [0, 255] by row sum
    # 2x2 box average of each channel (exact integer, round half up)
    r2, g2, b2 = (rgb.reshape(3, h // 2, 2, w // 2, 2).sum(dim=(2, 4), dtype=torch.int32)
                  + 2) >> 2
    cb = 128 + ((_CBR * r2 + _CBG * g2 + _CBB * b2 + 128) >> 8)
    cr = 128 + ((_CRR * r2 + _CRG * g2 + _CRB * b2 + 128) >> 8)
    return torch.cat([y.reshape(-1), cb.clamp(0, 255).reshape(-1),
                      cr.clamp(0, 255).reshape(-1)]).to(torch.uint8)


def make_present_encoder(config: RenderConfig):
    """The configuration's device-side encode of the cropped (3, H, W)
    frame: the preview downsample (present_scale), then the optional
    yuv420 pack."""
    scale = config.present_scale
    yuv = config.present_format == "yuv420"

    def encode(frame: torch.Tensor) -> torch.Tensor:
        out = downsample_box(frame, scale)
        return encode_yuv420(out) if yuv else out

    return encode


def upsample_nearest(frame: np.ndarray, scale: int, *, planar: bool = True) -> np.ndarray:
    """Host-side nearest upsample of a preview frame back to window size:
    planar=True upsamples a (C, H, W) frame's trailing two axes,
    planar=False an interleaved (H, W, C) frame's leading two."""
    if scale == 1:
        return frame
    axes = (-2, -1) if planar else (0, 1)
    out = np.repeat(frame, scale, axis=axes[0])
    return np.repeat(out, scale, axis=axes[1])


def decode_yuv420(packed: np.ndarray, height: int, width: int) -> np.ndarray:
    """Packed yuv420 bytes -> planar (3, H, W) uint8 RGB on the host. Chroma
    upsamples by 2x2 replication; gray content round-trips bit-exact."""
    n_y = height * width
    n_c = (height // 2) * (width // 2)
    if packed.size != n_y + 2 * n_c:
        raise ValueError(f"{packed.size} bytes is not a {height}x{width} yuv420 frame")
    y = packed[:n_y].reshape(height, width).astype(np.int32)
    cb = packed[n_y:n_y + n_c].reshape(height // 2, width // 2)
    cr = packed[n_y + n_c:].reshape(height // 2, width // 2)

    def up(ch):
        return np.repeat(np.repeat(ch, 2, axis=0), 2, axis=1).astype(np.int32) - 128

    cbu, cru = up(cb), up(cr)
    r = y + ((_RCR * cru + 128) >> 8)
    g = y - ((_GCB * cbu + _GCR * cru + 128) >> 8)
    b = y + ((_BCB * cbu + 128) >> 8)
    return np.clip(np.stack([r, g, b], axis=0), 0, 255).astype(np.uint8)


def decode_present(frame: np.ndarray, config: RenderConfig) -> np.ndarray:
    """Host-side inverse of make_present_encoder: the yuv decode at preview
    resolution, then the nearest upsample to the full window size."""
    scale = config.present_scale
    ph, pw = config.height // scale, config.width // scale
    if config.present_format == "yuv420":
        frame = decode_yuv420(frame, ph, pw)
    return upsample_nearest(frame, scale)
