"""Render configuration of the PyTorch + CUDA port.

The counterpart of ``vktf_tpu/config.py`` for what the port renders:
pixel- or sample-rate shading, K = 1..8 depth-peel layers (one for opaque
scenes, the scene's estimate or ``peel_layers`` for MASK/BLEND ones), every
texture configuration of the JAX frame program (the fused-mip or two-gather
pool, per-slot samplers, 1/2/4/8 anisotropic taps, the attrs boundary) and
the present encodings (the exact planar RGB frame, the yuv420 pack and the
2x/4x preview downsample). Only the fields this pipeline honours exist
here, and an explicit value it cannot honour raises instead of falling
back silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Frames in flight; the reference pipelines 2 frames via fences/semaphores
# (src/engine/engine.cppm:40). Engine.render waits for a frame only once
# this many are outstanding.
MAX_RENDER_FRAMES = 2

_SUPPORTED_MSAA = (8, 4, 2, 1)


def select_msaa_samples(requested: int) -> int:
    """The highest supported MSAA count <= requested, else 1: the
    reference's "max supported of {8, 4, 2} else 1" probe
    (src/engine/engine.cppm:157-171); the raster takes all of them."""
    for samples in _SUPPORTED_MSAA:
        if requested >= samples:
            return samples
    return 1

# anisotropic tap counts the shade kernels take (1/N exact in float32)
ANISO_TAPS = (1, 2, 4, 8)

# The raster kernel keeps at most this many nearest fragments per sample.
PEEL_LAYERS_MAX = 8

# Vulkan standard sample locations (pixel-relative), spec table "Standard
# sample locations" — the same table as vktf_tpu/ops/raster_xla.py.
SAMPLE_OFFSETS = {
    1: ((0.5, 0.5),),
    2: ((0.75, 0.75), (0.25, 0.25)),
    4: ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)),
    8: (
        (0.5625, 0.3125),
        (0.4375, 0.6875),
        (0.8125, 0.5625),
        (0.3125, 0.1875),
        (0.1875, 0.8125),
        (0.0625, 0.4375),
        (0.6875, 0.9375),
        (0.9375, 0.0625),
    ),
}

# Pixel block one CUDA raster thread block owns; tile dimensions must be
# multiples of it.
RASTER_BLOCK = (16, 16)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration."""

    width: int = 1920
    height: int = 1080
    msaa_samples: int = 4
    # Framebuffer tile (height, width) in pixels: the frame is rasterized
    # padded to a whole number of tiles and cropped at present.
    tile_shape: Tuple[int, int] = (64, 128)
    # Triangles per raster stream chunk (the unit of the chunk-bbox skip and
    # of the CUDA raster kernel's shared-memory staging): 256 only.
    pallas_chunk: int = 256
    # Sampler anisotropy as single-tap LOD sharpening (1.0 = isotropic).
    max_anisotropy: float = 16.0
    # True multi-tap anisotropic filtering: 1 = the LOD sharpening above
    # alone; 2/4/8 = N taps along the major footprint axis, each with its
    # own pool rows, averaged before the BRDF (the reference sampler's
    # anisotropy, model.cppm:261-275). Runs on whichever texel source the
    # scene takes.
    aniso_taps: int = 1
    # Texel pool form. None = auto: the fused-mip form (one pool row per
    # pixel serves both trilinear levels). False forces the two-gather form
    # (one row per level). Mirror-wrap and mixed-sampler scenes always take
    # the two-gather form (resolved_fused_pool): True cannot force it.
    shade_fused_pool: Optional[bool] = None
    # Attrs boundary: evaluate planes and addressing once per pixel into 28
    # attribute rows (plain torch), then shade from them in the attrs
    # kernels (two-gather pool, one tap). Off by default: the frame is the
    # same, and on the card phase A's rows cost more than they save
    # (PERF.md). With aniso_taps > 1 or mixed samplers the frame takes the
    # two-gather multi-tap or per-slot form instead, as the JAX frame
    # program does.
    shade_attrs_boundary: bool = False
    clear_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # Relative view-projection change (Frobenius) above which the cached
    # Morton stream permutation is recomputed; 0 re-sorts every frame.
    resort_threshold: float = 0.03
    # Depth-peel layer count. None = the scene's estimate
    # (SceneMeta.peel_layers: 1 + translucent instances, at most
    # PEEL_LAYERS_MAX); an explicit 1..8 forces K.
    peel_layers: Optional[int] = None
    # "pixel": shade once per pixel at its centre and resolve by sample
    # coverage; "sample": shade every MSAA sample at its own position,
    # composite each, then average over the samples.
    shading_rate: str = "pixel"
    # Device-side present encoding (ops/present.py): "rgb" the planar
    # (3, H, W) u8 frame, "yuv420" the packed BT.601 4:2:0 bytes.
    present_format: str = "rgb"
    # Preview stream: a box downsample of the presented frame by 1, 2 or 4
    # (Scene.render_still still returns the exact full-size frame).
    present_scale: int = 1

    def __post_init__(self) -> None:
        if self.msaa_samples not in _SUPPORTED_MSAA:
            raise ValueError(f"msaa_samples must be one of {_SUPPORTED_MSAA}, "
                             f"got {self.msaa_samples}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("render target must be non-empty")
        if self.shading_rate not in ("pixel", "sample"):
            raise ValueError(f"unknown shading_rate {self.shading_rate!r}")
        if self.present_format not in ("rgb", "yuv420"):
            raise ValueError(f"unknown present_format {self.present_format!r}")
        if self.present_scale not in (1, 2, 4):
            raise ValueError(f"present_scale must be 1, 2 or 4, got {self.present_scale}")
        if self.width % self.present_scale or self.height % self.present_scale:
            raise ValueError("present_scale must divide the frame dimensions, got "
                             f"{self.width}x{self.height} / {self.present_scale}")
        if self.present_format == "yuv420" and (
                (self.width // self.present_scale) % 2
                or (self.height // self.present_scale) % 2):
            raise ValueError("yuv420 present requires even (preview) width and height")
        th, tw = self.tile_shape
        bh, bw = RASTER_BLOCK
        if th <= 0 or tw <= 0 or th % bh or tw % bw:
            raise ValueError(f"tile_shape must be positive multiples of "
                             f"{RASTER_BLOCK}, got {self.tile_shape}")
        if self.pallas_chunk != 256:
            raise ValueError(f"pallas_chunk={self.pallas_chunk} is not ported; "
                             "the raster kernel stages 256-triangle chunks")
        if self.max_anisotropy < 1.0:
            raise ValueError("max_anisotropy must be >= 1")
        if self.aniso_taps not in ANISO_TAPS:
            raise ValueError(f"aniso_taps must be 1, 2, 4 or 8, got {self.aniso_taps}")
        if self.peel_layers is not None and not 1 <= self.peel_layers <= PEEL_LAYERS_MAX:
            raise ValueError(f"peel_layers must be None or 1..{PEEL_LAYERS_MAX}, "
                             f"got {self.peel_layers}")

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_shape[0])

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_shape[1])

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_shape[0]

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_shape[1]

    def resolved_peel_layers(self, scene_layers: int) -> int:
        """Effective depth-peel K: the explicit override, else the scene's
        estimate."""
        return self.peel_layers if self.peel_layers is not None else scene_layers

    def resolved_fused_pool(self, *, mirror_wrap: bool = False,
                            mixed_samplers: bool = False) -> bool:
        """The fused-mip pool form unless the scene makes it inexact: mirror
        wrap (the l+1 footprint can leave slot B's window) or per-slot
        samplers (each texture needs its own rows). The flag cannot force
        the fused form on for such scenes; it can force it off."""
        if mirror_wrap or mixed_samplers:
            return False
        if self.shade_fused_pool is not None:
            return self.shade_fused_pool
        return True

    def replace(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)
