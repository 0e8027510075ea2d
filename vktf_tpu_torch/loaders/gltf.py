"""glTF 2.0 scene structures (the element dataclasses of
``vktf_tpu/loaders/gltf.py``).

The file parser is not ported yet; procedural assets (``models/scenes.py``)
build these directly. One difference from the JAX package: a ``Texture``
carries its DECODED mip chain (``images.TextureData``) rather than encoded
KTX2 bytes, so building a scene needs no zstd codec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from vktf_tpu_torch.loaders.images import TextureData

NEAREST, LINEAR = "nearest", "linear"
REPEAT, CLAMP_TO_EDGE, MIRRORED_REPEAT = "repeat", "clamp_to_edge", "mirrored_repeat"


@dataclasses.dataclass
class Sampler:
    name: Optional[str] = None
    mag_filter: str = LINEAR
    min_filter: str = LINEAR
    mipmap_mode: str = LINEAR
    wrap_u: str = REPEAT
    wrap_v: str = REPEAT


@dataclasses.dataclass
class Texture:
    """Decoded image (full RGBA8 mip chain) + sampler."""

    name: Optional[str] = None
    data: Optional[TextureData] = None
    sampler: Optional[Sampler] = None


@dataclasses.dataclass
class PbrMetallicRoughness:
    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    base_color_texture: Optional[Texture] = None
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    metallic_roughness_texture: Optional[Texture] = None


@dataclasses.dataclass
class Material:
    name: Optional[str] = None
    pbr_metallic_roughness: Optional[PbrMetallicRoughness] = None
    normal_scale: float = 1.0
    normal_texture: Optional[Texture] = None
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    double_sided: bool = False


@dataclasses.dataclass
class Primitive:
    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (T, 3) u32
    normals: Optional[np.ndarray] = None  # (V, 3) f32
    tangents: Optional[np.ndarray] = None  # (V, 4) f32
    uvs: Optional[np.ndarray] = None  # (V, 2) f32
    material: Optional[Material] = None
    aabb: Optional[np.ndarray] = None  # (2, 3)


@dataclasses.dataclass
class Mesh:
    name: Optional[str] = None
    primitives: list[Primitive] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Light:
    name: Optional[str] = None
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    type: str = "directional"  # "directional" | "point"


@dataclasses.dataclass
class Node:
    name: Optional[str] = None
    local_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    mesh: Optional[int] = None
    light: Optional[int] = None
    children: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Scene:
    name: Optional[str] = None
    root_nodes: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Asset:
    name: str
    samplers: list[Sampler] = dataclasses.field(default_factory=list)
    textures: list[Texture] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(default_factory=list)
    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    lights: list[Light] = dataclasses.field(default_factory=list)
    nodes: list[Node] = dataclasses.field(default_factory=list)
    scenes: list[Scene] = dataclasses.field(default_factory=list)
    default_scene: Optional[int] = None
