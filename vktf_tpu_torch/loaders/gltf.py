"""Data-oriented glTF 2.0 loader.

The port's copy of ``vktf_tpu/loaders/gltf.py``, in numpy as there. One
field more: ``Texture.decoded`` carries an already decoded mip chain (the
procedural presets build their textures so), which texture decode takes
as it is; a loaded file fills the image source fields instead.

A re-design of the reference asset loader
(reference: src/engine/gltf_asset.cppm:276-982, which wraps cgltf): a pure
-CPU parse of .gltf/.glb producing **SoA numpy arrays** instead of pointer
graphs — positions/normals/tangents/uvs as float32 arrays, indices as uint32
triangles, a flat material table, and topologically-ordered node arrays with
parent indices (SURVEY.md §7 architecture stance).

Error policy mirrors the reference exactly (SURVEY.md §5.3): fatal problems
raise ``GltfError`` (nested-context messages), while unsupported features are
skipped with a logged error — non-triangle primitives
(gltf_asset.cppm:807-813), unsupported light types (gltf_asset.cppm:846-857),
missing attributes (validated later at scene build, model.cppm:531-584).

Supported beyond the reference's cgltf surface: embedded base64 data URIs,
GLB containers, and sparse accessors.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
import urllib.parse
from pathlib import Path
from typing import Optional

import numpy as np

from vktf_tpu_torch import native
from vktf_tpu_torch.loaders.images import TextureData
from vktf_tpu_torch.log import Log, default_log


class GltfError(RuntimeError):
    """Fatal glTF load error (analogue of the reference's nested runtime_error)."""


# ---------------------------------------------------------------------------
# Element structures (SoA where it matters)
# ---------------------------------------------------------------------------

# Filter / wrap enums are kept as small strings; the renderer maps them to
# sampling-kernel parameters (the analogue of vk::Filter/vk::SamplerAddressMode
# built in gltf_asset.cppm:484-556).
NEAREST, LINEAR = "nearest", "linear"
REPEAT, CLAMP_TO_EDGE, MIRRORED_REPEAT = "repeat", "clamp_to_edge", "mirrored_repeat"

_MAG_FILTERS = {9728: NEAREST, 9729: LINEAR}
_MIN_FILTERS = {
    9728: (NEAREST, NEAREST),  # NEAREST
    9729: (LINEAR, LINEAR),  # LINEAR
    9984: (NEAREST, NEAREST),  # NEAREST_MIPMAP_NEAREST
    9985: (LINEAR, NEAREST),  # LINEAR_MIPMAP_NEAREST
    9986: (NEAREST, LINEAR),  # NEAREST_MIPMAP_LINEAR
    9987: (LINEAR, LINEAR),  # LINEAR_MIPMAP_LINEAR
}
_WRAP_MODES = {33071: CLAMP_TO_EDGE, 33648: MIRRORED_REPEAT, 10497: REPEAT}


@dataclasses.dataclass
class Sampler:
    """glTF sampler state (reference: gltf::Sampler, gltf_asset.cppm:34-52)."""

    name: Optional[str] = None
    mag_filter: str = LINEAR
    min_filter: str = LINEAR
    mipmap_mode: str = LINEAR
    wrap_u: str = REPEAT
    wrap_v: str = REPEAT


@dataclasses.dataclass
class Texture:
    """Texture = image source + sampler (reference: gltf_asset.cppm:58-70).

    ``filepath`` points at the image payload (ktx2/png/jpg); ``data`` holds
    embedded bytes when the source was a data URI or GLB buffer view;
    ``decoded`` holds a decoded mip chain in place of a source.
    """

    name: Optional[str] = None
    filepath: Optional[Path] = None
    data: Optional[bytes] = None
    mime_type: Optional[str] = None
    sampler: Optional[Sampler] = None
    decoded: Optional[TextureData] = None


@dataclasses.dataclass
class PbrMetallicRoughness:
    """PBR MR factors + textures (reference: gltf_asset.cppm:73-101)."""

    base_color_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    base_color_texture: Optional[Texture] = None
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    metallic_roughness_texture: Optional[Texture] = None


@dataclasses.dataclass
class Material:
    """Material (reference: gltf_asset.cppm:104-121). Alpha mode is stored
    though the reference shader ignores it (fragment.glsl TODO)."""

    name: Optional[str] = None
    pbr_metallic_roughness: Optional[PbrMetallicRoughness] = None
    normal_scale: float = 1.0
    normal_texture: Optional[Texture] = None
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    double_sided: bool = False


@dataclasses.dataclass
class Primitive:
    """One triangle-list draw: SoA vertex attributes + u32 triangle indices.

    The reference keeps per-attribute vectors then interleaves into AoS
    ``Vertex`` (mesh.cppm:22-40, model.cppm:516-608); the TPU build stays SoA
    so attributes upload directly as device arrays.
    """

    positions: np.ndarray  # (V,3) f32
    indices: np.ndarray  # (T,3) u32 — always present (generated if absent)
    normals: Optional[np.ndarray] = None  # (V,3) f32
    tangents: Optional[np.ndarray] = None  # (V,4) f32
    uvs: Optional[np.ndarray] = None  # (V,2) f32
    material: Optional[Material] = None
    aabb: Optional[np.ndarray] = None  # (2,3) from accessor min/max


@dataclasses.dataclass
class Mesh:
    name: Optional[str] = None
    primitives: list[Primitive] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Light:
    """Punctual light (reference: gltf_asset.cppm:846-872): directional or
    point; color only — intensity is not consumed by the reference shader."""

    name: Optional[str] = None
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    type: str = "directional"  # "directional" | "point"


@dataclasses.dataclass
class Node:
    """Scene-graph node in flat index form (children as indices, not pointers)."""

    name: Optional[str] = None
    local_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    mesh: Optional[int] = None  # index into Asset.meshes
    light: Optional[int] = None  # index into Asset.lights
    children: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Scene:
    name: Optional[str] = None
    root_nodes: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Asset:
    """Parsed glTF asset (reference: gltf::Asset, gltf_asset.cppm:276-303)."""

    name: str
    samplers: list[Sampler] = dataclasses.field(default_factory=list)
    textures: list[Texture] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(default_factory=list)
    meshes: list[Mesh] = dataclasses.field(default_factory=list)
    lights: list[Light] = dataclasses.field(default_factory=list)
    nodes: list[Node] = dataclasses.field(default_factory=list)
    scenes: list[Scene] = dataclasses.field(default_factory=list)
    default_scene: Optional[int] = None


# ---------------------------------------------------------------------------
# Binary payload handling
# ---------------------------------------------------------------------------

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}
# normalized integer -> float scale factors per glTF 2.0 spec
_NORMALIZE_SCALE = {
    np.dtype(np.int8): 127.0,
    np.dtype(np.uint8): 255.0,
    np.dtype(np.int16): 32767.0,
    np.dtype(np.uint16): 65535.0,
}


def _decode_uri(uri: str, base_dir: Path) -> bytes:
    if uri.startswith("data:"):
        header, _, payload = uri.partition(",")
        if ";base64" not in header:
            raise GltfError(f"unsupported data URI encoding in {header!r}")
        return base64.b64decode(payload)
    path = base_dir / urllib.parse.unquote(uri)
    try:
        return path.read_bytes()
    except OSError as e:
        raise GltfError(f"failed to read buffer {path}") from e


class _BufferCache:
    def __init__(self, gltf: dict, base_dir: Path, glb_chunk: Optional[bytes]):
        self._defs = gltf.get("buffers", [])
        self._base_dir = base_dir
        self._glb_chunk = glb_chunk
        self._cache: dict[int, bytes] = {}

    def get(self, index: int) -> bytes:
        if index not in self._cache:
            buffer_def = self._defs[index]
            uri = buffer_def.get("uri")
            if uri is None:
                if self._glb_chunk is None:
                    raise GltfError(f"buffer {index} has no URI and no GLB binary chunk")
                data = self._glb_chunk
            else:
                data = _decode_uri(uri, self._base_dir)
            length = buffer_def.get("byteLength", len(data))
            if len(data) < length:
                raise GltfError(f"buffer {index}: expected {length} bytes, got {len(data)}")
            self._cache[index] = data[:length]
        return self._cache[index]


def _buffer_view_bytes(gltf: dict, buffers: _BufferCache, view_index: int) -> tuple[bytes, int]:
    view = gltf["bufferViews"][view_index]
    data = buffers.get(view["buffer"])
    offset = view.get("byteOffset", 0)
    length = view["byteLength"]
    return data[offset : offset + length], view.get("byteStride", 0)


def read_accessor(gltf: dict, buffers: _BufferCache, accessor_index: int) -> np.ndarray:
    """Unpack an accessor to (count, components) in its native dtype.

    Covers strided buffer views and sparse accessors (the role of
    cgltf_accessor_unpack_floats in gltf_asset.cppm:665-677). Normalization is
    applied by the caller via :func:`accessor_to_float` when needed.
    """
    accessor = gltf["accessors"][accessor_index]
    dtype = np.dtype(_COMPONENT_DTYPES[accessor["componentType"]])
    count = accessor["count"]
    if not isinstance(count, int) or count < 0:
        # numpy would read a negative count as "the whole view"
        raise GltfError(f"accessor {accessor_index} has an invalid count {count!r}")
    ncomp = _TYPE_COUNTS[accessor["type"]]
    elem_size = dtype.itemsize * ncomp

    if "bufferView" in accessor:
        raw, stride = _buffer_view_bytes(gltf, buffers, accessor["bufferView"])
        offset = accessor.get("byteOffset", 0)
        if stride and stride != elem_size:
            rows = np.frombuffer(raw, dtype=np.uint8)
            idx = offset + stride * np.arange(count)[:, None] + np.arange(elem_size)[None, :]
            out = rows[idx].copy().view(dtype).reshape(count, ncomp)
        else:
            out = (
                np.frombuffer(raw, dtype=dtype, count=count * ncomp, offset=offset)
                .reshape(count, ncomp)
                .copy()
            )
    else:
        out = np.zeros((count, ncomp), dtype=dtype)  # spec: zero-filled when absent

    sparse = accessor.get("sparse")
    if sparse:
        n = sparse["count"]
        idx_info = sparse["indices"]
        idx_raw, _ = _buffer_view_bytes(gltf, buffers, idx_info["bufferView"])
        idx_dtype = np.dtype(_COMPONENT_DTYPES[idx_info["componentType"]])
        indices = np.frombuffer(
            idx_raw, dtype=idx_dtype, count=n, offset=idx_info.get("byteOffset", 0)
        ).astype(np.int64)
        val_info = sparse["values"]
        val_raw, _ = _buffer_view_bytes(gltf, buffers, val_info["bufferView"])
        values = np.frombuffer(
            val_raw, dtype=dtype, count=n * ncomp, offset=val_info.get("byteOffset", 0)
        ).reshape(n, ncomp)
        out[indices] = values
    return out


def accessor_to_float(gltf: dict, buffers: _BufferCache, accessor_index: int) -> np.ndarray:
    """Accessor -> float32 (count, components), honoring `normalized`.

    A plain (non-sparse) accessor whose offset and stride are sane integers
    and whose elements lie inside its buffer view takes the native runtime's
    unpack when it is built (``vktf_tpu_torch.native.unpack_accessor``, equal
    bit for bit); every other one, and every accessor without the runtime,
    numpy's, which raises or stays inside the view on hostile fields."""
    accessor = gltf["accessors"][accessor_index]
    count = accessor["count"]
    if ("bufferView" in accessor and not accessor.get("sparse")
            and isinstance(count, int) and count > 0):
        ncomp = _TYPE_COUNTS[accessor["type"]]
        elem_size = np.dtype(_COMPONENT_DTYPES[accessor["componentType"]]).itemsize * ncomp
        raw_bytes, stride = _buffer_view_bytes(gltf, buffers, accessor["bufferView"])
        offset = accessor.get("byteOffset", 0)
        stride = stride or elem_size  # 0 or absent: tightly packed
        sane = (isinstance(offset, int) and isinstance(stride, int)
                and offset >= 0 and stride >= elem_size)
        end = offset + stride * (count - 1) + elem_size if sane else -1
        if sane and end <= len(raw_bytes):
            out = native.unpack_accessor(raw_bytes[offset:end], count, ncomp,
                                         accessor["componentType"],
                                         bool(accessor.get("normalized")), stride)
            if out is not None:
                return out
    raw = read_accessor(gltf, buffers, accessor_index)
    out = raw.astype(np.float32)
    if accessor.get("normalized") and raw.dtype in _NORMALIZE_SCALE:
        scale = _NORMALIZE_SCALE[raw.dtype]
        out = out / scale
        if raw.dtype in (np.dtype(np.int8), np.dtype(np.int16)):
            out = np.maximum(out, -1.0)
    return out


# ---------------------------------------------------------------------------
# GLB container
# ---------------------------------------------------------------------------

_GLB_MAGIC = 0x46546C67  # 'glTF'


def _parse_glb(blob: bytes) -> tuple[dict, Optional[bytes]]:
    if len(blob) < 12:  # header: magic, version, length (truncation fuzz)
        raise GltfError("GLB truncated: missing 12-byte header")
    magic, version, _length = struct.unpack_from("<III", blob, 0)
    if magic != _GLB_MAGIC:
        raise GltfError("not a GLB container")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json: Optional[dict] = None
    binary: Optional[bytes] = None
    while offset + 8 <= len(blob):
        chunk_len, chunk_type = struct.unpack_from("<II", blob, offset)
        offset += 8
        chunk = blob[offset : offset + chunk_len]
        if len(chunk) < chunk_len:
            raise GltfError(
                f"GLB truncated: chunk needs {chunk_len} bytes, "
                f"{len(chunk)} remain"
            )
        offset += chunk_len + (-chunk_len % 4)
        if chunk_type == 0x4E4F534A:  # 'JSON'
            try:
                gltf_json = json.loads(chunk)
            except ValueError as error:
                raise GltfError("GLB JSON chunk is corrupt") from error
            if not isinstance(gltf_json, dict):
                raise GltfError("GLB JSON chunk is not an object")
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            binary = chunk
    if gltf_json is None:
        raise GltfError("GLB missing JSON chunk")
    return gltf_json, binary


# ---------------------------------------------------------------------------
# Element construction
# ---------------------------------------------------------------------------


def _build_samplers(gltf: dict) -> list[Sampler]:
    samplers = []
    for s in gltf.get("samplers", []):
        min_filter, mipmap = _MIN_FILTERS.get(s.get("minFilter", 9987), (LINEAR, LINEAR))
        samplers.append(
            Sampler(
                name=s.get("name"),
                mag_filter=_MAG_FILTERS.get(s.get("magFilter", 9729), LINEAR),
                min_filter=min_filter,
                mipmap_mode=mipmap,
                wrap_u=_WRAP_MODES.get(s.get("wrapS", 10497), REPEAT),
                wrap_v=_WRAP_MODES.get(s.get("wrapT", 10497), REPEAT),
            )
        )
    return samplers


_DEFAULT_SAMPLER = Sampler()


def _build_textures(
    gltf: dict, samplers: list[Sampler], base_dir: Path, buffers: _BufferCache, log: Log
) -> list[Texture]:
    """Build textures, preferring the KHR_texture_basisu (KTX2) source like
    the reference (gltf_asset.cppm:580-601)."""
    images = gltf.get("images", [])
    textures: list[Texture] = []
    for t in gltf.get("textures", []):
        image_index = t.get("extensions", {}).get("KHR_texture_basisu", {}).get("source")
        if image_index is None:
            image_index = t.get("source")
        filepath = data = mime = None
        if image_index is not None and image_index < len(images):
            image = images[image_index]
            mime = image.get("mimeType")
            uri = image.get("uri")
            if uri is not None:
                if uri.startswith("data:"):
                    data = _decode_uri(uri, base_dir)
                else:
                    filepath = base_dir / urllib.parse.unquote(uri)
            elif "bufferView" in image:
                data = _buffer_view_bytes(gltf, buffers, image["bufferView"])[0]
        else:
            log.error(f"Texture {t.get('name', len(textures))} has no image source")
        sampler_index = t.get("sampler")
        sampler = (
            samplers[sampler_index] if sampler_index is not None else _DEFAULT_SAMPLER
        )
        textures.append(
            Texture(
                name=t.get("name"), filepath=filepath, data=data, mime_type=mime, sampler=sampler
            )
        )
    return textures


def _build_materials(gltf: dict, textures: list[Texture]) -> list[Material]:
    def texture_at(info: Optional[dict]) -> Optional[Texture]:
        if info is None:
            return None
        return textures[info["index"]]

    materials = []
    for m in gltf.get("materials", []):
        pbr_def = m.get("pbrMetallicRoughness")
        pbr = None
        if pbr_def is not None:
            pbr = PbrMetallicRoughness(
                base_color_factor=np.asarray(
                    pbr_def.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]), np.float32
                ),
                base_color_texture=texture_at(pbr_def.get("baseColorTexture")),
                metallic_factor=float(pbr_def.get("metallicFactor", 1.0)),
                roughness_factor=float(pbr_def.get("roughnessFactor", 1.0)),
                metallic_roughness_texture=texture_at(pbr_def.get("metallicRoughnessTexture")),
            )
        normal_def = m.get("normalTexture")
        materials.append(
            Material(
                name=m.get("name"),
                pbr_metallic_roughness=pbr,
                normal_scale=float(normal_def.get("scale", 1.0)) if normal_def else 1.0,
                normal_texture=texture_at(normal_def),
                alpha_mode=m.get("alphaMode", "OPAQUE"),
                alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
                double_sided=bool(m.get("doubleSided", False)),
            )
        )
    return materials


_TRIANGLES_MODE = 4


def _build_meshes(
    gltf: dict, buffers: _BufferCache, materials: list[Material], log: Log
) -> list[Mesh]:
    meshes = []
    for mesh_def in gltf.get("meshes", []):
        mesh = Mesh(name=mesh_def.get("name"))
        for prim_index, prim in enumerate(mesh_def.get("primitives", [])):
            if prim.get("mode", _TRIANGLES_MODE) != _TRIANGLES_MODE:
                # skip-and-log (gltf_asset.cppm:807-813)
                log.error(
                    f"Failed to create mesh primitive {mesh.name}[{prim_index}] "
                    f"with unsupported mode {prim.get('mode')}"
                )
                continue
            attributes = prim.get("attributes", {})
            if "POSITION" not in attributes:
                log.error(f"Mesh primitive {mesh.name}[{prim_index}] has no positions")
                continue
            positions = accessor_to_float(gltf, buffers, attributes["POSITION"])[:, :3]
            pos_accessor = gltf["accessors"][attributes["POSITION"]]
            aabb = None
            if "min" in pos_accessor and "max" in pos_accessor:
                # position bbox from accessor min/max (gltf_asset.cppm:730-734)
                aabb = np.asarray([pos_accessor["min"], pos_accessor["max"]], np.float32)

            def attr(name: str, ncomp: int) -> Optional[np.ndarray]:
                if name not in attributes:
                    return None
                data = accessor_to_float(gltf, buffers, attributes[name])
                if data.shape[0] != positions.shape[0]:
                    # count-mismatch validation (gltf_asset.cppm:744-760)
                    log.error(
                        f"Mesh primitive {mesh.name}[{prim_index}]: {name} count "
                        f"{data.shape[0]} != position count {positions.shape[0]}"
                    )
                    return None
                return data[:, :ncomp]

            if "indices" in prim:
                flat = read_accessor(gltf, buffers, prim["indices"]).reshape(-1)
                indices = flat.astype(np.uint32)
            else:
                indices = np.arange(positions.shape[0], dtype=np.uint32)
            if indices.size % 3 != 0:
                log.error(
                    f"Mesh primitive {mesh.name}[{prim_index}]: index count "
                    f"{indices.size} not divisible by 3"
                )
                continue
            if indices.size and int(indices.max()) >= positions.shape[0]:
                # index-bounds validation (the count-check tier of
                # gltf_asset.cppm:744-760 / cgltf_validate): a hostile index
                # buffer must land in skip-and-log, never a raw IndexError
                # downstream in flatten's tri_corner gather
                log.error(
                    f"Mesh primitive {mesh.name}[{prim_index}]: index "
                    f"{int(indices.max())} out of bounds for "
                    f"{positions.shape[0]} vertices"
                )
                continue
            material_index = prim.get("material")
            mesh.primitives.append(
                Primitive(
                    positions=np.ascontiguousarray(positions, np.float32),
                    indices=indices.reshape(-1, 3),
                    normals=attr("NORMAL", 3),
                    tangents=attr("TANGENT", 4),
                    uvs=attr("TEXCOORD_0", 2),
                    material=materials[material_index] if material_index is not None else None,
                    aabb=aabb,
                )
            )
        meshes.append(mesh)
    return meshes


def _build_lights(gltf: dict, log: Log) -> list[Optional[Light]]:
    """KHR_lights_punctual; directional/point only, others skip+log
    (gltf_asset.cppm:846-857). Returns None placeholders for skipped lights so
    node light indices stay aligned."""
    lights: list[Optional[Light]] = []
    defs = gltf.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    for i, light_def in enumerate(defs):
        light_type = light_def.get("type")
        if light_type not in ("directional", "point"):
            log.error(
                f"Failed to create light {light_def.get('name', i)} with "
                f"unsupported type {light_type}"
            )
            lights.append(None)
            continue
        lights.append(
            Light(
                name=light_def.get("name"),
                color=np.asarray(light_def.get("color", [1.0, 1.0, 1.0]), np.float32),
                type=light_type,
            )
        )
    return lights


def _node_local_transform(node_def: dict) -> np.ndarray:
    """Local transform from matrix or TRS (cgltf_node_transform_local)."""
    if "matrix" in node_def:
        # glTF matrices are column-major
        return np.asarray(node_def["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    scale = node_def.get("scale")
    rotation = node_def.get("rotation")  # glTF order (x,y,z,w)
    translation = node_def.get("translation")
    rs = np.eye(3, dtype=np.float32)
    if rotation is not None:
        from vktf_tpu_torch.mathx.quaternion import quat_to_matrix

        x, y, z, w = rotation
        rs = np.asarray(quat_to_matrix(np.asarray([w, x, y, z], np.float32)))
    if scale is not None:
        rs = rs * np.asarray(scale, np.float32)[None, :]
    m[:3, :3] = rs
    if translation is not None:
        m[:3, 3] = translation
    return m


def _validate_graph(nodes, meshes, scenes, default_scene) -> None:
    """Structural validation of the node graph (cgltf_validate's role,
    gltf_asset.cppm:466-470 — but always on, not debug-only).

    The glTF spec requires the nodes to form disjoint strict TREES. A
    cycle (e.g. a node listing itself as a child) would otherwise HANG
    transform propagation at scene flatten (found by the hostile-field
    fuzz: node_child_self looped forever), and out-of-range node/mesh/
    scene indices would crash flatten with raw IndexError."""
    n = len(nodes)
    for i, node in enumerate(nodes):
        if node.mesh is not None and not (
            isinstance(node.mesh, int) and 0 <= node.mesh < len(meshes)
        ):
            raise GltfError(
                f"node {i} references mesh {node.mesh!r} of {len(meshes)}"
            )
        for c in node.children:
            if not (isinstance(c, int) and 0 <= c < n):
                raise GltfError(f"node {i} child {c!r} out of range ({n})")
    has_parent = [False] * n
    for i, node in enumerate(nodes):
        for c in node.children:
            if has_parent[c]:
                raise GltfError(
                    f"node {c} has multiple parents; the node graph must "
                    "be a forest"
                )
            has_parent[c] = True
    # with in-degree <= 1 established, any node unreachable from an
    # in-degree-0 root lies on (or under) a cycle
    reached = [False] * n
    stack = [i for i in range(n) if not has_parent[i]]
    while stack:
        i = stack.pop()
        if reached[i]:
            continue
        reached[i] = True
        stack.extend(nodes[i].children)
    if not all(reached):
        bad = [i for i in range(n) if not reached[i]][:4]
        raise GltfError(f"node graph contains a cycle (nodes {bad} ...)")
    for si, scene in enumerate(scenes):
        for r in scene.root_nodes:
            if not (isinstance(r, int) and 0 <= r < n):
                raise GltfError(
                    f"scene {si} root node {r!r} out of range ({n})"
                )
            if has_parent[r]:
                # spec: scene.nodes must reference ROOT nodes; a child
                # listed as a root would render its subtree twice
                raise GltfError(
                    f"scene {si} root node {r} is another node's child"
                )
    if default_scene is not None and not (
        isinstance(default_scene, int) and 0 <= default_scene < len(scenes)
    ):
        raise GltfError(
            f"default scene {default_scene!r} out of range ({len(scenes)})"
        )


def _build_nodes(gltf: dict, lights: list[Optional[Light]]) -> list[Node]:
    nodes = []
    for node_def in gltf.get("nodes", []):
        light_index = (
            node_def.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        )
        if light_index is not None and (
            light_index >= len(lights) or lights[light_index] is None
        ):
            light_index = None  # light was skipped as unsupported
        nodes.append(
            Node(
                name=node_def.get("name"),
                local_transform=_node_local_transform(node_def),
                mesh=node_def.get("mesh"),
                light=light_index,
                children=list(node_def.get("children", [])),
            )
        )
    return nodes


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def load_gltf(path: str | Path, log: Log | None = None) -> Asset:
    """Load a .gltf/.glb file into a data-oriented :class:`Asset`.

    Mirrors gltf::Load (gltf_asset.cppm:947-982): parse, then build samplers →
    textures → materials → meshes → lights → nodes → scenes.
    """
    log = log or default_log()
    path = Path(path)
    try:
        blob = path.read_bytes()
    except OSError as e:
        raise GltfError(f"failed to read glTF file {path}") from e

    glb_chunk: Optional[bytes] = None
    if blob[:4] == b"glTF":
        gltf, glb_chunk = _parse_glb(blob)
    else:
        try:
            gltf = json.loads(blob)
        except json.JSONDecodeError as e:
            raise GltfError(f"failed to parse glTF JSON {path}") from e
        if not isinstance(gltf, dict):
            # valid JSON but not a glTF object ([], null, 3, ...): the same
            # guard the GLB chunk path applies
            raise GltfError(f"glTF JSON in {path} is not an object")

    try:
        return _build_asset(gltf, path, glb_chunk, log)
    except GltfError:
        raise
    except (KeyError, IndexError, ValueError, TypeError) as e:
        # parser boundary: hostile field values (bad enums, counts past the
        # buffer, wrong JSON types, out-of-range indices) surface as the
        # fatal tier, not as backend exceptions — pinned by the
        # hostile-field fuzz in tests/test_gltf_loader.py
        raise GltfError(f"malformed glTF structure in {path}: {e}") from e


def _build_asset(gltf: dict, path: Path, glb_chunk: Optional[bytes],
                 log: Log) -> Asset:
    buffers = _BufferCache(gltf, path.parent, glb_chunk)
    samplers = _build_samplers(gltf)
    textures = _build_textures(gltf, samplers, path.parent, buffers, log)
    materials = _build_materials(gltf, textures)
    meshes = _build_meshes(gltf, buffers, materials, log)
    lights_with_holes = _build_lights(gltf, log)

    # Re-index lights compactly while keeping node references valid.
    light_remap: dict[int, int] = {}
    lights: list[Light] = []
    for i, light in enumerate(lights_with_holes):
        if light is not None:
            light_remap[i] = len(lights)
            lights.append(light)

    nodes = _build_nodes(gltf, lights_with_holes)
    for node in nodes:
        if node.light is not None:
            node.light = light_remap[node.light]

    scenes = [
        Scene(name=s.get("name"), root_nodes=list(s.get("nodes", [])))
        for s in gltf.get("scenes", [])
    ]
    default_scene = gltf.get("scene")
    if default_scene is None and scenes:
        default_scene = 0

    _validate_graph(nodes, meshes, scenes, default_scene)

    return Asset(
        name=path.stem,
        samplers=samplers,
        textures=textures,
        materials=materials,
        meshes=meshes,
        lights=lights,
        nodes=nodes,
        scenes=scenes,
        default_scene=default_scene,
    )
