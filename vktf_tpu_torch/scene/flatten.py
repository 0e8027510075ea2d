"""Asset -> device-tensor scene flattening.

Counterpart of ``vktf_tpu/scene/flatten.py``: the node forest becomes
level-sorted index arrays, the triangles of every instance one stream in
world-space Morton order (which is also the draw order that breaks depth
ties), and the per-triangle shading inputs two component-major tables
built once here. Only the leaves the ported frame path reads exist.

The numpy half (``flatten_assets_numpy``) reproduces the JAX package's
leaves exactly; ``scene_from_numpy`` uploads any such leaf dict — the
port's own, or one read back from the JAX package's scene — to a device.
Every referenced (texture, kind) is decoded once, in a thread pool
(``loaders/images.decode_texture``); a texture whose decode fails takes
the default texture with a logged error and the counter
``textures.decode_failed``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vktf_tpu_torch.config import PEEL_LAYERS_MAX
from vktf_tpu_torch.loaders.gltf import Asset, GltfError, Material
from vktf_tpu_torch.loaders.images import decode_texture, default_texture_data
from vktf_tpu_torch.log import Log, default_log
from vktf_tpu_torch.ops.texture_pack import build_material_pool
from vktf_tpu_torch.utils.profiling import counters

_ALPHA_MODES = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}

# The leaves the frame path reads, in RenderScene field order.
SCENE_LEAVES = (
    "node_local", "node_parent", "inst_node", "tri_instance", "inst_aabb",
    "tri_corner", "tri_static_cols", "quad_pool", "light_node",
    "light_type", "light_color",
)


@dataclasses.dataclass
class RenderScene:
    """Device-resident scene state (torch tensors on one device)."""

    node_local: torch.Tensor  # (N, 4, 4) f32, level-sorted nodes
    node_parent: torch.Tensor  # (N,) i64 (roots point at themselves)
    inst_node: torch.Tensor  # (I,) i64
    tri_instance: torch.Tensor  # (T,) i64
    inst_aabb: torch.Tensor  # (I, 2, 3) f32 object-space AABB
    # object-space corner attrs, component-major: row = attr_base +
    # channel*3 + corner; bases uv 0, position 6, normal 15, tangent 24
    tri_corner: torch.Tensor  # (36, T) f32
    # static material columns: base color 4, metallic-roughness 2, normal
    # scale 1, (pool base row, w0, levels, 3 sampler codes), alpha 2
    tri_static_cols: torch.Tensor  # (15, T) f32
    # fused-mip texel pool as u32 lanes (bit view of the (P, 128) u16 pool)
    quad_pool: torch.Tensor  # (P, 64) i32
    light_node: torch.Tensor  # (L,) i64
    light_type: torch.Tensor  # (L,) i64: 0 directional, 1 point
    light_color: torch.Tensor  # (L, 3) f32

    @property
    def device(self) -> torch.device:
        return self.tri_corner.device


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene facts."""

    level_slices: Tuple[Tuple[int, int], ...]
    num_lights: int
    num_instances: int
    num_triangles: int
    num_vertices: int
    peel_layers: int = 1
    mixed_samplers: bool = False
    mirror_wrap: bool = False


def _compute_smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], face_n)
    lengths = np.linalg.norm(out, axis=-1, keepdims=True)
    lengths[lengths == 0] = 1.0
    return (out / lengths).astype(np.float32)


def _estimate_peel_layers(mat_alpha, tri_material, tri_instance, log: Log) -> int:
    """Depth-peel layer count: 1 + the number of translucent (MASK/BLEND)
    instances, clamped to PEEL_LAYERS_MAX. Any two translucent instances can
    line up along some view ray, so the instance count is the sound bound;
    past the cap, stacks composite only their nearest PEEL_LAYERS_MAX
    fragments, which is logged. Stacks inside one instance are not counted
    (RenderConfig.peel_layers forces a deeper K)."""
    alpha_mask = mat_alpha[:, 0] != 0
    if not bool(alpha_mask.any()):
        return 1
    n_alpha = int(np.unique(tri_instance[alpha_mask[tri_material]]).shape[0])
    if 1 + n_alpha > PEEL_LAYERS_MAX:
        counters.add("scene.peel_layers_clamped")
        log.warn(f"{n_alpha} translucent instances exceed the {PEEL_LAYERS_MAX}-layer "
                 f"depth peel limit: deeper stacks composite only their nearest "
                 f"{PEEL_LAYERS_MAX} fragments")
    return min(1 + n_alpha, PEEL_LAYERS_MAX)


def _spread3(x):  # 10 bits -> every 3rd bit
    x &= 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _texture_refs(material: Optional[Material]):
    """(texture, kind) of each texture slot a material reads."""
    if material is None:
        return []
    pbr = material.pbr_metallic_roughness
    refs = [(material.normal_texture, "normal")]
    if pbr is not None:
        refs += [(pbr.base_color_texture, "base_color"),
                 (pbr.metallic_roughness_texture, "metallic_roughness")]
    return [(tex, kind) for tex, kind in refs if tex is not None]


def decode_textures(assets: Sequence[Asset], log: Optional[Log] = None) -> dict:
    """Decode every (texture, kind) the assets' primitives reference, once
    each and in parallel (the reference's std::async KTX fan-out,
    model.cppm:333-349; zlib, zstd and PIL release the interpreter lock).
    Returns {(id(texture), kind): TextureData or None on a failed decode}."""
    log = log or default_log()
    jobs: dict[tuple[int, str], tuple] = {}
    for asset in assets:
        for mesh in asset.meshes:
            for prim in mesh.primitives:
                for tex, kind in _texture_refs(prim.material):
                    jobs.setdefault((id(tex), kind), (tex, kind))
    if not jobs:
        return {}
    with ThreadPoolExecutor() as pool:
        futures = {key: pool.submit(decode_texture, tex, kind, log)
                   for key, (tex, kind) in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def flatten_assets_numpy(assets: Sequence[Asset], log: Optional[Log] = None,
                         decoded: Optional[dict] = None) -> Tuple[dict, SceneMeta]:
    """Combine assets into the frame path's leaves as numpy arrays (the JAX
    package's dtypes and values) plus the static SceneMeta. ``decoded`` is
    ``decode_textures``' result for these assets (decoded here when None)."""
    leaves, meta, _entries, _oracle = _flatten(assets, log, decoded)
    return leaves, meta


def _flatten(assets, log, decoded, oracle: bool = False):
    """(leaves, meta, texture entries, oracle arrays): flatten_assets_numpy's
    result, the (TextureData, sampler dict) of each texture slot the pool
    holds, and, when `oracle` is set (only ``ops/reference.py`` sets it),
    the vertex-level arrays the numpy oracle reads, under the JAX
    RenderScene's field names; None otherwise."""
    log = log or default_log()
    order: list[tuple[Asset, int, int, int]] = []
    for asset in assets:
        if asset.default_scene is None:
            if not asset.scenes:
                counters.add("assets.skipped")
                log.error(f"Asset {asset.name} has no scenes; skipping")
                continue
            scene_def = asset.scenes[0]
        else:
            scene_def = asset.scenes[asset.default_scene]
        if not scene_def.root_nodes:
            counters.add("assets.skipped")
            log.error(f"Asset {asset.name} default scene has no root nodes; skipping")
            continue
        stack = [(root, -1, 0) for root in scene_def.root_nodes]
        while stack:
            node_idx, parent_flat, level = stack.pop(0)
            order.append((asset, node_idx, parent_flat, level))
            my_pos = len(order) - 1
            for child in asset.nodes[node_idx].children:
                stack.append((child, my_pos, level + 1))

    # sort BFS order by level (stable) -> contiguous level slices
    perm = sorted(range(len(order)), key=lambda i: order[i][3])
    order_to_flat = {old: new for new, old in enumerate(perm)}
    sorted_entries = [order[i] for i in perm]
    flat_locals, flat_parents, flat_levels = [], [], []
    node_flat_index: dict[tuple[int, int], int] = {}
    for asset, node_idx, parent_order, level in sorted_entries:
        flat_locals.append(np.asarray(asset.nodes[node_idx].local_transform, np.float32))
        flat_parents.append(order_to_flat[parent_order] if parent_order >= 0
                            else len(flat_parents))
        flat_levels.append(level)
        node_flat_index[(id(asset), node_idx)] = len(flat_locals) - 1
    level_bounds: list[Tuple[int, int]] = []
    start = 0
    for level in range(max(flat_levels, default=-1) + 1):
        count = sum(1 for lv in flat_levels if lv == level)
        level_bounds.append((start, start + count))
        start += count

    # ---- instances + geometry ----------------------------------------------
    positions_list, normals_list, tangents_list, uvs_list = [], [], [], []
    indices_list, tri_inst_list, vert_inst_list = [], [], []
    inst_nodes: list[int] = []
    inst_aabbs: list[np.ndarray] = []
    inst_materials: list[int] = []
    materials: list[Optional[Material]] = []
    material_index: dict[Optional[int], int] = {}

    def get_material_index(material: Optional[Material]) -> int:
        key = id(material) if material is not None else None
        if key not in material_index:
            material_index[key] = len(materials)
            materials.append(material)
        return material_index[key]

    vertex_offset = 0
    for asset, node_idx, _parent, _level in sorted_entries:
        node = asset.nodes[node_idx]
        if node.mesh is None:
            continue
        flat_node = node_flat_index[(id(asset), node_idx)]
        for prim in asset.meshes[node.mesh].primitives:
            count = prim.positions.shape[0]
            if count == 0 or prim.indices.size == 0:
                continue
            normals = prim.normals
            if normals is None:
                normals = _compute_smooth_normals(prim.positions, prim.indices)
            tangents = prim.tangents
            if tangents is None:
                tangents = np.tile(np.asarray([1.0, 0.0, 0.0, 1.0], np.float32),
                                   (count, 1))
            uvs = prim.uvs
            if uvs is None:
                uvs = np.zeros((count, 2), np.float32)
            instance = len(inst_nodes)
            inst_nodes.append(flat_node)
            aabb = prim.aabb
            if aabb is None:
                aabb = np.stack([prim.positions.min(axis=0), prim.positions.max(axis=0)])
            inst_aabbs.append(np.asarray(aabb, np.float32))
            inst_materials.append(get_material_index(prim.material))
            positions_list.append(prim.positions)
            normals_list.append(np.asarray(normals, np.float32))
            tangents_list.append(np.asarray(tangents, np.float32))
            uvs_list.append(np.asarray(uvs, np.float32))
            indices_list.append(prim.indices.astype(np.int64) + vertex_offset)
            tri_inst_list.append(np.full(prim.indices.shape[0], instance, np.int32))
            if oracle:
                vert_inst_list.append(np.full(count, instance, np.int32))
            vertex_offset += count

    if not inst_nodes:
        raise ValueError("no renderable geometry in assets")

    positions = np.concatenate(positions_list).astype(np.float32)
    normals = np.concatenate(normals_list)
    tangents = np.concatenate(tangents_list)
    uvs = np.concatenate(uvs_list)
    indices = np.concatenate(indices_list).astype(np.int32)
    if indices.size and int(indices.max()) >= positions.shape[0]:
        raise GltfError(f"triangle index {int(indices.max())} out of bounds "
                        f"for {positions.shape[0]} vertices")
    tri_instance = np.concatenate(tri_inst_list)
    tri_material = np.asarray(inst_materials, np.int32)[tri_instance]

    # ---- static triangle-stream order: 3-D Morton code of the world-space
    # centroid under the initial node transforms (the draw order, and so
    # the depth-tie rule, of every stage)
    parents_np = np.asarray(flat_parents, np.int64)
    node_global_np = np.stack(flat_locals).astype(np.float64)
    for lv_start, lv_end in level_bounds[1:]:
        node_global_np[lv_start:lv_end] = np.einsum(
            "nij,njk->nik",
            node_global_np[parents_np[lv_start:lv_end]],
            node_global_np[lv_start:lv_end],
        )
    tri_m = node_global_np[np.asarray(inst_nodes, np.int64)][tri_instance]
    centroid = (positions[indices[:, 0]] + positions[indices[:, 1]]
                + positions[indices[:, 2]]) / 3.0
    world_c = np.einsum("tij,tj->ti", tri_m[:, :3, :3], centroid) + tri_m[:, :3, 3]
    lo, hi = world_c.min(axis=0), world_c.max(axis=0)
    q = ((world_c - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint64)
    morton = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
    tri_perm = np.argsort(morton, kind="stable")
    indices = indices[tri_perm]
    tri_instance = tri_instance[tri_perm]
    tri_material = tri_material[tri_perm]

    # ---- materials + textures ----------------------------------------------
    texture_entries: list[tuple] = []  # (TextureData, sampler dict)
    texture_index: dict[tuple[Optional[int], str], int] = {}

    if decoded is None:
        decoded = decode_textures(assets, log)

    def add_texture(gltf_texture, kind: str) -> int:
        key = (id(gltf_texture) if gltf_texture is not None else None, kind)
        if key in texture_index:
            return texture_index[key]
        data = decoded.get(key) if gltf_texture is not None else None
        if data is None:
            if gltf_texture is not None:
                counters.add("textures.decode_failed")
                log.error(f"Using default {kind} texture after decode failure")
            data = default_texture_data(kind)
        sampler = {}
        if gltf_texture is not None and gltf_texture.sampler is not None:
            s = gltf_texture.sampler
            sampler = {"mag_filter": s.mag_filter, "min_filter": s.min_filter,
                       "mipmap_mode": s.mipmap_mode, "wrap_u": s.wrap_u,
                       "wrap_v": s.wrap_v}
        texture_index[key] = len(texture_entries)
        texture_entries.append((data, sampler))
        return texture_index[key]

    M = len(materials)
    mat_base_color = np.ones((M, 4), np.float32)
    mat_mr = np.ones((M, 2), np.float32)
    mat_normal_scale = np.ones(M, np.float32)
    mat_alpha = np.zeros((M, 2), np.float32)
    mat_alpha[:, 1] = 0.5
    mat_textures = np.zeros((M, 3), np.int32)
    for i, material in enumerate(materials):
        if material is None:
            mat_textures[i] = [add_texture(None, "base_color"),
                               add_texture(None, "metallic_roughness"),
                               add_texture(None, "normal")]
            continue
        pbr = material.pbr_metallic_roughness
        if pbr is None:
            log.error(f"Material {material.name} has no PBR metallic-roughness; "
                      "using defaults")
            pbr_base, pbr_metallic, pbr_rough = np.ones(4, np.float32), 1.0, 1.0
            base_tex = mr_tex = None
        else:
            pbr_base = pbr.base_color_factor
            pbr_metallic = pbr.metallic_factor
            pbr_rough = pbr.roughness_factor
            base_tex = pbr.base_color_texture
            mr_tex = pbr.metallic_roughness_texture
        mat_base_color[i] = pbr_base
        mat_mr[i] = (pbr_metallic, pbr_rough)
        mat_normal_scale[i] = material.normal_scale
        mat_alpha[i] = (_ALPHA_MODES.get(material.alpha_mode, 0), material.alpha_cutoff)
        mat_textures[i] = [add_texture(base_tex, "base_color"),
                           add_texture(mr_tex, "metallic_roughness"),
                           add_texture(material.normal_texture, "normal")]

    material_specs = []
    for i in range(M):
        slot_samplers = [texture_entries[mat_textures[i, s]][1] for s in range(3)]
        material_specs.append({
            "base": texture_entries[mat_textures[i, 0]][0],
            "mr": texture_entries[mat_textures[i, 1]][0],
            "normal": texture_entries[mat_textures[i, 2]][0],
            "samplers": slot_samplers,
        })
    material_pool = build_material_pool(material_specs)
    mat_meta = np.concatenate(
        [
            material_pool.base_row[:, None].astype(np.float32),
            material_pool.width0[:, None].astype(np.float32),
            material_pool.num_levels[:, None].astype(np.float32),
            material_pool.sampler_codes.astype(np.float32),
        ],
        axis=1,
    )

    # ---- precomputed per-triangle tables -----------------------------------
    num_tris = indices.shape[0]
    tri_corner = np.empty((36, num_tris), np.float32)
    for base, attr, nch in ((0, uvs, 2), (6, positions, 3),
                            (15, normals, 3), (24, tangents, 4)):
        for c in range(nch):
            col = np.ascontiguousarray(attr[:, c])
            for i in range(3):
                tri_corner[base + c * 3 + i] = col[indices[:, i]]
    mat_cols = np.concatenate(
        [mat_base_color, mat_mr, mat_normal_scale[:, None], mat_meta, mat_alpha],
        axis=1,
    ).astype(np.float32)
    tri_static_cols = np.ascontiguousarray(mat_cols[tri_material].T)

    # ---- lights -------------------------------------------------------------
    light_nodes, light_types, light_colors = [], [], []
    for asset, node_idx, _parent, _level in sorted_entries:
        node = asset.nodes[node_idx]
        if node.light is None:
            continue
        light = asset.lights[node.light]
        light_nodes.append(node_flat_index[(id(asset), node_idx)])
        light_types.append(0 if light.type == "directional" else 1)
        light_colors.append(light.color)

    leaves = {
        "node_local": np.stack(flat_locals),
        "node_parent": np.asarray(flat_parents, np.int32),
        "inst_node": np.asarray(inst_nodes, np.int32),
        "tri_instance": tri_instance,
        "inst_aabb": np.stack(inst_aabbs),
        "tri_corner": tri_corner,
        "tri_static_cols": tri_static_cols,
        "quad_pool": material_pool.quads,
        "light_node": np.asarray(light_nodes, np.int32).reshape(-1),
        "light_type": np.asarray(light_types, np.int32).reshape(-1),
        "light_color": np.asarray(light_colors, np.float32).reshape(-1, 3),
    }
    meta = SceneMeta(
        level_slices=tuple(level_bounds),
        num_lights=len(light_nodes),
        num_instances=len(inst_nodes),
        num_triangles=int(num_tris),
        num_vertices=int(positions.shape[0]),
        peel_layers=_estimate_peel_layers(mat_alpha, tri_material, tri_instance, log),
        mixed_samplers=material_pool.mixed,
        mirror_wrap=material_pool.mirror,
    )
    if not oracle:
        return leaves, meta, texture_entries, None
    arrays = {
        "positions": positions, "normals": normals, "tangents": tangents, "uvs": uvs,
        "indices": indices, "tri_material": tri_material,
        "vertex_instance": np.concatenate(vert_inst_list),
        "mat_base_color": mat_base_color, "mat_metallic_roughness": mat_mr,
        "mat_normal_scale": mat_normal_scale, "mat_alpha": mat_alpha,
        "mat_textures": mat_textures,
        **{name: leaves[name] for name in ("node_local", "node_parent", "inst_node",
                                           "light_node", "light_type", "light_color")},
    }
    return leaves, meta, texture_entries, arrays


_INDEX_LEAVES = ("node_parent", "inst_node", "tri_instance", "light_node",
                 "light_type")


def scene_from_numpy(leaves: dict, device) -> RenderScene:
    """Upload a leaf dict (numpy, the JAX package's dtypes) to `device`.

    Index leaves become int64; the (P, 128) u16 texel pool becomes its
    (P, 64) int32 bit view (little-endian u32 lanes)."""
    out = {}
    for name in SCENE_LEAVES:
        a = np.asarray(leaves[name])
        if name == "quad_pool":
            a = np.ascontiguousarray(a, np.uint16)
            if a.ndim != 2 or a.shape[1] % 2:
                raise ValueError(f"quad_pool must be (P, 2k) u16, got {a.shape}")
            a = a.view(np.int32)
        elif name in _INDEX_LEAVES:
            a = a.astype(np.int64)
        else:
            a = np.ascontiguousarray(a, np.float32)
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return RenderScene(**out)


def flatten_assets(assets: Sequence[Asset], log: Optional[Log] = None, *,
                   device=None) -> Tuple[RenderScene, SceneMeta, dict]:
    """Combine assets into one RenderScene on `device` (the current card by
    default, ``scene.resolve_device``) as ``vktf_tpu``'s flatten_assets:
    returns (scene, meta, aux), aux["texture_entries"] the (TextureData,
    sampler dict) of every texture slot, which the numpy reference
    renderer reads."""
    from vktf_tpu_torch.scene.scene import resolve_device

    if log is not None and not isinstance(log, Log):
        raise TypeError(f"flatten_assets(assets, log=None, *, device=None) takes a Log "
                        f"as its second argument, got {log!r}: pass the device by name")
    leaves, meta, entries, _oracle = _flatten(assets, log, None)
    return scene_from_numpy(leaves, resolve_device(device)), meta, {"texture_entries": entries}
