"""glTF 2.0 exporter: serialize a loader Asset back to .gltf + .ktx2 files.

The port's counterpart of ``vktf_tpu/models/export.py``; both write the
same bytes for the same asset (ZSTD levels: where ``zstandard`` is
installed, ``loaders/ktx.py``). One argument more: the KTX2
supercompression of ``texture_format="rgba"`` (ZSTD as in the JAX package,
through ``zstandard`` or the native runtime's libzstd; ZLIB and NONE need
nothing beyond the standard library and are lossless too).

The loader (vktf_tpu_torch.loaders.gltf) parses files into the in-memory Asset
model; this module writes that model back out — geometry through
GltfWriter, textures as KTX2 (Basis/ETC1S-supercompressed via
KHR_texture_basisu, or zstd RGBA8). It exists so the procedural demo scenes
(models/scenes.py) become REAL on-disk multi-asset content for the viewer
CLI, exercising the same files-on-disk path as the reference's
Engine::Load of the Sponza packs (game.cppm:80-88).

Usage:
    python -m vktf_tpu_torch.models.export --preset sponza --out demo_assets/
    python -m vktf_tpu_torch.game demo_assets/*.gltf --width 1920 --height 1080
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from vktf_tpu_torch.loaders.gltf import Asset, Sampler, Texture
from vktf_tpu_torch.loaders.images import decode_texture, generate_mips
from vktf_tpu_torch.loaders.ktx import (
    SUPERCOMPRESSION_NONE,
    SUPERCOMPRESSION_ZLIB,
    SUPERCOMPRESSION_ZSTD,
    write_ktx2,
    write_ktx2_basis,
)
from vktf_tpu_torch.log import Log, default_log
from vktf_tpu_torch.models.gltf_writer import GltfWriter

_SUPERCOMPRESSION = {"zstd": SUPERCOMPRESSION_ZSTD, "zlib": SUPERCOMPRESSION_ZLIB,
                     "none": SUPERCOMPRESSION_NONE}

_FILTER_ENUM = {"nearest": 9728, "linear": 9729}
_WRAP_ENUM = {"repeat": 10497, "clamp_to_edge": 33071, "mirrored_repeat": 33648}


def _min_filter_enum(sampler: Sampler) -> int:
    if sampler.min_filter == "nearest":
        return 9984 if sampler.mipmap_mode == "nearest" else 9986
    return 9985 if sampler.mipmap_mode == "nearest" else 9987


def export_asset(
    asset: Asset,
    out_dir: Path,
    texture_format: str = "basis",
    log: Optional[Log] = None,
    supercompression: int = SUPERCOMPRESSION_ZSTD,
) -> Path:
    """Write `asset` as <out_dir>/<asset.name>.gltf + sibling .ktx2 files.

    texture_format: "basis" (ETC1S/BasisLZ via KHR_texture_basisu) or
    "rgba" (RGBA8 KTX2 under `supercompression`, ZSTD by default).
    """
    if texture_format not in ("basis", "rgba"):
        raise ValueError(f"unknown texture_format {texture_format!r}")
    log = log or default_log()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    w = GltfWriter()

    sampler_ids: dict[int, int] = {}

    def writer_sampler(sampler: Optional[Sampler]) -> Optional[int]:
        if sampler is None:
            return None
        key = id(sampler)
        if key not in sampler_ids:
            sampler_ids[key] = w.add_sampler(
                mag=_FILTER_ENUM.get(sampler.mag_filter, 9729),
                min=_min_filter_enum(sampler),
                wrap_s=_WRAP_ENUM.get(sampler.wrap_u, 10497),
                wrap_t=_WRAP_ENUM.get(sampler.wrap_v, 10497),
            )
        return sampler_ids[key]

    texture_ids: dict[tuple[int, str], int] = {}

    def writer_texture(texture: Optional[Texture], kind: str) -> Optional[int]:
        if texture is None:
            return None
        key = (id(texture), kind)
        if key in texture_ids:
            return texture_ids[key]
        data = decode_texture(texture, kind, log)
        if data is None:
            return None
        filename = f"{asset.name}_{kind}_{len(texture_ids)}.ktx2"
        levels = data.levels
        if len(levels) == 1:
            levels = generate_mips(levels[0], data.srgb)
        if texture_format == "basis":
            write_ktx2_basis(out_dir / filename, levels, srgb=data.srgb)
        else:
            write_ktx2(out_dir / filename, levels, srgb=data.srgb,
                       supercompression=supercompression)
        image = w.add_image_uri(filename)
        texture_ids[key] = w.add_texture(
            image, writer_sampler(texture.sampler),
            basisu=texture_format == "basis",
        )
        return texture_ids[key]

    material_ids: dict[int, int] = {}

    def writer_material(material) -> Optional[int]:
        if material is None:
            return None
        if id(material) in material_ids:
            return material_ids[id(material)]
        pbr = material.pbr_metallic_roughness
        kwargs = dict(
            name=material.name,
            normal_scale=material.normal_scale,
            normal_texture=writer_texture(material.normal_texture, "normal"),
            alpha_mode=material.alpha_mode,
            double_sided=material.double_sided,
        )
        if material.alpha_mode == "MASK":
            kwargs["alpha_cutoff"] = material.alpha_cutoff
        if pbr is not None:
            kwargs.update(
                base_color_factor=tuple(np.asarray(pbr.base_color_factor, float)),
                base_color_texture=writer_texture(pbr.base_color_texture, "base_color"),
                metallic_factor=pbr.metallic_factor,
                roughness_factor=pbr.roughness_factor,
                metallic_roughness_texture=writer_texture(
                    pbr.metallic_roughness_texture, "metallic_roughness"
                ),
            )
        material_ids[id(material)] = w.add_material(**kwargs)
        return material_ids[id(material)]

    mesh_ids: list[int] = []
    for mesh in asset.meshes:
        # GltfWriter meshes hold one primitive; multi-primitive meshes export
        # as one writer-mesh per primitive, re-joined under a parent node
        prim_ids = []
        for prim in mesh.primitives:
            geometry = {"positions": prim.positions, "indices": prim.indices}
            if prim.normals is not None:
                geometry["normals"] = prim.normals
            if prim.tangents is not None:
                geometry["tangents"] = prim.tangents
            if prim.uvs is not None:
                geometry["uvs"] = prim.uvs
            prim_ids.append(
                w.add_mesh(geometry, material=writer_material(prim.material),
                           name=mesh.name)
            )
        mesh_ids.append(prim_ids)

    light_ids = [
        w.add_light(type=light.type, color=tuple(np.asarray(light.color, float)))
        for light in asset.lights
    ]

    # nodes: two passes (children reference node ids)
    node_ids: list[Optional[int]] = [None] * len(asset.nodes)

    def emit_node(index: int) -> int:
        if node_ids[index] is not None:
            return node_ids[index]
        node = asset.nodes[index]
        children = [emit_node(c) for c in node.children]
        mesh_ref: Optional[int] = None
        if node.mesh is not None:
            prims = mesh_ids[node.mesh]
            if len(prims) == 1:
                mesh_ref = prims[0]
            else:  # wrap multi-primitive meshes in child nodes
                children = [w.add_node(mesh=p) for p in prims] + children
        node_ids[index] = w.add_node(
            mesh=mesh_ref,
            light=light_ids[node.light] if node.light is not None else None,
            matrix=np.asarray(node.local_transform, np.float32),
            children=children or None,
            name=node.name,
        )
        return node_ids[index]

    scene_def = asset.scenes[asset.default_scene or 0]
    roots = [emit_node(r) for r in scene_def.root_nodes]
    w.add_scene(roots, name=scene_def.name)
    return w.write(out_dir / f"{asset.name}.gltf")


def export_preset(preset: str, out_dir: Path, texture_format: str = "basis",
                  log: Optional[Log] = None,
                  supercompression: int = SUPERCOMPRESSION_ZSTD) -> list[Path]:
    """Export every asset of a models.scenes preset to disk."""
    from vktf_tpu_torch.models.scenes import build_preset

    return [
        export_asset(asset, out_dir, texture_format, log, supercompression)
        for asset in build_preset(preset)
    ]


def main(argv=None) -> int:
    from vktf_tpu_torch.models.scenes import PRESETS

    parser = argparse.ArgumentParser(prog="vktf_tpu_torch.models.export")
    parser.add_argument("--preset", default="sponza", choices=sorted(PRESETS))
    parser.add_argument("--out", default="demo_assets")
    parser.add_argument("--texture-format", default="basis",
                        choices=["basis", "rgba"])
    parser.add_argument("--supercompression", default="zstd",
                        choices=sorted(_SUPERCOMPRESSION),
                        help="KTX2 supercompression of --texture-format rgba "
                             "(zstd through libzstd or the zstandard module)")
    args = parser.parse_args(argv)
    paths = export_preset(args.preset, Path(args.out), args.texture_format,
                          supercompression=_SUPERCOMPRESSION[args.supercompression])
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
