"""The system under test, reached through its public entry points only:
the port's asset types, ``Scene``, ``Camera`` and ``RenderConfig``. Imported after the harness has pointed the build caches
into the checkout."""

from __future__ import annotations

import numpy as np

from vktf_tpu_torch import Camera, Log, RenderConfig, ViewFrustumParams
from vktf_tpu_torch.loaders.gltf import (
    Asset, Light, Material, Mesh, Node, PbrMetallicRoughness, Primitive, Sampler, Scene,
    Texture,
)
from vktf_tpu_torch.loaders.images import TextureData
from vktf_tpu_torch.scene.scene import Scene as RenderedScene


def port_assets(assets: list) -> list:
    """The scene description as the port's glTF asset objects (textures
    carry their decoded mip chains, as the port's own presets do)."""
    out = []
    for a in assets:
        def texture(t):
            return Texture(decoded=TextureData(levels=t["levels"], srgb=t["srgb"]),
                           sampler=Sampler(**t["sampler"]))

        materials = []
        for m in a["materials"]:
            base, mr, normal = (texture(t) for t in m["textures"])
            materials.append(Material(
                name=m["name"], normal_scale=m["normal_scale"], normal_texture=normal,
                pbr_metallic_roughness=PbrMetallicRoughness(
                    base_color_factor=np.asarray(m["base_color_factor"], np.float32),
                    base_color_texture=base, metallic_factor=m["metallic_factor"],
                    roughness_factor=m["roughness_factor"], metallic_roughness_texture=mr)))
        meshes = []
        for mesh in a["meshes"]:
            g = mesh["geometry"]
            meshes.append(Mesh(primitives=[Primitive(
                positions=g["positions"], indices=g["indices"], normals=g["normals"],
                tangents=g["tangents"], uvs=g["uvs"], material=materials[mesh["material"]],
                aabb=np.stack([g["positions"].min(axis=0), g["positions"].max(axis=0)]))]))
        nodes = [Node(local_transform=n["transform"], mesh=n["mesh"], light=n["light"])
                 for n in a["nodes"]]
        lights = [Light(color=l["color"], type=l["type"]) for l in a["lights"]]
        out.append(Asset(name=a["name"], materials=materials, meshes=meshes, lights=lights,
                         nodes=nodes, scenes=[Scene(root_nodes=list(range(len(nodes))))],
                         default_scene=0))
    return out


def render_config(config: dict) -> RenderConfig:
    return RenderConfig(**config["render"])


def camera(config: dict, position, direction) -> Camera:
    r, c = config["render"], config["camera"]
    return Camera(np.asarray(position, np.float32), np.asarray(direction, np.float32),
                  ViewFrustumParams(np.radians(c["fov_y_deg"]), r["width"] / r["height"],
                                    c["z_near"], c["z_far"]))


def scene(assets: list, config: dict, device, log=None) -> RenderedScene:
    return RenderedScene(port_assets(assets), render_config(config), log=log, device=device)
