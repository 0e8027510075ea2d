"""The port's depth-peel K (tests/test_torch_peel_frame.py's third item, with
the parity tests' frame budget): tests/test_alpha.py's 9-deep
BLEND stack, built with both packages' asset builders, clamps to K = 8 with a
logged warning, and its frame at 96x64, 1x MSAA is held to the JAX production
program's; the configuration raises on K outside 1..8, and the frame program
takes the forced K, else the scene's."""

import io

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()


def _jax_stack_asset(tmp_path):
    from test_alpha import _stacked_blend_scene
    from vktf_tpu.loaders.gltf import load_gltf

    return load_gltf(_stacked_blend_scene(tmp_path, "stack9.gltf", n_quads=9,
                                          dz=0.05))


def _port_stack_asset(n_quads=9, dz=0.05):
    """tests/test_alpha.py _stacked_blend_scene with the port's builder."""
    from vktf_tpu_torch.loaders.gltf import (
        Asset, Light, Material, Mesh, Node, PbrMetallicRoughness, Primitive, Scene)
    from vktf_tpu_torch.mathx.quaternion import quat_to_matrix
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    colors = ((0.9, 0.2, 0.2, 0.45), (0.2, 0.3, 0.9, 0.5),
              (0.9, 0.8, 0.2, 0.4), (0.2, 0.9, 0.6, 0.5),
              (0.7, 0.2, 0.9, 0.45), (0.9, 0.5, 0.2, 0.5),
              (0.3, 0.8, 0.9, 0.4), (0.8, 0.3, 0.5, 0.5),
              (0.4, 0.6, 0.3, 0.45))

    def material(rgba, blend):
        return Material(pbr_metallic_roughness=PbrMetallicRoughness(
            base_color_factor=np.asarray(rgba, np.float32), metallic_factor=0.0,
            roughness_factor=0.5 if blend else 0.8),
            alpha_mode="BLEND" if blend else "OPAQUE")

    def node(translation=None, rotation=None, **kw):  # glTF TRS, (x, y, z, w)
        m = np.eye(4, dtype=np.float32)
        if rotation is not None:
            x, y, z, w = rotation
            m[:3, :3] = quat_to_matrix(np.asarray([w, x, y, z], np.float32))
        if translation is not None:
            m[:3, 3] = translation
        return Node(local_transform=m, **kw)

    def mesh(geom, mat):
        pos = geom["positions"]
        return Mesh(primitives=[Primitive(
            positions=pos, indices=geom["indices"].astype(np.uint32),
            normals=geom.get("normals"), tangents=geom.get("tangents"),
            uvs=geom.get("uvs"), material=mat,
            aabb=np.stack([pos.min(axis=0), pos.max(axis=0)]))])

    back = material((0.15, 0.6, 0.2, 1.0), False)
    quads = [material(c, True) for c in colors[:n_quads]]
    meshes = [mesh(box_mesh(0.6), back)] + [mesh(plane_mesh(0.9), m) for m in quads]
    nodes = [node((0.0, 0.3, -0.6), mesh=0),
             node((1.2, 1.5, 2.0), light=0),
             node(rotation=(0.2, 0.1, 0.0, 0.97), light=1)]
    for i in range(n_quads):
        nodes.append(node((0.1 - 0.05 * i, 0.35, 0.45 - dz * i),
                          (0.7071068, 0.0, 0.0, 0.7071068), mesh=1 + i))
    lights = [Light(color=np.asarray((6.0, 6.0, 6.0), np.float32), type="point"),
              Light(color=np.asarray((0.6, 0.6, 0.6), np.float32), type="directional")]
    return Asset(name="stack9", materials=[back] + quads, meshes=meshes, lights=lights,
                 nodes=nodes, scenes=[Scene(root_nodes=list(range(len(nodes))))],
                 default_scene=0)


def test_nine_deep_stack_clamps_to_eight_and_matches_jax(tmp_path):
    from helpers import default_camera
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu.ops.pipeline import make_frame_fn
    from vktf_tpu.scene.flatten import flatten_assets as jax_flatten
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.scene.scene import Scene

    width, height = 96, 64
    with tp._jax_native_mips(False):
        jscene, jmeta, _aux = jax_flatten([_jax_stack_asset(tmp_path)])
    jcam = default_camera(aspect=width / height)
    jconfig = JConfig(width=width, height=height, msaa_samples=1,
                      tile_shape=(32, 64), backend="pallas", pallas_chunk=128,
                      pallas_interpret=True)
    want = np.asarray(make_frame_fn(jmeta, jconfig)(
        jscene, jcam.view_projection_transform, jcam.position))

    camera = Camera(np.asarray(jcam.position), (0.0, -0.2, -1.0),
                    ViewFrustumParams(np.radians(45.0), width / height, 0.1, 100.0))
    warnings = io.StringIO()
    scene = Scene([_port_stack_asset()], tp.port_config(
        width=width, height=height, msaa_samples=1, tile_shape=(32, 64)),
        Log(io.StringIO(), warnings), camera=camera, device="cpu")
    assert jmeta.peel_layers == scene.meta.peel_layers == 8
    assert scene.frame_program.layers == 8
    assert "8-layer depth peel" in warnings.getvalue()
    got = scene.render_still()
    assert got.shape == want.shape == (3, height, width)
    tp.assert_frames_close(got, want, want.shape)


@pytest.mark.parametrize("value", [0, 9])
def test_config_raises_on_peel_layers_outside_1_to_8(value):
    from vktf_tpu_torch.config import RenderConfig

    with pytest.raises(ValueError):
        RenderConfig(peel_layers=value)


@pytest.mark.parametrize("scene_layers, forced, want", [
    (2, None, 2), (8, None, 8), (8, 3, 3), (1, 2, 2)])
def test_frame_program_builds_for_peel_metas(scene_layers, forced, want):
    from vktf_tpu_torch.ops.pipeline import FrameProgram
    from vktf_tpu_torch.scene.flatten import SceneMeta

    meta = SceneMeta(level_slices=((0, 1),), num_lights=0, num_instances=1,
                     num_triangles=1, num_vertices=3, peel_layers=scene_layers)
    assert FrameProgram(meta, tp.port_config(peel_layers=forced)).layers == want
