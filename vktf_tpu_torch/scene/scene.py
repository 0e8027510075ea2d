"""User-facing Scene: device state, camera and the frame program.

Counterpart of ``vktf_tpu/scene/scene.py``, with its signature
``Scene(assets, config, log=None, camera=None, ...)``: combines assets into
one device scene, owns the camera (default: position (0, 1, 0), looking
+x, 45 degree vertical field of view) and renders frames. The frame
program comes from the shared registry (``runtime/cache.py``), so scenes
of one shape and configuration share it. With a mesh
(``parallel.make_render_mesh``) the scene renders through the
multi-device program on this rank's device, and every rank of the mesh
renders each frame (``render_async`` and ``render_still`` are collectives).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.loaders.gltf import Asset
from vktf_tpu_torch.log import Log, default_log
from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
from vktf_tpu_torch.runtime.cache import frame_program
from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta, flatten_assets


def resolve_device(device=None) -> torch.device:
    """The device a scene renders on: the current CUDA device by default;
    with no card this raises, and the CPU (the kernels' plain versions)
    must be asked for with device="cpu"."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" to render "
                               "with the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Scene:
    def __init__(self, assets: Sequence[Asset], config: RenderConfig,
                 log: Optional[Log] = None, camera: Optional[Camera] = None,
                 device=None, mesh=None):
        """device: where the scene lives and renders (``resolve_device``:
        this rank's card under a mesh). mesh: a ``parallel.RenderMesh``, or
        None for one device."""
        log = log or default_log()
        render_scene, meta, _aux = flatten_assets(assets, log, device=resolve_device(device))
        self._init(render_scene, meta, config, camera, log, mesh)

    @classmethod
    def from_render_scene(cls, render_scene: RenderScene, meta: SceneMeta,
                          config: RenderConfig, camera: Optional[Camera] = None,
                          log: Optional[Log] = None, mesh=None) -> "Scene":
        """A Scene over an already flattened scene (for example one carried
        over from another renderer with ``flatten.scene_from_numpy``)."""
        scene = cls.__new__(cls)
        scene._init(render_scene, meta, config, camera, log or default_log(), mesh)
        return scene

    def _init(self, render_scene, meta, config, camera, log: Log, mesh) -> None:
        self.config = config
        self.mesh = mesh
        self.render_scene = render_scene
        self.meta = meta
        self.camera = camera or Camera(
            position=(0.0, 1.0, 0.0),
            direction=(1.0, 0.0, 0.0),
            view_frustum=ViewFrustumParams(
                field_of_view_y=np.radians(45.0),
                aspect_ratio=config.width / config.height,
                z_near=0.1,
                z_far=1.0e6,
            ),
        )
        self.frame_program = frame_program(meta, config, mesh)
        self._still_program = None
        log.info(f"Scene ready: {meta.num_triangles} tris, {meta.num_vertices} verts, "
                 f"{meta.num_instances} instances, {meta.num_lights} lights")

    @property
    def light_count(self) -> int:
        return self.meta.num_lights

    def render_async(self) -> torch.Tensor:
        """Enqueue one frame; returns the presented frame as a device tensor
        (``FrameProgram``: the (3, H, W) uint8 frame or its configured
        encoding) without waiting for the device (nothing on the frame path
        synchronizes with the card, so several frames can be in flight)."""
        return self.frame_program(self.render_scene,
                                  self.camera.view_projection_transform,
                                  self.camera.position)

    def binning_diagnostics(self) -> dict:
        """Dropped-triangle diagnostics for the current camera, as the JAX
        Scene's: the streaming raster keeps no fixed-capacity tile lists,
        so it drops nothing and always reports zeros."""
        return {"dropped_pairs": 0, "dropped_large": 0}

    def render_still(self) -> np.ndarray:
        """The exact full-size (3, H, W) uint8 frame at the current camera,
        on the host, whatever the present encoding: under a preview or
        yuv420 configuration it renders through the registry's program for
        present_format="rgb", present_scale=1 (built once per scene), the
        same pixels as an exact render."""
        program = self.frame_program
        if self.config.present_format != "rgb" or self.config.present_scale != 1:
            if self._still_program is None:
                self._still_program = frame_program(
                    self.meta, self.config.replace(present_format="rgb", present_scale=1),
                    self.mesh)
            program = self._still_program
        return program(self.render_scene, self.camera.view_projection_transform,
                       self.camera.position).cpu().numpy()
