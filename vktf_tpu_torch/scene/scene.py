"""User-facing Scene: device state, camera and the frame program.

Counterpart of ``vktf_tpu/scene/scene.py``: combines assets into one
device scene, owns the camera (default: position (0, 1, 0), looking +x,
45 degree vertical field of view) and renders frames.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.loaders.gltf import Asset
from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
from vktf_tpu_torch.ops.pipeline import FrameProgram
from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta, flatten_assets

log = logging.getLogger(__name__)


class Scene:
    def __init__(self, assets: Sequence[Asset], config: RenderConfig,
                 camera: Optional[Camera] = None, device=None):
        """device: where the scene lives and renders. The default is the
        current CUDA device; with no card it raises, and the CPU (the
        kernels' plain versions) must be asked for with device="cpu"."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device=\"cpu\" to render "
                                   "with the plain PyTorch versions on the CPU")
            device = "cuda"
        render_scene, meta = flatten_assets(assets, torch.device(device))
        self._init(render_scene, meta, config, camera)

    @classmethod
    def from_render_scene(cls, render_scene: RenderScene, meta: SceneMeta,
                          config: RenderConfig,
                          camera: Optional[Camera] = None) -> "Scene":
        """A Scene over an already flattened scene (for example one carried
        over from another renderer with ``flatten.scene_from_numpy``)."""
        scene = cls.__new__(cls)
        scene._init(render_scene, meta, config, camera)
        return scene

    def _init(self, render_scene, meta, config, camera) -> None:
        self.config = config
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
        self.frame_program = FrameProgram(meta, config)
        log.info("Scene ready: %d tris, %d verts, %d instances, %d lights",
                 meta.num_triangles, meta.num_vertices, meta.num_instances,
                 meta.num_lights)

    def render_async(self) -> torch.Tensor:
        """Enqueue one frame; returns the (3, H, W) uint8 device tensor
        without waiting for the device (nothing on the frame path
        synchronizes with the card, so several frames can be in flight)."""
        return self.frame_program(self.render_scene,
                                  self.camera.view_projection_transform,
                                  self.camera.position)

    def render_still(self) -> np.ndarray:
        """The (3, H, W) uint8 frame at the current camera, on the host."""
        return self.render_async().cpu().numpy()
