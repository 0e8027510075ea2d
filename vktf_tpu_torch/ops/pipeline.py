"""The frame program: scene update, setup, stream order, raster, shade
table, per-pixel winner and the fused shade + resolve, on one device.

Counterpart of ``vktf_tpu/ops/pipeline.py`` ``PallasFrameProgram`` at the
configuration the port renders (pixel-rate shading, one opaque peel layer,
fused-mip pool, one texture tap). Stages, in order:

  1. scene update (cached per scene): node transforms, world lights, the
     (16, T) per-triangle instance-matrix rows;
  2. setup kernel (``ops/setup_kernel.py``), once per frame;
  3. screen-Morton stream order (``ops/raster.stream_perm``), kept across
     frames until the camera moves past ``config.resort_threshold``;
  4. raster prologue (``ops/raster.raster_stream``) and raster kernel;
  5. shade-table kernel (``ops/shade_table.py``);
  6. phase A in plain torch: the per-pixel winner (min depth, then min id)
     and the sample coverage fraction;
  7. shade + resolve kernel (``ops/shade_kernel.py``), which gathers the
     table and pool rows itself;
  8. present: unpack the bytes and crop the tile padding (``ops/present.py``).

The JAX program ran the setup kernel twice (a second pass over
Morton-permuted inputs) and split the shade into two programs; both were
TPU layout economies that leave the frame unchanged, and are not copied.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.ops import present, raster, setup_kernel, shade_kernel, shade_table
from vktf_tpu_torch.ops.vertex import propagate_transforms
from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta


def gather_world_lights(node_global, light_node, light_type, light_color):
    """World-space lights (L, 8): position (w = 1) or normalized +z
    direction (w = 0), then colour and a pad of 1."""
    if light_node.shape[0] == 0:
        return torch.zeros((0, 8), dtype=torch.float32, device=node_global.device)
    transforms = node_global[light_node]
    z_axis = transforms[:, :3, 2]
    direction = z_axis / torch.linalg.vector_norm(z_axis, dim=-1, keepdim=True)
    position = transforms[:, :3, 3]
    is_point = (light_type == 1)[:, None]
    pos_or_dir = torch.where(is_point, position, direction)
    pad = torch.ones_like(is_point, dtype=torch.float32)
    return torch.cat([pos_or_dir, is_point.float(), light_color, pad], dim=-1)


def scene_update(scene: RenderScene, meta: SceneMeta):
    """The camera-independent half of the frame: (mrowsT (16, T) f32
    per-triangle instance-matrix rows, lights (L, 8) f32)."""
    node_global = propagate_transforms(scene.node_local, scene.node_parent,
                                       meta.level_slices)
    lights = gather_world_lights(node_global, scene.light_node,
                                 scene.light_type, scene.light_color)
    mrows = node_global[scene.inst_node].reshape(-1, 16)[scene.tri_instance]
    return mrows.T.contiguous(), lights


def pixel_winner(ids, depth):
    """Phase A: per pixel, the sample winner (min depth, then min id among
    the covered samples; -1 when none) and the covered-sample fraction.
    ids/depth (S, H, W) -> (tri (H*W,) i32, frac (H*W,) f32)."""
    d_min = depth.amin(dim=0, keepdim=True)
    imax = torch.iinfo(torch.int32).max
    cand = torch.where((depth == d_min) & (ids >= 0), ids,
                       torch.full_like(ids, imax))
    tri = cand.amin(dim=0)
    tri = torch.where(tri == imax, torch.full_like(tri, -1), tri)
    frac = (ids >= 0).float().mean(dim=0)
    return tri.reshape(-1), frac.reshape(-1)


def pixel_centers(height: int, width: int, device):
    """Row-major pixel centres (sx, sy), each (H*W,) f32."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return ((xs.float() + 0.5).reshape(-1).contiguous(),
            (ys.float() + 0.5).reshape(-1).contiguous())


class _StageTimer:
    """CUDA-event stage timing, on only when asked for (one event pair
    per stage; read after the frame synchronizes)."""

    def __init__(self):
        self.marks: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def start(self, name: str):
        begin = torch.cuda.Event(enable_timing=True)
        begin.record()
        self.marks.append((name, begin, None))

    def stop(self):
        name, begin, _ = self.marks[-1]
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.marks[-1] = (name, begin, end)

    def millis(self) -> dict:
        return {name: begin.elapsed_time(end) for name, begin, end in self.marks}


class FrameProgram:
    """Renders one (3, H, W) u8 frame per call from a RenderScene and a
    camera, on the scene's device (plain versions of every kernel on the
    CPU, the CUDA kernels on a card)."""

    def __init__(self, meta: SceneMeta, config: RenderConfig):
        if meta.peel_layers != 1:
            raise ValueError(
                f"the scene needs {meta.peel_layers} depth-peel layers; only "
                "one opaque layer is ported")
        if meta.mixed_samplers or meta.mirror_wrap:
            raise ValueError("mixed-sampler and mirror-wrap scenes need the "
                             "two-gather texture path, which is not ported")
        self.meta = meta
        self.config = config
        self._scene_key = None
        self._scene_state = None
        self._perm = None
        self._sort_vp = None
        self._centers = None
        self.timer: Optional[_StageTimer] = None

    def _maybe_scene_update(self, scene: RenderScene):
        key = (scene.node_local, scene.node_parent, scene.light_node,
               scene.light_type, scene.light_color, scene.inst_node,
               scene.tri_instance)
        if self._scene_state is None or any(
                a is not b for a, b in zip(key, self._scene_key)):
            self._scene_state = scene_update(scene, self.meta)
            self._scene_key = key
        return self._scene_state

    def _maybe_resort(self, setup, view_projection):
        vp = np.asarray(view_projection, dtype=np.float64)
        if self._perm is not None and self.config.resort_threshold > 0:
            ref = self._sort_vp
            if (np.linalg.norm(vp - ref)
                    <= self.config.resort_threshold * np.linalg.norm(ref)):
                return self._perm
        self._perm = raster.stream_perm(setup["bbox_rows"], setup["valid"],
                                        chunk=self.config.pallas_chunk)
        self._sort_vp = vp
        return self._perm

    @contextlib.contextmanager
    def _stage(self, name: str):
        if self.timer is None:
            yield
            return
        self.timer.start(name)
        yield
        self.timer.stop()

    def __call__(self, scene: RenderScene, view_projection,
                 camera_position) -> torch.Tensor:
        cfg = self.config
        dev = scene.device
        vp = torch.as_tensor(np.asarray(view_projection, np.float32), device=dev)
        cam = torch.as_tensor(np.asarray(camera_position, np.float32), device=dev)
        ph, pw = cfg.padded_height, cfg.padded_width
        if self._centers is None or self._centers[0].device != dev:
            self._centers = pixel_centers(ph, pw, dev)

        with self._stage("scene_update"):
            mrowsT, lights = self._maybe_scene_update(scene)
        with self._stage("setup"):
            setup = setup_kernel.setup_pack(scene.tri_corner, mrowsT, vp,
                                            cfg.width, cfg.height)
        with self._stage("raster"):
            perm = self._maybe_resort(setup, view_projection)
            stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"],
                                          perm, chunk=cfg.pallas_chunk)
            ids, depth = raster.rasterize(*stream, ph, pw, cfg.msaa_samples)
        with self._stage("shade_table"):
            table = shade_table.build_shade_table(
                setup["edge9"], scene.tri_corner, scene.tri_static_cols,
                setup["anchor2"], mrowsT)
        with self._stage("winner"):
            tri, frac = pixel_winner(ids, depth)
        with self._stage("shade"):
            background = torch.tensor(cfg.clear_color[:3], dtype=torch.float32,
                                      device=dev)
            packed = shade_kernel.shade_resolve(
                tri, *self._centers, frac, table, scene.quad_pool, cam, lights,
                background, cfg.max_anisotropy)
        with self._stage("present"):
            frame = present.encode_rgb(packed, cfg)
        return frame
