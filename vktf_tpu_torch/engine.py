"""Engine orchestration: load assets, run the frame loop, render.

Counterpart of ``vktf_tpu/engine.py`` (reference: src/engine/engine.cppm):
  * ``Engine(window, config, log, device, mesh)`` picks the device: the
    current CUDA card unless the caller asks for another (``device="cpu"``
    runs the kernels' plain versions); with no card and no device it
    raises. It logs the card and the kernels' build directory.
    With a mesh (``parallel.make_render_mesh``) the device is this rank's
    card (the launcher sets it) and the scenes it loads render through the
    multi-device program (``Scene(mesh=)``), every rank rendering each
    frame.
  * ``load(paths)`` skips non-glTF paths with a logged error
    (engine.cppm:462-473), then parses, decodes, flattens and uploads the
    assets into one Scene, timing each step (``load_seconds``).
  * ``run(callback)`` is the main loop: delta time, window events, the
    user's callback (engine.cppm:76-84).
  * ``render(scene)`` enqueues one frame. The reference keeps 2 frames in
    flight with fences (engine.cppm:40,501-563). Here each frame is copied
    to a pinned host buffer by a non-blocking copy with a CUDA event
    recorded after it; once MAX_RENDER_FRAMES frames are outstanding,
    render waits on the oldest frame's event alone and presents that
    frame. It never synchronizes the device. A pinned buffer goes back to
    the ring only after the window has consumed its frame. A frame in a
    present encoding (a preview or yuv420 config) is copied as encoded and
    decoded on the host before the window (``_to_presentable``).
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from vktf_tpu_torch.config import MAX_RENDER_FRAMES, RenderConfig
from vktf_tpu_torch.loaders.gltf import load_gltf
from vktf_tpu_torch.log import Log, default_log
from vktf_tpu_torch.ops.present import decode_present
from vktf_tpu_torch.runtime.cache import enable_persistent_cache
from vktf_tpu_torch.scene.flatten import decode_textures, flatten_assets_numpy, scene_from_numpy
from vktf_tpu_torch.scene.scene import Scene
from vktf_tpu_torch.utils.delta_time import DeltaTime
from vktf_tpu_torch.utils.profiling import annotate, counters
from vktf_tpu_torch.utils.timing import FrameTimer
from vktf_tpu_torch.window import Window

_GLTF_EXTENSIONS = (".gltf", ".glb")


def rank_devices(devices: Optional[Sequence[torch.device]] = None) -> list[torch.device]:
    """CUDA devices by index (the reference ranks discrete GPUs highest,
    physical_device.cppm:126-142); the visible cards when none are given.
    The CPU is never ranked: it is used only when asked for."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return sorted((torch.device(d) for d in devices if torch.device(d).type == "cuda"),
                  key=lambda d: d.index or 0)


class Engine:
    def __init__(self, window: Window, config: Optional[RenderConfig] = None,
                 log: Optional[Log] = None, device=None, mesh=None):
        self.log = log or default_log()
        self.window = window
        self.mesh = mesh
        self.config = config or RenderConfig(width=window.width, height=window.height)
        if device is None:
            # the current card, as the JAX engine takes its default device
            # (under a mesh the launcher has made this rank's card current)
            if not torch.cuda.is_available():
                raise RuntimeError("Engine: no CUDA device; pass device=\"cpu\" to render "
                                   "with the plain PyTorch versions on the CPU")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        if self.device.type == "cuda":
            index = (self.device.index if self.device.index is not None
                     else torch.cuda.current_device())
            self.device = torch.device("cuda", index)
            self.log.info(f"Engine using cuda device {index} "
                          f"({torch.cuda.get_device_name(index)}); "
                          f"topology: {{'cuda': {torch.cuda.device_count()}}}")
        else:
            self.log.info(f"Engine using {self.device.type} device (the kernels' plain "
                          "PyTorch versions)")
        if mesh is not None:
            self.log.info(f"Engine rank {mesh.rank} of the {mesh} mesh ({mesh.backend})")
        cache_dir = enable_persistent_cache()
        self.log.info(f"Kernel build cache at {cache_dir}")
        # (pinned host frame, CUDA event after its copy or None) per frame
        self._in_flight: deque = deque()
        self._free_buffers: list[torch.Tensor] = []
        self.frame_timer = FrameTimer()
        self.load_seconds: dict[str, float] = {}

    # -- asset loading (engine.cppm:459-499) ---------------------------------
    def load(self, paths: Sequence[str | Path]) -> Optional[Scene]:
        """Load glTF assets into a renderable Scene.

        Non-glTF paths are skipped with a logged error (engine.cppm:465-470);
        returns None when nothing loadable remains. ``load_seconds`` holds
        the host seconds of parse, texture decode, flatten and upload (the
        upload ends in a synchronize of the device).
        """
        t0 = time.perf_counter()
        assets = []
        for path in paths:
            path = Path(path)
            if path.suffix.lower() not in _GLTF_EXTENSIONS:
                self.log.error(
                    f"Failed to load {path} with unsupported file extension {path.suffix}"
                )
                continue
            assets.append(load_gltf(path, self.log))
        if not assets:
            return None
        t1 = time.perf_counter()
        decoded = decode_textures(assets, self.log)
        t2 = time.perf_counter()
        leaves, meta = flatten_assets_numpy(assets, self.log, decoded)
        t3 = time.perf_counter()
        render_scene = scene_from_numpy(leaves, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t4 = time.perf_counter()
        self.load_seconds = {"parse": t1 - t0, "decode": t2 - t1, "flatten": t3 - t2,
                             "upload": t4 - t3}
        self.log.info("Load seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in self.load_seconds.items()))
        return Scene.from_render_scene(render_scene, meta, self.config, log=self.log,
                                       mesh=self.mesh)

    # -- main loop (engine.cppm:76-84) ---------------------------------------
    def run(self, callback: Callable[[float], None]) -> None:
        """Loop until the window closes: delta update -> poll -> callback."""
        delta_time = DeltaTime()
        delta_time.update()
        while not self.window.is_closed():
            dt = delta_time.update()
            self.window.update()
            callback(dt)
        self.wait_idle()

    # -- per-frame rendering (engine.cppm:501-563) ---------------------------
    def render(self, scene: Scene) -> None:
        """Enqueue one frame and its copy to the host; present the oldest
        frame once MAX_RENDER_FRAMES are in flight (the fence-wait analogue,
        engine.cppm:505-509)."""
        with annotate("engine.dispatch"):
            frame = scene.render_async()
            if frame.is_cuda:
                host = self._host_buffer(frame)
                host.copy_(frame, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(frame.device))
            else:
                host, done = frame, None
        self._in_flight.append((host, done))
        if len(self._in_flight) >= MAX_RENDER_FRAMES:
            self._present_oldest()

    def _host_buffer(self, frame: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer for `frame` from the ring (a new one when
        none of the frame's shape is free)."""
        while self._free_buffers:
            buf = self._free_buffers.pop()
            if buf.shape == frame.shape and buf.dtype == frame.dtype:
                return buf
        return torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)

    def _present_oldest(self) -> None:
        host, done = self._in_flight.popleft()
        if done is not None:
            done.synchronize()
        with annotate("engine.present"):
            # present copies the planar frame into the window's own
            # interleaved RGBA array, so the buffer is free afterwards
            self.window.present(self._to_presentable(host.numpy()))
        if done is not None:
            self._free_buffers.append(host)
        self.frame_timer.tick()

    def _to_presentable(self, frame):
        """The host decode of a device present encoding (ops/present.py):
        the yuv420 unpack at preview resolution, then the nearest upsample
        back to the window size under the preview stream."""
        if self.config.present_format != "rgb" or self.config.present_scale != 1:
            return decode_present(frame, self.config)
        return frame

    def wait_idle(self) -> None:
        """Present every frame still in flight (the deviceWaitIdle analogue,
        engine.cppm:83), then log the frame statistics and counters."""
        while self._in_flight:
            self._present_oldest()
        summary = self.frame_timer.summary()
        if summary.get("frames", 0) > 1:
            self.log.info(
                "Frame stats: {fps:.2f} FPS, {frame_ms_mean:.1f} ms mean, "
                "p50 {frame_ms_p50:.1f} / p99 {frame_ms_p99:.1f} ms over "
                "{frames} frames".format(**summary)
            )
        events = counters.snapshot()
        if events:
            self.log.info(f"Counters: {events}")
