"""Frame-program registry and the kernels' build directory.

Counterpart of ``vktf_tpu/runtime/cache.py``. The reference compiles its
shaders offline and reloads them at start-up (cmake/compile_shader.cmake);
the port has two such layers:

  * an in-process registry: one ``FrameProgram`` per (scene shape, render
    configuration, mesh), shared by every Scene of that shape (with a
    ``parallel.RenderMesh``, the mesh's ``ShardedFrameProgram``). A program keeps
    per-scene state keyed on each leaf's identity and version and its
    stream order per device, so scenes that share it each render their own
    frame;
  * the kernels' build directory (``ops/_cuda.BUILD_DIR``), the analogue of
    JAX's persistent compile cache: each CUDA source is compiled once into
    a library named by a hash of the source and flags, and reused by later
    processes.

``warmup()`` renders one frame and waits for it, which builds (or loads)
every kernel the frame runs before a render loop starts.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from vktf_tpu_torch.ops import _cuda
from vktf_tpu_torch.ops.pipeline import FrameProgram
from vktf_tpu_torch.parallel.tiles import ShardedFrameProgram

_programs: Dict[Tuple, FrameProgram] = {}


def enable_persistent_cache() -> str:
    """The directory the kernels are built into and reloaded from."""
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(_cuda.BUILD_DIR)


def frame_program(meta, config, mesh=None) -> FrameProgram:
    """The FrameProgram for (scene shape, config, mesh), built once: on one
    device without a mesh, the ShardedFrameProgram over a RenderMesh.
    SceneMeta and RenderConfig are frozen and hashable, and a mesh hashes by
    identity, so they key the registry."""
    key = ("frame", meta, config, mesh)
    program = _programs.get(key)
    if program is None:
        program = _programs[key] = (FrameProgram(meta, config) if mesh is None
                                    else ShardedFrameProgram(meta, config, mesh))
    return program


def warmup(scene, meta, config, view_projection, camera_position) -> float:
    """Render one frame through the registry's program and wait for it;
    returns the seconds taken (kernel builds included on a cold cache)."""
    program = frame_program(meta, config)
    t0 = time.perf_counter()
    frame = program(scene, view_projection, camera_position)
    if frame.is_cuda:
        torch.cuda.synchronize(frame.device)
    return time.perf_counter() - t0


def program_cache_info() -> dict:
    return {"programs": len(_programs),
            "persistent_cache": str(_cuda.BUILD_DIR) if _cuda.BUILD_DIR.exists() else None}
