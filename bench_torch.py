#!/usr/bin/env python
"""Benchmark harness of the PyTorch + CUDA port (vktf_tpu_torch): steady
render FPS on the bench presets, on one CUDA card.

The counterpart of bench.py, which measures the JAX package: the same
presets, resolutions, cameras, rows and JSON line, and the same promise
that a JSON line lands whatever happens (stderr phase markers, a watchdog
thread with a wall-clock budget, a SIGTERM/SIGINT flush, a zero line on an
early death). It imports neither jax nor the JAX package.

Prints ONE JSON line per measured config:
    {"metric": ..., "value": fps, "unit": "fps", "vs_baseline": fps / 60, ...}

Rows (each frame moves the camera by rotate(0, 0.002), as bench.py's loops):
  * value / frame_ms: the device loop, n frames through Scene.render_async,
    each folded into an on-device probe sum of its last 128 bytes, one
    synchronize at the end (best of up to four loops);
  * present_fps: --depth frames in flight (default 4), each copied to a
    pinned host buffer by a non-blocking copy, waiting only on the oldest
    frame's CUDA event; the median present-to-present interval;
  * interactive_fps: the same loop at depth 2 (the viewer's
    MAX_RENDER_FRAMES);
  * preview_fps: that loop under the preview stream (yuv420 at
    present_scale 2, and 4 at 3840 px and wider; the best is reported).

session_init_s is the CUDA context's start-up, compile_s the kernels'
build (or load from vktf_tpu_torch/_build/) plus the first frame.

It runs on the card: with no card it prints an error line and exits 1.
VKTF_FORCE_CPU=1 asks for the kernels' plain versions on the CPU instead
(platform/backend "cpu/plain"). --backend takes pallas (the streaming
raster) only; another prints the error line and exits 1.

--mesh GP,SP measures the multi-device frame path (vktf_tpu_torch.parallel)
under torchrun, one process per device (one card a rank under NCCL, gloo
with VKTF_FORCE_CPU): every rank renders every frame, rank 0 prints the
lines (with "mesh": "gpGx spS"), and every decision the budget makes is
rank 0's. Without the launcher's environment a mesh of more than one rank
prints the error line and exits 1.

Usage:
    python3 bench_torch.py                 # headline: sponza @1080p, 4x MSAA
    python3 bench_torch.py --all           # five presets + sponza aniso_taps=2
    VKTF_FORCE_CPU=1 python3 bench_torch.py --preset box --width 192 \\
        --height 96 --msaa 1 --frames 2
    torchrun --standalone --nproc-per-node 4 bench_torch.py --mesh 2,2
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import signal
import sys
import threading
import time

import numpy as np

BASELINE_TARGET_FPS = 60.0
_T0 = time.time()
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))
_DEADLINE = _T0 + _BUDGET_S

# bench.py's configs and cameras, copied (tests/test_torch_bench.py holds
# the two files equal): (preset, width, height, msaa)
CONFIGS = {
    "box": ("box", 1920, 1080, 1),
    "duck": ("duck", 1920, 1080, 1),
    "helmet": ("helmet", 1920, 1080, 4),
    "sponza": ("sponza", 1920, 1080, 4),
    "flythrough": ("flythrough", 3840, 2160, 4),
}

# camera placements per preset: (position, direction)
CAMERAS = {
    "box": ((0.0, 0.8, 2.4), (0.0, -0.25, -1.0)),
    "duck": ((0.0, 0.5, 2.0), (0.0, -0.2, -1.0)),
    "helmet": ((0.0, 0.4, 2.4), (0.0, -0.1, -1.0)),
    "sponza": ((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0)),
    "flythrough": ((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0)),
}

# ---------------------------------------------------------------------------
# always-report machinery (bench.py's)
# ---------------------------------------------------------------------------

_emit_lock = threading.Lock()
_state = {
    "phase": "startup",          # most recent phase marker
    "partial": None,             # best-so-far headline dict (not yet printed)
    "printed": 0,                # completed JSON lines already on stdout
    "done": False,               # normal completion reached
    "quiet": False,              # a mesh rank other than 0 prints no line
}


def _mark(phase: str, **kv) -> None:
    """Timestamped progress marker on stderr (the killed-run breadcrumb)."""
    _state["phase"] = phase
    extra = "".join(f" {k}={v}" for k, v in kv.items())
    sys.stderr.write(f"[bench +{time.time() - _T0:6.1f}s] {phase}{extra}\n")
    sys.stderr.flush()


def _remaining() -> float:
    return _DEADLINE - time.time()


def _set_partial(line: dict) -> None:
    """Record the best-so-far headline; flushed by watchdog/signal if the
    run never reaches its normal print."""
    _state["partial"] = dict(line)


def _print_line(line: dict) -> None:
    with _emit_lock:
        if not _state["quiet"]:
            print(json.dumps(line), flush=True)
        _state["printed"] += 1
        _state["partial"] = None


def _flush_partial(reason: str) -> None:
    """Emergency emission: print the best-so-far (or a zero line) exactly
    once, annotated with where the run died. Safe from any thread."""
    with _emit_lock:
        if _state["done"]:
            return
        line = _state["partial"]
        if line is None and _state["printed"] == 0:
            line = {
                "metric": "sponza @1920x1080 4xMSAA render FPS",
                "value": 0.0,
                "unit": "fps",
                "vs_baseline": 0.0,
            }
        if line is not None and not _state["quiet"]:
            line = dict(line)
            line["partial"] = reason
            line["phase"] = _state["phase"]
            line["elapsed_s"] = round(time.time() - _T0, 1)
            print(json.dumps(line), flush=True)
            _state["printed"] += 1
            _state["partial"] = None
        _state["done"] = True


def _watchdog() -> None:
    while True:
        left = _DEADLINE - time.time()
        if _state["done"]:
            return
        if left <= 0:
            sys.stderr.write(
                f"[bench +{time.time() - _T0:6.1f}s] watchdog fired "
                f"(budget_s={_BUDGET_S}, stuck in: {_state['phase']})\n"
            )
            sys.stderr.flush()
            _flush_partial("budget")
            os._exit(0)
        time.sleep(min(left, 2.0))


def _on_signal(signum, frame) -> None:  # pragma: no cover - signal path
    sys.stderr.write(
        f"[bench +{time.time() - _T0:6.1f}s] signal {signum} "
        f"(in phase: {_state['phase']})\n"
    )
    sys.stderr.flush()
    _flush_partial(f"signal{signum}")
    os._exit(0)


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def bench_device():
    """The card (cuda:0, or the rank's card under a launcher), or the CPU
    when VKTF_FORCE_CPU asks for it; with no card and no such request this
    raises."""
    import torch

    if os.environ.get("VKTF_FORCE_CPU"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_torch.py measures the card; set "
                           "VKTF_FORCE_CPU=1 to run the plain versions on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _build_kernels() -> None:
    """Build (or load) every CUDA source in parallel, one nvcc each."""
    from vktf_tpu_torch.ops import _cuda, raster, setup_kernel, shade_kernel, shade_table

    kernels = (setup_kernel.KERNEL, raster.KERNEL, shade_table.KERNEL, *shade_kernel.KERNELS)
    _cuda.build(sorted({k.source for k in kernels}))


def run_bench(preset: str, width: int, height: int, msaa: int,
              frames: int, animate: bool = True,
              backend: str | None = None, depth: int = 4,
              anisotropy: float = 16.0, aniso_taps: int = 1,
              present_format: str = "rgb",
              mesh=None,
              emit=None):
    """Measure one config on bench_device(). Calls ``emit(stats_dict)``
    after every refinement so the watchdog always has the latest valid
    number to flush. mesh: a parallel.RenderMesh (every rank calls this
    alike; the budget's decisions are rank 0's)."""
    emit = emit or (lambda stats: None)

    def agree(flag: bool) -> bool:
        """Rank 0's decision on every rank of the mesh."""
        return flag if mesh is None else bool(mesh.broadcast_host([float(flag)])[0])

    if backend not in (None, "pallas"):
        raise NotImplementedError(f"--backend {backend} is not ported: the port has the "
                                  "streaming raster alone (pallas)")
    _mark(f"{preset}: import torch")
    import torch

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.runtime import enable_persistent_cache, frame_program
    from vktf_tpu_torch.scene.scene import Scene

    dev = bench_device()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cache_dir = enable_persistent_cache()
    cache_files = len(os.listdir(cache_dir))
    _mark(f"{preset}: kernel build directory ready", dir=cache_dir, entries=cache_files)

    config = RenderConfig(width=width, height=height, msaa_samples=msaa,
                          max_anisotropy=anisotropy, aniso_taps=aniso_taps,
                          present_format=present_format)
    position, direction = CAMERAS[preset]
    camera = Camera(position, direction,
                    ViewFrustumParams(np.radians(45.0), width / height, 0.1, 1.0e6))

    _mark(f"{preset}: device start-up")
    t0 = time.time()
    (torch.zeros((8,), dtype=torch.float32, device=dev) + 1.0).cpu()
    session_init_s = time.time() - t0
    platform = "cuda" if on_card else "cpu"
    _mark(f"{preset}: device up", secs=round(session_init_s, 1), platform=platform)

    t0 = time.time()
    scene = Scene(build_preset(preset), config, camera=camera, device=dev, mesh=mesh)
    sync()
    build_s = time.time() - t0
    _mark(f"{preset}: scene built", secs=round(build_s, 1), tris=scene.meta.num_triangles)

    _mark(f"{preset}: kernel build + first frame")
    t0 = time.time()
    if on_card:
        _build_kernels()
    scene.render_async().cpu()
    compile_s = time.time() - t0
    cache_delta = len(os.listdir(cache_dir)) - cache_files
    _mark(f"{preset}: compiled", secs=round(compile_s, 1),
          cache="miss (built new libraries)" if cache_delta > 0 else "hit",
          new_cache_entries=cache_delta)

    def loop(n: int, depth: int = depth, render=None) -> float:
        """Steady-state loop, `depth` frames in flight: frame i is enqueued
        and its non-blocking copy to a pinned host buffer started before
        the host waits on frame i - depth's copy (its CUDA event). Returns
        the median present-to-present interval."""
        in_flight = collections.deque()
        free = []
        presents = []

        def present_oldest():
            host, done = in_flight.popleft()
            if done is not None:
                done.synchronize()
                free.append(host)
            np.asarray(host.numpy())
            presents.append(time.time())

        for _ in range(n):
            if animate:
                scene.camera.rotate(0.0, 0.002)
            frame = (render or scene.render_async)()
            done = None
            if on_card:
                match = [b for b in free if b.shape == frame.shape]
                host = free.pop(free.index(match[0])) if match else torch.empty(
                    frame.shape, dtype=frame.dtype, pin_memory=True)
                host.copy_(frame, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = frame
            in_flight.append((host, done))
            if len(in_flight) >= depth:
                present_oldest()
        while in_flight:
            present_oldest()
        return float(np.median(np.diff(presents)))

    def device_loop(n: int) -> float:
        """Device render throughput: n frames enqueued, each folded into an
        on-device probe of its last 128 bytes, one synchronize at the end.
        The probe depends on the whole frame program, so every frame is
        fully rendered."""
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        sync()
        t0 = time.time()
        for _ in range(n):
            if animate:
                scene.camera.rotate(0.0, 0.002)
            frame = scene.render_async()
            acc += frame.reshape(-1)[-128:].to(torch.int32).sum()
        sync()
        return (time.time() - t0) / n

    tris = scene.meta.num_triangles

    def stats_from(dt, present_dt=None, dt2=None, quality="first-loop"):
        s = {
            "fps": 1.0 / dt,
            "frame_ms": dt * 1e3,
            "mtris_per_s": tris / dt / 1e6,
            "triangles": tris,
            "build_s": build_s,
            "compile_s": compile_s,
            "session_init_s": session_init_s,
            "platform": platform,
            "backend": "cuda" if on_card else "plain",
            "quality": quality,
        }
        if present_dt is not None:
            s["present_fps"] = 1.0 / present_dt
            s["present_frame_ms"] = present_dt * 1e3
        if dt2 is not None:
            s["interactive_fps"] = 1.0 / dt2
            s["interactive_frame_ms"] = dt2 * 1e3
        return s

    # --- measurement ladder: cheapest valid number first, refine within
    # budget. Every rung re-emits so the watchdog can flush it. ---
    first_n = max(4, min(frames, 8))
    dt = device_loop(first_n)  # doubles as warmup
    emit(stats_from(dt))
    _mark(f"{preset}: first device loop", n=first_n, frame_ms=round(dt * 1e3, 3))

    loop_cost = frames * dt + 1.0
    n_loops = 0
    while n_loops < 3 and agree(_remaining() > loop_cost + 30.0):
        dt = min(dt, device_loop(frames))
        n_loops += 1
        emit(stats_from(dt, quality=f"best-of-{n_loops + 1}"))
    _mark(f"{preset}: device loops done", loops=n_loops + 1,
          frame_ms=round(dt * 1e3, 3), budget_left=round(_remaining()))

    present_dt = None
    dt2 = None
    present_cost = frames * (dt + 0.04) + 1.0
    if agree(_remaining() > 2 * present_cost + 30.0):
        present_dt = min(loop(frames), loop(frames))
        emit(stats_from(dt, present_dt, quality=f"best-of-{n_loops + 1}"))
        _mark(f"{preset}: present loops done", present_ms=round(present_dt * 1e3, 3))
        if depth == 2:
            dt2 = present_dt
        elif agree(_remaining() > 2 * present_cost + 30.0):
            dt2 = min(loop(frames, depth=2), loop(frames, depth=2))
            _mark(f"{preset}: interactive loops done", interactive_ms=round(dt2 * 1e3, 3))
    else:
        _mark(f"{preset}: skipping present/interactive rows", budget_left=round(_remaining()))

    # the preview row: the viewer's --preview stream (box downsample +
    # yuv420), at the interactive row's depth 2
    preview_dt = None
    preview_scale = None
    if (dt2 is not None and config.present_scale == 1 and config.present_format == "rgb"
            and config.width % 4 == 0 and config.height % 4 == 0
            and agree(_remaining() > 2 * present_cost + 60.0)):
        scales = [2]
        if config.width >= 3840 and config.width % 8 == 0 and config.height % 8 == 0:
            scales.append(4)
        for scale in scales:
            preview_fn = frame_program(scene.meta, config.replace(present_format="yuv420",
                                                                  present_scale=scale), mesh)

            def preview_render():
                return preview_fn(scene.render_scene, scene.camera.view_projection_transform,
                                  scene.camera.position)

            t0 = time.time()
            preview_render().cpu()
            _mark(f"{preset}: preview program ready (scale {scale})",
                  secs=round(time.time() - t0, 1))
            if agree(_remaining() > 2 * present_cost + 30.0):
                p_dt = min(loop(frames, depth=2, render=preview_render),
                           loop(frames, depth=2, render=preview_render))
                _mark(f"{preset}: preview loops done (scale {scale})",
                      preview_ms=round(p_dt * 1e3, 3))
                if preview_dt is None or p_dt < preview_dt:
                    preview_dt, preview_scale = p_dt, scale

    stats = stats_from(dt, present_dt, dt2, quality=f"best-of-{n_loops + 1}")
    if mesh is not None:
        stats["mesh"] = str(mesh)
    if preview_dt is not None:
        stats["preview_fps"] = 1.0 / preview_dt
        stats["preview_frame_ms"] = preview_dt * 1e3
        stats["preview_scale"] = preview_scale
    return stats


def _format_line(preset, width, height, msaa, stats, present_format,
                 mesh_shape, aniso_taps=1):
    """bench.py's JSON line, key for key."""
    extra = {}
    if present_format != "rgb":
        extra["present_format"] = present_format
    if aniso_taps != 1:
        extra["aniso_taps"] = aniso_taps
    if mesh_shape is not None:
        extra["mesh"] = stats.get("mesh", f"gp{mesh_shape[0]}x sp{mesh_shape[1]}")
    line = {
        "metric": f"{preset} @{width}x{height} {msaa}xMSAA render FPS"
                  f" ({stats['triangles']} tris, {stats['platform']}/{stats['backend']})",
        "value": round(stats["fps"], 2),
        "unit": "fps",
        "vs_baseline": round(stats["fps"] / BASELINE_TARGET_FPS, 3),
        "frame_ms": round(stats["frame_ms"], 2),
        "mtris_per_s": round(stats["mtris_per_s"], 1),
        "compile_s": round(stats["compile_s"], 1),
        "session_init_s": round(stats["session_init_s"], 1),
        **extra,
    }
    if "present_fps" in stats:
        line["present_fps"] = round(stats["present_fps"], 2)
    if "interactive_fps" in stats:
        line["interactive_fps"] = round(stats["interactive_fps"], 2)
    if "preview_fps" in stats:
        line["preview_fps"] = round(stats["preview_fps"], 2)
        if stats.get("preview_scale", 2) != 2:
            line["preview_scale"] = stats["preview_scale"]
    if stats.get("quality"):
        line["loops"] = stats["quality"]
    return line


def _error_line(preset, width, height, msaa, exc) -> dict:
    return {
        "metric": f"{preset} @{width}x{height} {msaa}xMSAA render FPS",
        "value": 0.0,
        "unit": "fps",
        "vs_baseline": 0.0,
        "error": f"{type(exc).__name__}: {exc}"[:300],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", default="sponza", choices=sorted(CONFIGS))
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--msaa", type=int, default=None)
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--depth", type=int, default=4,
                        help="frames in flight (throughput pipelining)")
    parser.add_argument("--backend", default=None,
                        choices=["pallas", "tiled", "dense"],
                        help="raster backend: pallas (the streaming raster, the "
                             "default) only; tiled and dense are not ported")
    parser.add_argument("--anisotropy", type=float, default=16.0,
                        help="max sampler anisotropy (1 = off)")
    parser.add_argument("--aniso-taps", type=int, default=1, choices=[1, 2, 4, 8],
                        help="true multi-tap anisotropic filtering (--all adds a "
                             "sponza aniso_taps=2 row automatically)")
    parser.add_argument("--present-format", default="rgb", choices=("rgb", "yuv420"),
                        help="device-side present encoding for the present/"
                             "interactive rows (yuv420 = half the device->host "
                             "bytes; render fps unaffected)")
    parser.add_argument("--mesh", default=None, metavar="GP,SP",
                        help="the multi-device frame path over a (gp, sp) mesh of "
                             "processes (under torchrun --nproc-per-node GP*SP)")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--budget", type=float, default=None,
                        help="wall-clock budget in seconds (same as env "
                             "BENCH_BUDGET_S, default 480): the watchdog "
                             "flushes the best-so-far JSON and exits when "
                             "it expires")
    parser.add_argument("--verbose", action="store_true",
                        help="print observability counters to stderr")
    args = parser.parse_args()
    if args.budget is not None:
        global _BUDGET_S, _DEADLINE
        _BUDGET_S = float(args.budget)
        _DEADLINE = _T0 + _BUDGET_S

    mesh_shape = None
    if args.mesh:
        gp, sp = (int(x) for x in args.mesh.split(","))
        mesh_shape = (gp, sp)

    # arm the watchdog + signal flush BEFORE anything heavy (importing torch
    # takes seconds, and a SIGTERM landing then must still print a line)
    _mark("bench start", budget_s=_BUDGET_S, argv=" ".join(sys.argv[1:]) or "(headline)")
    threading.Thread(target=_watchdog, daemon=True).start()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):  # pragma: no cover - non-main thread
            pass

    # jobs: (preset, aniso_taps). --all appends the sponza aniso_taps=2 row;
    # an explicit --aniso-taps applies to every job instead.
    if args.all:
        jobs = [(p, args.aniso_taps) for p in sorted(CONFIGS)]
        if args.aniso_taps == 1:
            jobs.append(("sponza", 2))
    else:
        jobs = [(args.preset, args.aniso_taps)]

    def job_config(preset):
        _, width, height, msaa = CONFIGS[preset]
        return preset, args.width or width, args.height or height, args.msaa or msaa

    _mark("import torch")
    with contextlib.ExitStack() as stack:
        try:
            mesh = None
            dev = bench_device()
            if mesh_shape is not None:
                from vktf_tpu_torch.parallel.launch import launcher_mesh

                mesh, _ = stack.enter_context(launcher_mesh(*mesh_shape, dev.type))
                _state["quiet"] = mesh.rank != 0
        except (RuntimeError, ValueError) as exc:
            _print_line(_error_line(*job_config(jobs[0][0]), exc))
            _state["done"] = True
            return 1
        return _run_jobs(args, jobs, job_config, mesh_shape, mesh)


def _run_jobs(args, jobs, job_config, mesh_shape, mesh) -> int:
    code = 0
    for i, (preset, aniso_taps) in enumerate(jobs):
        out_of_budget = i > 0 and _remaining() < 120.0
        if mesh is not None:
            out_of_budget = bool(mesh.broadcast_host([float(out_of_budget)])[0])
        if out_of_budget:
            _mark(f"skipping {preset}: budget exhausted", budget_left=round(_remaining()))
            break
        preset, width, height, msaa = job_config(preset)

        def emit(stats, preset=preset, width=width, height=height, msaa=msaa,
                 aniso_taps=aniso_taps):
            _set_partial(_format_line(preset, width, height, msaa, stats,
                                      args.present_format, mesh_shape, aniso_taps))

        try:
            stats = run_bench(preset, width, height, msaa, args.frames,
                              backend=args.backend, depth=args.depth,
                              anisotropy=args.anisotropy, aniso_taps=aniso_taps,
                              present_format=args.present_format,
                              mesh=mesh, emit=emit)
        except Exception as exc:  # a failed row reports and the next one runs
            _print_line(_error_line(preset, width, height, msaa, exc))
            code = 1
            continue
        _print_line(_format_line(preset, width, height, msaa, stats,
                                 args.present_format, mesh_shape, aniso_taps))
    if args.verbose:
        from vktf_tpu_torch.utils.profiling import counters

        print(f"counters: {counters.snapshot()}", file=sys.stderr)
    _mark("bench done", elapsed=round(time.time() - _T0, 1))
    _state["done"] = True
    return code


if __name__ == "__main__":
    sys.exit(main())
