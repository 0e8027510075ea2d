"""GPU smoke run of the PyTorch + CUDA port (vktf_tpu_torch).

    python3 chip_smoke.py            # sponza preset, 1920x1080, 4x MSAA
    python3 chip_smoke.py --small    # the 38k-triangle courtyard at 256x128 (the
                                     # presets and the bench at 256x128 too)
    python3 chip_smoke.py --four-cards  # the launch off the current card and
                                        # phase 15d alone, on four cards

Needs one CUDA card and nvcc. In order, it:
  1. reports the card (nvidia-smi name and power limit);
  2. builds the CUDA sources of vktf_tpu_torch/csrc (one nvcc each, in
     parallel; nineteen kernel records) and times the build; builds the
     native host runtime (csrc/host/vktf_native.cpp, g++) and requires it
     to load;
  3. builds the sponza preset with the port's numpy builder and uploads it;
     exports it (RGBA8 KTX2 under ZLIB, lossless) and the box preset
     (Basis ETC1S) to glTF files under vktf_tpu_torch/_build/assets/ for
     phase 10, and the sponza at the exporter's defaults (RGBA8 KTX2 under
     ZSTD, through libzstd with zstandard hidden) for phase 16;
  4. the opaque path (K = 1): renders frames through the port's Scene
     (render_async / render_still) with every kernel launch counter set to
     0 just before and read just after, printing per-stage CUDA-event
     times, the synchronized frame time and the steady frame time with 4
     frames in flight (enqueue, one synchronize, divide); then holds the
     stream with a ~0.1 s sleep kernel, enqueues 4 frames through
     render_async and requires the stream still busy when the last call
     returns (nothing on the frame path waits for the card);
  5. holds each K = 1 kernel against its plain PyTorch version on the
     card, at the shapes the frame gave it, and times both; setup and the
     shade table also as the bare C launch on preallocated outputs (CUDA
     events around launches queued behind a sleep kernel, and the
     profiler's kernel time), beside the wrapper; prints what the raster
     kernel stages for the frame's stream (staging_counts); holds the
     raster's winner form (rasterize_winner) bit for bit to pixel_winner
     of its planes form and to pixel_winner of the plain version's planes
     (winners within the raster's sample tolerance, coverage bit-equal
     where they agree) and times both forms and the planes form with
     phase A in torch beside each form's bound (winner_held); the raster
     and raster_layers records are the winner form, which the one-card
     pixel-rate frame runs;
  5a. the raster prologue (raster_stream) bit for bit against its plain
     version and timed beside it and its byte bound, at the sponza's
     stream and at the 2160p benchmark cell's (benchmark/configs'
     flythrough, 2,979,744 triangles, built by the benchmark's scene
     generator), and the winner form there at K = 1 and K = 8;
  5b. holds the depth at every covered sample of that frame (setup and
     raster kernels) to the float64 depth of its triangle through the same
     float32 clip corners, computed in float64 on the card, within the
     bound tests/torch_parity.py states (float64_depth_bound); prints the
     median, p99 and max error;
  6. renders the same scene at a forced peel_layers=2: the frame must
     equal the K = 1 frame;
  7. the translucent path: the sponza preset with its curtain and clutter
     materials BLEND at alpha 0.5 (K = 8 from the scene), frames through
     Scene.render_async with the counters zeroed and read (in flight and
     behind a sleeping stream, too), the K-layer
     raster (and its staging counts and its winner form) and the layer
     shade held against their plain versions and timed, and the
     stage-by-stage frame against the Scene frame;
  8. the texture side paths, each a path of its own through Scene with
     the counters zeroed and read, its kernel held against its plain
     version at the frame's shapes and timed:
       a. aniso_taps=4 on the opaque sponza (shade_taps; the frame differs
          from the one-tap frame);
       b. aniso_taps=4 on the translucent sponza (shade_layer_taps);
       c. shade_fused_pool=False (shade_classic; the frame equals the
          fused frame on every pixel);
       d. shade_attrs_boundary=True (shade_attrs; the frame equals c's,
          and phase A's "attrs" stage is timed);
       e. the mirror sponza (models.scenes.SAMPLER_PRESETS, every sampler
          MIRRORED_REPEAT: shade_classic);
       f. the mixed sponza (per-slot samplers: shade_per_slot);
       g. the layer forms on translucent scenes: shade_fused_pool=False
          (shade_layer_classic), the attrs boundary (shade_attrs_layer; its
          frame equals the two-gather one) and the translucent mixed
          sponza (shade_layer_per_slot);
       h. four taps on the other texel sources: the attrs boundary with
          aniso_taps=4 (shade_classic_taps; the frame equals a's) and the
          mixed sponza (shade_per_slot_taps);
       i. their layer forms at K = 8: shade_fused_pool=False with
          aniso_taps=4 (shade_layer_classic_taps; the frame equals b's)
          and the translucent mixed sponza (shade_layer_per_slot_taps);
  9. renders small frames of every path on the card and on the CPU (plain
     versions only) and compares them;
 10. the viewer, from files on disk: Engine.load of both exported presets
     (the load split: parse, texture decode, flatten, upload); the loaded
     sponza's still at CAMERA must equal phase 4's in-memory frame bit for
     bit; Engine.render's first call must return while a sleep kernel holds
     the stream; game.main at the phase's size, 4x MSAA, headless, for a
     32-frame fly-through with the counters zeroed just before and read
     just after (setup, raster, shade table and shade once per presented
     frame, no other kernel) and its FrameTimer p50 / p99 / FPS beside
     phase 4's render_async frame with 4 in flight; two frames dumped by
     --frame-dir (game.start) must decode to the presented frames;
 11. the other presets at bench_torch.py's configurations and cameras (box
     and duck 1920x1080 1x MSAA, helmet 1920x1080 4x, flythrough 3840x2160
     4x), each a path through Scene with the counters zeroed and read
     (setup, raster, shade table and shade once a frame, nothing else),
     and a 256x128 frame of each on the card against the CPU;
 12. the present encodings on the opaque sponza (yuv420, the rgb preview at
     scale 2, yuv420 at scale 2 and 4), each a path through Scene: the
     encoded frame must equal the CPU encode of the card's exact frame bit
     for bit and render_still the exact frame of phase 4; prints the frame
     time with 4 in flight and the copy to the host, and the bytes copied;
 13. sample-rate shading on the opaque sponza and the translucent one
     (K = 8), each a path through Scene: the layer record once a frame, the
     resolve record never, and 4 render_async calls return while a sleep
     kernel holds the stream; the layer record over every (layer, sample)
     entry timed with its bound, at K = 1 also held to its plain version;
 14. one bench_torch.run_bench("sponza", 1920, 1080, 4, frames=8) on the
     card, printing its JSON line (fps > 0 required);
 15. the multi-device frame path (vktf_tpu_torch.parallel): a. the raster's
     band offset: the second band of a (2, 2) mesh at K = 1 and K = 8 against
     the full-frame raster's rows (ids and depth bit-equal) and against the
     plain version at the band's shape; b. NCCL at world size 1 in this
     process, the opaque sponza on a (1, 1) mesh driven as a path (its frame
     equal to phase 4's bit for bit; frame times beside phase 4's: the
     sharded program's own overhead); c. one spawn of 4 processes sharing
     the card over gloo (parallel/launch.py), the opaque sponza on (2, 2),
     (4, 1) and (1, 4), the translucent (K = 8) and mixed sponza on (2, 2),
     and the opaque, translucent and mixed sponza at sample rate on (2, 2),
     each frame equal to its single-device frame at its rate bit for bit
     (phase 13's sample-rate frames; the mixed one rendered in the phase),
     the counters zeroed and read on every rank (at sample rate the layer
     record once a frame, the resolve records never), frame and stage times
     printed (4 ranks on one card over gloo: not a scaling number); d. with
     4 or more cards, the same cases over NCCL, one card a rank, else a line
     saying it did not run. The launch on a card that is not the current
     one (a Scene on cuda:1 with card 0 current, Engine() after
     torch.cuda.set_device(1): each frame equal to card 0's bit for bit)
     runs with --four-cards; a one-card run says on an early line that it
     did not run;
 16. the native host runtime and the numpy oracle: Engine.load of the
     ZSTD sponza with zstandard hidden (the load split), its 1080p 4x frame
     through the K = 1 kernels equal to phase 4's bit for bit; host
     timings, native against numpy (VKTF_NATIVE=0), each pair bit-equal:
     one 2048x2048 sRGB texture's ZSTD decode, mips and pool pack, and the
     sponza's ZLIB files through Engine.load, printed beside the host CPU
     and the card; tests/test_alpha.py's five fixtures (the opaque and the
     BLEND quad over the box at 1x and 4x, the three-deep stack; written
     with the port's writer) rendered at 96x64 by the kernels, every sample
     shaded, each a path with the counters zeroed and read, held to the
     port's numpy oracle (ops/reference.py) within
     tests/helpers.assert_images_close's default budget;
 17. checks the frames (shape, dtype, the share of pixels lit: 50% for
     sponza paths, 5% for the single-object presets), saves them as .npy in
     the build directory (vktf_tpu_torch/_build/, not committed), and prints
     the kernels line, the card line and, last, {"ok": true, "device": {...}}.
Each kernel record carries its least possible time on the card
(``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, both counted from this run's inputs).
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# sponza camera: inside the courtyard, looking down its length
CAMERA = ((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0))

# tolerances of the kernel-vs-plain comparisons on the card (see README)
SETUP_FLOAT_MISMATCH = 1e-5   # fraction of plane/anchor values not bit-equal
RASTER_ID_MISMATCH = 1e-5     # fraction of samples whose winner differs
TABLE_MISMATCH = 1e-5         # fraction of table values not bit-equal
SHADE_STEP = 1                # max u8 step of any channel
SHADE_MISMATCH = 1e-3         # fraction of pixels off by that step
FRAME_MISMATCH = 5e-3         # small frame: card vs CPU plain path
# layer shade: float32 values (covered entries) not bit-equal, and their
# largest distance in units in the last place (kernel and plain version run
# the same operations with the same CUDA math library)
SHADE_LAYER_MISMATCH = 1e-5
SHADE_LAYER_ULP = 4
# forced peel_layers=2 on the opaque scene vs the K = 1 frame: the
# composite returns an opaque layer 0 exactly, but the K = 1 path encodes
# sRGB inside the shade kernel (powf) and the K-layer path in torch
# (torch.pow), whose last bits may differ: one u8 step on <= 1e-4 pixels
FORCED_K2_MISMATCH = 1e-4
TRANSLUCENT_SHARE_MIN = 0.05  # pixels whose nearest surface is translucent
FRAMES_IN_FLIGHT = 4
# records a K = 1 frame launches once each: setup, the raster prologue,
# raster, shade table, shade (the first entries of main's kernel list)
K1_RECORDS = 5
# torch.cuda._sleep cycles holding the stream: ~0.1 s at the H100's clock
SLEEP_CYCLES = 200_000_000

# the card's published peaks (H100 SXM): HBM bytes/s, float32 operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per unit of work, counted from the kernels' sources
# (a transcendental counted as 20): setup per triangle; raster per
# (sample, triangle) pair whose pixel lies in the triangle's bbox (5 plane
# evaluations and the tests); table per triangle; shade per shaded pixel
# the plane evaluation (1/w and the interpolated attributes) and the tail
# (TBN, alpha), plus per texture tap the addressing (LOD and both levels'
# windows) and the 24 texel decodes and filters of three textures at two
# levels, plus per light the BRDF. The attrs kernels take the plane
# evaluation and the addressing from phase A and do neither.
SETUP_OPS = 420
RASTER_OPS = 20
TABLE_OPS = 600
SHADE_OPS_PLANES = 100
SHADE_OPS_TAIL = 200
SHADE_OPS_ADDR_PER_TAP = 100
SHADE_OPS_FILTER_PER_TAP = 600
SHADE_OPS_PER_LIGHT = 120


# The bound of a covered sample's depth against the float64 depth of its
# triangle through the same float32 clip corners, as
# tests/torch_parity.py's float64_depth_bound states it: 2^-20 plus 2^-16
# of the plane's change across the triangle's bbox times the conditioning
# of the screen-space solve; where the homogeneous plane stays (near-plane
# crossers, insane projections), 128 roundings of its summand scale
# (depth_plane_bound) in place of the second term.
DEPTH_F64_ABS, DEPTH_F64_REL = 2.0 ** -20, 2.0 ** -16
DEPTH_PLANE_ROUNDINGS = 128

# the oracle's budget: tests/helpers.py assert_images_close's defaults
ORACLE_MAX_MEAN = 2.0        # mean |diff| over the RGB values
ORACLE_MAX_OUTLIERS = 0.015  # share of pixels with a channel more than ...
ORACLE_OUTLIER_STEP = 8      # ... this many u8 steps apart
ORACLE_SIZE = (96, 64)
ORACLE_CAMERA = ((0.0, 0.6, 2.2), (0.0, -0.2, -1.0))
HOST_TEXTURE = 2048  # the side of the host timings' sRGB texture


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    return torch.device("cuda", 0)


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bare_ms(launch, reps: int) -> float:
    """Device time of one kernel launch: `launch` calls a C entry point on
    preallocated outputs; the host queues `reps` of them behind a sleep
    kernel, so the events around them time the card alone."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES // 4)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, reps: int, kernel_name: str):
    """The profiler's device time per call of the kernels whose name holds
    kernel_name, over `reps` calls of fn; None when it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                   for e in prof.key_averages() if kernel_name in e.key)
    return total_us / reps / 1e3 if total_us else None


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bits_mismatch(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """(count of float32 values whose bits differ, max |a - b|)."""
    diff = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
    err = (a - b).abs()
    err = torch.where(torch.isnan(err), torch.zeros_like(err), err)
    return int(diff.sum()), float(err.max()) if err.numel() else 0.0


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms the card could take, and what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def raster_bound(stream, height: int, width: int, samples: int, layers: int,
                 winner: bool = False):
    """Valid triangles' 20 stream rows and 8 bbox rows read once, the chunk
    bboxes, and the output written once: the (K, S, H, W) ids and depths of
    the planes form, or the winner form's (K, H, W) int32 ids and (H, W)
    float32 coverage; operations per (sample, triangle) pair whose pixel
    lies in the triangle's bbox."""
    tri_data, tri_bbox, chunk_bbox = stream
    valid = tri_data[15] >= 0
    box = tri_bbox[:4, valid]
    area = (box[2] - box[0]).clamp(min=0) * (box[3] - box[1]).clamp(min=0)
    out = (layers + 1) * 4 if winner else layers * samples * 8
    nbytes = int(valid.sum()) * 28 * 4 + chunk_bbox.numel() * 4 + height * width * out
    return bound(nbytes, float(area.double().sum()) * samples * RASTER_OPS)


def stream_bound(t: int, t_pad: int) -> tuple[float, str]:
    """The raster prologue's bytes: each position's perm entry (8 bytes) and
    each triangle's 24 tri_data and 4 bbox floats read once, 24 + 8 stream
    floats written a position, and the chunk bboxes."""
    return bound(t_pad * 8 + t * 28 * 4 + t_pad * 32 * 4 + t_pad // 256 * 16, 0.0)


def stream_held(what: str, tri_data, bbox_rows, perm) -> tuple:
    """Phase 5a at one stream: raster_stream's three outputs bit for bit
    against raster_stream_plain's, then both timed; prints the kernel's
    time (CUDA events through the wrapper, and the profiler's kernel time)
    beside the plain version's and the byte bound. Returns (kernel ms
    through the wrapper, plain ms, (bound ms, what bounds it))."""
    from vktf_tpu_torch.ops import raster

    args = (tri_data, bbox_rows, perm)
    got, want = raster.raster_stream(*args), raster.raster_stream_plain(*args)
    require(all(g.shape == w.shape for g, w in zip(got, want)),
            f"raster stream {what}: the plain version's shapes")
    n_bad = sum(bits_mismatch(g, w)[0] for g, w in zip(got, want))
    require(n_bad == 0, f"raster stream {what}: bit-equal to the plain version ({n_bad} differ)")
    del got, want
    t, t_pad = tri_data.shape[1], perm.shape[0]
    kernel_ms = cuda_ms(lambda: raster.raster_stream(*args), 50)
    alone_ms = profiled_ms(lambda: raster.raster_stream(*args), 50, "stream_kernel")
    plain_ms = cuda_ms(lambda: raster.raster_stream_plain(*args), 20)
    bound_ms, bound_by = bound_pair = stream_bound(t, t_pad)
    alone = "not measured" if alone_ms is None else f"{alone_ms:.4f} ms"
    log(f"raster stream, {what}: {t} triangles, {t_pad // 256} chunks; all three outputs "
        f"bit-equal to the plain version; kernel {kernel_ms:.4f} ms through the wrapper (CUDA "
        f"events), {alone} alone (profiler); plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms "
        f"({bound_by}), {100 * bound_ms / (alone_ms or kernel_ms):.1f}% of it reached")
    return kernel_ms, plain_ms, bound_pair


def winner_held(what: str, stream, height: int, width: int, samples: int, layers: int,
                plain=None, allowed: int = 0) -> tuple:
    """The raster kernel's winner form at one stream: bit for bit
    pipeline.pixel_winner of its planes form and, where ``plain`` gives the
    plain version's (ids, depth) planes, against pixel_winner of those: at
    most ``allowed`` pixels whose winner differs in a layer, and the
    coverage bit-equal wherever the winners agree. Then timed through the
    wrappers against the planes form alone and the planes form followed by
    phase A in torch (the frame program before the winner form), and each
    form's raster_kernel alone (profiler), beside each form's bound.
    Returns (max |coverage diff| against the plain version, winner form ms
    through the wrapper, (bound ms, what bounds it))."""
    from vktf_tpu_torch.ops import pipeline, raster

    args = (*stream, height, width, samples, layers)
    tri, frac = raster.rasterize_winner(*args)
    want_tri, want_frac = pipeline.pixel_winner(*raster.rasterize(*args))
    n_bad = int((tri != want_tri).sum()) + bits_mismatch(frac, want_frac)[0]
    require(n_bad == 0, f"raster winner form, {what}, K = {layers}: bit-equal to pixel_winner "
                        f"of the planes form ({n_bad} values differ)")
    err = 0.0
    if plain is not None:
        p_tri, p_frac = pipeline.pixel_winner(*plain)
        agree = (tri == p_tri) if layers == 1 else (tri == p_tri).all(dim=0)
        px_bad = int((~agree).sum())
        f_bad, err = bits_mismatch(frac[agree], p_frac[agree])
        log(f"[winner form] {what}, K = {layers}: against pixel_winner of the plain version's "
            f"planes, winner differs at {px_bad} of {agree.numel()} pixels (tolerance {allowed}), "
            f"coverage not bit-equal at {f_bad} of the rest (tolerance: bit-equal)")
        require(px_bad <= allowed and f_bad == 0,
                f"raster winner form, {what}, K = {layers}: against the plain version")
        del p_tri, p_frac, agree
    del tri, frac, want_tri, want_frac
    forms = {"winner form": lambda: raster.rasterize_winner(*args),
             "planes form": lambda: raster.rasterize(*args)}
    ms = {name: cuda_ms(fn, 20) for name, fn in forms.items()}
    ms["planes + phase A"] = cuda_ms(lambda: pipeline.pixel_winner(*raster.rasterize(*args)), 20)
    alone = {name: profiled_ms(fn, 20, "raster_kernel") for name, fn in forms.items()}
    bounds = {name: raster_bound(stream, height, width, samples, layers, name == "winner form")
              for name in forms}
    log(f"[winner form] {what}, {samples}x, K = {layers}: bit-equal to pixel_winner of the "
        "planes form; ms through the wrappers (CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + "; raster_kernel alone "
        "(profiler): " + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                                   for k, v in alone.items())
        + "; bound: " + ", ".join(f"{k} {b:.5f} ms ({by})" for k, (b, by) in bounds.items()))
    return err, ms["winner form"], bounds["winner form"]


def stream_2160p(dev) -> None:
    """Phase 5a at the 2160p benchmark cell's stream: its configuration's
    scene (benchmark/scene_gen.py, seed 0) at its camera."""
    from pathlib import Path

    from benchmark import program, scene_gen

    config = json.loads(Path("benchmark/configs/flythrough-2160p-msaa4.json").read_text())
    t0 = time.perf_counter()
    scn = program.scene(scene_gen.build(config["scene"], 0), config, dev)
    cam = config["camera"]
    scn.camera = program.camera(config, cam["position"], cam["direction"])
    st = frame_stages(scn)
    log(f"raster stream, 2160p cell: scene built in {time.perf_counter() - t0:.1f} s")
    stream_held("2160p cell", st["setup"]["tri_data"], st["setup"]["bbox_rows"], st["perm"])
    cfg = scn.config
    for layers in (1, 8):
        winner_held("2160p cell", st["stream"], cfg.padded_height, cfg.padded_width,
                    cfg.msaa_samples, layers)
    del scn, st
    torch.cuda.empty_cache()


def staging_counts(stream, height: int, width: int, block: int = 16) -> dict:
    """What the raster kernel stages for this stream, counted in torch: per
    16x16 block its hit chunks (chunk bbox overlaps the block) and its
    touching triangles (valid, bbox overlaps the block); per frame the bytes
    its triangle tests read into registers (5 rows of 1 KB per hit chunk)
    and the bytes it stages into shared memory (24 floats per touching
    triangle, 19 of them gathered by cp.async), beside the earlier design,
    which staged all 32 rows of every hit chunk (32 KB)."""
    tri_data, tri_bbox, chunk_bbox = stream
    dev = tri_data.device
    bx = torch.arange(0, width, block, device=dev, dtype=torch.float32)
    by = torch.arange(0, height, block, device=dev, dtype=torch.float32)
    hx = (chunk_bbox[0][None] < (bx + block)[:, None]) & (chunk_bbox[2][None] > bx[:, None])
    hy = (chunk_bbox[1][None] < (by + block)[:, None]) & (chunk_bbox[3][None] > by[:, None])
    hits = hy.double() @ hx.double().T  # (blocks y, blocks x)
    box = tri_bbox[:4, tri_data[15] >= 0].double()
    # the blocks a bbox touches: 16 i < x1 and 16 i + 16 > x0
    i0 = torch.floor(box[0] / block).clamp(0, bx.numel()).long()
    i1 = (torch.ceil(box[2] / block) - 1).clamp(-1, bx.numel() - 1).long()
    j0 = torch.floor(box[1] / block).clamp(0, by.numel()).long()
    j1 = (torch.ceil(box[3] / block) - 1).clamp(-1, by.numel() - 1).long()
    keep = (i1 >= i0) & (j1 >= j0)
    i0, i1, j0, j1 = i0[keep], i1[keep], j0[keep], j1[keep]
    diff = torch.zeros((by.numel() + 1, bx.numel() + 1), dtype=torch.float64, device=dev)
    ones = torch.ones_like(i0, dtype=torch.float64)
    for jj, ii, sign in ((j0, i0, 1), (j0, i1 + 1, -1), (j1 + 1, i0, -1), (j1 + 1, i1 + 1, 1)):
        diff.index_put_((jj, ii), sign * ones, accumulate=True)
    touch = diff.cumsum(0).cumsum(1)[:-1, :-1]
    n_hits, n_touch = float(hits.sum()), float(touch.sum())
    return {"blocks": hits.numel(), "chunks": chunk_bbox.shape[1],
            "hit_chunks_per_block_mean": round(n_hits / hits.numel(), 3),
            "hit_chunks_per_block_max": int(hits.max()),
            "touching_tris_per_block_mean": round(n_touch / hits.numel(), 3),
            "touching_tris_per_block_max": int(touch.max()),
            "block_chunk_hits": int(n_hits), "block_tri_touches": int(n_touch),
            "test_read_mb": round(n_hits * 5 * 1024 / 1e6, 3),
            "staged_mb": round(n_touch * 24 * 4 / 1e6, 3),
            "staged_mb_whole_chunks": round(n_hits * 32 * 1024 / 1e6, 3)}


def shade_bound(tri, sx, sy, table, max_anisotropy: float, num_lights: int, layer: bool,
                texels: str = "fused", taps: int = 1, attrs: bool = False):
    """The per-pixel inputs the kernel reads once (tri, and the sx/sy
    centres and, resolving, the frac coverage; the attrs kernels read tri
    and frac alone), its outputs once (a packed pixel, or rgb and alpha of
    each (layer, pixel)), each distinct table row the covered entries read
    (256 bytes; the attrs form reads 28 floats and two pool-row indices per
    covered entry instead) and each distinct pool row the texel source
    reads over all taps (256 bytes: the l0 row of the fused form, the l0
    and l1 rows of the classic form, those of every slot per slot);
    operations per covered entry."""
    from vktf_tpu_torch.ops import shade_kernel as sk
    from vktf_tpu_torch.ops.fmath import f32

    n = tri.shape[-1]
    flat = tri.reshape(-1)
    covered = flat >= 0
    reps = flat.numel() // n
    ids = flat[covered]
    px, py = sx.repeat(reps)[covered], sy.repeat(reps)[covered]
    # the pool rows each covered entry reads: the fragment body's
    # addressing (shade_kernel._fragment_plain)
    rows = table[ids.long()]

    def cf(v):
        return f32(v, px)

    def col(c):
        return rows[:, c]

    inv_w, attr = sk._anchored(cf, col, px, py)
    pool_rows = []
    for shift in [None] if taps == 1 else [(i + 0.5) / taps - 0.5 for i in range(taps)]:
        tps = [sk._texture_params(cf, col, inv_w, attr, max_anisotropy, s, shift)
               for s in range(3)]
        for tp in tps if texels == "per_slot" else tps[:1]:
            level0, level1 = sk.pool_window_addr(cf, tp)
            pool_rows += [level0[0]] if texels == "fused" else [level0[0], level1[0]]
    row_bytes = (ids.numel() * (sk.ATTR_ROWS + 2) * 4 if attrs
                 else torch.unique(ids).numel() * 256)
    in_bytes_per_px = (0 if layer else 4) + (0 if attrs else 8)
    out_bytes_per_entry = 16 if layer else 4
    nbytes = (flat.numel() * 4 + n * in_bytes_per_px + flat.numel() * out_bytes_per_entry
              + row_bytes + torch.unique(torch.cat(pool_rows)).numel() * 256)
    per_tap = SHADE_OPS_FILTER_PER_TAP + (0 if attrs else SHADE_OPS_ADDR_PER_TAP)
    ops = int(covered.sum()) * ((0 if attrs else SHADE_OPS_PLANES) + SHADE_OPS_TAIL
                                + per_tap * taps + SHADE_OPS_PER_LIGHT * num_lights)
    return bound(nbytes, ops)


def frame_stages(scn) -> dict:
    """A scene's frame up to the shade, stage by stage with the kernels, as
    its path gives each stage its inputs: vp, inst_rows, tri_instance,
    lights, setup, perm, stream, table, the raster's ids, and the pixel-rate
    shade's tri and frac (kernel_ab.py uses it too)."""
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel, shade_table

    rs, config = scn.render_scene, scn.config
    vp = torch.as_tensor(np.asarray(scn.camera.view_projection_transform, np.float32),
                         device=rs.tri_corner.device)
    inst_rows, tri_instance, lights = pipeline.scene_update(rs, scn.meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, config.width,
                                    config.height)
    perm = raster.stream_perm(setup["bbox_rows"], setup["valid"], chunk=config.pallas_chunk)
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"], perm,
                                  chunk=config.pallas_chunk)
    ids, depth = raster.rasterize(*stream, config.padded_height, config.padded_width,
                                  config.msaa_samples, scn.frame_program.layers)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner, rs.tri_static_cols,
                                          setup["anchor2"], inst_rows, tri_instance)
    tri, frac = pipeline.pixel_winner(ids, depth)
    return dict(vp=vp, inst_rows=inst_rows, tri_instance=tri_instance, lights=lights,
                setup=setup, perm=perm, stream=stream, table=table, ids=ids, tri=tri, frac=frac)


def scene_leaves(rs) -> dict:
    """A device scene's leaves as numpy (flatten.scene_from_numpy's input)."""
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES

    leaves = {f: getattr(rs, f).cpu().numpy() for f in SCENE_LEAVES}
    leaves["quad_pool"] = leaves["quad_pool"].view(np.uint16)
    return leaves


def mesh_ranks(cases, inputs, frames: int, flight: int) -> dict:
    """One rank of phase 15's spawns. Per case (tag, scene key, gp, sp,
    config overrides): the scene from `inputs` (its leaves' .npz and
    SceneMeta) on this rank's card at the phase's configuration with the
    case's overrides, one warm frame, then with the
    counters zeroed `frames` synchronized frames (host clock), `flight`
    frames with FRAMES_IN_FLIGHT in flight (none when 0), the still, the
    counters, and one frame's stage times; every rank's counters are
    gathered to each rank. Returns {tag: {...}} (rank 0's is the one kept)."""
    import torch.distributed as dist

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel, shade_kernel, shade_table
    from vktf_tpu_torch.parallel import make_render_mesh
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda", torch.cuda.current_device())
    kernels = [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, raster.KERNEL_LAYERS,
               shade_table.KERNEL, *shade_kernel.KERNELS]
    out = {}
    for tag, key, gp, sp, overrides in cases:
        path, meta, (width, height) = inputs[key]
        with np.load(path) as z:
            leaves = {k: z[k] for k in z.files}
        config = RenderConfig(width=width, height=height, msaa_samples=4, **overrides)
        camera = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                                   0.1, 1.0e6))
        scn = Scene.from_render_scene(scene_from_numpy(leaves, dev), meta, config, camera,
                                      mesh=make_render_mesh(gp, sp))
        scn.render_async()
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        frame_ms = []
        for _ in range(frames):
            t0 = time.perf_counter()
            scn.render_async()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        pending = collections.deque()
        t0 = time.perf_counter()
        for _ in range(flight):
            if len(pending) == FRAMES_IN_FLIGHT:
                pending.popleft().synchronize()
            scn.render_async()
            done = torch.cuda.Event()
            done.record()
            pending.append(done)
        torch.cuda.synchronize()
        flight_ms = (time.perf_counter() - t0) * 1e3 / flight if flight else None
        still = scn.render_still()
        launches = {k.name: k.launches for k in kernels if k.launches}
        prog = scn.frame_program
        prog.timer = pipeline._StageTimer()
        scn.render_async()
        torch.cuda.synchronize()
        stages = prog.timer.millis()
        prog.timer = None
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, launches)
        out[tag] = {"still": still, "frame_ms": frame_ms, "flight_ms": flight_ms,
                    "launches": every,
                    "stages": stages, "layers": prog.layers, "form": str(prog.form)}
        del scn, prog
        torch.cuda.empty_cache()
    return out


# (tag, scene key, gp, sp, RenderConfig overrides)
SAMPLE_RATE = {"shading_rate": "sample"}
MESH_CASES = [("opaque_2x2", "opaque", 2, 2, {}), ("opaque_4x1", "opaque", 4, 1, {}),
              ("opaque_1x4", "opaque", 1, 4, {}), ("translucent_2x2", "translucent", 2, 2, {}),
              ("mixed_2x2", "mixed", 2, 2, {}), ("sample_2x2", "opaque", 2, 2, SAMPLE_RATE),
              ("sample_translucent_2x2", "translucent", 2, 2, SAMPLE_RATE),
              ("sample_mixed_2x2", "mixed", 2, 2, SAMPLE_RATE)]


def mesh_spawn(label: str, scenes: dict, size, backend: str, flight: int) -> collections.Counter:
    """Phase 15's spawned paths: MESH_CASES on 4 ranks (`backend`: gloo, the
    ranks sharing the card; nccl, one card a rank), each scene given as
    (device scene leaves, SceneMeta, {shading rate: single-device still});
    every frame must equal its scene's still at its rate bit for bit and
    every rank must launch setup, raster, shade table and shade once a
    frame, at sample rate the shade a layer record (no resolve record).
    Returns the launches."""
    from vktf_tpu_torch.ops import _cuda, shade_kernel
    from vktf_tpu_torch.parallel import launch

    input_dir = _cuda.BUILD_DIR / "mesh_inputs"
    input_dir.mkdir(parents=True, exist_ok=True)
    inputs = {}
    for key, (leaves, meta_k, _still) in scenes.items():
        np.savez(input_dir / f"{key}.npz", **leaves)
        inputs[key] = (str(input_dir / f"{key}.npz"), meta_k, size)
    t0 = time.perf_counter()
    try:
        ranks = launch.run(mesh_ranks, 4, MESH_CASES, inputs, 3, flight, device="cuda",
                           backend=backend, timeout_s=400)
    finally:
        shutil.rmtree(input_dir, ignore_errors=True)
    log(f"[mesh] {label}: spawn and {len(MESH_CASES)} paths {time.perf_counter() - t0:.1f} s "
        f"on {card_line()}")
    shade_records = {k.name for k in shade_kernel.KERNELS}
    layer_records = {n for n in shade_records if n.startswith("shade_layer")}
    launches = collections.Counter()
    for tag, key, _gp, _sp, overrides in MESH_CASES:
        got = ranks[tag]
        rate = overrides.get("shading_rate", "pixel")
        same = np.array_equal(got["still"], scenes[key][2][rate])
        log(f"[mesh {tag}] {label}: K = {got['layers']}, {got['form']}, {rate} rate: frame == "
            f"the single-device frame: {same}; launches per rank over 3 frames, {flight} in flight "
            "and the still:", json.dumps(got["launches"]))
        log(f"[mesh {tag}] {label}: frame ms (host clock, synchronized) "
            f"{[round(v, 3) for v in got['frame_ms']]}"
            + (f"; with {FRAMES_IN_FLIGHT} in flight {got['flight_ms']:.4f} per frame over "
               f"{flight}" if flight else "")
            + "; rank 0 stage ms (CUDA events):",
            json.dumps({k: round(v, 4) for k, v in got["stages"].items()}))
        require(same, f"mesh {tag} ({label}): frame == the single-device frame")
        for launched in got["launches"]:
            require(len(set(launched.values())) == 1 and len(launched) == 5,
                    f"mesh {tag}: setup, the raster prologue, raster, shade table and shade "
                    f"once a frame on every rank: {launched}")
            if rate == "sample":
                require(set(launched) & shade_records <= layer_records,
                        f"mesh {tag}: the layer record, never a resolve record: {launched}")
            launches.update(launched)
    return launches


def depth_against_float64(rs, inst_rows, tri_instance, vp, setup, ids, depth, config) -> None:
    """Phase 5b: the raster kernel's depth at every covered sample of the
    frame (ids, depth (S, H, W) from the setup kernel's rows) against the
    float64 depth of its triangle through the same float32 clip corners,
    computed in float64 on the card (2D homogeneous: depth = z^T M^-1 s, M's
    columns (xs, ys, w) of the corners), within the bound above."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS
    from vktf_tpu_torch.ops.setup_kernel import instance_rowsT
    from vktf_tpu_torch.ops.vertex import clip_corners, setup_from_corners

    width, height = config.width, config.height
    corners = clip_corners(rs.tri_corner, instance_rowsT(inst_rows, tri_instance), vp)
    flat = setup_from_corners(*corners, width, height)
    homogeneous, inv_det = ~flat["use_screen"], flat["inv_det"].double().abs()
    x, y, z, w = ([c.double() for c in row] for row in corners)
    xs = [(x[i] + w[i]) * (0.5 * width) for i in range(3)]
    ys = [(y[i] + w[i]) * (0.5 * height) for i in range(3)]
    m = torch.stack([torch.stack(xs, -1), torch.stack(ys, -1), torch.stack(w, -1)], -2)
    ok = torch.linalg.det(m).abs() > 0
    minv = torch.zeros_like(m)
    minv[ok] = torch.linalg.inv(m[ok])
    co = torch.einsum("ti,tij->tj", torch.stack(z, -1), minv)
    front = (w[0] > 1e-12) & (w[1] > 1e-12) & (w[2] > 1e-12)
    px = [torch.where(front, xs[i] / w[i], 0.0) for i in range(3)]
    py = [torch.where(front, ys[i] / w[i], 0.0) for i in range(3)]
    p1 = (px[1] - px[0]) * (py[2] - py[0])
    p2 = (px[2] - px[0]) * (py[1] - py[0])
    cond = (p1.abs() + p2.abs()) / (p1 - p2).abs()
    br = setup["bbox_rows"].double()
    bw, bh = br[2] - br[0], br[3] - br[1]
    screen = DEPTH_F64_REL * cond * (co[:, 0].abs() * bw + co[:, 1].abs() * bh)
    e9 = setup["edge9"].double()
    scale = [inv_det * sum((e9[3 * i + k] * z[i]).abs() for i in range(3)) for k in range(3)]
    crosser = ~front
    homog = 2.0 ** -24 * DEPTH_PLANE_ROUNDINGS * (
        scale[0] * bw + scale[1] * bh + 1.0
        + torch.where(crosser, scale[0] * br[0] + scale[1] * br[1] + scale[2], 0.0))
    bound_t = DEPTH_F64_ABS + torch.where(homogeneous, homog, screen)
    s, sy_i, sx_i = torch.nonzero(ids >= 0, as_tuple=True)
    tri = ids[s, sy_i, sx_i].long()
    offsets = torch.tensor(SAMPLE_OFFSETS[config.msaa_samples], dtype=torch.float64,
                           device=ids.device)[s]
    sx, sy = sx_i.double() + offsets[:, 0], sy_i.double() + offsets[:, 1]
    exact = co[tri, 0] * sx + co[tri, 1] * sy + co[tri, 2]
    err = (depth[s, sy_i, sx_i].double() - exact).abs()
    ratio = err / bound_t[tri]
    ranked = err.sort().values
    median, p99 = (float(ranked[int(q * (ranked.numel() - 1))]) for q in (0.5, 0.99))
    log(f"[depth] {err.numel()} covered samples ({int(homogeneous[tri].sum())} on homogeneous "
        f"planes): |depth - float64| median {median:.3e}, p99 {p99:.3e}, max "
        f"{float(ranked[-1]):.3e}; worst error / bound {float(ratio.max()):.4f} (bound: "
        f"2^-20 + 2^-16 x K x the plane's change over the bbox; homogeneous planes: "
        f"{DEPTH_PLANE_ROUNDINGS} roundings of the summand scale)")
    require(bool((ratio <= 1.0).all()), "covered-sample depth within the float64 bound")


def off_current_card(config, camera, assets, still, asset_dir) -> None:
    """The launch off the current card, on a machine with two or more cards: a Scene on
    cuda:1 while card 0 is current, and an Engine made after
    torch.cuda.set_device(1) (the current card, which it must take), each
    render the opaque sponza at `camera`; both frames must equal card 0's
    `still` bit for bit."""
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.scene.scene import Scene
    from vktf_tpu_torch.window import Window

    quiet = Log(out_stream=sys.stderr, err_stream=sys.stderr)
    torch.cuda.set_device(0)
    other = Scene(assets, config, camera=camera, device="cuda:1")
    frames = [other.render_async() for _ in range(FRAMES_IN_FLIGHT)]
    require(torch.cuda.current_device() == 0, "rendering on cuda:1 leaves card 0 current")
    require(all(f.device == torch.device("cuda", 1) for f in frames), "frames on cuda:1")
    require(all(np.array_equal(f.cpu().numpy(), still) for f in frames),
            "a Scene on cuda:1 with card 0 current renders card 0's frame bit for bit")
    log(f"[current card] Scene(device=\"cuda:1\") with card 0 current: {FRAMES_IN_FLIGHT} "
        "render_async frames on cuda:1, each equal to card 0's frame bit for bit")
    del other, frames
    files = [export_asset(a, asset_dir / "sponza", "rgba", quiet, SUPERCOMPRESSION_ZLIB)
             for a in assets]
    torch.cuda.set_device(1)
    try:
        engine = Engine(Window(width=config.width, height=config.height), config, quiet)
        require(engine.device == torch.device("cuda", 1), f"Engine() took {engine.device}")
        loaded = engine.load(files)
        loaded.camera = camera
        for _ in range(3):
            engine.render(loaded)
        engine.wait_idle()
        presented = np.moveaxis(engine.window.last_frame[..., :3], -1, 0)
        require(np.array_equal(presented, still),
                "Engine() after set_device(1) presents card 0's frame bit for bit")
    finally:
        torch.cuda.set_device(0)
    log("[current card] Engine() after torch.cuda.set_device(1): renders on cuda:1; its "
        "presented frame equals card 0's frame bit for bit")


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG as the port's window writes it (filter 0
    rows, window.write_png), decoded with zlib: (H, W, 3) or (H, W, 4)."""
    blob = path.read_bytes()
    pos, idat, size, channels = 8, b"", None, None
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        if kind == b"IHDR":
            size = struct.unpack(">II", blob[pos + 8:pos + 16])
            channels = {2: 3, 6: 4}[blob[pos + 17]]
        elif kind == b"IDAT":
            idat += blob[pos + 8:pos + 8 + length]
        pos += 12 + length
    width, height = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + channels * width)
    require(bool((rows[:, 0] == 0).all()), f"{path.name}: unfiltered rows")
    return rows[:, 1:].reshape(height, width, channels)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 distance in units in the last place."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def viewer_breakdown(engine, scene, frames: int = 32) -> None:
    """Where a viewer frame's host time goes: `frames` Engine.render calls
    at a fixed camera, timed by the host clock, then again under
    torch.profiler, whose spans split each frame into the dispatch
    (render_async, the pinned copy and its event) and the window's present
    (the interleaved RGBA copy); the rest of a frame is the wait on the
    oldest frame's event. Also the card's busy share in the profiled
    window (the kernels' device time over the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    engine.wait_idle()
    t0 = time.perf_counter()
    for _ in range(frames):
        engine.render(scene)
    engine.wait_idle()
    plain_ms = (time.perf_counter() - t0) * 1e3 / frames
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            engine.render(scene)
        engine.wait_idle()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    spans = {e.key: e.cpu_time_total / 1e3 / frames for e in events
             if e.key in ("engine.dispatch", "engine.present")}
    device_ms = sum(getattr(e, "self_device_time_total", None) or
                    getattr(e, "self_cuda_time_total", 0.0) for e in events) / 1e3
    log(f"[viewer] Engine.render at a fixed camera, {frames} frames: {plain_ms:.4f} ms per frame "
        f"(host clock); profiled {wall_ms / frames:.4f} ms per frame, of which dispatch "
        f"{spans.get('engine.dispatch', float('nan')):.4f} ms and present "
        f"{spans.get('engine.present', float('nan')):.4f} ms (profiler spans, host); card busy "
        f"{device_ms / wall_ms:.4f} of the profiled wall time ("
        + ("not measured: no device time recorded" if device_ms == 0 else
           f"{device_ms / frames:.4f} ms of kernels and copies per frame") + ")")


def viewer_phase(dev, config, camera, meta, still, sponza_files, box_files, asset_dir,
                 kernels, flight_ms, export_s, viewer_log) -> None:
    """Phase 10: the viewer from files on disk (module docstring). `still`
    is the in-memory preset's frame at `camera`; `flight_ms` its
    render_async frame time with FRAMES_IN_FLIGHT in flight."""
    from vktf_tpu_torch import engine as engine_mod
    from vktf_tpu_torch import game
    from vktf_tpu_torch.ops import _cuda
    from vktf_tpu_torch.window import ScriptedInput, Window

    width, height = config.width, config.height
    clear = (np.asarray(config.clear_color[:3]) * 255 + 0.5).astype(np.uint8)
    export_sponza_s, export_box_s = export_s

    t_phase = time.perf_counter()
    on_disk = sum(f.stat().st_size for f in asset_dir.rglob("*") if f.is_file())
    log(f"[viewer] export (host s): sponza, RGBA8 KTX2 under ZLIB {export_sponza_s:.3f}; box, "
        f"Basis ETC1S {export_box_s:.3f}; {len(list(asset_dir.rglob('*.ktx2')))} .ktx2 files, "
        f"{on_disk / 1e6:.1f} MB on disk")
    engine = engine_mod.Engine(Window(width=width, height=height), config, viewer_log, device=dev)
    loaded = engine.load(sponza_files)
    load_s = dict(engine.load_seconds)
    log("[viewer] Engine.load of the sponza files (host s, upload ends in a synchronize):",
        json.dumps({k: round(v, 4) for k, v in load_s.items()}),
        f"total {sum(load_s.values()):.3f}")
    require(loaded.meta == meta, "the loaded sponza has the in-memory preset's shape")
    loaded.camera = camera
    require(np.array_equal(loaded.render_still(), still),
            "the sponza loaded from files renders the in-memory preset's frame bit for bit")
    log("[viewer] loaded sponza at CAMERA == in-memory preset frame: bit-equal")
    box = engine.load(box_files)
    require(box.light_count == 1 and box.meta.num_triangles == 12, "the box file loads")
    box.render_still()
    del box
    stream = torch.cuda.current_stream(dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    engine.render(loaded)
    host_ms = (time.perf_counter() - t0) * 1e3
    busy = not stream.query()
    engine.wait_idle()
    log(f"[viewer] Engine.render's first call returned after {host_ms:.3f} ms of host time; "
        f"stream still busy: {busy}")
    require(busy, "Engine.render returns while the card is busy")
    require(np.array_equal(np.moveaxis(engine.window.last_frame[..., :3], -1, 0), still),
            "Engine.render presents the synchronized frame")
    viewer_breakdown(engine, loaded)
    del loaded, engine

    viewer_stats = {}
    wait_idle = engine_mod.Engine.wait_idle

    def recording_wait_idle(self):
        wait_idle(self)
        viewer_stats.update(self.frame_timer.summary(), load=dict(self.load_seconds))

    engine_mod.Engine.wait_idle = recording_wait_idle
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        rc = game.main([*map(str, sponza_files), "--width", str(width), "--height",
                        str(height), "--msaa", "4", "--frames", "32", "--display", "off"])
        main_s = time.perf_counter() - t0
        viewer_launches = {k.name: k.launches for k in kernels}
    finally:
        engine_mod.Engine.wait_idle = wait_idle
    require(rc == 0, "game.main exits 0")
    n_frames = viewer_stats["frames"]
    log(f"[viewer] game.main, {width}x{height} 4x MSAA, 32-frame fly-through: {n_frames} frames "
        f"presented in {main_s:.3f} s of host time (load included); launches in the path:",
        json.dumps(viewer_launches))
    require(n_frames == 33, "the fly-through presents 33 frames")
    require(all(viewer_launches[k.name] == n_frames for k in kernels[:K1_RECORDS])
            and not any(viewer_launches[k.name] for k in kernels[K1_RECORDS:]),
            "setup, the raster prologue, raster, shade table and shade ran once per presented "
            "frame, nothing else")
    log("[viewer] game.main load (host s):",
        json.dumps({k: round(v, 4) for k, v in viewer_stats["load"].items()}))
    log(f"[viewer] FrameTimer over {n_frames} frames: p50 {viewer_stats['frame_ms_p50']:.4f} ms, "
        f"p99 {viewer_stats['frame_ms_p99']:.4f} ms, mean {viewer_stats['frame_ms_mean']:.4f} ms, "
        f"{viewer_stats['fps']:.2f} FPS; Scene.render_async with {FRAMES_IN_FLIGHT} frames in "
        f"flight (phase 4): {flight_ms:.4f} ms per frame")

    presented = []
    present = Window.present

    def recording_present(self, frame):
        present(self, frame)
        presented.append(self.last_frame.copy())

    dump_dir = _cuda.BUILD_DIR / "viewer_frames"
    shutil.rmtree(dump_dir, ignore_errors=True)
    Window.present = recording_present
    try:
        game.start([str(f) for f in sponza_files], width, height, config,
                   script=ScriptedInput([None]), frame_dir=dump_dir, display=None)
    finally:
        Window.present = present
    pngs = sorted(dump_dir.glob("frame_*.png"))
    require(len(pngs) == len(presented) == 2, "two frames dumped")
    for png, frame in zip(pngs, presented):
        require(np.array_equal(read_png(png), frame), f"{png.name} decodes to its frame")
    lit = float((presented[-1][..., :3] != clear).any(axis=-1).mean())
    log(f"[viewer] --frame-dir: {len(pngs)} PNGs decode to the presented frames; last frame "
        f"lit at {lit:.4f} of pixels")
    require(lit >= 0.5, "the viewer's frame is lit")
    log(f"[viewer] phase time: {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def without_zstandard():
    """The zstandard module hidden from import, so ZSTD runs through the
    native runtime's libzstd."""
    saved = sys.modules.get("zstandard")
    sys.modules["zstandard"] = None
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop("zstandard", None)
        else:
            sys.modules["zstandard"] = saved


@contextlib.contextmanager
def native_runtime(on: bool):
    """VKTF_NATIVE as asked: off, every host loop takes its numpy version."""
    saved = os.environ.get("VKTF_NATIVE")
    os.environ["VKTF_NATIVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("VKTF_NATIVE")
        else:
            os.environ["VKTF_NATIVE"] = saved


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it, and the cores this process sees."""
    model = "not reported"
    try:
        with open("/proc/cpuinfo") as cpuinfo:
            model = next((line.split(":", 1)[1].strip() for line in cpuinfo
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return f"{model} ({os.cpu_count()} cores visible)"


def quad_over_box(directory, front: dict, name: str):
    """tests/test_alpha.py's fixture, written with the port's writer: an
    alpha-tested or blended quad floating in front of an opaque box."""
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    w = GltfWriter()
    back = w.add_material(base_color_factor=(0.15, 0.6, 0.2, 1.0), metallic_factor=0.0,
                          roughness_factor=0.8)
    front_material = w.add_material(**front)
    mbox = w.add_mesh(box_mesh(0.6), material=back)
    mquad = w.add_mesh(plane_mesh(0.9), material=front_material)
    light = w.add_light("point", color=(6.0, 6.0, 6.0))
    sun = w.add_light("directional", color=(0.6, 0.6, 0.6))
    w.add_scene([
        w.add_node(mesh=mbox, translation=(0.0, 0.3, -0.6)),
        w.add_node(mesh=mquad, translation=(0.1, 0.35, 0.45),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        w.add_node(light=light, translation=(1.2, 1.5, 2.0)),
        w.add_node(light=sun, rotation=(0.2, 0.1, 0.0, 0.97)),
    ])
    return w.write(directory / name)


def stacked_blend_scene(directory, name: str = "stack.gltf", n_quads: int = 3,
                        dz: float = 0.2):
    """tests/test_alpha.py's stack of BLEND quads in front of an opaque box,
    written with the port's writer."""
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh, plane_mesh

    w = GltfWriter()
    back = w.add_material(base_color_factor=(0.15, 0.6, 0.2, 1.0), metallic_factor=0.0,
                          roughness_factor=0.8)
    colors = ((0.9, 0.2, 0.2, 0.45), (0.2, 0.3, 0.9, 0.5), (0.9, 0.8, 0.2, 0.4),
              (0.2, 0.9, 0.6, 0.5), (0.7, 0.2, 0.9, 0.45), (0.9, 0.5, 0.2, 0.5),
              (0.3, 0.8, 0.9, 0.4), (0.8, 0.3, 0.5, 0.5), (0.4, 0.6, 0.3, 0.45))
    quads = [w.add_material(base_color_factor=c, metallic_factor=0.0, roughness_factor=0.5,
                            alpha_mode="BLEND") for c in colors[:n_quads]]
    mbox = w.add_mesh(box_mesh(0.6), material=back)
    meshes = [w.add_mesh(plane_mesh(0.9), material=m) for m in quads]
    light = w.add_light("point", color=(6.0, 6.0, 6.0))
    sun = w.add_light("directional", color=(0.6, 0.6, 0.6))
    nodes = [
        w.add_node(mesh=mbox, translation=(0.0, 0.3, -0.6)),
        w.add_node(light=light, translation=(1.2, 1.5, 2.0)),
        w.add_node(light=sun, rotation=(0.2, 0.1, 0.0, 0.97)),
    ]
    for i, mq in enumerate(meshes):
        nodes.append(w.add_node(mesh=mq, translation=(0.1 - 0.05 * i, 0.35, 0.45 - dz * i),
                                rotation=(0.7071068, 0.0, 0.0, 0.7071068)))
    w.add_scene(nodes)
    return w.write(directory / name)


# (tag, fixture, MSAA samples): tests/test_alpha.py's five frames
OPAQUE_FRONT = dict(base_color_factor=(0.9, 0.25, 0.2, 1.0), metallic_factor=0.0,
                    roughness_factor=0.5)
BLEND_FRONT = dict(base_color_factor=(0.9, 0.25, 0.2, 0.45), metallic_factor=0.0,
                   roughness_factor=0.5, alpha_mode="BLEND")
ORACLE_FIXTURES = (
    ("opaque_1x", lambda d: quad_over_box(d, OPAQUE_FRONT, "opaque.gltf"), 1),
    ("opaque_4x", lambda d: quad_over_box(d, OPAQUE_FRONT, "opaque.gltf"), 4),
    ("blend_1x", lambda d: quad_over_box(d, BLEND_FRONT, "blend.gltf"), 1),
    ("blend_4x", lambda d: quad_over_box(d, BLEND_FRONT, "blend.gltf"), 4),
    ("stack_1x", stacked_blend_scene, 1),
)


def image_difference(produced: np.ndarray, expected: np.ndarray) -> tuple[float, float]:
    """(mean |diff| of the RGB values, share of pixels with a channel more
    than ORACLE_OUTLIER_STEP apart) of two (H, W, >= 3) u8 images, as
    tests/helpers.assert_images_close measures them."""
    diff = np.abs(produced[..., :3].astype(np.int32) - expected[..., :3].astype(np.int32))
    return float(diff.mean()), float((diff.max(axis=-1) > ORACLE_OUTLIER_STEP).mean())


def oracle_fixtures(dev, kernels, directory) -> None:
    """tests/test_alpha.py's five fixtures rendered on the card by the
    hand-written kernels (every sample shaded, as the oracle does), each a
    path with the counters zeroed and read, against the port's numpy
    oracle within assert_images_close's default budget."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS, RenderConfig
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.ops.reference import reference_scene, render_reference
    from vktf_tpu_torch.scene.scene import Scene

    width, height = ORACLE_SIZE
    camera = Camera(*ORACLE_CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                                      0.1, 100.0))
    directory.mkdir(parents=True, exist_ok=True)
    for tag, fixture, msaa in ORACLE_FIXTURES:
        path = fixture(directory)
        config = RenderConfig(width=width, height=height, msaa_samples=msaa,
                              shading_rate="sample")
        scene = Scene([load_gltf(path)], config, camera=camera, device=dev)
        for k in kernels:
            k.launches = 0
        produced = np.moveaxis(scene.render_still(), 0, -1)
        launches = {k.name: k.launches for k in kernels if k.launches}
        t0 = time.perf_counter()
        ref = reference_scene([load_gltf(path)])
        expected = render_reference(ref, camera.view_projection_transform, camera.position,
                                    width, height, SAMPLE_OFFSETS[msaa],
                                    max_anisotropy=config.max_anisotropy,
                                    peel_layers=max(ref.meta.peel_layers, 2))
        oracle_s = time.perf_counter() - t0
        mean, outliers = image_difference(produced, expected)
        lit = float((expected[..., :3].max(axis=-1) > 0).mean())
        log(f"[oracle] {tag}: K = {scene.frame_program.layers}, {width}x{height} {msaa}x, "
            f"every sample shaded; launches {json.dumps(launches)}; against the numpy oracle "
            f"({oracle_s:.1f} s on the host): mean |diff| {mean:.4f}, pixels more than "
            f"{ORACLE_OUTLIER_STEP} steps apart {outliers:.4f} (budget: mean <= "
            f"{ORACLE_MAX_MEAN}, share <= {ORACLE_MAX_OUTLIERS}); oracle lit {lit:.3f}")
        require(lit > 0.2, f"oracle {tag}: the fixture is in view")
        setup, stream, raster_1, table, shade_1, raster_k, *shade_others = kernels
        require(all(launches.get(k.name) for k in (setup, stream, table))
                and any(launches.get(k.name) for k in (raster_1, raster_k))
                and any(launches.get(k.name) for k in (shade_1, *shade_others)),
                f"oracle {tag}: setup, the raster prologue, a raster, shade table and a shade "
                "record ran on the card")
        require(mean <= ORACLE_MAX_MEAN and outliers <= ORACLE_MAX_OUTLIERS,
                f"oracle {tag}: the card's frame within the oracle's budget")


def host_timings(sponza_zlib_files, meta, viewer_log, dev, card) -> None:
    """One HOST_TEXTURE-square sRGB texture through decode (a ZSTD KTX2
    level), mips and pool pack, and the sponza's ZLIB files through
    Engine.load, with the native runtime and with numpy (VKTF_NATIVE=0):
    host seconds, each pair's outputs equal bit for bit."""
    from vktf_tpu_torch import engine as engine_mod
    from vktf_tpu_torch import native
    from vktf_tpu_torch.loaders import images
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZSTD, encode_ktx2, parse_ktx2
    from vktf_tpu_torch.ops.texture_pack import build_material_pool
    from vktf_tpu_torch.window import Window

    rng = np.random.default_rng(12)
    side = HOST_TEXTURE
    yy, xx = np.mgrid[0:side, 0:side]
    base = np.stack([(xx * 255) // side, (yy * 255) // side, ((xx ^ yy) & 255),
                     np.full_like(xx, 255)], axis=-1).astype(np.int32)
    base = np.clip(base + rng.integers(-6, 7, base.shape), 0, 255).astype(np.uint8)
    blob = encode_ktx2([base], True, SUPERCOMPRESSION_ZSTD)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    decoded, decode_s = timed(lambda: parse_ktx2(blob).levels[0])
    require(np.array_equal(decoded, base), "the ZSTD KTX2 level decodes to its texels")
    times = {}
    for on in (True, False):
        with native_runtime(on):
            require(native.available() == on, f"VKTF_NATIVE={int(on)}")
            mips, mips_s = timed(lambda: images.generate_mips(base, True))
            spec = {"base": images.TextureData(levels=mips, srgb=True), "mr": None,
                    "normal": None, "samplers": [{}] * 3}
            pool, pack_s = timed(lambda: build_material_pool([spec]))
            times[on] = (mips, mips_s, pool.quads, pack_s)
    (mips_n, mips_ns, quads_n, pack_ns), (mips_p, mips_ps, quads_p, pack_ps) = (
        times[True], times[False])
    require(all(np.array_equal(a, b) for a, b in zip(mips_n, mips_p)) and
            len(mips_n) == len(mips_p), "native mips == numpy mips bit for bit")
    require(np.array_equal(quads_n, quads_p), "native pool rows == numpy pool rows")
    log(f"[host] one {side}x{side} sRGB texture (host s; host CPU {host_cpu()}; card {card}): "
        f"ZSTD KTX2 decode (libzstd) {decode_s:.4f} ({len(blob) / 1e6:.2f} MB -> "
        f"{base.nbytes / 1e6:.2f} MB; no numpy counterpart); mips native {mips_ns:.4f}, "
        f"numpy {mips_ps:.4f} (bit-equal); pool pack native {pack_ns:.4f}, numpy "
        f"{pack_ps:.4f} (bit-equal)")

    loads = {}
    for on in (True, False):
        with native_runtime(on):
            engine = engine_mod.Engine(Window(width=64, height=64), None, viewer_log, device=dev)
            loaded = engine.load(sponza_zlib_files)
            loads[on] = (dict(engine.load_seconds), loaded.render_scene)
            require(loaded.meta == meta, "the loaded sponza has the preset's shape")
            del engine, loaded
    for name in ("tri_corner", "tri_static_cols", "quad_pool"):
        require(torch.equal(getattr(loads[True][1], name), getattr(loads[False][1], name)),
                f"the sponza's {name}: native load == numpy load")
    for on, label in ((True, "native"), (False, "numpy (VKTF_NATIVE=0)")):
        split = loads[on][0]
        log(f"[host] Engine.load of the sponza's ZLIB files, {label} (host s):",
            json.dumps({k: round(v, 4) for k, v in split.items()}),
            f"total {sum(split.values()):.3f}")
    log("[host] the two loads' tri_corner, tri_static_cols and quad_pool: bit-equal")


def host_phase(dev, config, camera, meta, still, zstd_files, export_zstd_s,
               sponza_zlib_files, kernels, viewer_log, card) -> None:
    """Phase 16: the native host runtime and the numpy oracle (module
    docstring)."""
    from vktf_tpu_torch import engine as engine_mod
    from vktf_tpu_torch import native
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZSTD
    from vktf_tpu_torch.ops import _cuda
    from vktf_tpu_torch.window import Window

    t_phase = time.perf_counter()
    require(native.available(), "the native host runtime is built and loaded")
    schemes = {struct.unpack_from("<I", f.read_bytes(), 44)[0]
               for f in zstd_files[0].parent.glob("*.ktx2")}
    require(schemes == {SUPERCOMPRESSION_ZSTD}, f"every exported level is ZSTD: {schemes}")
    on_disk = sum(f.stat().st_size for f in zstd_files[0].parent.iterdir())
    log(f"[host] the sponza exported at the exporter's defaults (RGBA8 KTX2 under ZSTD, "
        f"level {native.ZSTD_LEVEL}, libzstd) in {export_zstd_s:.3f} host s, "
        f"{on_disk / 1e6:.1f} MB on disk")
    with without_zstandard():
        engine = engine_mod.Engine(Window(width=config.width, height=config.height), config,
                                   viewer_log, device=dev)
        loaded = engine.load(zstd_files)
    load_s = dict(engine.load_seconds)
    log("[host] Engine.load of the ZSTD sponza (host s, upload ends in a synchronize):",
        json.dumps({k: round(v, 4) for k, v in load_s.items()}),
        f"total {sum(load_s.values()):.3f}")
    require(loaded.meta == meta, "the ZSTD sponza has the in-memory preset's shape")
    loaded.camera = camera
    for k in kernels:
        k.launches = 0
    frame = loaded.render_still()
    launches = {k.name: k.launches for k in kernels if k.launches}
    require(all(launches.get(k.name) == 1 for k in kernels[:K1_RECORDS]),
            f"the ZSTD sponza's frame ran the K = 1 kernels: {launches}")
    require(np.array_equal(frame, still),
            "the ZSTD sponza renders phase 4's in-memory frame bit for bit")
    log(f"[host] the ZSTD sponza at CAMERA, {config.width}x{config.height} "
        f"{config.msaa_samples}x: launches {json.dumps(launches)}; == phase 4's frame bit "
        "for bit")
    del loaded, engine
    host_timings(sponza_zlib_files, meta, viewer_log, dev, card)
    oracle_fixtures(dev, kernels, _cuda.BUILD_DIR / "oracle")
    log(f"[host] phase time: {time.perf_counter() - t_phase:.1f} s")


def four_cards(args) -> int:
    """--four-cards: phase 15d alone, on a machine with four cards: the
    sources built, the opaque, translucent and mixed sponza's single-device
    stills on card 0 at pixel and sample rate (the opaque pixel-rate frame
    also timed, synchronized and with 4 in flight: the one-card reference,
    and rendered on cuda:1 with card 0 current and by an Engine made
    after torch.cuda.set_device(1): off_current_card), then MESH_CASES
    over NCCL, one card a rank."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers, sponza_like_asset)
    from vktf_tpu_torch.ops import _cuda, raster, setup_kernel, shade_kernel, shade_table
    from vktf_tpu_torch.scene.scene import Scene

    dev = cuda_device()
    require(torch.cuda.device_count() >= 4, "--four-cards needs four cards")
    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0), "| cards",
        torch.cuda.device_count(), "| torch", torch.__version__, "cuda", torch.version.cuda)
    kernels = [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, shade_table.KERNEL,
               *shade_kernel.KERNELS]
    t0 = time.perf_counter()
    _cuda.build(sorted({k.source for k in kernels}))
    log(f"build: {time.perf_counter() - t0:.1f} s wall")
    width, height = (256, 128) if args.small else (1920, 1080)
    config = RenderConfig(width=width, height=height, msaa_samples=4)
    camera = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), width / height, 0.1, 1.0e6))
    scenes = {}
    for key in ("opaque", "translucent", "mixed"):
        assets = ([sponza_like_asset(columns_per_ring=4, clutter=8, curtains=2, tex_size=64)]
                  if args.small else build_preset("sponza"))
        if key == "translucent":
            set_blend(assets)
        elif key == "mixed":
            set_samplers(assets, **SAMPLER_PRESETS["mixed"])
        scn = Scene(assets, config, camera=camera, device=dev)
        if key == "opaque":
            frame_ms = []
            for _ in range(args.frames):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scn.render_async()
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            n_flight, pending = 4 * args.frames, collections.deque()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_flight):
                if len(pending) == FRAMES_IN_FLIGHT:
                    pending.popleft().synchronize()
                scn.render_async()
                done = torch.cuda.Event()
                done.record()
                pending.append(done)
            torch.cuda.synchronize()
            log(f"[one card] opaque sponza {width}x{height} 4x, no mesh: frame ms (host clock, "
                f"synchronized) {[round(v, 3) for v in frame_ms]}; with {FRAMES_IN_FLIGHT} in "
                f"flight {(time.perf_counter() - t0) * 1e3 / n_flight:.4f} per frame over "
                f"{n_flight}")
            off_current_card(config, camera, assets, scn.render_still(),
                             _cuda.BUILD_DIR / "assets_f5")
        sample = Scene.from_render_scene(scn.render_scene, scn.meta,
                                         config.replace(shading_rate="sample"), camera)
        scenes[key] = (scene_leaves(scn.render_scene), scn.meta,
                       {"pixel": scn.render_still(), "sample": sample.render_still()})
        del scn, sample
    launches = mesh_spawn("4 cards over NCCL", scenes, (width, height), "nccl",
                          4 * args.frames)
    log("[mesh] launches on the four-card paths (every rank):", json.dumps(dict(launches)))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--small", action="store_true",
                        help="the small courtyard at 256x128 (a quick check)")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--four-cards", action="store_true",
                        help="phase 15d alone: the mesh paths over NCCL on four cards")
    args = parser.parse_args()
    if args.four_cards:
        return four_cards(args)

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.export import export_asset, export_preset
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers, sponza_like_asset)
    from vktf_tpu_torch import native
    from vktf_tpu_torch.ops import (_cuda, _host, pipeline, present, raster, setup_kernel,
                                    shade_kernel, shade_table)
    from vktf_tpu_torch.scene.scene import Scene

    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    log("[current card] launches on a card that is not the current one (a Scene on cuda:1 "
        "with card 0 current; Engine() after torch.cuda.set_device(1)): not run here, it "
        "needs two cards and this run uses one; --four-cards runs it")
    # the K = 1 path's K1_RECORDS, then the K-layer raster and every other shade
    kernels = [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, shade_table.KERNEL,
               shade_kernel.KERNEL, raster.KERNEL_LAYERS, *shade_kernel.KERNELS[1:]]
    sources = list(dict.fromkeys(k.source for k in kernels))

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _cuda.build(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{s} {v:.1f} s" for s, v in build_s.items()))
    for source in sources:
        log(f"ptxas {source}: " + " | ".join(
            line.strip() for line in _cuda.build_log(source).splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line))
    t0 = time.perf_counter()
    native_lib = _host.build("vktf_native.cpp")
    native_build_s = time.perf_counter() - t0
    require(native.available(), "the native host runtime loads")
    log(f"[host] native runtime: g++ {native_build_s:.2f} s -> {native_lib.name}; zstandard "
        f"installed: {importlib.util.find_spec('zstandard') is not None} (hidden wherever "
        "this run writes or reads ZSTD, which goes through libzstd)")

    # ---- 3. scene -------------------------------------------------------
    width, height = (256, 128) if args.small else (1920, 1080)

    def sponza_assets():
        if args.small:
            return [sponza_like_asset(columns_per_ring=4, clutter=8, curtains=2, tex_size=64)]
        return build_preset("sponza")

    t0 = time.perf_counter()
    assets = sponza_assets()
    config = RenderConfig(width=width, height=height, msaa_samples=4)
    camera = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                               0.1, 1.0e6))
    host_s = time.perf_counter() - t0
    # the viewer's files (phase 10), written before any path edits the assets
    viewer_log = Log(out_stream=sys.stdout, err_stream=sys.stderr)
    asset_dir = _cuda.BUILD_DIR / "assets"
    shutil.rmtree(asset_dir, ignore_errors=True)
    t0 = time.perf_counter()
    sponza_files = [export_asset(a, asset_dir / "sponza", "rgba", viewer_log,
                                 SUPERCOMPRESSION_ZLIB) for a in assets]
    export_sponza_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with without_zstandard():  # the exporter's defaults: RGBA8 KTX2 under ZSTD
        zstd_files = [export_asset(a, asset_dir / "sponza_zstd", "rgba", viewer_log)
                      for a in assets]
    export_zstd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    box_files = export_preset("box", asset_dir / "box", "basis", viewer_log)
    export_box_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = Scene(assets, config, camera=camera, device=dev)
    torch.cuda.synchronize()
    meta = scene.meta
    log(f"scene: {meta.num_triangles} triangles, {meta.num_instances} instances, "
        f"{meta.num_lights} lights, pool {tuple(scene.render_scene.quad_pool.shape)}, "
        f"peel layers {meta.peel_layers}; assets {host_s:.1f} s, flatten+upload "
        f"{time.perf_counter() - t0:.1f} s")
    ph, pw = config.padded_height, config.padded_width
    clear = (np.asarray(config.clear_color[:3]) * 255 + 0.5).astype(np.uint8)

    flight_by_path = {}

    def drive(scn, tag: str, min_lit: float = 0.5):
        """One path through Scene: counters zeroed just before, read just
        after; prints frame and stage times. The presented frame must be
        the CPU encode (ops/present.py) of the exact still, and at least
        min_lit of the still's pixels differ from the clear colour."""
        for k in kernels:
            k.launches = 0
        frame_ms, stage_ms = [], []
        prog = scn.frame_program
        for _ in range(args.frames):
            prog.timer = pipeline._StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = scn.render_async()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            stage_ms.append(prog.timer.millis())
        prog.timer = None
        # FRAMES_IN_FLIGHT deep: wait for frame i - 4 before enqueuing frame i
        n_flight = 4 * args.frames
        pending = collections.deque()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_flight):
            if len(pending) == FRAMES_IN_FLIGHT:
                pending.popleft().synchronize()
            scn.render_async()
            done = torch.cuda.Event()
            done.record()
            pending.append(done)
        torch.cuda.synchronize()
        flight_ms = (time.perf_counter() - t0) * 1e3 / n_flight
        flight_by_path[tag] = flight_ms
        still = scn.render_still()
        launches = {k.name: k.launches for k in kernels}
        log(f"[{tag}] launches in the path:", json.dumps(launches))
        steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
        log(f"[{tag}] frame ms (host clock, synchronized): first {frame_ms[0]:.3f}, "
            f"steady median {float(np.median(steady)):.3f}, min {min(steady):.3f}, "
            f"all {[round(v, 3) for v in frame_ms]}; with {FRAMES_IN_FLIGHT} frames in "
            f"flight: {flight_ms:.3f} per frame over {n_flight}")
        # stream_order is a stage only of the frames that re-sort: 0 ms elsewhere
        stages = {name: float(np.median([s.get(name, 0.0) for s in stage_ms[1:] or stage_ms]))
                  for name in dict.fromkeys(n for s in stage_ms for n in s)}
        log(f"[{tag}] stage ms (CUDA events, steady median):",
            json.dumps({k: round(v, 4) for k, v in stages.items()}))
        cfg = scn.config
        require(still.shape == (3, cfg.height, cfg.width) and still.dtype == np.uint8,
                f"{tag} frame shape/dtype {still.shape} {still.dtype}")
        encoded = present.make_present_encoder(cfg)(torch.from_numpy(still))
        require(torch.equal(frame.cpu(), encoded),
                f"{tag}: render_async == the CPU encode of render_still")
        lit = float((still != clear[:, None, None]).any(axis=0).mean())
        log(f"[{tag}] pixels differing from the clear colour: {lit:.4f}")
        require(lit >= min_lit, f"{tag}: at least {min_lit} of the frame is lit")
        out_path = _cuda.BUILD_DIR / f"frame_{tag}_{cfg.width}x{cfg.height}.npy"
        out_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(out_path, still)
        log(f"[{tag}] frame saved:", out_path.relative_to(_cuda.BUILD_DIR.parent.parent))
        return still, launches

    def behind_a_busy_stream(scn, tag: str, still) -> None:
        """F2: with the stream held by a sleep kernel, FRAMES_IN_FLIGHT
        render_async calls must return before it ends (nothing on the frame
        path waits for the card), and give the synchronized frame."""
        stream = torch.cuda.current_stream(dev)
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        end.record()
        t0 = time.perf_counter()
        frames = [scn.render_async() for _ in range(FRAMES_IN_FLIGHT)]
        host_ms = (time.perf_counter() - t0) * 1e3
        busy = not stream.query()
        torch.cuda.synchronize()
        log(f"[{tag}] frames in flight: {FRAMES_IN_FLIGHT} render_async calls returned after "
            f"{host_ms:.3f} ms of host time, behind a {begin.elapsed_time(end):.1f} ms sleep "
            f"kernel; stream still busy when the last returned: {busy}")
        require(busy, f"{tag}: render_async returns while the card is busy")
        require(all(np.array_equal(f.cpu().numpy(), still) for f in frames),
                f"{tag}: the frames enqueued behind the sleep equal the synchronized frame")

    def compare_packed(what: str, got, want) -> float:
        """Packed pixels of a kernel against its plain version."""
        step = torch.zeros_like(got)
        for c in range(3):
            step = torch.maximum(step, (((got >> (8 * c)) & 0xFF)
                                        - ((want >> (8 * c)) & 0xFF)).abs())
        n_step = int((step > 0).sum())
        log(f"{what}: {got.numel()} pixels, max u8 step {int(step.max())}, off at {n_step} "
            f"(tolerance: step <= {SHADE_STEP} on <= {SHADE_MISMATCH} of pixels)")
        require(int(step.max()) <= SHADE_STEP and n_step <= SHADE_MISMATCH * got.numel(), what)
        return float(step.max())

    def compare_layer(what: str, got, want, tri_l) -> float:
        """(rgb, alpha) of a layer kernel against its plain version: the
        covered entries' values, and zeros where uncovered."""
        (rgb_k, alpha_k), (rgb_p, alpha_p) = got, want
        cov = tri_l >= 0
        got_v = torch.cat([rgb_k.permute(1, 0, 2)[:, cov].reshape(-1), alpha_k[cov]])
        want_v = torch.cat([rgb_p.permute(1, 0, 2)[:, cov].reshape(-1), alpha_p[cov]])
        n_bad, err = bits_mismatch(got_v, want_v)
        ulp = int(ulp_distance(got_v, want_v).max()) if got_v.numel() else 0
        zero_ok = bool((rgb_k.permute(1, 0, 2)[:, ~cov] == 0).all() and (alpha_k[~cov] == 0).all())
        log(f"{what}: {tri_l.numel()} (layer, pixel) entries, {int(cov.sum())} covered; "
            f"values not bit-equal {n_bad} of {got_v.numel()}, max {ulp} ulp, max |diff| "
            f"{err:.3e}; uncovered all zero: {zero_ok} (tolerance: {SHADE_LAYER_MISMATCH} of "
            f"values, <= {SHADE_LAYER_ULP} ulp)")
        require(zero_ok and n_bad <= SHADE_LAYER_MISMATCH * got_v.numel()
                and ulp <= SHADE_LAYER_ULP, what)
        return err

    # ---- 4. the opaque path (K = 1) through Scene -------------------------
    still, launches = drive(scene, "opaque")
    require(all(launches[k.name] > 0 for k in kernels[:K1_RECORDS]),
            "every K = 1 kernel ran in the opaque path")
    behind_a_busy_stream(scene, "opaque", still)
    path_launches = {k.name: launches[k.name] for k in kernels[:K1_RECORDS]}

    # ---- 5. each kernel against its plain version, main-path shapes -----
    rs = scene.render_scene
    vp = torch.as_tensor(np.asarray(camera.view_projection_transform, np.float32), device=dev)
    cam = torch.as_tensor(np.asarray(camera.position, np.float32), device=dev)
    inst_rows, tri_instance, lights = pipeline.scene_update(rs, meta)
    t_count, i_count = rs.tri_corner.shape[1], inst_rows.shape[0]
    records = []

    def record(kernel, err, ms, plain_ms, bound_pair):
        bound_ms, bound_by = bound_pair
        records.append({"name": kernel.name, "route": "cuda", "source": kernel.source_path,
                        "replaces": kernel.replaces, "launches": path_launches[kernel.name],
                        "max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                        "bound_ms": round(bound_ms, 5), "bound_by": bound_by,
                        "library_ms": None})

    def split_times(what, wrapper, launch, kernel_name):
        """The wrapper call (as every record is timed) against the bare C
        launch on preallocated outputs, and the profiler's kernel time."""
        wrapper_ms = cuda_ms(wrapper, 50)
        launch_ms = bare_ms(launch, 200)
        prof_ms = profiled_ms(wrapper, 50, kernel_name)
        log(f"{what} split: wrapper {wrapper_ms:.4f} ms, bare launch {launch_ms:.4f} ms (CUDA "
            f"events, launches queued behind a sleep), profiler kernel time "
            + ("not measured (no device time recorded)" if prof_ms is None
               else f"{prof_ms:.4f} ms"))
        return wrapper_ms

    # setup
    args_setup = (rs.tri_corner, inst_rows, tri_instance, vp, width, height)
    got = setup_kernel.setup_pack(*args_setup)
    want = setup_kernel.setup_pack_plain(*args_setup)
    require(torch.equal(got["valid"], want["valid"]), "setup valid exact")
    require(torch.equal(got["bbox_rows"], want["bbox_rows"]), "setup bbox exact")
    for r in (15, 16, 17, 18, 19):
        require(torch.equal(got["tri_data"][r], want["tri_data"][r]), f"setup row {r} exact")
    total, worst, count = 0, 0.0, 0
    for key in ("tri_data", "edge9", "anchor2"):
        n_bad, err = bits_mismatch(got[key], want[key])
        total += n_bad
        count += got[key].numel()
        worst = max(worst, err)
    log(f"setup: {int(got['valid'].sum())} of {got['valid'].numel()} valid; float values "
        f"not bit-equal {total} of {count}, max |diff| {worst:.3e} "
        f"(tolerance: {SETUP_FLOAT_MISMATCH} of values)")
    require(total <= SETUP_FLOAT_MISMATCH * count, "setup float rows")
    lib = _cuda.library(setup_kernel.KERNEL.source)
    outs = [torch.empty_like(got[k]) for k in ("tri_data", "bbox_rows", "edge9", "anchor2")]
    valid_u8 = torch.empty((t_count,), dtype=torch.uint8, device=dev)
    argv = (*(_cuda.ptr(x) for x in (rs.tri_corner, inst_rows, tri_instance, vp)), None,
            *(_cuda.ptr(x) for x in (*outs, valid_u8)), t_count, width, height,
            _cuda.stream_of(vp))
    setup_ms = split_times("setup", lambda: setup_kernel.setup_pack(*args_setup),
                           lambda: lib.vktf_setup_pack(*argv), "setup_kernel")
    # reads 9 corner rows, the instance index, the view projection and the
    # (I, 16) instance rows; writes 24 + 4 + 9 + 2 float rows and one byte
    old_bound = bound(t_count * (22 * 4 + 39 * 4 + 1), t_count * SETUP_OPS)
    setup_bound = bound(t_count * (9 * 4 + 4 + 39 * 4 + 1) + 64 + i_count * 64,
                        t_count * SETUP_OPS)
    log(f"setup bound: {setup_bound[0]:.5f} ms ({setup_bound[1]}); with the per-triangle "
        f"matrix rows and id row of the earlier design: {old_bound[0]:.5f} ms")
    record(setup_kernel.KERNEL, worst, setup_ms,
           cuda_ms(lambda: setup_kernel.setup_pack_plain(*args_setup), 3), setup_bound)

    # raster (full frame)
    setup = got
    perm = raster.stream_perm(setup["bbox_rows"], setup["valid"], chunk=config.pallas_chunk)
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"], perm,
                                  chunk=config.pallas_chunk)
    r_args = (*stream, ph, pw, config.msaa_samples)
    ids, depth = raster.rasterize(*r_args)
    ids_p, depth_p = raster.rasterize_plain(*r_args)
    id_bad = int((ids != ids_p).sum())
    same = ids == ids_p
    d_bad, d_err = bits_mismatch(depth[same], depth_p[same])
    log(f"raster: {ids.numel()} samples, {float((ids >= 0).float().mean()):.4f} covered; "
        f"winner differs at {id_bad}, depth not bit-equal at {d_bad} of the rest, "
        f"max |depth diff| {d_err:.3e} (tolerance: {RASTER_ID_MISMATCH} of samples, depth "
        f"bit-equal)")
    require(id_bad <= RASTER_ID_MISMATCH * ids.numel() and d_bad == 0, "raster")
    log("raster staging, opaque:", json.dumps(staging_counts(stream, ph, pw)))
    # the record is the winner form, which the one-card pixel-rate frame runs; a
    # differing sample moves at most one pixel's winner
    w_err, w_ms, w_bound = winner_held("sponza", stream, ph, pw, config.msaa_samples, 1,
                                       (ids_p, depth_p), int(RASTER_ID_MISMATCH * ids.numel()))
    record(raster.KERNEL, w_err, w_ms,
           cuda_ms(lambda: pipeline.pixel_winner(*raster.rasterize_plain(*r_args)), 2), w_bound)

    # ---- 5a. the raster prologue against its plain version ---------------
    record(raster.KERNEL_STREAM, 0.0,
           *stream_held("sponza", setup["tri_data"], setup["bbox_rows"], perm))
    if not args.small:
        stream_2160p(dev)

    # ---- 5b. the covered samples' depth against float64 -----------------
    depth_against_float64(rs, inst_rows, tri_instance, vp, setup,
                          ids[:, :height, :width], depth[:, :height, :width], config)

    # shade table
    t_args = (setup["edge9"], rs.tri_corner, rs.tri_static_cols, setup["anchor2"], inst_rows,
              tri_instance)
    table = shade_table.build_shade_table(*t_args)
    table_p = shade_table.build_shade_table_plain(*t_args)
    n_bad, t_err = bits_mismatch(table, table_p)
    log(f"shade table: {tuple(table.shape)}, not bit-equal {n_bad} of {table.numel()}, "
        f"max |diff| {t_err:.3e} (tolerance: {TABLE_MISMATCH} of values)")
    require(n_bad <= TABLE_MISMATCH * table.numel(), "shade table")
    lib = _cuda.library(shade_table.KERNEL.source)
    table_out = torch.empty_like(table)
    argv_t = (*(_cuda.ptr(x) for x in (*t_args, table_out)), t_count, _cuda.stream_of(table))
    table_ms = split_times("shade table", lambda: shade_table.build_shade_table(*t_args),
                           lambda: lib.vktf_shade_table(*argv_t), "table_kernel")
    # reads 9 edge, 36 corner, 15 material and 2 anchor rows, the instance
    # index and the (I, 16) instance rows; writes a 64-float row
    old_bound = bound(t_count * ((9 + 36 + 15 + 2 + 12) * 4 + 64 * 4), t_count * TABLE_OPS)
    table_bound = bound(t_count * ((9 + 36 + 15 + 2) * 4 + 4 + 64 * 4) + i_count * 64,
                        t_count * TABLE_OPS)
    log(f"shade table bound: {table_bound[0]:.5f} ms ({table_bound[1]}); with the "
        f"per-triangle matrix rows of the earlier design: {old_bound[0]:.5f} ms")
    record(shade_table.KERNEL, t_err, table_ms,
           cuda_ms(lambda: shade_table.build_shade_table_plain(*t_args), 3), table_bound)

    # shade + resolve (all pixels)
    tri, frac = pipeline.pixel_winner(ids, depth)
    sx, sy = pipeline.pixel_centers(ph, pw, dev)
    bg = torch.tensor(config.clear_color[:3], dtype=torch.float32, device=dev)
    s_args = (tri, sx, sy, frac, table, rs.quad_pool, cam, lights, bg, config.max_anisotropy)
    packed = shade_kernel.shade_resolve(*s_args)
    err = compare_packed("shade", packed, shade_kernel.shade_resolve_plain(*s_args))
    record(shade_kernel.KERNEL, err, cuda_ms(lambda: shade_kernel.shade_resolve(*s_args), 20),
           cuda_ms(lambda: shade_kernel.shade_resolve_plain(*s_args), 3),
           shade_bound(tri, sx, sy, table, config.max_anisotropy, meta.num_lights, False))

    # the frame the main path produced equals these stages' output
    frame_again = present.encode_rgb(packed, config).cpu().numpy()
    require(np.array_equal(frame_again, still), "stage-by-stage frame == Scene frame")

    # ---- 6. the opaque scene at a forced peel_layers=2 --------------------
    forced = Scene.from_render_scene(rs, meta, config.replace(peel_layers=2), camera)
    require(forced.frame_program.layers == 2, "forced K = 2")
    still2 = forced.render_still()
    fd = np.abs(still2.astype(np.int16) - still).max(axis=0)
    log(f"forced peel_layers=2 vs K = 1 frame: max diff {int(fd.max())}, off at "
        f"{int((fd > 0).sum())} of {fd.size} pixels (tolerance: 1 on {FORCED_K2_MISMATCH})")
    require(fd.max() <= 1 and (fd > 0).mean() <= FORCED_K2_MISMATCH, "forced K = 2 frame")

    # ---- 7. the translucent path ------------------------------------------
    set_blend(assets)
    t0 = time.perf_counter()
    scene_t = Scene(assets, config, camera=camera, device=dev)
    torch.cuda.synchronize()
    meta_t = scene_t.meta
    layers = scene_t.frame_program.layers
    log(f"translucent scene: peel layers {meta_t.peel_layers} (K = {layers}); flatten+upload "
        f"{time.perf_counter() - t0:.1f} s")
    require(layers == 8, "the translucent sponza renders K = 8 layers")
    still_t, launches_t = drive(scene_t, "translucent")
    behind_a_busy_stream(scene_t, "translucent", still_t)
    require(all(launches_t[k.name] > 0 for k in (setup_kernel.KERNEL, raster.KERNEL_LAYERS,
                                                  shade_table.KERNEL, shade_kernel.KERNEL_LAYER)),
            "every K-layer kernel ran in the translucent path")
    path_launches.update({k: launches_t[k] for k in ("raster_layers", "shade_layer")})

    rs_t = scene_t.render_scene
    inst_rows_t, tri_instance_t, lights_t = pipeline.scene_update(rs_t, meta_t)
    setup_t = setup_kernel.setup_pack(rs_t.tri_corner, inst_rows_t, tri_instance_t, vp, width,
                                      height)
    perm_t = raster.stream_perm(setup_t["bbox_rows"], setup_t["valid"], chunk=config.pallas_chunk)
    stream_t = raster.raster_stream(setup_t["tri_data"], setup_t["bbox_rows"], perm_t,
                                    chunk=config.pallas_chunk)
    rl_args = (*stream_t, ph, pw, config.msaa_samples, layers)
    ids_t, depth_t = raster.rasterize(*rl_args)
    ids_tp, depth_tp = raster.rasterize_plain(*rl_args)
    id_bad = int((ids_t != ids_tp).sum())
    same = ids_t == ids_tp
    d_bad, d_err = bits_mismatch(depth_t[same], depth_tp[same])
    cover = [round(float((ids_t[l] >= 0).float().mean()), 4) for l in range(layers)]
    log(f"raster K = {layers}: {ids_t.numel()} (layer, sample) entries, covered share per "
        f"layer {cover}; id differs at {id_bad}, depth not bit-equal at {d_bad} of the rest, "
        f"max |depth diff| {d_err:.3e} (tolerance: ids exact, depth bit-equal)")
    require(id_bad == 0 and d_bad == 0, "K-layer raster")
    log("raster staging, translucent:", json.dumps(staging_counts(stream_t, ph, pw)))
    w_err, w_ms, w_bound = winner_held("translucent sponza", stream_t, ph, pw,
                                       config.msaa_samples, layers, (ids_tp, depth_tp))
    del ids_tp, depth_tp
    record(raster.KERNEL_LAYERS, w_err, w_ms,
           cuda_ms(lambda: pipeline.pixel_winner(*raster.rasterize_plain(*rl_args)), 1), w_bound)

    table_t = shade_table.build_shade_table(setup_t["edge9"], rs_t.tri_corner,
                                            rs_t.tri_static_cols, setup_t["anchor2"],
                                            inst_rows_t, tri_instance_t)
    tri_t, frac_t = pipeline.pixel_winner(ids_t, depth_t)
    amode = rs_t.tri_static_cols[13]
    front = tri_t[0].reshape(ph, pw)[:height, :width]
    translucent = (front >= 0) & (amode[front.clamp(min=0)] != 0)
    share = float(translucent.float().mean())
    second = float((tri_t[1].reshape(ph, pw)[:height, :width] >= 0).float().mean())
    log(f"translucent: layer-0 winner translucent at {share:.4f} of pixels, layer 1 "
        f"covered at {second:.4f} (required: >= {TRANSLUCENT_SHARE_MIN})")
    require(share >= TRANSLUCENT_SHARE_MIN, "translucent share")

    sl_args = (tri_t, sx, sy, table_t, rs_t.quad_pool, cam, lights_t, config.max_anisotropy)
    rgb_t, alpha_t = shade_kernel.shade_layer(*sl_args)
    l_err = compare_layer("shade layer", (rgb_t, alpha_t), shade_kernel.shade_layer_plain(*sl_args),
                          tri_t)
    record(shade_kernel.KERNEL_LAYER, l_err, cuda_ms(lambda: shade_kernel.shade_layer(*sl_args), 10),
           cuda_ms(lambda: shade_kernel.shade_layer_plain(*sl_args), 1),
           shade_bound(tri_t, sx, sy, table_t, config.max_anisotropy, meta_t.num_lights, True))

    packed_t = pipeline.composite_resolve(rgb_t, alpha_t, frac_t, bg)
    require(np.array_equal(present.encode_rgb(packed_t, config).cpu().numpy(), still_t),
            "translucent stage-by-stage frame == Scene frame")

    # ---- 8. the texture side paths, each a path through Scene ------------
    ma = config.max_anisotropy

    def variant(base, **overrides):
        """base's device scene under another configuration."""
        return Scene.from_render_scene(base.render_scene, base.meta,
                                       base.config.replace(**overrides), camera)

    def run_path(scn, tag: str, kernel, form):
        """Drive one path; its shade form must be `form` and `kernel` must
        have run in it."""
        got = scn.frame_program.form
        require((got.texels, got.taps, got.attrs) == form, f"{tag}: shade form {got}")
        still_v, launches_v = drive(scn, tag)
        require(launches_v[kernel.name] > 0, f"{tag}: {kernel.name} ran in the path")
        path_launches.setdefault(kernel.name, launches_v[kernel.name])
        return still_v, launches_v

    def shade_inputs(scn):
        """(tri, frac, table, lights) of a scene's frame."""
        st = frame_stages(scn)
        return st["tri"], st["frac"], st["table"], st["lights"]

    def held_resolve(what, kernel, args, bound_args, texels="fused", taps=1, attrs=False):
        """A resolve-form kernel against its plain version, timed, recorded."""
        fn, plain = ((shade_kernel.shade_attrs_resolve, shade_kernel.shade_attrs_resolve_plain)
                     if attrs else (shade_kernel.shade_resolve, shade_kernel.shade_resolve_plain))
        err = compare_packed(what, fn(*args), plain(*args))
        record(kernel, err, cuda_ms(lambda: fn(*args), 20), cuda_ms(lambda: plain(*args), 1),
               shade_bound(*bound_args, False, texels, taps, attrs))

    def held_layer(what, kernel, args, tri_l, bound_args, texels="fused", taps=1, attrs=False):
        """A layer-form kernel against its plain version, timed, recorded."""
        fn, plain = ((shade_kernel.shade_attrs_layer, shade_kernel.shade_attrs_layer_plain)
                     if attrs else (shade_kernel.shade_layer, shade_kernel.shade_layer_plain))
        err = compare_layer(what, fn(*args), plain(*args), tri_l)
        record(kernel, err, cuda_ms(lambda: fn(*args), 10), cuda_ms(lambda: plain(*args), 1),
               shade_bound(*bound_args, True, texels, taps, attrs))

    pool = rs.quad_pool
    opaque_bound = (tri, sx, sy, table, ma, meta.num_lights)
    # a. four taps, opaque: the multi-tap resolve kernel and not the one-tap
    still_a, launches_a = run_path(variant(scene, aniso_taps=4), "taps4",
                                   shade_kernel.KERNEL_TAPS, ("fused", 4, False))
    require(launches_a["shade"] == 0, "taps4: the one-tap kernel did not run")
    a_diff = (still_a != still).any(axis=0).mean()
    log(f"[taps4] pixels differing from the one-tap frame: {a_diff:.4f}")
    require(a_diff > 0.01, "taps4: the taps change the frame")
    held_resolve("shade taps=4", shade_kernel.KERNEL_TAPS,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "fused", 4),
                 opaque_bound, "fused", 4)

    # b. four taps, translucent K = 8
    scene_bt = variant(scene_t, aniso_taps=4)
    still_b, launches_b = run_path(scene_bt, "translucent_taps4",
                                    shade_kernel.KERNEL_LAYER_TAPS, ("fused", 4, False))
    require(launches_b["shade_layer"] == 0, "translucent_taps4: the one-tap kernel did not run")
    translucent_bound = (tri_t, sx, sy, table_t, ma, meta_t.num_lights)
    held_layer("shade layer taps=4", shade_kernel.KERNEL_LAYER_TAPS,
               (tri_t, sx, sy, table_t, rs_t.quad_pool, cam, lights_t, ma, "fused", 4), tri_t,
               translucent_bound, "fused", 4)
    del scene_bt

    # c. the two-gather pool on the opaque sponza: the fused frame exactly
    still_c, _ = run_path(variant(scene, shade_fused_pool=False), "classic",
                          shade_kernel.KERNEL_CLASSIC, ("classic", 1, False))
    c_diff = int((still_c != still).any(axis=0).sum())
    log(f"[classic] pixels differing from the fused frame: {c_diff} of {height * width}")
    require(c_diff == 0, "classic frame == fused frame on every pixel")
    held_resolve("shade classic", shade_kernel.KERNEL_CLASSIC,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "classic", 1),
                 opaque_bound, "classic")

    # d. the attrs boundary: the classic frame exactly
    still_d, _ = run_path(variant(scene, shade_attrs_boundary=True), "attrs",
                          shade_kernel.KERNEL_ATTRS, ("classic", 1, True))
    d_diff = int((still_d != still_c).any(axis=0).sum())
    log(f"[attrs] pixels differing from the classic frame: {d_diff} of {height * width}")
    require(d_diff == 0, "attrs frame == classic frame on every pixel")
    attrs = shade_kernel.fragment_attrs(tri, sx, sy, table, ma)
    held_resolve("shade attrs", shade_kernel.KERNEL_ATTRS,
                 (*attrs, tri, frac, pool, cam, lights, bg), opaque_bound, "classic", attrs=True)
    del attrs

    # e. the mirror sponza: the classic kernel on its own scene
    assets_m = set_samplers(sponza_assets(), **SAMPLER_PRESETS["mirror"])
    scene_m = Scene(assets_m, config, camera=camera, device=dev)
    require(scene_m.meta.mirror_wrap and not scene_m.meta.mixed_samplers, "mirror sponza flags")
    still_m, _ = run_path(scene_m, "mirror", shade_kernel.KERNEL_CLASSIC, ("classic", 1, False))
    # every sponza uv lies in [0, 1], so mirror and repeat wrap differ only
    # in the texels a footprint takes across a texture's border
    log(f"[mirror] pixels differing from the repeat-wrap frame: "
        f"{int((still_m != still).any(axis=0).sum())} of {height * width}")
    tri_m, frac_m, table_m, lights_m = shade_inputs(scene_m)
    m_args = (tri_m, sx, sy, frac_m, table_m, scene_m.render_scene.quad_pool, cam, lights_m, bg,
              ma, "classic", 1)
    compare_packed("shade classic, mirror sponza", shade_kernel.shade_resolve(*m_args),
                   shade_kernel.shade_resolve_plain(*m_args))
    del scene_m, assets_m

    # f. the mixed sponza: per-slot rows
    assets_x = set_samplers(sponza_assets(), **SAMPLER_PRESETS["mixed"])
    scene_x = Scene(assets_x, config, camera=camera, device=dev)
    require(scene_x.meta.mixed_samplers and scene_x.meta.mirror_wrap, "mixed sponza flags")
    still_x, _ = run_path(scene_x, "mixed", shade_kernel.KERNEL_PER_SLOT, ("per_slot", 1, False))
    log(f"[mixed] pixels differing from the one-sampler frame: "
        f"{int((still_x != still).any(axis=0).sum())} of {height * width}")
    tri_x, frac_x, table_x, lights_x = shade_inputs(scene_x)
    mixed_bound = (tri_x, sx, sy, table_x, ma, scene_x.meta.num_lights)
    held_resolve("shade per-slot, mixed sponza", shade_kernel.KERNEL_PER_SLOT,
                 (tri_x, sx, sy, frac_x, table_x, scene_x.render_scene.quad_pool, cam, lights_x,
                  bg, ma, "per_slot", 1), mixed_bound, "per_slot")

    # g. the layer forms on translucent scenes
    still_g1, _ = run_path(variant(scene_t, shade_fused_pool=False), "translucent_classic",
                           shade_kernel.KERNEL_LAYER_CLASSIC, ("classic", 1, False))
    held_layer("shade layer classic", shade_kernel.KERNEL_LAYER_CLASSIC,
               (tri_t, sx, sy, table_t, rs_t.quad_pool, cam, lights_t, ma, "classic", 1), tri_t,
               translucent_bound, "classic")
    still_g2, _ = run_path(variant(scene_t, shade_attrs_boundary=True), "translucent_attrs",
                           shade_kernel.KERNEL_ATTRS_LAYER, ("classic", 1, True))
    g_diff = int((still_g2 != still_g1).any(axis=0).sum())
    log(f"[translucent_attrs] pixels differing from the translucent classic frame: {g_diff}")
    require(g_diff == 0, "translucent attrs frame == translucent classic frame")
    attrs_t = shade_kernel.fragment_attrs(tri_t, sx, sy, table_t, ma)
    log(f"attrs boundary at K = {layers}: {attrs_t[0].numel() * 4 / 1e9:.2f} GB of rows")
    held_layer("shade attrs layer", shade_kernel.KERNEL_ATTRS_LAYER,
               (*attrs_t, tri_t, rs_t.quad_pool, cam, lights_t), tri_t, translucent_bound,
               "classic", attrs=True)
    del attrs_t
    scene_xt = Scene(set_blend(assets_x), config, camera=camera, device=dev)
    require(scene_xt.frame_program.layers == 8, "the translucent mixed sponza renders K = 8")
    run_path(scene_xt, "translucent_mixed", shade_kernel.KERNEL_LAYER_PER_SLOT,
             ("per_slot", 1, False))
    tri_xt, _frac_xt, table_xt, lights_xt = shade_inputs(scene_xt)
    held_layer("shade layer per-slot", shade_kernel.KERNEL_LAYER_PER_SLOT,
               (tri_xt, sx, sy, table_xt, scene_xt.render_scene.quad_pool, cam, lights_xt, ma,
                "per_slot", 1), tri_xt,
               (tri_xt, sx, sy, table_xt, ma, scene_xt.meta.num_lights), "per_slot")

    # h. four taps on the two-gather and per-slot forms: the attrs boundary
    # with taps takes the classic multi-tap kernel, whose frame is the fused
    # four-tap frame exactly
    still_h, _ = run_path(variant(scene, shade_attrs_boundary=True, aniso_taps=4), "attrs_taps4",
                          shade_kernel.KERNEL_CLASSIC_TAPS, ("classic", 4, False))
    h_diff = int((still_h != still_a).any(axis=0).sum())
    log(f"[attrs_taps4] pixels differing from the fused four-tap frame: {h_diff} of "
        f"{height * width}")
    require(h_diff == 0, "classic four-tap frame == fused four-tap frame on every pixel")
    held_resolve("shade classic taps=4", shade_kernel.KERNEL_CLASSIC_TAPS,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "classic", 4),
                 opaque_bound, "classic", 4)
    run_path(variant(scene_x, aniso_taps=4), "mixed_taps4", shade_kernel.KERNEL_PER_SLOT_TAPS,
             ("per_slot", 4, False))
    held_resolve("shade per-slot taps=4, mixed sponza", shade_kernel.KERNEL_PER_SLOT_TAPS,
                 (tri_x, sx, sy, frac_x, table_x, scene_x.render_scene.quad_pool, cam, lights_x,
                  bg, ma, "per_slot", 4), mixed_bound, "per_slot", 4)
    leaves_x, meta_x = scene_leaves(scene_x.render_scene), scene_x.meta  # phase 15
    del scene_x

    # i. their layer forms at K = 8
    still_i, _ = run_path(variant(scene_t, shade_fused_pool=False, aniso_taps=4),
                          "translucent_classic_taps4", shade_kernel.KERNEL_LAYER_CLASSIC_TAPS,
                          ("classic", 4, False))
    i_diff = int((still_i != still_b).any(axis=0).sum())
    log(f"[translucent_classic_taps4] pixels differing from the translucent fused four-tap "
        f"frame: {i_diff}")
    require(i_diff == 0, "translucent classic four-tap frame == fused four-tap frame")
    held_layer("shade layer classic taps=4", shade_kernel.KERNEL_LAYER_CLASSIC_TAPS,
               (tri_t, sx, sy, table_t, rs_t.quad_pool, cam, lights_t, ma, "classic", 4), tri_t,
               translucent_bound, "classic", 4)
    run_path(variant(scene_xt, aniso_taps=4), "translucent_mixed_taps4",
             shade_kernel.KERNEL_LAYER_PER_SLOT_TAPS, ("per_slot", 4, False))
    held_layer("shade layer per-slot taps=4", shade_kernel.KERNEL_LAYER_PER_SLOT_TAPS,
               (tri_xt, sx, sy, table_xt, scene_xt.render_scene.quad_pool, cam, lights_xt, ma,
                "per_slot", 4), tri_xt,
               (tri_xt, sx, sy, table_xt, ma, scene_xt.meta.num_lights), "per_slot", 4)
    del scene_xt, assets_x
    require({r["name"] for r in records} == {k.name for k in kernels},
            "every kernel was held against its plain version")

    # ---- 9. small frames: card kernels vs the CPU plain path --------------
    small_cfg = RenderConfig(width=256, height=128, msaa_samples=4)
    small_cam = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 1.0e6))
    small_paths = [  # (tag, asset edits, config overrides): one of each form
        ("opaque", (), {}), ("translucent", ("blend",), {}), ("taps4", (), {"aniso_taps": 4}),
        ("translucent_taps2", ("blend",), {"aniso_taps": 2}),
        ("classic", (), {"shade_fused_pool": False}), ("attrs", (), {"shade_attrs_boundary": True}),
        ("translucent_attrs", ("blend",), {"shade_attrs_boundary": True}),
        ("mirror_taps2", ("mirror",), {"aniso_taps": 2}), ("mixed", ("mixed",), {}),
        ("translucent_mixed", ("blend", "mixed"), {}),
        ("mixed_taps2", ("mixed",), {"aniso_taps": 2}),
        ("translucent_classic_taps2", ("blend",), {"shade_fused_pool": False, "aniso_taps": 2}),
        ("translucent_mixed_taps2", ("blend", "mixed"), {"aniso_taps": 2}),
        ("sample", (), {"shading_rate": "sample"}),
        ("translucent_sample", ("blend",), {"shading_rate": "sample"}),
        ("mixed_sample_taps2", ("mixed",), {"shading_rate": "sample", "aniso_taps": 2}),
    ]
    for tag, edits, overrides in small_paths:
        small = [sponza_like_asset(columns_per_ring=4, clutter=8, curtains=2, tex_size=64)]
        for edit in edits:
            if edit == "blend":
                set_blend(small)
            else:
                set_samplers(small, **SAMPLER_PRESETS[edit])
        cfg_s = small_cfg.replace(**overrides)
        f_gpu = Scene(small, cfg_s, camera=small_cam, device=dev)
        f_cpu = Scene(small, cfg_s, camera=small_cam, device="cpu")
        fd = np.abs(f_gpu.render_still().astype(np.int16) - f_cpu.render_still()).max(axis=0)
        log(f"small {tag} frame (K = {f_gpu.frame_program.layers}, {f_gpu.frame_program.form}) "
            f"card vs CPU plain: max diff {int(fd.max())}, off at {float((fd > 0).mean()):.5f} "
            f"of pixels (tolerance: 1 on {FRAME_MISMATCH})")
        require(fd.max() <= 1 and (fd > 0).mean() <= FRAME_MISMATCH, f"small {tag} frame")

    # ---- 10. the viewer: glTF files on disk -> Engine -> game.main ---------
    viewer_phase(dev, config, camera, meta, still, sponza_files, box_files, asset_dir,
                 kernels, flight_by_path["opaque"], (export_sponza_s, export_box_s), viewer_log)

    # ---- 11. the other presets at their bench configurations -------------
    import bench_torch

    t_phase = time.perf_counter()
    for preset in ("box", "duck", "helmet", "flythrough"):
        _, w_p, h_p, msaa_p = bench_torch.CONFIGS[preset]
        if args.small:
            w_p, h_p = 256, 128
        pose = bench_torch.CAMERAS[preset]
        t0 = time.perf_counter()
        assets_p = build_preset(preset)
        scene_p = Scene(assets_p, RenderConfig(width=w_p, height=h_p, msaa_samples=msaa_p),
                        camera=Camera(*pose, ViewFrustumParams(np.radians(45.0), w_p / h_p,
                                                               0.1, 1.0e6)), device=dev)
        torch.cuda.synchronize()
        m_p = scene_p.meta
        log(f"[{preset}] {w_p}x{h_p} {msaa_p}x MSAA: {m_p.num_triangles} triangles, "
            f"{m_p.num_instances} instances, {m_p.num_lights} lights, peel layers "
            f"{scene_p.frame_program.layers}; build+flatten+upload "
            f"{time.perf_counter() - t0:.1f} s")
        _still_p, launches_p = drive(scene_p, preset, min_lit=0.05)
        require(all(launches_p[k.name] == launches_p["setup"] > 0 for k in kernels[:K1_RECORDS])
                and not any(launches_p[k.name] for k in kernels[K1_RECORDS:]),
                f"{preset}: setup, the raster prologue, raster, shade table and shade once a "
                "frame, nothing else")
        cam_s = Camera(*pose, ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 1.0e6))
        small_p = RenderConfig(width=256, height=128, msaa_samples=msaa_p)
        fd = np.abs(Scene(assets_p, small_p, camera=cam_s, device=dev).render_still()
                    .astype(np.int16)
                    - Scene(assets_p, small_p, camera=cam_s, device="cpu").render_still()
                    ).max(axis=0)
        log(f"[{preset}] small frame 256x128 card vs CPU plain: max diff {int(fd.max())}, off "
            f"at {float((fd > 0).mean()):.5f} of pixels (tolerance: 1 on {FRAME_MISMATCH})")
        require(fd.max() <= 1 and (fd > 0).mean() <= FRAME_MISMATCH, f"small {preset} frame")
        del scene_p, assets_p
    log(f"[presets] phase time: {time.perf_counter() - t_phase:.1f} s")

    # ---- 12. the present encodings on the opaque sponza -------------------
    def flight_with_copy(scn, n: int):
        """FRAMES_IN_FLIGHT frames in flight, each copied to a pinned host
        buffer by a non-blocking copy, waiting on the oldest copy's event
        (Engine.render's and bench_torch.py's pattern): (ms per frame,
        bytes copied per frame)."""
        pending, free = collections.deque(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if len(pending) == FRAMES_IN_FLIGHT:
                host, done = pending.popleft()
                done.synchronize()
                free.append(host)
            frame = scn.render_async()
            host = free.pop() if free else torch.empty(frame.shape, dtype=frame.dtype,
                                                        pin_memory=True)
            host.copy_(frame, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            pending.append((host, done))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, frame.numel() * frame.element_size()

    t_phase = time.perf_counter()
    n_copy = 4 * args.frames
    exact_ms, exact_bytes = flight_with_copy(scene, n_copy)
    log(f"[present_rgb_x1] with {FRAMES_IN_FLIGHT} frames in flight and the copy to the host: "
        f"{exact_ms:.4f} ms per frame over {n_copy}, {exact_bytes} bytes copied per frame")
    for fmt, scale in (("yuv420", 1), ("rgb", 2), ("yuv420", 2), ("yuv420", 4)):
        tag = f"present_{fmt}_x{scale}"
        scene_e = variant(scene, present_format=fmt, present_scale=scale)
        still_e, launches_e = drive(scene_e, tag)
        require(np.array_equal(still_e, still),
                f"{tag}: render_still is the exact frame bit for bit")
        require(all(launches_e[k.name] == launches_e["setup"] > 0
                    for k in kernels[:K1_RECORDS]),
                f"{tag}: the K = 1 kernels once a frame")
        copy_ms, copy_bytes = flight_with_copy(scene_e, n_copy)
        log(f"[{tag}] encoded frame == CPU encode of the card's exact frame (bit for bit); still "
            f"== exact frame; with {FRAMES_IN_FLIGHT} frames in flight and the copy to the host: "
            f"{copy_ms:.4f} ms per frame over {n_copy}, {copy_bytes} bytes copied per frame "
            f"({exact_bytes / copy_bytes:.2f}x fewer than the exact frame)")
        del scene_e
    log(f"[present] phase time: {time.perf_counter() - t_phase:.1f} s")

    # ---- 13. sample-rate shading: opaque and translucent K = 8 -------------
    t_phase = time.perf_counter()
    sample_stills = {}  # phase 15's references
    for tag, base, still_base in (("sample", scene, still), ("translucent_sample", scene_t,
                                                             still_t)):
        scene_s = variant(base, shading_rate="sample")
        form = scene_s.frame_program.form
        require((form.texels, form.taps, form.attrs) == ("fused", 1, False),
                f"{tag}: shade form {form}")
        still_s, launches_s = drive(scene_s, tag)
        sample_stills[tag] = still_s
        behind_a_busy_stream(scene_s, tag, still_s)
        require(launches_s["shade_layer"] == launches_s["setup"] > 0
                and launches_s["shade"] == 0,
                f"{tag}: the layer record once a frame, the resolve record never")
        share = float((still_s != still_base).any(axis=0).mean())
        log(f"[{tag}] K = {scene_s.frame_program.layers}; pixels differing from the pixel-rate "
            f"frame: {share:.4f}")
        st = frame_stages(scene_s)
        tri_s = st["ids"].reshape(scene_s.frame_program.layers, -1)
        sx_s, sy_s = pipeline.sample_centers(ph, pw, config.msaa_samples, dev)
        sl_args_s = (tri_s, sx_s, sy_s, st["table"], scene_s.render_scene.quad_pool, cam,
                     st["lights"], ma)
        if base is scene:  # K = 1: the record against its plain version too
            compare_layer(f"shade layer at sample rate, K = 1, {tri_s.shape[1]} samples",
                          shade_kernel.shade_layer(*sl_args_s),
                          shade_kernel.shade_layer_plain(*sl_args_s), tri_s)
        kernel_ms = cuda_ms(lambda: shade_kernel.shade_layer(*sl_args_s), 5)
        bound_s = shade_bound(tri_s, sx_s, sy_s, st["table"], ma, meta.num_lights, True)
        log(f"[{tag}] shade_layer over {tuple(tri_s.shape)} (layer, sample) entries: "
            f"{kernel_ms:.4f} ms (CUDA events), bound {bound_s[0]:.5f} ms ({bound_s[1]})")
        del scene_s, st, tri_s, sl_args_s
    log(f"[sample] phase time: {time.perf_counter() - t_phase:.1f} s")

    # ---- 14. the bench: bench_torch.run_bench on the card -----------------
    t_phase = time.perf_counter()
    w_b, h_b = (256, 128) if args.small else (1920, 1080)
    stats = bench_torch.run_bench("sponza", w_b, h_b, 4, frames=8)
    line = bench_torch._format_line("sponza", w_b, h_b, 4, stats, "rgb", None)
    log("[bench] " + json.dumps(line))
    require(stats["fps"] > 0 and stats["platform"] == "cuda" and "preview_fps" in stats,
            "bench_torch.run_bench measures the card")
    log(f"[bench] phase time: {time.perf_counter() - t_phase:.1f} s")

    # ---- 15. the multi-device frame path ----------------------------------
    from vktf_tpu_torch.parallel import launch
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    t_phase = time.perf_counter()
    mesh_launches = collections.Counter()
    # a. the band offset: the second band of a (2, 2) mesh's frame
    th = config.tile_shape[0]
    band_h = (config.tiles_y + config.tiles_y % 2) * th // 2
    for tag, strm, full_ids, full_depth, k in (("K = 1", stream, ids, depth, 1),
                                              (f"K = {layers}", stream_t, ids_t, depth_t,
                                               layers)):
        b_args = (*strm, band_h, pw, config.msaa_samples, k)
        b_ids, b_depth = raster.rasterize(*b_args, y_offset=band_h)
        n = ph - band_h
        rows_ok = (torch.equal(b_ids[..., :n, :], full_ids[..., band_h:, :])
                   and bits_mismatch(b_depth[..., :n, :], full_depth[..., band_h:, :])[0] == 0
                   and bool((b_ids[..., n:, :] == -1).all()))
        p_ids, p_depth = raster.rasterize_plain(*b_args, band_h)
        id_bad = int((b_ids != p_ids).sum())
        d_bad, _ = bits_mismatch(b_depth[b_ids == p_ids], p_depth[b_ids == p_ids])
        band_ms = cuda_ms(lambda: raster.rasterize(*b_args, y_offset=band_h), 10)
        log(f"[mesh] band raster {tag}, rows {band_h}..{2 * band_h} of {pw} px: equal to the "
            f"full frame's rows (ids, depth bits; rows past the frame empty): {rows_ok}; against "
            f"the plain version at the band's shape: id differs at {id_bad}, depth not bit-equal "
            f"at {d_bad} of the rest; {band_ms:.4f} ms (CUDA events)")
        require(rows_ok, f"band raster {tag} == the full frame's rows")
        require(id_bad <= (RASTER_ID_MISMATCH * b_ids.numel() if k == 1 else 0) and d_bad == 0,
                f"band raster {tag} against its plain version")
        del b_ids, b_depth, p_ids, p_depth
    # b. NCCL at world size 1, in this process
    with launch.launcher_mesh(1, 1, "cuda") as (mesh1, _):
        require(mesh1.backend == "nccl", "the 1x1 mesh runs over NCCL")
        still_n, launches_n = drive(Scene.from_render_scene(rs, meta, config, camera,
                                                            mesh=mesh1), "mesh_nccl_1x1")
    require(np.array_equal(still_n, still), "the NCCL 1x1 frame == phase 4's frame")
    require(all(launches_n[k.name] > 0 for k in kernels[:K1_RECORDS]),
            "the 1x1 mesh path's kernels ran")
    mesh_launches.update({k: v for k, v in launches_n.items() if v})
    log(f"[mesh] NCCL 1x1 frame == phase 4's frame bit for bit; with {FRAMES_IN_FLIGHT} frames "
        f"in flight {flight_by_path['mesh_nccl_1x1']:.4f} ms per frame against phase 4's "
        f"{flight_by_path['opaque']:.4f} ms")
    # c. four ranks sharing the card over gloo; the mixed sponza's
    # single-device sample-rate frame is rendered here
    still_xs = Scene.from_render_scene(scene_from_numpy(leaves_x, dev), meta_x,
                                       config.replace(shading_rate="sample"),
                                       camera).render_still()
    scenes = {"opaque": (scene_leaves(rs), meta, {"pixel": still,
                                                  "sample": sample_stills["sample"]}),
              "translucent": (scene_leaves(scene_t.render_scene), meta_t,
                              {"pixel": still_t, "sample": sample_stills["translucent_sample"]}),
              "mixed": (leaves_x, meta_x, {"pixel": still_x, "sample": still_xs})}
    del leaves_x
    mesh_launches.update(mesh_spawn("4 ranks on one card over gloo (not a scaling number)",
                                    scenes, (width, height), "gloo", 0))
    # d. four cards over NCCL, where the machine has them
    if torch.cuda.device_count() >= 4:
        mesh_launches.update(mesh_spawn("4 cards over NCCL", scenes, (width, height), "nccl",
                                        4 * args.frames))
    else:
        log(f"[mesh] the paths over NCCL on four cards: not run, this machine has "
            f"{torch.cuda.device_count()} card(s) (chip_smoke.py --four-cards on a machine "
            "with four)")
    del scenes
    log("[mesh] launches on the mesh paths (NCCL 1x1 and every rank of the spawns):",
        json.dumps(dict(mesh_launches)))
    log(f"[mesh] phase time: {time.perf_counter() - t_phase:.1f} s")

    # ---- 16. the native host runtime and the numpy oracle ------------------
    host_phase(dev, config, camera, meta, still, zstd_files, export_zstd_s, sponza_files,
               kernels, viewer_log, card)
    for r in records:
        r["mesh_launches"] = mesh_launches.get(r["name"], 0)

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
