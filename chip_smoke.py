"""The port's kernels and paths measured on one CUDA card (vktf_tpu_torch).

    python3 chip_smoke.py            # sponza preset, 1920x1080, 4x MSAA
    python3 chip_smoke.py --small    # the 38k-triangle courtyard at 256x128 (the
                                     # presets at 256x128 too)

Needs one CUDA card and nvcc. This script measures; the card tests check
(``python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py``). The
one check kept here is each timed kernel record's against its plain
version at the inputs it is timed on (its ``max_abs_err``), which guards
the number it prints. In order, it:
  1. reports the card (nvidia-smi name and power limit);
  2. builds the CUDA sources of vktf_tpu_torch/csrc (one nvcc each, in
     parallel; twenty kernel records) and prints each source's ptxas
     report (registers, stack frame, spill bytes of every kernel); builds
     the native host runtime (csrc/host/vktf_native.cpp, g++); both timed;
  3. builds the sponza preset with the port's numpy builder, uploads it and
     exports it (RGBA8 KTX2 under ZLIB) for phase 10;
  4. drives each path through Scene (``drive``), every kernel launch
     counter set to 0 just before and read just after: the synchronized
     frame time, the steady frame time with 4 frames in flight (enqueue,
     one synchronize, divide), each stage's device and host ms (3 frames
     under torch.profiler, each in a ``bench.frame.<i>`` span, read by the
     benchmark's own readers of the program's ``frame.<stage>`` spans,
     benchmark/timeline.py and benchmark/stages.py); the still is saved as
     .npy in the build directory (vktf_tpu_torch/_build/, not committed);
  5. the opaque path (K = 1), then each K = 1 record held against its
     plain version on the card at the shapes the frame gave it, timed with
     it and beside its bound; setup and the shade table also as the bare C
     launch on preallocated outputs (CUDA events around launches queued
     behind a sleep kernel) and the profiler's kernel time; the raster's
     staging counts (staging_counts); the group level of its chunk cull
     (raster_groups) bit for bit against its plain version and timed; the
     raster record is the winner form
     (rasterize_winner, which the one-card pixel-rate frame runs), bit for
     bit pixel_winner of its planes form and held to pixel_winner of the
     plain version's planes, timed beside the planes form (winner_held);
  5a. the raster prologue (raster_stream) bit for bit against its plain
     version and timed beside its byte bound, at the sponza's stream and at
     the 2160p benchmark cell's (benchmark/configs' flythrough, 2,979,744
     triangles, built by the benchmark's scene generator), and there the
     raster's staging counts, the group level, and the winner form at K = 1
     and K = 8;
  6. the translucent path: the sponza with its curtain and clutter
     materials BLEND at alpha 0.5 (K = 8); the K-layer raster and the
     layer shade held and timed likewise;
  7. the texture side paths, each a path of its own, its shade record held
     and timed at the frame's shapes: four taps (opaque and translucent),
     the two-gather pool, the attrs boundary, the mirror and the mixed
     sponza (models.scenes.SAMPLER_PRESETS), their layer forms at K = 8,
     and four taps on the two-gather and per-slot sources;
  8. the other presets at bench_torch.py's configurations and cameras (box
     and duck 1920x1080 1x MSAA, helmet 1920x1080 4x, flythrough 3840x2160
     4x); the present encodings on the opaque sponza (yuv420, the rgb
     preview at scale 2, yuv420 at scale 2 and 4), with 4 frames in flight
     copied to pinned host memory (ms and bytes a frame); sample-rate
     shading on the opaque and the translucent sponza, the layer record over
     every (layer, sample) entry timed beside its bound (at K = 1 held to its
     plain version); each a path;
  9. the mesh paths (vktf_tpu_torch.parallel): the band raster the second
     band of a (2, 2) mesh runs, at K = 1 and K = 8, held to its plain
     version at the band's shape and timed; NCCL at world size 1 in this
     process, the opaque sponza on a (1, 1) mesh driven as a path; one
     spawn of 4 processes sharing the card over gloo and, on a machine
     with four cards, one over NCCL, one card a rank: the opaque sponza on
     (2, 2), (4, 1) and (1, 4), the translucent and mixed sponza on (2, 2),
     and the three at sample rate on (2, 2), each rank's launches (the
     counters zeroed just before) and frame times (gloo on one card is not
     a scaling number); the launches go into each record's mesh_launches;
 10. the viewer from files on disk: Engine.load's split of the exported
     sponza, Engine.render's host time a frame split by its spans, and
     game.main's 32-frame fly-through (its FrameTimer and launches);
 11. prints the kernels line, the card line and, last,
     {"ok": true, "device": {...}}.
Each kernel record carries its least possible time on the card
(``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, both counted from this run's inputs).
A record's failed check raises, so the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
import time

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
# layer shade: float32 values (covered entries) not bit-equal, and their
# largest distance in units in the last place (kernel and plain version run
# the same operations with the same CUDA math library)
SHADE_LAYER_MISMATCH = 1e-5
SHADE_LAYER_ULP = 4
FRAMES_IN_FLIGHT = 4
# records a K = 1 frame launches once each: setup, the raster prologue,
# raster, the group level of its cull, shade table, shade (the first
# entries of main's kernel list)
K1_RECORDS = 6
STAGE_FRAMES = 3  # frames profiled for the stage times
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
    log("raster staging, 2160p cell:",
        json.dumps(staging_counts(st["stream"], cfg.padded_height, cfg.padded_width)))
    groups_held("2160p cell", st["stream"][2])
    for layers in (1, 8):
        winner_held("2160p cell", st["stream"], cfg.padded_height, cfg.padded_width,
                    cfg.msaa_samples, layers)
    del scn, st
    torch.cuda.empty_cache()


def groups_held(what: str, chunk_bbox) -> tuple:
    """The group level of the raster's chunk cull at one stream: the group
    kernel's bboxes bit for bit against chunk_group_bbox_plain's, then both
    timed beside the byte bound (the chunk bboxes read once, the group
    bboxes written once). Returns (kernel ms through the wrapper, plain ms,
    (bound ms, what bounds it))."""
    from vktf_tpu_torch.ops import raster

    got, want = raster.chunk_group_bbox(chunk_bbox), raster.chunk_group_bbox_plain(chunk_bbox)
    n_bad = bits_mismatch(got, want)[0] if got.shape == want.shape else -1
    require(n_bad == 0, f"raster groups {what}: bit-equal to the plain version ({n_bad} differ)")
    kernel_ms = cuda_ms(lambda: raster.chunk_group_bbox(chunk_bbox), 50)
    alone_ms = profiled_ms(lambda: raster.chunk_group_bbox(chunk_bbox), 50, "chunk_group_kernel")
    plain_ms = cuda_ms(lambda: raster.chunk_group_bbox_plain(chunk_bbox), 20)
    bound_ms, bound_by = bound_pair = bound((chunk_bbox.numel() + got.numel()) * 4,
                                            chunk_bbox.numel())
    alone = "not measured" if alone_ms is None else f"{alone_ms:.4f} ms"
    log(f"raster groups, {what}: {chunk_bbox.shape[1]} chunks, {got.shape[1]} groups of "
        f"{raster.CHUNK_GROUP}; bit-equal to the plain version; kernel {kernel_ms:.4f} ms "
        f"through the wrapper (CUDA events), {alone} alone (profiler); plain {plain_ms:.4f} ms; "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return kernel_ms, plain_ms, bound_pair


def staging_counts(stream, height: int, width: int, block: int = 16) -> dict:
    """What the raster kernel stages for this stream, counted in torch: per
    16x16 block its hit groups and hit chunks (group or chunk bbox overlaps
    the block), the bbox tests of its two-level cull (every group bbox,
    then each chunk of a hit group) beside those of a test of every chunk
    bbox, and its touching triangles (valid, bbox overlaps the block); per
    frame the bytes its triangle tests read into registers (5 rows of 1 KB
    per hit chunk) and the bytes it stages into shared memory (24 floats per
    touching triangle, 19 of them gathered by cp.async), beside the earlier
    design, which staged all 32 rows of every hit chunk (32 KB)."""
    from vktf_tpu_torch.ops.raster import CHUNK_GROUP, chunk_group_bbox_plain

    tri_data, tri_bbox, chunk_bbox = stream
    dev = tri_data.device
    bx = torch.arange(0, width, block, device=dev, dtype=torch.float32)
    by = torch.arange(0, height, block, device=dev, dtype=torch.float32)

    def overlaps(bbox, weight=None):
        """(blocks y, blocks x): the bboxes overlapping each block, each
        counted as its weight (1 by default)."""
        hx = (bbox[0][None] < (bx + block)[:, None]) & (bbox[2][None] > bx[:, None])
        hy = (bbox[1][None] < (by + block)[:, None]) & (bbox[3][None] > by[:, None])
        hx = hx.double() if weight is None else hx.double() * weight[None]
        return hy.double() @ hx.T

    n_chunks = chunk_bbox.shape[1]
    group_bbox = chunk_group_bbox_plain(chunk_bbox)
    n_groups = group_bbox.shape[1]
    # the chunks a group holds (the last one may be ragged)
    sizes = (n_chunks - CHUNK_GROUP * torch.arange(n_groups, device=dev)).clamp(max=CHUNK_GROUP)
    hits = overlaps(chunk_bbox)
    group_hits = overlaps(group_bbox)
    group_tests = overlaps(group_bbox, sizes.double())
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
    return {"blocks": hits.numel(), "chunks": n_chunks, "groups": n_groups,
            "hit_groups_per_block_mean": round(float(group_hits.sum()) / hits.numel(), 3),
            "hit_groups_per_block_max": int(group_hits.max()),
            "chunk_tests_per_block_flat": n_chunks,
            "chunk_tests_per_block": round(n_groups + float(group_tests.sum()) / hits.numel(), 3),
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


def stage_ms(scn, frames: int = STAGE_FRAMES) -> dict:
    """{stage: (device ms, host ms)} a frame of `scn`: `frames` frames
    enqueued under torch.profiler, each in a ``bench.frame.<i>`` span, read
    by the benchmark's readers of the program's ``frame.<stage>`` spans (a
    stage that only some frames have, stream_order, counts 0 in the rest;
    device ms None where the trace holds no kernel)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.stages import Stages
    from benchmark.timeline import Timeline
    from vktf_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            with record_function(f"bench.frame.{i}"):
                scn.render_async()
        torch.cuda.synchronize()
    path = _cuda.BUILD_DIR / "stages_trace.json"
    prof.export_chrome_trace(str(path))
    stages = Stages(Timeline.load(path))
    path.unlink()
    return {name: (stages.device_ms([name]), stages.host_ms([name]))
            for name in dict.fromkeys(name for _, _, name in stages.spans)}


def in_flight(scn, n: int, copy: bool = False) -> tuple[float, int]:
    """FRAMES_IN_FLIGHT deep: wait for frame i - 4 before enqueuing frame i;
    with `copy`, each frame copied to a pinned host buffer by a non-blocking
    copy, waiting on the oldest copy's event (Engine.render's and the
    benchmark's pattern). (ms a frame, bytes copied a frame)."""
    pending, free, frame = collections.deque(), [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        if len(pending) == FRAMES_IN_FLIGHT:
            host, done = pending.popleft()
            done.synchronize()
            if host is not None:
                free.append(host)
        frame = scn.render_async()
        host = None
        if copy:
            host = free.pop() if free else torch.empty(frame.shape, dtype=frame.dtype,
                                                        pin_memory=True)
            host.copy_(frame, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        pending.append((host, done))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, frame.numel() * frame.element_size()


def scene_leaves(rs) -> dict:
    """A device scene's leaves as numpy (flatten.scene_from_numpy's input)."""
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES

    leaves = {f: getattr(rs, f).cpu().numpy() for f in SCENE_LEAVES}
    leaves["quad_pool"] = leaves["quad_pool"].view(np.uint16)
    return leaves


# (tag, scene key, gp, sp, RenderConfig overrides)
SAMPLE_RATE = {"shading_rate": "sample"}
MESH_CASES = [("opaque_2x2", "opaque", 2, 2, {}), ("opaque_4x1", "opaque", 4, 1, {}),
              ("opaque_1x4", "opaque", 1, 4, {}), ("translucent_2x2", "translucent", 2, 2, {}),
              ("mixed_2x2", "mixed", 2, 2, {}), ("sample_2x2", "opaque", 2, 2, SAMPLE_RATE),
              ("sample_translucent_2x2", "translucent", 2, 2, SAMPLE_RATE),
              ("sample_mixed_2x2", "mixed", 2, 2, SAMPLE_RATE)]


def mesh_ranks(cases, inputs, frames: int, flight: int) -> dict:
    """One rank of the mesh spawns. Per case (tag, scene key, gp, sp,
    config overrides): the scene from `inputs` (its leaves' .npz, SceneMeta
    and frame size) on this rank's card, one warm frame, then with the
    counters zeroed `frames` synchronized frames (host clock) and `flight`
    frames with FRAMES_IN_FLIGHT in flight (none when 0); every rank's
    counters are gathered to each rank. Returns {tag: {...}}."""
    import torch.distributed as dist

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.ops import raster, setup_kernel, shade_kernel, shade_table
    from vktf_tpu_torch.parallel import make_render_mesh
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda", torch.cuda.current_device())
    kernels = [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, raster.KERNEL_GROUPS,
               raster.KERNEL_LAYERS, shade_table.KERNEL, *shade_kernel.KERNELS]
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
        flight_ms = in_flight(scn, flight)[0] if flight else None
        launches = {k.name: k.launches for k in kernels if k.launches}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, launches)
        out[tag] = {"frame_ms": frame_ms, "flight_ms": flight_ms, "launches": every,
                    "layers": scn.frame_program.layers, "form": str(scn.frame_program.form)}
        del scn
        torch.cuda.empty_cache()
    return out


def mesh_spawn(label: str, scenes: dict, size, backend: str, flight: int) -> collections.Counter:
    """MESH_CASES on 4 spawned ranks (`backend`: gloo, the ranks sharing the
    card; nccl, one card a rank), each scene given as (device scene leaves,
    SceneMeta): prints each case's frame times and every rank's launches,
    and returns the launches summed over the ranks."""
    from vktf_tpu_torch.ops import _cuda
    from vktf_tpu_torch.parallel import launch

    input_dir = _cuda.BUILD_DIR / "mesh_inputs"
    input_dir.mkdir(parents=True, exist_ok=True)
    inputs = {}
    for key, (leaves, meta_k) in scenes.items():
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
    launches = collections.Counter()
    for tag, _key, _gp, _sp, overrides in MESH_CASES:
        got = ranks[tag]
        rate = overrides.get("shading_rate", "pixel")
        log(f"[mesh {tag}] {label}: K = {got['layers']}, {got['form']}, {rate} rate; frame ms "
            f"(host clock, synchronized) {[round(v, 3) for v in got['frame_ms']]}"
            + (f"; with {FRAMES_IN_FLIGHT} in flight {got['flight_ms']:.4f} per frame over "
               f"{flight}" if flight else "")
            + f"; launches per rank over 3 frames{' and those' if flight else ''}:",
            json.dumps(got["launches"]))
        for launched in got["launches"]:
            launches.update(launched)
    return launches


def viewer_phase(dev, config, camera, sponza_files, export_s, kernels, flight_ms,
                 viewer_log) -> None:
    """Phase 10: the viewer from files on disk (module docstring). `flight_ms`
    is the in-memory sponza's render_async frame with FRAMES_IN_FLIGHT in
    flight."""
    from vktf_tpu_torch import engine as engine_mod
    from vktf_tpu_torch import game
    from vktf_tpu_torch.window import Window

    t_phase = time.perf_counter()
    on_disk = sum(f.stat().st_size for f in sponza_files[0].parent.rglob("*") if f.is_file())
    log(f"[viewer] export of the sponza, RGBA8 KTX2 under ZLIB: {export_s:.3f} host s, "
        f"{on_disk / 1e6:.1f} MB on disk")
    engine = engine_mod.Engine(Window(width=config.width, height=config.height), config,
                               viewer_log, device=dev)
    loaded = engine.load(sponza_files)
    load_s = dict(engine.load_seconds)
    log("[viewer] Engine.load of the sponza files (host s, upload ends in a synchronize):",
        json.dumps({k: round(v, 4) for k, v in load_s.items()}),
        f"total {sum(load_s.values()):.3f}")
    loaded.camera = camera
    viewer_breakdown(engine, loaded)
    del loaded, engine

    stats = {}
    wait_idle = engine_mod.Engine.wait_idle

    def recording_wait_idle(self):
        wait_idle(self)
        stats.update(self.frame_timer.summary())

    engine_mod.Engine.wait_idle = recording_wait_idle
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        game.main([*map(str, sponza_files), "--width", str(config.width), "--height",
                   str(config.height), "--msaa", "4", "--frames", "32", "--display", "off"])
        main_s = time.perf_counter() - t0
    finally:
        engine_mod.Engine.wait_idle = wait_idle
    log(f"[viewer] game.main, {config.width}x{config.height} 4x MSAA, 32-frame fly-through: "
        f"{stats['frames']} frames presented in {main_s:.3f} s of host time (load included); "
        "launches in the path:", json.dumps({k.name: k.launches for k in kernels}))
    log(f"[viewer] FrameTimer over {stats['frames']} frames: p50 {stats['frame_ms_p50']:.4f} ms, "
        f"p99 {stats['frame_ms_p99']:.4f} ms, mean {stats['frame_ms_mean']:.4f} ms, "
        f"{stats['fps']:.2f} FPS; Scene.render_async with {FRAMES_IN_FLIGHT} frames in "
        f"flight (phase 5): {flight_ms:.4f} ms per frame")
    log(f"[viewer] phase time: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--small", action="store_true",
                        help="the small courtyard at 256x128 (a quick run)")
    parser.add_argument("--frames", type=int, default=8)
    args = parser.parse_args()

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import bench_torch
    from vktf_tpu_torch import native
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers, sponza_like_asset)
    from vktf_tpu_torch.ops import (_cuda, _host, pipeline, raster, setup_kernel,
                                    shade_kernel, shade_table)
    from vktf_tpu_torch.scene.scene import Scene

    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    # the K = 1 path's records, then the K-layer raster and every other shade
    kernels = [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, raster.KERNEL_GROUPS,
               shade_table.KERNEL, shade_kernel.KERNEL, raster.KERNEL_LAYERS,
               *shade_kernel.KERNELS[1:]]
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
    log(f"[host] native runtime: g++ {time.perf_counter() - t0:.2f} s -> {native_lib.name}; "
        f"loaded: {native.available()}")

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
    t0 = time.perf_counter()
    sponza_files = [export_asset(a, _cuda.BUILD_DIR / "assets" / "sponza", "rgba", viewer_log,
                                 SUPERCOMPRESSION_ZLIB) for a in assets]
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = Scene(assets, config, camera=camera, device=dev)
    torch.cuda.synchronize()
    meta = scene.meta
    log(f"scene: {meta.num_triangles} triangles, {meta.num_instances} instances, "
        f"{meta.num_lights} lights, pool {tuple(scene.render_scene.quad_pool.shape)}, "
        f"peel layers {meta.peel_layers}; assets {host_s:.1f} s, flatten+upload "
        f"{time.perf_counter() - t0:.1f} s")
    ph, pw = config.padded_height, config.padded_width
    flight_by_path = {}

    def drive(scn, tag: str):
        """One path through Scene (phase 4): counters zeroed just before,
        read just after; prints frame and stage times, saves the still."""
        for k in kernels:
            k.launches = 0
        frame_ms = []
        for _ in range(args.frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scn.render_async()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        n_flight = 4 * args.frames
        flight_ms, _ = in_flight(scn, n_flight)
        flight_by_path[tag] = flight_ms
        still = scn.render_still()
        launches = {k.name: k.launches for k in kernels}
        log(f"[{tag}] launches in the path:", json.dumps(launches))
        steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
        log(f"[{tag}] frame ms (host clock, synchronized): first {frame_ms[0]:.3f}, "
            f"steady median {float(np.median(steady)):.3f}, min {min(steady):.3f}, "
            f"all {[round(v, 3) for v in frame_ms]}; with {FRAMES_IN_FLIGHT} frames in "
            f"flight: {flight_ms:.3f} per frame over {n_flight}")
        stages = stage_ms(scn)
        log(f"[{tag}] stage ms a frame over {STAGE_FRAMES} profiled frames (device, host):",
            json.dumps({k: [None if d is None else round(d, 4), round(h, 4)]
                        for k, (d, h) in stages.items()}))
        cfg = scn.config
        out_path = _cuda.BUILD_DIR / f"frame_{tag}_{cfg.width}x{cfg.height}.npy"
        np.save(out_path, still)
        log(f"[{tag}] frame saved:", out_path.relative_to(_cuda.BUILD_DIR.parent.parent))
        return still, launches

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

    # ---- 5. the opaque path (K = 1) and its records ----------------------
    still, launches = drive(scene, "opaque")
    path_launches = {k.name: launches[k.name] for k in kernels[:K1_RECORDS]}
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
                        "library_ms": None, "mesh_launches": None})

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
    del ids_p, depth_p
    # the group level of the cull, which every raster entry launches first
    record(raster.KERNEL_GROUPS, 0.0, *groups_held("sponza", stream[2]))

    # ---- 5a. the raster prologue against its plain version ---------------
    record(raster.KERNEL_STREAM, 0.0,
           *stream_held("sponza", setup["tri_data"], setup["bbox_rows"], perm))
    if not args.small:
        stream_2160p(dev)

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
    ma = config.max_anisotropy
    s_args = (tri, sx, sy, frac, table, rs.quad_pool, cam, lights, bg, ma)
    err = compare_packed("shade", shade_kernel.shade_resolve(*s_args),
                         shade_kernel.shade_resolve_plain(*s_args))
    record(shade_kernel.KERNEL, err, cuda_ms(lambda: shade_kernel.shade_resolve(*s_args), 20),
           cuda_ms(lambda: shade_kernel.shade_resolve_plain(*s_args), 3),
           shade_bound(tri, sx, sy, table, ma, meta.num_lights, False))
    del ids, depth

    # ---- 6. the translucent path ------------------------------------------
    set_blend(assets)
    scene_t = Scene(assets, config, camera=camera, device=dev)
    meta_t = scene_t.meta
    layers = scene_t.frame_program.layers
    log(f"translucent scene: peel layers {meta_t.peel_layers} (K = {layers})")
    _still_t, launches_t = drive(scene_t, "translucent")
    path_launches.update({k: launches_t[k] for k in ("raster_layers", "shade_layer")})
    st_t = frame_stages(scene_t)
    rs_t, stream_t = scene_t.render_scene, st_t["stream"]
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
    del ids_t, depth_t, ids_tp, depth_tp
    record(raster.KERNEL_LAYERS, w_err, w_ms,
           cuda_ms(lambda: pipeline.pixel_winner(*raster.rasterize_plain(*rl_args)), 1), w_bound)
    tri_t, table_t, lights_t = st_t["tri"], st_t["table"], st_t["lights"]
    del st_t
    translucent_bound = (tri_t, sx, sy, table_t, ma, meta_t.num_lights)

    # ---- 7. the texture side paths, each a path through Scene ------------
    def variant(base, **overrides):
        """base's device scene under another configuration."""
        return Scene.from_render_scene(base.render_scene, base.meta,
                                       base.config.replace(**overrides), camera)

    def run_path(scn, tag: str, kernel):
        """Drive one path; `kernel` is its shade record."""
        _still, launched = drive(scn, tag)
        path_launches.setdefault(kernel.name, launched[kernel.name])

    def shade_inputs(scn):
        """(tri, frac, table, lights, pool) of a scene's frame."""
        st = frame_stages(scn)
        return st["tri"], st["frac"], st["table"], st["lights"], scn.render_scene.quad_pool

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

    pool, pool_t = rs.quad_pool, rs_t.quad_pool
    opaque_bound = (tri, sx, sy, table, ma, meta.num_lights)
    held_layer("shade layer", shade_kernel.KERNEL_LAYER,
               (tri_t, sx, sy, table_t, pool_t, cam, lights_t, ma), tri_t, translucent_bound)
    # four taps
    run_path(variant(scene, aniso_taps=4), "taps4", shade_kernel.KERNEL_TAPS)
    held_resolve("shade taps=4", shade_kernel.KERNEL_TAPS,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "fused", 4),
                 opaque_bound, "fused", 4)
    run_path(variant(scene_t, aniso_taps=4), "translucent_taps4",
             shade_kernel.KERNEL_LAYER_TAPS)
    held_layer("shade layer taps=4", shade_kernel.KERNEL_LAYER_TAPS,
               (tri_t, sx, sy, table_t, pool_t, cam, lights_t, ma, "fused", 4), tri_t,
               translucent_bound, "fused", 4)
    # the two-gather pool and the attrs boundary
    run_path(variant(scene, shade_fused_pool=False), "classic", shade_kernel.KERNEL_CLASSIC)
    held_resolve("shade classic", shade_kernel.KERNEL_CLASSIC,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "classic", 1),
                 opaque_bound, "classic")
    run_path(variant(scene, shade_attrs_boundary=True), "attrs", shade_kernel.KERNEL_ATTRS)
    attrs = shade_kernel.fragment_attrs(tri, sx, sy, table, ma)
    held_resolve("shade attrs", shade_kernel.KERNEL_ATTRS,
                 (*attrs, tri, frac, pool, cam, lights, bg), opaque_bound, "classic", attrs=True)
    del attrs
    run_path(variant(scene_t, shade_fused_pool=False), "translucent_classic",
             shade_kernel.KERNEL_LAYER_CLASSIC)
    held_layer("shade layer classic", shade_kernel.KERNEL_LAYER_CLASSIC,
               (tri_t, sx, sy, table_t, pool_t, cam, lights_t, ma, "classic", 1), tri_t,
               translucent_bound, "classic")
    run_path(variant(scene_t, shade_attrs_boundary=True), "translucent_attrs",
             shade_kernel.KERNEL_ATTRS_LAYER)
    attrs_t = shade_kernel.fragment_attrs(tri_t, sx, sy, table_t, ma)
    log(f"attrs boundary at K = {layers}: {attrs_t[0].numel() * 4 / 1e9:.2f} GB of rows")
    held_layer("shade attrs layer", shade_kernel.KERNEL_ATTRS_LAYER,
               (*attrs_t, tri_t, pool_t, cam, lights_t), tri_t, translucent_bound, "classic",
               attrs=True)
    del attrs_t
    # four taps on the two-gather source (the attrs boundary with taps)
    run_path(variant(scene, shade_attrs_boundary=True, aniso_taps=4), "attrs_taps4",
             shade_kernel.KERNEL_CLASSIC_TAPS)
    held_resolve("shade classic taps=4", shade_kernel.KERNEL_CLASSIC_TAPS,
                 (tri, sx, sy, frac, table, pool, cam, lights, bg, ma, "classic", 4),
                 opaque_bound, "classic", 4)
    run_path(variant(scene_t, shade_fused_pool=False, aniso_taps=4), "translucent_classic_taps4",
             shade_kernel.KERNEL_LAYER_CLASSIC_TAPS)
    held_layer("shade layer classic taps=4", shade_kernel.KERNEL_LAYER_CLASSIC_TAPS,
               (tri_t, sx, sy, table_t, pool_t, cam, lights_t, ma, "classic", 4), tri_t,
               translucent_bound, "classic", 4)
    # the mirror sponza: the two-gather kernel on its own scene
    scene_m = Scene(set_samplers(sponza_assets(), **SAMPLER_PRESETS["mirror"]), config,
                    camera=camera, device=dev)
    drive(scene_m, "mirror")
    del scene_m
    # the mixed sponza: per-slot rows, one and four taps, opaque and K = 8
    assets_x = set_samplers(sponza_assets(), **SAMPLER_PRESETS["mixed"])
    scene_x = Scene(assets_x, config, camera=camera, device=dev)
    tri_x, frac_x, table_x, lights_x, pool_x = shade_inputs(scene_x)
    mixed_bound = (tri_x, sx, sy, table_x, ma, scene_x.meta.num_lights)
    for taps, kernel in ((1, shade_kernel.KERNEL_PER_SLOT), (4, shade_kernel.KERNEL_PER_SLOT_TAPS)):
        run_path(variant(scene_x, aniso_taps=taps), "mixed" + ("_taps4" if taps > 1 else ""),
                 kernel)
        held_resolve(f"shade per-slot taps={taps}, mixed sponza", kernel,
                     (tri_x, sx, sy, frac_x, table_x, pool_x, cam, lights_x, bg, ma, "per_slot",
                      taps), mixed_bound, "per_slot", taps)
    leaves_x, meta_x = scene_leaves(scene_x.render_scene), scene_x.meta  # the mesh phase
    del scene_x, tri_x, frac_x, table_x
    scene_xt = Scene(set_blend(assets_x), config, camera=camera, device=dev)
    tri_xt, _frac_xt, table_xt, lights_xt, pool_xt = shade_inputs(scene_xt)
    for taps, kernel in ((1, shade_kernel.KERNEL_LAYER_PER_SLOT),
                         (4, shade_kernel.KERNEL_LAYER_PER_SLOT_TAPS)):
        run_path(variant(scene_xt, aniso_taps=taps),
                 "translucent_mixed" + ("_taps4" if taps > 1 else ""), kernel)
        held_layer(f"shade layer per-slot taps={taps}", kernel,
                   (tri_xt, sx, sy, table_xt, pool_xt, cam, lights_xt, ma, "per_slot", taps),
                   tri_xt, (tri_xt, sx, sy, table_xt, ma, scene_xt.meta.num_lights), "per_slot",
                   taps)
    del scene_xt, assets_x, tri_xt, table_xt
    require({r["name"] for r in records} == {k.name for k in kernels},
            "every kernel was held against its plain version")

    # ---- 8. the presets, the present encodings, sample-rate shading -------
    t_phase = time.perf_counter()
    for preset in ("box", "duck", "helmet", "flythrough"):
        _, w_p, h_p, msaa_p = bench_torch.CONFIGS[preset]
        if args.small:
            w_p, h_p = 256, 128
        t0 = time.perf_counter()
        scene_p = Scene(build_preset(preset),
                        RenderConfig(width=w_p, height=h_p, msaa_samples=msaa_p),
                        camera=Camera(*bench_torch.CAMERAS[preset],
                                      ViewFrustumParams(np.radians(45.0), w_p / h_p, 0.1,
                                                        1.0e6)), device=dev)
        torch.cuda.synchronize()
        m_p = scene_p.meta
        log(f"[{preset}] {w_p}x{h_p} {msaa_p}x MSAA: {m_p.num_triangles} triangles, "
            f"{m_p.num_instances} instances, {m_p.num_lights} lights, peel layers "
            f"{scene_p.frame_program.layers}; build+flatten+upload "
            f"{time.perf_counter() - t0:.1f} s")
        drive(scene_p, preset)
        del scene_p
    log(f"[presets] phase time: {time.perf_counter() - t_phase:.1f} s")

    n_copy = 4 * args.frames
    exact_ms, exact_bytes = in_flight(scene, n_copy, copy=True)
    log(f"[present_rgb_x1] with {FRAMES_IN_FLIGHT} frames in flight and the copy to the host: "
        f"{exact_ms:.4f} ms per frame over {n_copy}, {exact_bytes} bytes copied per frame")
    for fmt, scale in (("yuv420", 1), ("rgb", 2), ("yuv420", 2), ("yuv420", 4)):
        tag = f"present_{fmt}_x{scale}"
        scene_e = variant(scene, present_format=fmt, present_scale=scale)
        drive(scene_e, tag)
        copy_ms, copy_bytes = in_flight(scene_e, n_copy, copy=True)
        log(f"[{tag}] with {FRAMES_IN_FLIGHT} frames in flight and the copy to the host: "
            f"{copy_ms:.4f} ms per frame over {n_copy}, {copy_bytes} bytes copied per frame "
            f"({exact_bytes / copy_bytes:.2f}x fewer than the exact frame)")
        del scene_e

    for tag, base in (("sample", scene), ("translucent_sample", scene_t)):
        scene_s = variant(base, shading_rate="sample")
        drive(scene_s, tag)
        st = frame_stages(scene_s)
        tri_s = st["ids"].reshape(scene_s.frame_program.layers, -1)
        sx_s, sy_s = pipeline.sample_centers(ph, pw, config.msaa_samples, dev)
        sl_args_s = (tri_s, sx_s, sy_s, st["table"], scene_s.render_scene.quad_pool, cam,
                     st["lights"], ma)
        if base is scene:  # K = 1: the timed record against its plain version
            compare_layer(f"shade layer at sample rate, K = 1, {tri_s.shape[1]} samples",
                          shade_kernel.shade_layer(*sl_args_s),
                          shade_kernel.shade_layer_plain(*sl_args_s), tri_s)
        kernel_ms = cuda_ms(lambda: shade_kernel.shade_layer(*sl_args_s), 5)
        bound_s = shade_bound(tri_s, sx_s, sy_s, st["table"], ma, meta.num_lights, True)
        log(f"[{tag}] shade_layer over {tuple(tri_s.shape)} (layer, sample) entries: "
            f"{kernel_ms:.4f} ms (CUDA events), bound {bound_s[0]:.5f} ms ({bound_s[1]})")
        del scene_s, st, tri_s, sl_args_s

    # ---- 9. the mesh paths (vktf_tpu_torch.parallel) ----------------------
    from vktf_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    mesh_launches = collections.Counter()
    # the band raster the second band of a (2, 2) mesh runs, held to its
    # plain version at the band's shape
    band_h = (config.tiles_y + config.tiles_y % 2) * config.tile_shape[0] // 2
    for tag, strm, k in (("K = 1", stream, 1), (f"K = {layers}", stream_t, layers)):
        b_args = (*strm, band_h, pw, config.msaa_samples, k)
        b_ids, b_depth = raster.rasterize(*b_args, y_offset=band_h)
        p_ids, p_depth = raster.rasterize_plain(*b_args, band_h)
        id_bad = int((b_ids != p_ids).sum())
        d_bad, _ = bits_mismatch(b_depth[b_ids == p_ids], p_depth[b_ids == p_ids])
        band_ms = cuda_ms(lambda: raster.rasterize(*b_args, y_offset=band_h), 10)
        log(f"[mesh] band raster {tag}, rows {band_h}..{2 * band_h} of {pw} px: against the "
            f"plain version at the band's shape, id differs at {id_bad}, depth not bit-equal "
            f"at {d_bad} of the rest; {band_ms:.4f} ms (CUDA events)")
        require(id_bad <= (RASTER_ID_MISMATCH * b_ids.numel() if k == 1 else 0) and d_bad == 0,
                f"band raster {tag} against its plain version")
        del b_ids, b_depth, p_ids, p_depth
    # NCCL at world size 1, in this process: the sharded program's own overhead
    with launch.launcher_mesh(1, 1, "cuda") as (mesh1, _):
        _, launched = drive(Scene.from_render_scene(rs, meta, config, camera, mesh=mesh1),
                            "mesh_nccl_1x1")
    mesh_launches.update({k: v for k, v in launched.items() if v})
    log(f"[mesh] NCCL 1x1 with {FRAMES_IN_FLIGHT} frames in flight "
        f"{flight_by_path['mesh_nccl_1x1']:.4f} ms per frame against the one-device path's "
        f"{flight_by_path['opaque']:.4f} ms")
    # four ranks sharing the card over gloo; four cards over NCCL where the
    # machine has them
    scenes = {"opaque": (scene_leaves(rs), meta),
              "translucent": (scene_leaves(scene_t.render_scene), meta_t),
              "mixed": (leaves_x, meta_x)}
    del leaves_x
    mesh_launches.update(mesh_spawn("4 ranks on one card over gloo (not a scaling number)",
                                    scenes, (width, height), "gloo", 0))
    if torch.cuda.device_count() >= 4:
        mesh_launches.update(mesh_spawn("4 cards over NCCL", scenes, (width, height), "nccl",
                                        4 * args.frames))
    else:
        log(f"[mesh] the paths over NCCL on four cards: not run, this machine has "
            f"{torch.cuda.device_count()} card(s)")
    del scenes, scene_t
    log("[mesh] launches on the mesh paths (NCCL 1x1 and every rank of the spawns):",
        json.dumps(dict(mesh_launches)))
    log(f"[mesh] phase time: {time.perf_counter() - t_phase:.1f} s")
    for r in records:
        r["mesh_launches"] = mesh_launches.get(r["name"], 0)

    # ---- 10. the viewer: glTF files on disk -> Engine -> game.main --------
    viewer_phase(dev, config, camera, sponza_files, export_s, kernels,
                 flight_by_path["opaque"], viewer_log)

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
