"""GPU smoke run of the PyTorch + CUDA port (vktf_tpu_torch).

    python3 chip_smoke.py            # sponza preset, 1920x1080, 4x MSAA
    python3 chip_smoke.py --small    # the 38k-triangle courtyard at 256x128

Needs one CUDA card and nvcc. In order, it:
  1. reports the card (nvidia-smi name and power limit);
  2. builds the four CUDA kernels from vktf_tpu_torch/csrc (one nvcc each,
     in parallel) and times the build;
  3. builds the sponza preset with the port's numpy builder and uploads it;
  4. renders frames through the port's Scene (render_async / render_still)
     with every kernel launch counter set to 0 just before and read just
     after, printing per-stage CUDA-event times and the frame time;
  5. holds each kernel against its plain PyTorch version on the card, at
     the shapes the frame gave it, and times both;
  6. renders a small frame on the card and on the CPU (plain versions
     only) and compares them;
  7. checks the frame (shape, dtype, >= 50% of pixels lit), saves it as
     .npy in the build directory (vktf_tpu_torch/_build/, not committed),
     and prints the kernels line, the card line and, last,
     {"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
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
FRAME_MISMATCH = 5e-3         # small frame: card vs CPU plain path


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


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bits_mismatch(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    """(count of float32 values whose bits differ, max |a - b|)."""
    diff = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
    err = (a - b).abs()
    err = torch.where(torch.isnan(err), torch.zeros_like(err), err)
    return int(diff.sum()), float(err.max()) if err.numel() else 0.0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--small", action="store_true",
                        help="the small courtyard at 256x128 (a quick check)")
    parser.add_argument("--frames", type=int, default=8)
    args = parser.parse_args()

    dev = cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import build_preset, sponza_like_asset
    from vktf_tpu_torch.ops import _cuda, pipeline, raster, setup_kernel, shade_kernel, shade_table
    from vktf_tpu_torch.scene.scene import Scene

    card = card_line()
    log("card:", card, "|", torch.cuda.get_device_name(0), "| torch",
        torch.__version__, "cuda", torch.version.cuda)
    kernels = [setup_kernel.KERNEL, raster.KERNEL, shade_table.KERNEL, shade_kernel.KERNEL]

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _cuda.build([k.source for k in kernels])
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{s} {v:.1f} s" for s, v in build_s.items()))
    for k in kernels:
        log(f"ptxas {k.source}: " + " | ".join(
            line.strip() for line in _cuda.build_log(k.source).splitlines()
            if "registers" in line or "spill" in line))

    # ---- 3. scene -------------------------------------------------------
    if args.small:
        width, height = 256, 128
        t0 = time.perf_counter()
        assets = [sponza_like_asset(columns_per_ring=4, clutter=8, curtains=2,
                                    tex_size=64)]
    else:
        width, height = 1920, 1080
        t0 = time.perf_counter()
        assets = build_preset("sponza")
    config = RenderConfig(width=width, height=height, msaa_samples=4)
    camera = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                               0.1, 1.0e6))
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = Scene(assets, config, camera=camera, device=dev)
    torch.cuda.synchronize()
    meta = scene.meta
    log(f"scene: {meta.num_triangles} triangles, {meta.num_instances} instances, "
        f"{meta.num_lights} lights, pool {tuple(scene.render_scene.quad_pool.shape)}; "
        f"assets {host_s:.1f} s, flatten+upload {time.perf_counter() - t0:.1f} s")

    # ---- 4. the main path: frames through Scene -------------------------
    for k in kernels:
        k.launches = 0
    frame_ms = []
    stage_ms = []
    prog = scene.frame_program
    for i in range(args.frames):
        prog.timer = pipeline._StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = scene.render_async()
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        stage_ms.append(prog.timer.millis())
    still = scene.render_still()
    launches = {k.name: k.launches for k in kernels}
    prog.timer = None
    log("launches in the main path:", json.dumps(launches))
    require(all(n > 0 for n in launches.values()), "every kernel ran in the main path")
    steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
    log(f"frame ms (host clock, synchronized): first {frame_ms[0]:.3f}, "
        f"steady median {float(np.median(steady)):.3f}, min {min(steady):.3f}, "
        f"all {[round(v, 3) for v in frame_ms]}")
    stages = {name: float(np.median([s[name] for s in stage_ms[1:] or stage_ms]))
              for name in stage_ms[0]}
    log("stage ms (CUDA events, steady median):",
        json.dumps({k: round(v, 4) for k, v in stages.items()}))

    # ---- 7a. the frame --------------------------------------------------
    require(still.shape == (3, height, width) and still.dtype == np.uint8,
            f"frame shape/dtype {still.shape} {still.dtype}")
    require(np.array_equal(still, frame.cpu().numpy()), "render_still == render_async")
    clear = (np.asarray(config.clear_color[:3]) * 255 + 0.5).astype(np.uint8)
    lit = float((still != clear[:, None, None]).any(axis=0).mean())
    log(f"pixels differing from the clear colour: {lit:.4f}")
    require(lit >= 0.5, "at least half the frame is lit")
    out_path = _cuda.BUILD_DIR / f"frame_{'small' if args.small else 'sponza'}_{width}x{height}.npy"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, still)
    log("frame saved:", out_path.relative_to(_cuda.BUILD_DIR.parent.parent))

    # ---- 5. each kernel against its plain version, main-path shapes -----
    rs = scene.render_scene
    vp = torch.as_tensor(np.asarray(camera.view_projection_transform, np.float32), device=dev)
    cam = torch.as_tensor(np.asarray(camera.position, np.float32), device=dev)
    mrowsT, lights = pipeline.scene_update(rs, meta)
    ph, pw = config.padded_height, config.padded_width
    records = []

    def record(kernel, err, ms, plain_ms):
        records.append({"name": kernel.name, "route": "cuda", "source": kernel.source_path,
                        "replaces": kernel.replaces, "launches": launches[kernel.name],
                        "max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)})

    # setup
    args_setup = (rs.tri_corner, mrowsT, vp, width, height)
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
    record(setup_kernel.KERNEL, worst, cuda_ms(lambda: setup_kernel.setup_pack(*args_setup), 50),
           cuda_ms(lambda: setup_kernel.setup_pack_plain(*args_setup), 3))

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
    record(raster.KERNEL, d_err, cuda_ms(lambda: raster.rasterize(*r_args), 10),
           cuda_ms(lambda: raster.rasterize_plain(*r_args), 2))

    # shade table
    t_args = (setup["edge9"], rs.tri_corner, rs.tri_static_cols, setup["anchor2"], mrowsT)
    table = shade_table.build_shade_table(*t_args)
    table_p = shade_table.build_shade_table_plain(*t_args)
    n_bad, t_err = bits_mismatch(table, table_p)
    log(f"shade table: {tuple(table.shape)}, not bit-equal {n_bad} of {table.numel()}, "
        f"max |diff| {t_err:.3e} (tolerance: {TABLE_MISMATCH} of values)")
    require(n_bad <= TABLE_MISMATCH * table.numel(), "shade table")
    record(shade_table.KERNEL, t_err, cuda_ms(lambda: shade_table.build_shade_table(*t_args), 50),
           cuda_ms(lambda: shade_table.build_shade_table_plain(*t_args), 3))

    # shade + resolve (all pixels)
    tri, frac = pipeline.pixel_winner(ids, depth)
    sx, sy = pipeline.pixel_centers(ph, pw, dev)
    bg = torch.tensor(config.clear_color[:3], dtype=torch.float32, device=dev)
    s_args = (tri, sx, sy, frac, table, rs.quad_pool, cam, lights, bg, config.max_anisotropy)
    packed = shade_kernel.shade_resolve(*s_args)
    packed_p = shade_kernel.shade_resolve_plain(*s_args)
    step = torch.zeros_like(packed)
    for c in range(3):
        step = torch.maximum(step, (((packed >> (8 * c)) & 0xFF)
                                    - ((packed_p >> (8 * c)) & 0xFF)).abs())
    n_step = int((step > 0).sum())
    log(f"shade: {packed.numel()} pixels, max u8 step {int(step.max())}, off at {n_step} "
        f"(tolerance: step <= {SHADE_STEP} on <= {SHADE_MISMATCH} of pixels)")
    require(int(step.max()) <= SHADE_STEP and n_step <= SHADE_MISMATCH * packed.numel(), "shade")
    record(shade_kernel.KERNEL, float(step.max()), cuda_ms(lambda: shade_kernel.shade_resolve(*s_args), 20),
           cuda_ms(lambda: shade_kernel.shade_resolve_plain(*s_args), 3))

    # the frame the main path produced equals these stages' output
    frame_again = torch.stack([((packed.reshape(ph, pw)[:height, :width] >> (8 * c)) & 0xFF)
                               .to(torch.uint8) for c in range(3)]).cpu().numpy()
    require(np.array_equal(frame_again, still), "stage-by-stage frame == Scene frame")

    # ---- 6. a small frame: card kernels vs the CPU plain path -----------
    small_cfg = RenderConfig(width=256, height=128, msaa_samples=4)
    small_cam = Camera(*CAMERA, ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 1.0e6))
    small = [sponza_like_asset(columns_per_ring=4, clutter=8, curtains=2, tex_size=64)]
    f_gpu = Scene(small, small_cfg, camera=small_cam, device=dev).render_still()
    f_cpu = Scene(small, small_cfg, camera=small_cam, device="cpu").render_still()
    fd = np.abs(f_gpu.astype(np.int16) - f_cpu).max(axis=0)
    log(f"small frame card vs CPU plain: max diff {int(fd.max())}, off at "
        f"{float((fd > 0).mean()):.5f} of pixels (tolerance: 1 on {FRAME_MISMATCH})")
    require(fd.max() <= 1 and (fd > 0).mean() <= FRAME_MISMATCH, "small frame")

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
