#!/usr/bin/env python3
"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The run builds the cell's scene from the seed, warms up the cell's own
shapes (the first run in a checkout also builds the kernels), runs the
traffic's closed loop of frames for the given seconds, holds a sample of
the window's frames (drawn from the seed) to the plain reference renderer,
and prints as the last line of standard output one JSON object: correct,
attempted, failed, the metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones, read from two profiled spans of the window),
the device and, last, each number the check compared beside its limit
(also the last lines of standard error). It prints no result and exits
non-zero without CUDA or with fewer cards than the cell asks for, or when
jax, jaxlib, flax or the JAX package is loaded once the window has closed.
The kernel build and Triton caches stay at fixed directories inside the
checkout.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_START = _process_age()
ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vktf_tpu")


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: vktf_tpu_torch is not vktf_tpu."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a metric's reader reads: the cell, the loop's Record, set-up
    times, the profiled spans' Timelines (host and device; device alone),
    the card's peaks and the frozen work counts of some traced frames."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def _fail(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, device=None) -> int:
    """`device` is for the harness's own tests (the CPU, the kernels'
    plain versions); the command line always measures a card."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import spec

    bench = spec.benchmark()
    workload, config, traffic = spec.cell(args.workload, bench)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: this benchmark measures a card")
        if torch.cuda.device_count() < workload["chips"]:
            return _fail(f"{workload['name']} needs {workload['chips']} cards, "
                         f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    result, check_lines = run_cell(args, bench, workload, config, traffic, device)
    found = loaded_forbidden()
    if found:
        return _fail(f"modules loaded in this process that must not be: {found}")
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(args, bench, workload, config, traffic, device):
    import torch

    from benchmark import check, loops, program, reference, scene_gen, spec, walk
    from benchmark.roofline import PEAKS
    from benchmark.timeline import Timeline

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    seed = args.seed
    log = program.Log()  # the run's own, on this process's standard error
    assets = scene_gen.build(config["scene"], seed)
    t = time.perf_counter()
    scn = program.scene(assets, config, device, log)
    sync()
    scene_build_s = time.perf_counter() - t

    warm = traffic["warmup_frames"]
    count = warm + math.ceil(args.seconds * traffic["max_frames_per_s"]) + 1
    positions, directions = walk.poses(traffic["walk"], config["camera"], seed, count)
    frustum = program.camera(config, positions[0], directions[0]).view_frustum

    def set_camera(i: int) -> None:
        if i >= count:
            raise RuntimeError(f"the walk holds {count} frames: raise max_frames_per_s")
        scn.camera = program.Camera(positions[i].astype(np.float32),
                                    directions[i].astype(np.float32), frustum)

    if traffic["kind"] != "server":
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    # the sample holds check_frames frames, as many of each slot in flight
    reservoir = loops.Reservoir(traffic["check_frames"], seed, traffic["in_flight"])
    trace_dir = trace_paths = None
    if args.trace:
        trace_dir = Path(tempfile.mkdtemp(prefix="bench-trace-"))
        trace_paths = (trace_dir / "host.json", trace_dir / "device.json")
        loops.warm_profiler(scn.render_async)
    buffers = collections.deque()
    loops.run_server(scn, set_camera, traffic, 0, buffers, count=warm)
    sync()
    gc.collect()
    gc.disable()  # no collector pauses inside the window
    t_first = time.perf_counter()
    rec = loops.run_server(scn, set_camera, traffic, warm, buffers, seconds=args.seconds,
                           reservoir=reservoir, trace_paths=trace_paths)
    gc.enable()
    setup_s = AGE_AT_START + (t_first - T_START)
    sync()
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                if on_card else 0}
    timeline = idle_timeline = None
    if trace_dir is not None:
        timeline, idle_timeline = (Timeline.load(p) if p.exists() else None
                                   for p in trace_paths)
        if idle_timeline is not None and idle_timeline.device:
            dev_info["busy_s"] = idle_timeline.busy_s()
            dev_info["window_s"] = idle_timeline.device_window_s()
        for p in trace_paths:
            p.unlink(missing_ok=True)
        trace_dir.rmdir()

    # the program's state goes before the reference runs on the card
    del scn, buffers
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    r = config["render"]
    width, height, samples = r["width"], r["height"], r["msaa_samples"]
    aniso = r.get("max_anisotropy", 16.0)
    ref = reference.ReferenceScene(assets, device)

    def ref_frame(i, counts=False):
        vp = reference.view_projection(config["camera"], width, height, positions[i],
                                       directions[i])
        return reference.render(ref, vp, positions[i], width, height, samples, aniso,
                                counts=counts)

    t_ref = time.perf_counter()
    per_frame = []
    for i, frame in sorted(reservoir.kept, key=lambda kv: kv[0]):
        per_frame.append({"frame": i, **check.frame_numbers(frame, ref_frame(i).cpu())})
    correct, compared = check.judge(per_frame, config["check"]["limits"])
    ref_s = time.perf_counter() - t_ref

    work = {}
    if timeline is not None:
        traced = sorted(rec.traced & set(timeline.frames))
        picks = np.random.default_rng([seed, 2]).permutation(traced)[:traffic["roofline_frames"]]
        for i in sorted(int(i) for i in picks):
            work[i] = ref_frame(i, counts=True)[1]

    run = Run(config=config, traffic=traffic, workload=workload, seconds=args.seconds,
              record=rec, setup_s=setup_s, scene_build_s=scene_build_s, timeline=timeline,
              idle_timeline=idle_timeline, peaks=PEAKS.get(kind), work=work)
    metrics = {}
    for entry in spec.metrics_of(bench, workload["name"], bool(args.trace)):
        value = spec.reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    lat = rec.latencies()
    quarters = np.histogram(list(rec.done.values()), bins=4, range=(rec.t0, rec.t1))[0]
    lines = [f"window: {len(rec.enqueued)} frames enqueued, {rec.completed_in_window()} done "
             f"in {args.seconds} s (by quarter {quarters.tolist()}); latency median "
             f"{float(np.median(lat)) * 1e3 if lat else float('nan'):.4f} ms over {len(lat)}; "
             f"setup {setup_s:.3f} s (scene build {scene_build_s:.3f} s); "
             f"reference {ref_s:.3f} s for {len(per_frame)} frames"]
    for label, frames in (("host and device", rec.traced),
                          ("device only", rec.profiled - rec.traced)):
        if frames:
            times = [rec.dispatch[i] for i in frames]
            lines.append(f"profiled span, {label}: {len(times)} frames, dispatch mean "
                         f"{sum(times) / len(times) * 1e3:.4f} ms under the profiler")
    lines += [f"frame {n['frame']}: " + ", ".join(f"{k} {v}" for k, v in n.items() if k != "frame")
              for n in per_frame]
    lines += [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in compared.items()]
    result = {"correct": correct, "attempted": len(rec.enqueued),
              "failed": len(rec.enqueued) - len(rec.done), "metrics": metrics,
              "device": dev_info}
    if timeline is not None:
        result["breakdown"] = {"device_ops": timeline.top_device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    result["check"] = compared
    return result, lines


if __name__ == "__main__":
    sys.exit(main())
