#!/usr/bin/env python3
"""The check's control and planted faults, read at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 [--frames 2]

For each seed, at `frames` poses of the cell's walk drawn from the seed,
it renders the plain reference (float64) and holds to it, by the numbers
of ``check.frame_numbers``:
  * the control: the reference with everything after the raster in
    bfloat16 and the raster in float32, put in the program's place;
  * a stale frame: the reference's frame of the pose before (a frame
    server that returns its last frame unchanged);
  * an altered frame: the reference's frame with one 64x128 tile, the
    port's raster tile, left at the clear colour.
Prints one JSON line per (seed, frame) and a last line with each number's
smallest reading per kind; the benchmark's own runs do not run it.
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, reference, scene_gen, spec, walk  # noqa: E402

TILE = (64, 128)


def altered(frame: torch.Tensor, rng) -> torch.Tensor:
    """The frame with one tile, the most lit of four drawn, left black."""
    out = frame.clone()
    _, h, w = out.shape
    best = None
    for _ in range(4):
        y = int(rng.integers(0, max(h - TILE[0], 1)))
        x = int(rng.integers(0, max(w - TILE[1], 1)))
        lit = int(out[:, y:y + TILE[0], x:x + TILE[1]].amax(0).gt(0).sum())
        if best is None or lit > best[0]:
            best = (lit, y, x)
    _, y, x = best
    out[:, y:y + TILE[0], x:x + TILE[1]] = 0
    return out


def readings(workload: str, seeds, frames: int, device) -> list:
    _, config, traffic = spec.cell(workload, spec.benchmark())
    r = config["render"]
    width, height, samples = r["width"], r["height"], r["msaa_samples"]
    aniso = r.get("max_anisotropy", 16.0)
    rows = []
    for seed in seeds:
        assets = scene_gen.build(config["scene"], seed)
        ref = reference.ReferenceScene(assets, device)
        warm = traffic["warmup_frames"]
        positions, directions = walk.poses(traffic["walk"], config["camera"], seed, warm + 2000)
        rng = np.random.default_rng([seed, 3])
        for i in sorted(int(i) for i in rng.integers(warm + 1, warm + 2000, size=frames)):
            def frame(j, **kw):
                vp = reference.view_projection(config["camera"], width, height,
                                               positions[j], directions[j])
                return reference.render(ref, vp, positions[j], width, height, samples, aniso,
                                        **kw)

            truth = frame(i)
            control = frame(i, shade_dtype=torch.bfloat16, raster_dtype=torch.float32)
            row = {"seed": seed, "frame": i,
                   "control": check.frame_numbers(control.cpu(), truth.cpu()),
                   "stale": check.frame_numbers(frame(i - 1).cpu(), truth.cpu()),
                   "altered": check.frame_numbers(altered(truth, rng).cpu(), truth.cpu())}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--frames", type=int, default=2)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rows = readings(args.workload, args.seeds, args.frames, device)
    least = {kind: {name: min(row[kind][name] for row in rows) for name in rows[0][kind]}
             for kind in ("control", "stale", "altered")}
    print(json.dumps({"workload": args.workload, "device": str(device), "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
