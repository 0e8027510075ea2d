"""A/B frame times of the port's opaque sponza frame across source trees, on one CUDA card.

    python3 frame_ab.py DIR [DIR ...] [--frames N] [--json PATH]

Each DIR is the root of a tree of this repository ("." for this one), for
example another commit unpacked under the ignored ``vktf_tpu_torch/_build/``::

    mkdir -p vktf_tpu_torch/_build/parent
    git archive <commit> | tar -x -C vktf_tpu_torch/_build/parent

Each tree runs in a process of its own (its package, its kernel builds in
its own build directory), in turns: the trees in the order given, then in
reverse (parent, new, new, parent for two). A turn builds the sponza preset
through that tree's ``Scene`` at 1920x1080, 4x MSAA, from chip_smoke.py's
camera, and measures on the host clock the synchronized frame (one
``render_async`` and a synchronize; steady median of N) and the frame with
4 in flight (4N frames, frame i enqueued once frame i - 4's event has
completed), and with CUDA events the setup kernel's wrapper (50 calls).
Prints the card and one JSON line per turn; ``--json PATH`` writes them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r"""
import collections, hashlib, json, sys, time
import numpy as np
import torch
from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
from vktf_tpu_torch.models.scenes import build_preset
from vktf_tpu_torch.ops import _cuda, pipeline, raster, setup_kernel, shade_kernel, shade_table
from vktf_tpu_torch.scene.scene import Scene

frames = int(sys.argv[1])
kernels = [setup_kernel.KERNEL, raster.KERNEL, shade_table.KERNEL, *shade_kernel.KERNELS]
_cuda.build(sorted({k.source for k in kernels}))
dev = torch.device("cuda", torch.cuda.current_device())
width, height = 1920, 1080
camera = Camera((-9.0, 1.7, 0.0), (1.0, 0.05, 0.0),
                ViewFrustumParams(np.radians(45.0), width / height, 0.1, 1.0e6))
scene = Scene(build_preset("sponza"), RenderConfig(width=width, height=height, msaa_samples=4),
              camera=camera, device=dev)
scene.render_still()
sync_ms = []
for _ in range(frames + 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene.render_async()
    torch.cuda.synchronize()
    sync_ms.append((time.perf_counter() - t0) * 1e3)
pending, n_flight = collections.deque(), 4 * frames
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(n_flight):
    if len(pending) == 4:
        pending.popleft().synchronize()
    scene.render_async()
    done = torch.cuda.Event()
    done.record()
    pending.append(done)
torch.cuda.synchronize()
flight_ms = (time.perf_counter() - t0) * 1e3 / n_flight
rs = scene.render_scene
inst_rows, tri_instance, _lights = pipeline.scene_update(rs, scene.meta)
vp = torch.as_tensor(np.asarray(camera.view_projection_transform, np.float32), device=dev)
args = (rs.tri_corner, inst_rows, tri_instance, vp, width, height)
for _ in range(5):
    setup_kernel.setup_pack(*args)
begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
begin.record()
for _ in range(50):
    setup_kernel.setup_pack(*args)
end.record()
torch.cuda.synchronize()
still = scene.render_still()
print(json.dumps({"sync_ms": round(float(np.median(sync_ms[1:])), 4),
                  "sync_all": [round(v, 3) for v in sync_ms],
                  "flight_ms": round(flight_ms, 4),
                  "setup_wrapper_ms": round(begin.elapsed_time(end) / 50, 5),
                  "frame_sha1": hashlib.sha1(still.tobytes()).hexdigest()[:12]}))
"""


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="+", help="roots of the trees to time")
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("frame_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown",
          flush=True)
    results = []
    for turn, tree in enumerate(args.trees + args.trees[::-1]):
        root = Path(tree).resolve()
        out = subprocess.run([sys.executable, "-c", TURN, str(args.frames)], cwd=root,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        line = json.loads(out.stdout.strip().splitlines()[-1])
        line.update(turn=turn, tree=tree)
        results.append(line)
        print(json.dumps(line), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
