"""A/B timing of the port's kernels against another commit's, on one CUDA card.

    python3 kernel_ab.py --parent DIR [--json PATH]

DIR holds another commit's ``vktf_tpu_torch/csrc`` files, unpacked under the
ignored ``vktf_tpu_torch/_build/``::

    git archive <commit> vktf_tpu_torch/csrc | tar -x -C DIR --strip-components=2

Every source whose text or headers differ from DIR's is built from both
directories (``_cuda.build``), and each kernel record of such a source is
timed at its chip_smoke.py path's inputs (``chip_smoke.frame_stages``): the
sponza preset at 1920x1080 4x MSAA, opaque, translucent (K = 8), the
mixed-sampler sponza and its translucent form, the attrs boundary's rows.
Each new output must equal the parent's bit for bit. Each record is timed
with CUDA events through its wrapper, in turns on one card: parent, new,
new, parent. Prints the card and one JSON line per record; ``--json PATH``
writes them all to PATH. A variant of a kernel is timed the same way: put
the variant's sources in DIR.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke


def same(a, b) -> bool:
    """Bit-equal tensors, or tuples or dicts of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def records(dev):
    """(kernel, call) for every kernel record, each at its chip_smoke path's
    inputs."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers)
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel, shade_kernel as sk
    from vktf_tpu_torch.ops import shade_table
    from vktf_tpu_torch.scene.scene import Scene

    width, height = 1920, 1080
    config = RenderConfig(width=width, height=height, msaa_samples=4)
    camera = Camera(*chip_smoke.CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                                          0.1, 1.0e6))
    ph, pw, ma, ms = (config.padded_height, config.padded_width, config.max_anisotropy,
                      config.msaa_samples)
    cam = torch.as_tensor(np.asarray(camera.position, np.float32), device=dev)
    bg = torch.tensor(config.clear_color[:3], dtype=torch.float32, device=dev)
    sx, sy = pipeline.pixel_centers(ph, pw, dev)

    def stages(assets):
        scene = Scene(assets, config, camera=camera, device=dev)
        return dict(chip_smoke.frame_stages(scene), rs=scene.render_scene,
                    pool=scene.render_scene.quad_pool)

    opaque = stages(build_preset("sponza"))
    translucent = stages(set_blend(build_preset("sponza")))
    mixed_assets = set_samplers(build_preset("sponza"), **SAMPLER_PRESETS["mixed"])
    mixed = stages(mixed_assets)
    mixed_t = stages(set_blend(mixed_assets))
    assert translucent["tri"].shape[0] == 8 and mixed_t["tri"].shape[0] == 8

    def resolve(st, texels, taps):
        args = (st["tri"], sx, sy, st["frac"], st["table"], st["pool"], cam, st["lights"], bg,
                ma, texels, taps)
        return lambda: sk.shade_resolve(*args)

    def layer(st, texels, taps):
        args = (st["tri"], sx, sy, st["table"], st["pool"], cam, st["lights"], ma, texels, taps)
        return lambda: sk.shade_layer(*args)

    rs, setup = opaque["rs"], opaque["setup"]
    attrs = sk.fragment_attrs(opaque["tri"], sx, sy, opaque["table"], ma)
    attrs_t = sk.fragment_attrs(translucent["tri"], sx, sy, translucent["table"], ma)
    out = [
        (setup_kernel.KERNEL,
         lambda: setup_kernel.setup_pack(rs.tri_corner, opaque["mrowsT"], opaque["vp"], width,
                                         height)),
        (raster.KERNEL, lambda: raster.rasterize(*opaque["stream"], ph, pw, ms)),
        (raster.KERNEL_LAYERS, lambda: raster.rasterize(*translucent["stream"], ph, pw, ms, 8)),
        (shade_table.KERNEL,
         lambda: shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                               rs.tri_static_cols, setup["anchor2"],
                                               opaque["mrowsT"])),
        (sk.KERNEL_ATTRS,
         lambda: sk.shade_attrs_resolve(*attrs, opaque["tri"], opaque["frac"], opaque["pool"],
                                        cam, opaque["lights"], bg)),
        (sk.KERNEL_ATTRS_LAYER,
         lambda: sk.shade_attrs_layer(*attrs_t, translucent["tri"], translucent["pool"], cam,
                                      translucent["lights"])),
    ]
    for (texels, multi), (k_resolve, k_layer) in sk._COLS_KERNELS.items():
        res_st, lay_st = (mixed, mixed_t) if texels == "per_slot" else (opaque, translucent)
        taps = 4 if multi else 1
        out += [(k_resolve, resolve(res_st, texels, taps)), (k_layer, layer(lay_st, texels, taps))]
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, required=True,
                        help="directory holding the other commit's csrc files")
    parser.add_argument("--json", type=Path, help="write every result to this file")
    args = parser.parse_args()

    dev = chip_smoke.cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    from vktf_tpu_torch.ops import _cuda

    parent = args.parent.resolve()
    card = chip_smoke.card_line()
    print("card:", card, flush=True)
    recs = records(dev)  # the inputs are made with this tree's kernels
    changed = sorted({k.source for k, _ in recs
                      if _cuda._lib_path(k.source) != _cuda._lib_path(k.source, parent)})
    print("sources that differ from the parent's:", changed, flush=True)
    _cuda.build(changed)
    _cuda.build(changed, parent)
    libs = {"new": {s: _cuda.library(s) for s in changed},
            "parent": {s: _cuda.load(s, parent) for s in changed}}
    results = []
    for kernel, call in recs:
        if kernel.source not in changed:
            continue

        def run(label):
            _cuda._libs[kernel.source] = libs[label][kernel.source]
            return call()

        want = run("parent")
        if not same(run("new"), want):
            raise RuntimeError(f"{kernel.name}: the new output differs from the parent's")
        torch.cuda.synchronize()
        ms_probe = chip_smoke.cuda_ms(lambda: run("parent"), 3)
        reps = max(5, min(50, int(20.0 / max(ms_probe, 1e-3))))
        times = {"parent": [], "new": []}
        for label in ("parent", "new", "new", "parent"):
            times[label].append(round(chip_smoke.cuda_ms(lambda: run(label), reps), 4))
        _cuda._libs[kernel.source] = libs["new"][kernel.source]
        del want
        row = {"name": kernel.name, "reps": reps, "turns": times,
               "parent_ms": round(float(np.mean(times["parent"])), 4),
               "new_ms": round(float(np.mean(times["new"])), 4)}
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "records": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
