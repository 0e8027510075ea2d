"""A/B timing of the port's kernels against another commit's, on one CUDA card.

    python3 kernel_ab.py --parent DIR [DIR ...] [--parent-args gathered] [--json PATH]

Each DIR holds another commit's ``vktf_tpu_torch/csrc`` files (or a
variant's), unpacked under the ignored ``vktf_tpu_torch/_build/``::

    git archive <commit> vktf_tpu_torch/csrc | tar -x -C DIR --strip-components=2

Every source whose text or headers differ from a DIR's (one the DIR does
not have is left out) is built from both directories (``_cuda.build``),
and each kernel record of such a source is timed at its chip_smoke.py
path's inputs (``chip_smoke.frame_stages``): the sponza preset at
1920x1080 4x MSAA, opaque, translucent (K = 8), the mixed-sampler sponza
and its translucent form, the attrs boundary's rows (only the scenes the
differing records read are built).
Each new output must equal the parent's bit for bit. Each record is timed
with CUDA events through its wrapper, in turns on one card: parent, new,
new, parent. Prints the card and one JSON line per record; ``--json PATH``
writes them all to PATH. A variant of a kernel is timed the same way: put
the variant's sources in DIR.

The setup and shade-table C entries changed their arguments after commit
c75c6c0: they read the (I, 16) instance rows by an int32 instance index,
and setup takes a null id row. A parent from before (``--parent-args
gathered``) is called through its own entries with its own argument lists (the per-triangle (16, T) matrix rows gathered once, and
an explicit id row), on outputs this script allocates like the wrappers.
The raster's C entries took a group bbox buffer after commit 40138de: a
parent's raster library without the group entry (``vktf_raster_groups``)
is called through this tree's wrappers with that argument dropped.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke

WIDTH, HEIGHT = 1920, 1080


def same(a, b) -> bool:
    """Bit-equal tensors, or tuples or dicts of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def c_entries(opaque, kind: str):
    """{source: (call, launcher)} for the setup and shade-table C entries of
    a library whose argument lists are of `kind`: "instance" (this tree's:
    the (I, 16) instance rows by an int32 index, a null id row) or
    "gathered" (the per-triangle (16, T) matrix rows, gathered once, and an
    explicit id row). call(lib) allocates the outputs as the wrappers do
    and returns what they return; launcher(lib) gives a function that only
    launches, on outputs allocated once (the bare launch time)."""
    from vktf_tpu_torch.ops import _cuda
    from vktf_tpu_torch.ops.setup_kernel import TRI_ROWS, instance_rowsT

    rs, setup, vp = opaque["rs"], opaque["setup"], opaque["vp"]
    tc = rs.tri_corner
    t, dev = tc.shape[1], tc.device
    p, i = ctypes.c_void_p, ctypes.c_int
    if kind == "gathered":
        mats = (instance_rowsT(opaque["inst_rows"], opaque["tri_instance"]).contiguous(),)
        setup_in = (*mats, vp, torch.arange(t, dtype=torch.float32, device=dev))
    else:
        mats = (opaque["inst_rows"], opaque["tri_instance"])
        setup_in = (*mats, vp, None)
    setup_types = [p] * (6 + len(setup_in)) + [i] * 3 + [p]
    table_types = [p] * (5 + len(mats)) + [i, p]

    def setup_outs():
        return [*(torch.empty((rows, t), device=dev) for rows in (TRI_ROWS, 4, 9, 2)),
                torch.empty((t,), dtype=torch.uint8, device=dev)]

    def setup_fn(lib, outs):
        fn = lib.vktf_setup_pack
        fn.argtypes = setup_types
        argv = (_cuda.ptr(tc), *(x if x is None else _cuda.ptr(x) for x in setup_in),
                *(_cuda.ptr(o) for o in outs), t, WIDTH, HEIGHT, _cuda.stream_of(tc))
        return lambda: _cuda.check(fn(*argv), "setup")

    def setup_call(lib):
        outs = setup_outs()
        setup_fn(lib, outs)()
        return dict(zip(("tri_data", "bbox_rows", "edge9", "anchor2"), outs),
                    valid=outs[4].view(torch.bool))

    def table_fn(lib, table):
        fn = lib.vktf_shade_table
        fn.argtypes = table_types
        argv = (*(_cuda.ptr(x) for x in (setup["edge9"], tc, rs.tri_static_cols,
                                         setup["anchor2"], *mats, table)), t,
                _cuda.stream_of(tc))
        return lambda: _cuda.check(fn(*argv), "shade table")

    def table_call(lib):
        table = torch.empty((t, 64), device=dev)
        table_fn(lib, table)()
        return table

    fixed_setup, fixed_table = setup_outs(), torch.empty((t, 64), device=dev)
    return {"setup.cu": (setup_call, lambda lib: setup_fn(lib, fixed_setup)),
            "shade_table.cu": (table_call, lambda lib: table_fn(lib, fixed_table))}


class WithoutGroupBuffer:
    """A raster library from before the group level of the chunk cull: its
    entries take every argument of this tree's but the group bbox buffer
    (the fourth), which a call through this tree's wrapper drops."""

    def __init__(self, lib):
        from vktf_tpu_torch.ops import _cuda

        self._fns = {}
        for entry, argtypes in _cuda._entries["raster.cu"].items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes = argtypes[:3] + argtypes[4:]
                self._fns[entry] = fn

    def __getattr__(self, entry):
        fn = self._fns[entry]
        return lambda *args: fn(*args[:3], *args[4:])


def load_parent(source: str, parent: Path):
    """A parent's library of one source, its raster entries adapted to this
    tree's argument lists where they predate the group bbox buffer."""
    from vktf_tpu_torch.ops import _cuda

    lib = _cuda.load(source, parent)
    if source == "raster.cu" and not hasattr(lib, "vktf_raster_groups"):
        return WithoutGroupBuffer(lib)
    return lib


SOURCES = ("setup.cu", "raster_stream.cu", "raster.cu", "shade_table.cu", "shade.cu")


def records(dev, sources):
    """(kernel, call) for every kernel record of the given sources, each at
    its chip_smoke path's inputs (only the scenes those records read are
    built), and the opaque path's stages."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers)
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel, shade_kernel as sk
    from vktf_tpu_torch.ops import shade_table
    from vktf_tpu_torch.scene.scene import Scene

    width, height = WIDTH, HEIGHT
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
    rs, setup = opaque["rs"], opaque["setup"]
    out = [
        (setup_kernel.KERNEL,
         lambda: setup_kernel.setup_pack(rs.tri_corner, opaque["inst_rows"],
                                         opaque["tri_instance"], opaque["vp"], width, height)),
        (raster.KERNEL_STREAM,
         lambda: raster.raster_stream(setup["tri_data"], setup["bbox_rows"], opaque["perm"])),
        (raster.KERNEL, lambda: raster.rasterize(*opaque["stream"], ph, pw, ms)),
        (shade_table.KERNEL,
         lambda: shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                               rs.tri_static_cols, setup["anchor2"],
                                               opaque["inst_rows"], opaque["tri_instance"])),
    ]
    if "raster.cu" not in sources and "shade.cu" not in sources:
        return out, opaque
    translucent = stages(set_blend(build_preset("sponza")))
    assert translucent["tri"].shape[0] == 8
    out.append((raster.KERNEL_LAYERS,
                lambda: raster.rasterize(*translucent["stream"], ph, pw, ms, 8)))
    if "shade.cu" not in sources:
        return out, opaque
    mixed_assets = set_samplers(build_preset("sponza"), **SAMPLER_PRESETS["mixed"])
    mixed = stages(mixed_assets)
    mixed_t = stages(set_blend(mixed_assets))
    assert mixed_t["tri"].shape[0] == 8

    def resolve(st, texels, taps):
        args = (st["tri"], sx, sy, st["frac"], st["table"], st["pool"], cam, st["lights"], bg,
                ma, texels, taps)
        return lambda: sk.shade_resolve(*args)

    def layer(st, texels, taps):
        args = (st["tri"], sx, sy, st["table"], st["pool"], cam, st["lights"], ma, texels, taps)
        return lambda: sk.shade_layer(*args)

    attrs = sk.fragment_attrs(opaque["tri"], sx, sy, opaque["table"], ma)
    attrs_t = sk.fragment_attrs(translucent["tri"], sx, sy, translucent["table"], ma)
    out += [
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
    return out, opaque


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, nargs="+", required=True,
                        help="directories each holding another commit's (or a variant's) "
                             "csrc files, timed one after the other against this tree's")
    parser.add_argument("--json", type=Path, help="write every result to this file")
    parser.add_argument("--parent-args", choices=("instance", "gathered"), default="instance",
                        help="the parents' setup and shade-table entries take the instance "
                             "rows and index, as this tree's do, or the gathered (16, T) "
                             "matrix rows and an id row (the sources up to commit c75c6c0)")
    args = parser.parse_args()

    dev = chip_smoke.cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    from vktf_tpu_torch.ops import _cuda

    card = chip_smoke.card_line()
    print("card:", card, flush=True)
    parents = {str(d): d.resolve() for d in args.parent}
    # a source the parent does not have yet is not compared
    changed = {name: sorted(s for s in SOURCES if (d / s).exists()
                            and _cuda._lib_path(s) != _cuda._lib_path(s, d))
               for name, d in parents.items()}
    print("sources that differ from each parent's:", changed, flush=True)
    every = {s for c in changed.values() for s in c}
    _cuda.build(sorted(every))
    recs, opaque = records(dev, every)  # the inputs are made with this tree's kernels
    entries = {"new": c_entries(opaque, "instance"),
               "parent": c_entries(opaque, args.parent_args)}
    results = []
    for name, parent in parents.items():
        _cuda.build(changed[name], parent)
        libs = {"new": {s: _cuda.library(s) for s in changed[name]},
                "parent": {s: load_parent(s, parent) for s in changed[name]}}
        for kernel, call in recs:
            if kernel.source not in changed[name]:
                continue

            def run(label):
                if label == "parent" and args.parent_args == "gathered":
                    return entries["parent"][kernel.source][0](libs["parent"][kernel.source])
                _cuda._libs[kernel.source] = libs[label][kernel.source]
                return call()

            want = run("parent")
            if not same(run("new"), want):
                raise RuntimeError(f"{kernel.name}: the new output differs from {name}'s")
            torch.cuda.synchronize()
            ms_probe = chip_smoke.cuda_ms(lambda: run("parent"), 3)
            reps = max(5, min(50, int(20.0 / max(ms_probe, 1e-3))))
            times = {"parent": [], "new": []}
            for label in ("parent", "new", "new", "parent"):
                times[label].append(round(chip_smoke.cuda_ms(lambda: run(label), reps), 4))
            _cuda._libs[kernel.source] = libs["new"][kernel.source]
            del want
            row = {"parent": name, "name": kernel.name, "reps": reps, "turns": times,
                   "parent_ms": round(float(np.mean(times["parent"])), 4),
                   "new_ms": round(float(np.mean(times["new"])), 4)}
            if kernel.source in entries["new"]:
                launch = {label: entries[label][kernel.source][1](libs[label][kernel.source])
                          for label in ("parent", "new")}
                bare = {"parent": [], "new": []}
                for label in ("parent", "new", "new", "parent"):
                    bare[label].append(round(chip_smoke.bare_ms(launch[label], 200), 4))
                row.update(bare_turns=bare,
                           bare_parent_ms=round(float(np.mean(bare["parent"])), 4),
                           bare_new_ms=round(float(np.mean(bare["new"])), 4))
            results.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "records": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
