"""The frame program's stage spans (``FrameProgram._stage``) on the CPU.

Under ``torch.profiler`` every stage of a frame is a flat host span
``frame.<stage>`` (cat ``user_annotation`` in the Chrome trace, which the
benchmark's ``benchmark/stages.py`` reads), in the frame's order, holding
every torch op of the frame; ``frame.stream_order`` appears only in frames
that re-sort. With no profiler a stage is one shared no-op context: no
``record_function`` call. The mesh program's stages are spans too (two
gloo ranks).
"""

import json

import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

WIDTH, HEIGHT = 64, 32
TILE = (32, 64)
POSITION = (-3.0, 0.2, 0.1)
DIRECTION = (1.0, 0.0, 0.0)
# a one-device pixel-rate frame: phase A is in the raster kernel's epilogue
OPAQUE = ["camera", "scene_update", "setup", "stream_order", "raster", "shade_table",
          "shade", "present"]


def _config(**kw):
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(width=WIDTH, height=HEIGHT, msaa_samples=4, tile_shape=TILE, **kw)


def _camera(position=POSITION, direction=DIRECTION):
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams

    return Camera(np.asarray(position, np.float32), np.asarray(direction, np.float32),
                  ViewFrustumParams(np.radians(45.0), WIDTH / HEIGHT, 0.1, 100.0))


@pytest.fixture(scope="module")
def box():
    """The box preset's (leaves, SceneMeta)."""
    return tp.torch_leaves("box")


def _program(box, **kw):
    """A fresh FrameProgram (none of the registry's state) and its scene."""
    from vktf_tpu_torch.ops.pipeline import FrameProgram
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    leaves, meta = box
    return FrameProgram(meta, _config(**kw)), scene_from_numpy(leaves, "cpu")


def _render(prog, rs, camera=None):
    camera = camera or _camera()
    return prog(rs, camera.view_projection_transform, camera.position)


def _traced(tmp_path, fn):
    """The Chrome trace's complete events of `fn()` run under the CPU
    profiler inside a ``test.frame`` span."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.frame"):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _stage_spans(events):
    """The frame.* host spans as (name, start, end), in start order."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("frame.")),
                  key=lambda s: s[1])


def _stages(events):
    return [name[len("frame."):] for name, _, _ in _stage_spans(events)]


def _assert_flat_and_covering(events):
    """The stage spans do not overlap, and every torch op of the frame lies
    inside one of them."""
    spans = _stage_spans(events)
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    frame = next(e for e in events if e["name"] == "test.frame")
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and frame["ts"] <= e["ts"] <= frame["ts"] + frame["dur"]]
    assert ops
    loose = [e["name"] for e in ops
             if not any(s <= e["ts"] and e["ts"] + e["dur"] <= t for _, s, t in spans)]
    assert loose == []


@pytest.mark.parametrize("kw, stages", [
    ({}, OPAQUE),
    ({"peel_layers": 8}, OPAQUE[:-1] + ["composite", "present"]),
    ({"shade_attrs_boundary": True}, OPAQUE[:-2] + ["attrs", "shade", "present"]),
    ({"shading_rate": "sample"}, OPAQUE[:-1] + ["composite", "present"]),
], ids=["opaque", "k8", "attrs", "sample"])
def test_a_frame_exports_its_stages_in_order(box, tmp_path, kw, stages):
    prog, rs = _program(box, **kw)
    events = _traced(tmp_path, lambda: _render(prog, rs))
    assert _stages(events) == stages
    _assert_flat_and_covering(events)


def test_stream_order_is_a_span_only_when_the_frame_re_sorts(box, tmp_path):
    prog, rs = _program(box)
    assert "stream_order" in _stages(_traced(tmp_path, lambda: _render(prog, rs)))
    still = _stages(_traced(tmp_path, lambda: _render(prog, rs)))
    assert "stream_order" not in still and still == [s for s in OPAQUE if s != "stream_order"]
    moved = _camera(direction=(1.0, 0.0, 0.5))
    vp0 = np.asarray(_camera().view_projection_transform, np.float64)
    vp1 = np.asarray(moved.view_projection_transform, np.float64)
    assert np.linalg.norm(vp1 - vp0) > prog.config.resort_threshold * np.linalg.norm(vp0)
    assert _stages(_traced(tmp_path, lambda: _render(prog, rs, moved))) == OPAQUE


def test_no_profiler_makes_no_span(box, monkeypatch):
    """Off, a stage is the one shared no-op context: record_function is
    never reached, and the frame is the same."""
    import contextlib

    prog, rs = _program(box)
    want = _render(prog, rs)

    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    stage = prog._stage("setup")
    assert isinstance(stage, contextlib.nullcontext) and stage is prog._stage("present")
    assert torch.equal(_render(prog, rs), want)


def _mesh_stages(leaves, meta, config, position, direction):
    """On every rank: a (2, 1) gloo mesh frame under the CPU profiler; the
    frame.* span names in order, and whether any two overlap."""
    import tempfile
    from pathlib import Path

    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.parallel import make_render_mesh
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    tp.limit_threads()
    camera = Camera(np.asarray(position, np.float32), np.asarray(direction, np.float32),
                    ViewFrustumParams(np.radians(45.0), config.width / config.height, 0.1,
                                      100.0))
    scn = Scene.from_render_scene(scene_from_numpy(leaves, "cpu"), meta, config, camera,
                                  mesh=make_render_mesh(2, 1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frame = scn.render_async()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans = _stage_spans([e for e in events if e.get("ph") == "X"])
    overlap = any(end > start for (_, _, end), (_, start, _) in zip(spans, spans[1:]))
    return [name for name, _, _ in spans], overlap, frame.numpy()


def test_mesh_stages_are_frame_spans(box):
    from vktf_tpu_torch.parallel import launch
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    leaves, meta = box
    config = _config()
    names, overlap, frame = launch.run(_mesh_stages, 2, leaves, meta, config, POSITION,
                                       DIRECTION, device="cpu", timeout_s=300)
    assert names == ["frame." + s for s in (
        "scene_update", "camera_broadcast", "setup", "shade_table", "table_gather",
        "setup_gather", "stream_order", "raster", "merge", "winner", "table_wait", "shade",
        "slice_gather", "band_gather", "present")]
    assert not overlap
    single = Scene.from_render_scene(scene_from_numpy(leaves, "cpu"), meta, config, _camera())
    np.testing.assert_array_equal(frame, single.render_async().numpy())
