"""What the frame program's own stage spans say of a ``--trace 1`` run.

The port wraps each stage of a frame in a host span ``frame.<stage>``
(``FrameProgram._stage``, a ``record_function``: cat ``user_annotation``
in the Chrome trace; the card-side ``gpu_user_annotation`` twin that the
profiler also writes is not read). The spans are flat: camera,
scene_update, setup, stream_order (only in a frame that re-sorts),
raster, shade_table, winner, attrs, shade, composite, present.

``Stages`` keeps the stage spans that lie in a traced ``bench.frame.<i>``
span and gives each kernel the stage whose span holds the host call that
launched it (the call and the kernel share a correlation id), as
``Timeline`` gives each kernel its frame. Values are per traced frame, a
stage absent from a frame counting 0. A program without the spans has no
reading: ``of`` returns None, and so does every reader of it.
"""

from __future__ import annotations

import functools
import re
from bisect import bisect_right

from benchmark.timeline import _HOST_LAUNCH_CATS, FRAME_SPAN

STAGE_SPAN = "frame."


def _holder(starts, spans, ts):
    """The index of the span (sorted, flat) holding time `ts`, or None."""
    i = bisect_right(starts, ts) - 1
    return i if i >= 0 and ts <= spans[i][1] else None


class Stages:
    """The traced frames' stage spans and each kernel's stage; times in us."""

    def __init__(self, timeline):
        host = [e for e in timeline.host if e.get("cat") == "user_annotation"]
        frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                        if e["name"].startswith(FRAME_SPAN))
        frame_starts = [s for s, _ in frames]
        self.frames = len(frames)
        self.spans = sorted(  # (start, end, stage) inside a traced frame
            (e["ts"], e["ts"] + e["dur"], e["name"][len(STAGE_SPAN):]) for e in host
            if e["name"].startswith(STAGE_SPAN)
            and _holder(frame_starts, frames, e["ts"]) is not None)
        starts = [s for s, _, _ in self.spans]
        stage_of = {}
        for e in timeline.host:
            if e.get("cat") in _HOST_LAUNCH_CATS and "correlation" in e.get("args", {}):
                i = _holder(starts, self.spans, e["ts"])
                if i is not None:
                    stage_of[e["args"]["correlation"]] = self.spans[i][2]
        # (stage, kernel name, device us) of each kernel launched in a stage span
        self.kernels = [(stage_of[k["args"]["correlation"]], k["name"], k["dur"])
                        for k in timeline.kernels
                        if k.get("args", {}).get("correlation") in stage_of]

    def host_ms(self, stages) -> float:
        """Host ms a frame inside the spans of the given stages."""
        return sum(e - s for s, e, name in self.spans if name in stages) / self.frames * 1e-3

    def spans_per_frame(self, stage: str) -> float:
        return sum(name == stage for _, _, name in self.spans) / self.frames

    def launches_per_frame(self):
        """Kernels a frame launched inside a stage span; None where the
        trace holds no kernel of a stage (a run on the CPU)."""
        return len(self.kernels) / self.frames if self.kernels else None

    def device_ms(self, stages, leave_out=()):
        """Device ms a frame of the kernels launched in the given stages'
        spans, less those whose name matches a pattern of `leave_out`; None
        where the trace holds no kernel of a stage."""
        if not self.kernels:
            return None
        regs = [re.compile(p) for p in leave_out]
        return sum(dur for stage, name, dur in self.kernels if stage in stages
                   and not any(r.search(name) for r in regs)) / self.frames * 1e-3


@functools.lru_cache(maxsize=1)
def _stages(timeline) -> Stages:
    return Stages(timeline)


def of(run):
    """The run's Stages (built once for its timeline), or None without a
    trace, a traced frame or a stage span in one."""
    if run.timeline is None or not run.timeline.frames:
        return None
    stages = _stages(run.timeline)
    return stages if stages.frames and stages.spans else None
