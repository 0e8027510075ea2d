"""Host ms of each Scene.render_async call (FrameProgram.__call__: the
frame's launches), mean over the window's frames outside the profiled
spans (host clock)."""

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"


def read(run):
    times = [s for i, s in run.record.dispatch.items() if i not in run.record.profiled]
    return sum(times) / len(times) * 1e3 if times else None
