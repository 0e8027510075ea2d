"""Host ms a traced frame in the stream_order (frames that re-sort) and
raster stage spans (benchmark/stages.py): the stream order, the raster
prologue's gathers and the raster kernel's launch."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"
STAGES = ("stream_order", "raster")


def read(run):
    s = stages.of(run)
    return s.host_ms(STAGES) if s else None
