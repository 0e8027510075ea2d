"""Share of the traced frames that rebuild the raster's stream order: the
frame program's stream_order spans (one in each frame that re-sorts,
benchmark/stages.py) over the traced frames."""

from benchmark import stages

UNIT, LAYER, MOVES = "%", "stream order", "frame_rate"


def read(run):
    s = stages.of(run)
    return 100.0 * s.spans_per_frame("stream_order") if s else None
