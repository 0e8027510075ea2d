"""Frames whose bytes reached host memory (or the window) within the
measured window, over the window's seconds (host clock)."""

UNIT, LAYER, MOVES = "frames/s", None, None


def read(run):
    return run.record.completed_in_window() / run.seconds
