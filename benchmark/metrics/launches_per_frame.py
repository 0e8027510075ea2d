"""Kernels a traced frame launches inside the frame program's stage spans
(benchmark/stages.py: each kernel by its launch's correlation id)."""

from benchmark import stages

UNIT, LAYER, MOVES = "launches", "frame dispatch", "frame_rate"


def read(run):
    s = stages.of(run)
    return s.launches_per_frame() if s else None
