"""Host ms a traced frame in the present stage span (benchmark/stages.py):
unpacking the bytes, the crop and the present encoding."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"
STAGES = ("present",)


def read(run):
    s = stages.of(run)
    return s.host_ms(STAGES) if s else None
