"""Host ms a traced frame in the winner, attrs, shade and composite stage
spans (benchmark/stages.py): phase A and the shade kernel's launch."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"
STAGES = ("winner", "attrs", "shade", "composite")


def read(run):
    s = stages.of(run)
    return s.host_ms(STAGES) if s else None
