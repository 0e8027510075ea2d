"""Host ms a traced frame in the shade_table stage span
(benchmark/stages.py): the shade-table kernel's launch."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"
STAGES = ("shade_table",)


def read(run):
    s = stages.of(run)
    return s.host_ms(STAGES) if s else None
