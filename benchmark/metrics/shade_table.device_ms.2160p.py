"""Device ms a traced frame of the kernels launched in the shade_table
stage span (benchmark/stages.py): the shade-table kernel."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "shade table", "frame_rate.2160p"
STAGES = ("shade_table",)


def read(run):
    s = stages.of(run)
    return s.device_ms(STAGES) if s else None
