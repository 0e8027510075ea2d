"""Device ms a traced frame of the kernels launched in the present stage
span (benchmark/stages.py): unpacking, the crop and the encoding."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "PyTorch stages", "frame_rate.2160p"
STAGES = ("present",)


def read(run):
    s = stages.of(run)
    return s.device_ms(STAGES) if s else None
