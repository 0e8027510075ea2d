"""Device ms a traced frame of the kernels launched in the winner stage
span (benchmark/stages.py): phase A's per-pixel winner and coverage."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "PyTorch stages", "frame_rate.2160p"
STAGES = ("winner",)


def read(run):
    s = stages.of(run)
    return s.device_ms(STAGES) if s else None
