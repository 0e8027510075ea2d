"""Device ms a traced frame of the kernels launched in the camera,
scene_update and setup stage spans (benchmark/stages.py): the setup
kernel and the torch work around it."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "setup kernel", "frame_rate.2160p"
STAGES = ("camera", "scene_update", "setup")


def read(run):
    s = stages.of(run)
    return s.device_ms(STAGES) if s else None
