"""Host ms a traced frame in the frame program's camera, scene_update and
setup stage spans (benchmark/stages.py): the staged camera copy, the
cached scene update and the setup kernel's launch."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "frame dispatch", "frame_rate"
STAGES = ("camera", "scene_update", "setup")


def read(run):
    s = stages.of(run)
    return s.host_ms(STAGES) if s else None
