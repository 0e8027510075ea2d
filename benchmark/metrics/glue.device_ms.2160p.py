"""``glue.device_ms`` of the 2160p cells: the same reading under a name that
moves the 2160p cells' ``frame_rate.2160p``."""

from benchmark.spec import reader

UNIT, LAYER, MOVES = "ms", "PyTorch stages", "frame_rate.2160p"
read = reader("glue.device_ms").read
