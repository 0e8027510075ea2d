"""``device_idle_pct`` of the 2160p cells: the same reading under a name that
moves the 2160p cells' ``frame_rate.2160p``."""

from benchmark.spec import reader

UNIT, LAYER, MOVES = "%", "device", "frame_rate.2160p"
read = reader("device_idle_pct").read
