"""``frame_latency_p95_ms`` of the 2160p cells: the same reading under a name with a
bound of its own, since the card paces that cell and its runs spread far
less than the host-paced 1080p cell's."""

from benchmark.spec import reader

UNIT, LAYER, MOVES = "ms", None, None
read = reader("frame_latency_p95_ms").read
