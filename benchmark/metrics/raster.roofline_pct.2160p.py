"""``raster.roofline_pct`` of the 2160p cells: the same reading under a name that
moves the 2160p cells' ``frame_rate.2160p``."""

from benchmark.spec import reader

UNIT, LAYER, MOVES = "%", "raster kernel", "frame_rate.2160p"
read = reader("raster.roofline_pct").read
