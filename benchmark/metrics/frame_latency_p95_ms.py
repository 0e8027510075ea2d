"""The 95th percentile of every window frame's latency: from the call that
enqueued it (its camera set) to its bytes in host memory, or its reaching
the window's present (host clock)."""

import numpy as np

UNIT, LAYER, MOVES = "ms", None, None


def read(run):
    lat = run.record.latencies()
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
