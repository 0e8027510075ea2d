"""Share of the device-only profiled span, from its first device operation
to its last, with no kernel, copy or fill on the card (torch.profiler's
device timeline; no host-side recording slows the dispatch there)."""

UNIT, LAYER, MOVES = "%", "device", "frame_rate"


def read(run):
    t = run.idle_timeline
    window = t.device_window_s() if t is not None else 0.0
    if window <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / window)
