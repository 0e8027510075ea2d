"""Process start to the first timed frame: imports, the CUDA context, the
kernels' build or load, the scene's generation, flatten and upload, and
the warm-up frames (host clock)."""

UNIT, LAYER, MOVES = "s", None, None


def read(run):
    return run.setup_s
