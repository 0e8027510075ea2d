"""Device ms a traced frame of the kernels launched in the stream_order and
raster stage spans other than the raster kernel (benchmark/stages.py):
the stream order and the raster prologue's gathers."""

from benchmark import stages

UNIT, LAYER, MOVES = "ms", "PyTorch stages", "frame_rate.2160p"
STAGES = ("stream_order", "raster")
RASTER_KERNEL = (r"\braster_kernel\b",)


def read(run):
    s = stages.of(run)
    return s.device_ms(STAGES, leave_out=RASTER_KERNEL) if s else None
