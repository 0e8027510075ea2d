"""The raster kernel's share of its roofline: the least time the frames'
raster work could take on the card (benchmark/roofline.py, counted by the
reference's own setup) over the device time of the kernels named here, on
the same traced frames."""

from benchmark.roofline import raster_least_s

UNIT, LAYER, MOVES = "%", "raster kernel", "frame_rate"
KERNELS = (r"\braster_kernel\b",)


def read(run):
    if run.timeline is None or not run.work or run.peaks is None:
        return None
    frames = sorted(run.work)
    device = run.timeline.kernel_s(KERNELS, frames)
    if device <= 0:
        return None
    return 100.0 * sum(raster_least_s(run.work[f], run.peaks) for f in frames) / device
