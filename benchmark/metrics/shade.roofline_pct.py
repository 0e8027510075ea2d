"""The shade kernel's share of its roofline: the least time the frames'
shading could take on the card (benchmark/roofline.py: each distinct
texel read counted once, from the reference's own addressing) over the
device time of the kernels named here, on the same traced frames."""

from benchmark.roofline import shade_least_s

UNIT, LAYER, MOVES = "%", "shade kernel", "frame_rate"
KERNELS = (r"\bresolve_kernel\b", r"\blayer_kernel\b")


def read(run):
    if run.timeline is None or not run.work or run.peaks is None:
        return None
    frames = sorted(run.work)
    device = run.timeline.kernel_s(KERNELS, frames)
    if device <= 0:
        return None
    taps = run.config["render"].get("aniso_taps", 1)
    return 100.0 * sum(shade_least_s(run.work[f], run.peaks, taps) for f in frames) / device
