"""Device ms per traced frame in kernels that are not the port's csrc/
kernels: the PyTorch stages (raster prologue, phase A, present)."""

UNIT, LAYER, MOVES = "ms", "PyTorch stages", "frame_rate"
PORT_KERNELS = (r"\bsetup_kernel\b", r"\braster_kernel\b", r"\btable_kernel\b",
                r"\bresolve_kernel\b", r"\blayer_kernel\b")


def read(run):
    t = run.timeline
    if t is None or not t.frames or not t.kernels:
        return None
    return t.other_kernel_s(PORT_KERNELS) / len(t.frames) * 1e3
