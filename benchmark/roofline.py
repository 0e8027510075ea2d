"""The yardstick of the kernel rooflines: the card's published peaks and
the least time a stage's work could take on it, counted from what one
frame's inputs need (the reference's own raster and texture addressing
give the counts; ``reference.render(counts=True)``).

Least time = max(bytes / peak bytes per second, float32 operations / peak
operations per second). Operations per unit of work are counted from the
kernels' sources, a transcendental as 20 (the arithmetic ``chip_smoke.py``
uses for its bounds): raster 20 per (sample, triangle) pair whose pixel
lies in the triangle's box; shade per covered pixel 100 for the plane
evaluation, 200 for the tail (TBN, alpha), 100 addressing and 600
filtering per texture tap, 120 per light for the BRDF.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 (non-tensor) FLOP/s
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops": 67e12}}

RASTER_OPS_PER_PAIR = 20
RASTER_BYTES_PER_TRIANGLE = 28 * 4   # its stream rows and box, read once
SAMPLE_OUT_BYTES = 8                  # depth and id of a sample, written once
SHADE_OPS_PLANES = 100
SHADE_OPS_TAIL = 200
SHADE_OPS_PER_TAP = 100 + 600
SHADE_OPS_PER_LIGHT = 120
SHADE_BYTES_PER_TRIANGLE = 256       # a shaded triangle's planes and material
SHADE_BYTES_PER_PIXEL = 4 + 4 + 4    # winner and coverage in, the packed pixel out
TEXEL_BYTES = 4                      # RGBA8, each texel read counted once


def least_s(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["flops"])


def raster_least_s(work: dict, peaks: dict) -> float:
    samples = work["samples"] * work["width"] * work["height"]
    nbytes = work["live_triangles"] * RASTER_BYTES_PER_TRIANGLE + samples * SAMPLE_OUT_BYTES
    ops = work["box_pixels"] * work["samples"] * RASTER_OPS_PER_PAIR
    return least_s(nbytes, ops, peaks)


def shade_least_s(work: dict, peaks: dict, taps: int = 1) -> float:
    nbytes = (work["width"] * work["height"] * SHADE_BYTES_PER_PIXEL
              + work["shaded_triangles"] * SHADE_BYTES_PER_TRIANGLE
              + work["texels_read"] * TEXEL_BYTES)
    ops = work["covered_pixels"] * (SHADE_OPS_PLANES + SHADE_OPS_TAIL + SHADE_OPS_PER_TAP * taps
                                    + SHADE_OPS_PER_LIGHT * work["lights"])
    return least_s(nbytes, ops, peaks)
