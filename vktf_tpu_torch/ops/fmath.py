"""Float32 arithmetic helpers shared by the plain versions of the kernels.

The JAX package's reference numbers come from XLA, whose CPU backend
contracts ``x * y + z`` into one fused multiply-add in most places:
``a * b + c * d`` usually becomes ``fma(a, b, c * d)`` (the left product
fuses), ``a + b * c`` becomes ``fma(b, c, a)``, ``a * b - c * d`` becomes
``fma(a, b, -(c * d))``. Not everywhere: which product fuses depends on
XLA's fusion of the whole kernel, so each place was settled against the
JAX outputs (tests/test_torch_*.py) — the raster's plane evaluation fuses
the right product, the setup's screen-area test fuses none. Each plain
version writes the fused operations out with ``fma`` below, and the CUDA
kernels (built with ``--fmad=false``, so the compiler fuses nothing on its
own) call ``__fmaf_rn`` at exactly the same places, so a kernel and its
plain version round alike.

One caller runs on the card too: the depth-peel composite and resolve
(``ops/pipeline.composite_resolve``), which has no kernel of its own, so
its float64 ``fma`` passes over the (K, 3, N) layer outputs lie on the
translucent frame's path (its largest stage; folding them into the layer
shade kernel is queued in ROADMAP.md).
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """float32 a * b + c rounded once.

    The product of two float32 values is exact in float64 and the sum is
    rounded once there before the final rounding to float32; that double
    rounding can differ from a true fused result only when the float64 sum
    lands exactly on a float32 rounding boundary (about 2^-29 of inputs).
    """
    return (a.double() * b.double() + c.double()).float()


def f32(value, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on `like`'s device (keeps comparisons and
    arithmetic against constants in float32). It is filled on that device,
    with no copy from the host, so a frame that uses it is enqueued without
    waiting for the card; its bits are those of
    ``torch.tensor(value, dtype=torch.float32)``."""
    return torch.full((), value, dtype=torch.float32, device=like.device)
