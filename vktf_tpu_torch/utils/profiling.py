"""Spans and event counters.

The port's counterpart of ``vktf_tpu/utils/profiling.py``:

  * ``annotate(name)`` is a named span (``torch.profiler.record_function``)
    on the profiler's clock, host and card alike: a kernel launched inside
    it is the span's in the trace (the launch and the kernel share a
    correlation id). While no profiler runs it is one shared no-op context,
    so a span costs a flag test. The frame program's stages
    (``FrameProgram._stage``: ``frame.<stage>``) and the viewer's
    ``engine.dispatch`` and ``engine.present`` are such spans; whoever
    wants them runs ``torch.profiler.profile`` around the frames;
  * ``Counters`` are named, monotonically increasing event counters, with
    the JAX package's names (``textures.decode_failed``, ``assets.skipped``).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span in the profiler's timeline; the shared no-op context while
    no profiler runs (``torch.profiler.profile`` sets the flag read here)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class Counters:
    """Named event counters (process-wide observability)."""

    def __init__(self):
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def add(self, name: str, value: int = 1) -> None:
        self._counts[name] += int(value)

    def get(self, name: str) -> int:
        return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)


counters = Counters()
