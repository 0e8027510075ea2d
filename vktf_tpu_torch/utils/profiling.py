"""Tracing, profiling and event counters.

The port's counterpart of ``vktf_tpu/utils/profiling.py``:

  * ``trace(log_dir)`` profiles a block with ``torch.profiler`` (the host
    and, on a card, its kernels) and writes a Chrome trace into log_dir;
  * ``annotate(name)`` is a named span (``torch.profiler.record_function``),
    visible in such a trace;
  * ``Counters`` are named, monotonically increasing event counters, with
    the JAX package's names (``textures.decode_failed``, ``assets.skipped``).
"""

from __future__ import annotations

import collections
import contextlib
from pathlib import Path
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block; the trace lands in <log_dir>/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named span in the profiler's timeline."""
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
