"""Per-frame elapsed time (reference: src/engine/delta_time.cppm:10-40)."""

from __future__ import annotations

import time


class DeltaTime:
    """Seconds elapsed between successive ``update`` calls (monotonic clock)."""

    def __init__(self) -> None:
        self._previous = time.monotonic()
        self._delta = 0.0

    def update(self) -> float:
        now = time.monotonic()
        self._delta = now - self._previous
        self._previous = now
        return self._delta

    @property
    def value(self) -> float:
        return self._delta

    def __float__(self) -> float:
        return self._delta
