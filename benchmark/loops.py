"""The closed loop of the ``server`` traffic kind: a headless frame server.

Each frame's camera is set, the frame is enqueued with
``Scene.render_async`` and copied non-blocking into a pinned host buffer
with a CUDA event behind the copy; once ``in_flight`` frames are
outstanding the host waits on the oldest frame's event, and that frame is
done when the wait returns. Frame i takes the buffer frame i - in_flight
gave back, so the buffers, like the slots in flight, go round by the
frame's index modulo ``in_flight``.

A frame's latency runs from the call that enqueues it (its camera already
set) to its being done. Frames are enqueued until the window's seconds have
passed, then every outstanding frame is waited for. The profiler, when
asked for, covers two steady spans of the window, one after the other:
from ``trace_at`` of the window for ``trace_seconds`` with host and device
activities (frame spans, kernels by frame, host stalls), then from
``idle_at`` for ``idle_seconds`` with device activities alone (the idle
share, without the host-side recording that slows dispatch). At the end of
each span the outstanding frames are waited for and it stops.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from benchmark.timeline import FRAME_SPAN


class Reservoir:
    """A sample of the window's frames drawn from the seed: `k` of them,
    uniform within each of `strata` classes of the frame index modulo
    `strata` (reservoir sampling in each), k // strata a class. Keeps
    (frame index, host copy) pairs."""

    def __init__(self, k: int, seed: int, strata: int):
        if k % strata:
            raise ValueError(f"{k} frames do not split evenly over {strata} strata")
        self.per = k // strata
        self.strata = strata
        self.rng = np.random.default_rng([seed, 1])
        self.seen = [0] * strata
        self.classes: list = [[] for _ in range(strata)]

    def offer(self, index: int, frame) -> None:
        s = index % self.strata
        kept = self.classes[s]
        if self.seen[s] < self.per:
            kept.append((index, np.array(frame, copy=True)))
        else:
            j = int(self.rng.integers(0, self.seen[s] + 1))
            if j < self.per:
                kept[j] = (index, np.array(frame, copy=True))
        self.seen[s] += 1

    @property
    def kept(self) -> list:
        return [pair for kept in self.classes for pair in kept]


class Record:
    """Per frame of the window: enqueue time, dispatch seconds, done time."""

    def __init__(self):
        self.enqueued: dict = {}
        self.dispatch: dict = {}
        self.done: dict = {}
        self.traced: set = set()    # enqueued under the host and device span
        self.profiled: set = set()  # enqueued under either span
        self.t0 = self.t1 = 0.0

    def latencies(self) -> list:
        return [self.done[i] - self.enqueued[i] for i in sorted(self.done)]

    def completed_in_window(self) -> int:
        return sum(1 for t in self.done.values() if t <= self.t1)


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _activities(host: bool):
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities or [ProfilerActivity.CPU]


def warm_profiler(step) -> None:
    """Profile one call of `step` in each of the two kinds of span and drop
    the results: the first profiler run of a process starts the device
    tracer, which takes seconds, and belongs in set-up, not in the window."""
    for host in (True, False):
        with torch.profiler.profile(activities=_activities(host)):
            step()
            if torch.cuda.is_available():
                torch.cuda.synchronize()


class _Span:
    """One profiled span: from `start_at` for `length` seconds (at most to
    `end`), with host activities or the device's alone, exported to `path`."""

    def __init__(self, path, host: bool, start_at: float, length: float, end: float):
        self.path, self.host = path, host
        self.start_at, self.length, self.end = start_at, length, end
        self.stop_at = end
        self.prof = None
        self.finished = False

    def active(self, now: float) -> bool:
        if self.finished:
            return False
        if self.prof is None and now >= self.start_at:
            self.prof = torch.profiler.profile(activities=_activities(self.host))
            self.prof.__enter__()
            self.stop_at = min(time.perf_counter() + self.length, self.end)
            now = time.perf_counter()
        return self.prof is not None and now < self.stop_at

    def stop(self) -> None:
        if self.prof is not None and not self.finished:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.prof.export_chrome_trace(str(self.path))
        self.finished = True


def _spans(trace_paths, traffic: dict, t0: float, seconds: float) -> list:
    """The traced run's two spans (host and device; device alone), or none."""
    if trace_paths is None:
        return []
    host_path, device_path = trace_paths
    end = t0 + seconds
    idle_start = t0 + traffic["idle_at"] * seconds
    # the first span ends by the second's start, so a short window holds both
    return [_Span(host_path, True, t0 + traffic["trace_at"] * seconds,
                  traffic["trace_seconds"], min(idle_start, end)),
            _Span(device_path, False, idle_start, traffic["idle_seconds"], end)]


def run_server(scene, set_camera, traffic: dict, first: int, buffers: list, count: int = None,
               seconds: float = None, reservoir: Reservoir = None, trace_paths=None):
    """Frames first, first + 1, ... until `count` frames (the warm-up) or
    `seconds` of window have passed. `buffers`, a deque, holds the free
    pinned host buffers in the order they were freed, kept from the warm-up
    into the window. `trace_paths`, a pair,
    asks for the two profiled spans. Returns the Record."""
    rec = Record()
    depth = traffic["in_flight"]
    in_flight = collections.deque()
    on_card = scene.render_scene.device.type == "cuda"
    rec.t0 = time.perf_counter()
    rec.t1 = rec.t0 + (seconds or 0.0)
    spans = _spans(trace_paths, traffic, rec.t0, seconds or 0.0)

    def complete_oldest():
        i, host, event = in_flight.popleft()
        if event is not None:
            event.synchronize()
        rec.done[i] = time.perf_counter()
        if reservoir is not None:
            reservoir.offer(i, host.numpy())
        if event is not None:
            buffers.append(host)

    i = first
    while True:
        now = time.perf_counter()
        if (count is not None and i - first >= count) or (seconds is not None and now >= rec.t1):
            break
        span = next((s for s in spans if not s.finished), None)
        profiling = span is not None and span.active(now)
        if span is not None and span.prof is not None and not profiling:
            while in_flight:
                complete_oldest()
            span.stop()
        tracing = profiling and span.host
        set_camera(i)
        with _span(f"{FRAME_SPAN}{i}", tracing):
            t = time.perf_counter()
            frame = scene.render_async()
            rec.dispatch[i] = time.perf_counter() - t
            rec.enqueued[i] = t
            if on_card:
                host = buffers.popleft() if buffers else torch.empty(
                    frame.shape, dtype=frame.dtype, pin_memory=True)
                host.copy_(frame, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host, event = frame, None
        if profiling:
            rec.profiled.add(i)
        if tracing:
            rec.traced.add(i)
        in_flight.append((i, host, event))
        if len(in_flight) >= depth:
            with _span("bench.wait", tracing):
                complete_oldest()
        i += 1
    while in_flight:
        complete_oldest()
    for span in spans:
        span.stop()
    return rec
