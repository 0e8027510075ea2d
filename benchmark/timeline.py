"""What a ``--trace 1`` run reads from the profiler's timelines.

The harness profiles two steady spans of the measured window with
``torch.profiler`` and exports each as a Chrome trace. In the first (host
and device activities) each frame's enqueue is wrapped in a span named
``bench.frame.<index>``; the second records the device alone, for the
share of time the card is busy. ``Timeline`` parses either:

  * device intervals: kernels, copies and fills on the card;
  * each kernel's frame: the frame span that holds the host call that
    launched it (the kernel and the call share a correlation id); kernels
    of frames enqueued before the span are no frame's;
  * the host spans by name (``engine.present``, ``bench.wait``, ...).
"""

from __future__ import annotations

import json
import re
from bisect import bisect_right

FRAME_SPAN = "bench.frame."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Timeline:
    """A parsed Chrome trace; times in seconds."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        self.device = [e for e in xs if e.get("cat") in _DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in xs if e.get("cat") not in _DEVICE_CATS]
        spans = sorted((e["ts"], e["ts"] + e["dur"], int(e["name"][len(FRAME_SPAN):]))
                       for e in self.host if e.get("name", "").startswith(FRAME_SPAN))
        self.frames = [f for _, _, f in spans]
        starts = [s for s, _, _ in spans]
        frame_of = {}
        for e in self.host:
            if e.get("cat") in _HOST_LAUNCH_CATS and "correlation" in e.get("args", {}):
                i = bisect_right(starts, e["ts"]) - 1
                if i >= 0 and e["ts"] <= spans[i][1]:
                    frame_of[e["args"]["correlation"]] = spans[i][2]
        self.kernel_frame = [frame_of.get(k.get("args", {}).get("correlation"))
                             for k in self.kernels]
        ends = [e["ts"] + e["dur"] for e in xs]
        self.start_us = min((e["ts"] for e in xs), default=0.0)
        self.end_us = max(ends, default=0.0)

    @classmethod
    def load(cls, path) -> "Timeline":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def device_window_s(self) -> float:
        """From the first device operation's start to the last one's end:
        work queued before the profiler started is not recorded, so the
        span's own start would count it as idle."""
        if not self.device:
            return 0.0
        return (max(e["ts"] + e["dur"] for e in self.device)
                - min(e["ts"] for e in self.device)) * 1e-6

    def busy_s(self) -> float:
        return union_length((e["ts"], e["ts"] + e["dur"]) for e in self.device) * 1e-6

    def kernel_s(self, patterns, frames=None) -> float:
        """Device seconds of the kernels whose name matches any pattern, of
        the given frames (every traced frame by default)."""
        wanted = set(self.frames if frames is None else frames)
        regs = [re.compile(p) for p in patterns]
        return sum(k["dur"] for k, f in zip(self.kernels, self.kernel_frame)
                   if f in wanted and any(r.search(k["name"]) for r in regs)) * 1e-6

    def other_kernel_s(self, patterns) -> float:
        """Device seconds of the traced frames' kernels matching no pattern."""
        regs = [re.compile(p) for p in patterns]
        wanted = set(self.frames)
        return sum(k["dur"] for k, f in zip(self.kernels, self.kernel_frame)
                   if f in wanted and not any(r.search(k["name"]) for r in regs)) * 1e-6

    def host_span_s(self, name: str) -> list:
        return [e["dur"] * 1e-6 for e in self.host if e.get("name") == name]

    def top_device_ops(self, n: int = 10) -> list:
        totals = {}
        for e in self.device:
            totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"] * 1e-6
        return sorted(([k[:120], v] for k, v in totals.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by
        the innermost host span running at its middle."""
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host
                 if e.get("cat") in ("user_annotation", "cpu_op", "python_function")
                 or e.get("name", "").startswith(("bench.", "engine."))]
        idle = gaps([(e["ts"], e["ts"] + e["dur"]) for e in self.device],
                    self.start_us, self.end_us)
        out = []
        for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "no host span"
            if name.startswith(FRAME_SPAN):
                name = FRAME_SPAN + "N"
            out.append([name[:120], (e - s) * 1e-6])
        return out

