"""Percentile, rate and idle-share arithmetic on synthetic timestamps and a
synthetic trace."""

import numpy as np
import pytest

from benchmark import loops, spec
from benchmark.timeline import Timeline, gaps, union_length


def _run(**fields):
    return type("Run", (), fields)


def test_rate_counts_frames_done_inside_the_window():
    rec = loops.Record()
    rec.t0, rec.t1 = 100.0, 110.0
    for i in range(50):
        rec.enqueued[i] = 100.0 + 0.2 * i
        rec.done[i] = rec.enqueued[i] + 0.5
    # frames done after 110 s (i >= 48) are not the window's
    assert rec.completed_in_window() == 48
    assert spec.reader("frame_rate").read(_run(record=rec, seconds=10.0)) == 4.8


def test_p95_is_over_every_frame():
    rec = loops.Record()
    lat = np.arange(1, 201) * 1e-3
    for i, v in enumerate(lat):
        rec.enqueued[i], rec.done[i] = float(i), float(i) + v
    value = spec.reader("frame_latency_p95_ms").read(_run(record=rec))
    assert value == pytest.approx(np.percentile(lat, 95) * 1e3)


def test_dispatch_leaves_out_profiled_frames():
    rec = loops.Record()
    rec.dispatch = {0: 0.001, 1: 0.003, 2: 0.100}
    rec.profiled = {2}
    assert spec.reader("dispatch_ms").read(_run(record=rec)) == pytest.approx(2.0)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert union_length(spans) == 4
    assert gaps(spans, 0, 10) == [(3, 5), (6, 10)]


def _trace():
    """Two frames: each a span on the host holding two launches; frame 0's
    kernels run 10-20 and 20-25 us, frame 1's 40-50 and 55-60 us; one
    kernel of an earlier frame (no launch in the trace) runs 0-5 us, a copy
    60-64 us. The host waits from 26 to 33 us (bench.wait) and enqueues frame
    8 from 34 us."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args})

    x("user_annotation", "bench.frame.7", 1, 8)
    x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1)
    x("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=2)
    x("user_annotation", "bench.wait", 26, 7)
    x("user_annotation", "bench.frame.8", 34, 5)
    x("cuda_runtime", "cudaLaunchKernel", 35, 1, correlation=3)
    x("cuda_runtime", "cudaLaunchKernel", 37, 1, correlation=4)
    x("kernel", "void raster_kernel<4, 1>(float const*)", 10, 10, correlation=1)
    x("kernel", "void at::native::elementwise_kernel<128>", 20, 5, correlation=2)
    x("kernel", "void raster_kernel<4, 1>(float const*)", 40, 10, correlation=3)
    x("kernel", "void resolve_kernel<Fused>(int const*)", 55, 5, correlation=4)
    x("kernel", "void resolve_kernel<Fused>(int const*)", 0, 5, correlation=99)
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60, 4, correlation=5)
    return Timeline(ev)


def test_timeline_attributes_kernels_to_frames():
    t = _trace()
    assert t.frames == [7, 8]
    assert t.kernel_s([r"\braster_kernel\b"]) == pytest.approx(20e-6)
    assert t.kernel_s([r"\braster_kernel\b"], frames=[8]) == pytest.approx(10e-6)
    # the earlier frame's resolve is no traced frame's
    assert t.kernel_s([r"\bresolve_kernel\b"]) == pytest.approx(5e-6)
    glue = spec.reader("glue.device_ms").read(_run(timeline=t))
    assert glue == pytest.approx(5e-6 / 2 * 1e3)


def test_idle_share_and_gaps():
    t = _trace()
    # busy: 0-5, 10-25, 40-50, 55-64 -> 39 us of 64
    assert t.busy_s() == pytest.approx(39e-6)
    # the idle share runs from the first device operation (0 us) to the last
    assert t.device_window_s() == pytest.approx(64e-6)
    idle = spec.reader("device_idle_pct").read(_run(idle_timeline=t))
    assert idle == pytest.approx(100 * 25 / 64)
    longest = t.idle_gaps(1)[0]
    assert longest[0] == "bench.wait" and longest[1] == pytest.approx(15e-6)
    assert t.top_device_ops(1)[0][0].startswith("void raster_kernel")


def test_readers_return_nothing_without_a_trace():
    for name in ("device_idle_pct", "glue.device_ms", "raster.roofline_pct",
                 "shade.roofline_pct"):
        assert spec.reader(name).read(_run(timeline=None, idle_timeline=None, work={},
                                           peaks=None)) is None


def test_device_window_starts_at_the_first_device_operation():
    """Work queued before a device-only span began is not recorded: the
    share runs from the first recorded operation, not from the span's
    first event."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 1,
           "args": {}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 30, "dur": 10, "args": {}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 50, "dur": 10, "args": {}}]
    t = Timeline(ev)
    assert (t.start_us, t.end_us) == (0, 60)
    assert t.device_window_s() == pytest.approx(30e-6)
    idle = spec.reader("device_idle_pct").read(_run(idle_timeline=t))
    assert idle == pytest.approx(100 * 10 / 30)


def test_the_sample_is_stratified_by_slot():
    r = loops.Reservoir(8, seed=5, strata=4)
    for i in range(40, 1040):
        r.offer(i, np.zeros(1))
    slots = sorted(i % 4 for i, _ in r.kept)
    assert slots == [0, 0, 1, 1, 2, 2, 3, 3]
    again = loops.Reservoir(8, seed=5, strata=4)
    for i in range(40, 1040):
        again.offer(i, np.zeros(1))
    assert [i for i, _ in again.kept] == [i for i, _ in r.kept]
    with pytest.raises(ValueError):
        loops.Reservoir(6, seed=5, strata=4)
