"""The readers of the frame program's stage spans (benchmark/stages.py) on
a synthetic trace: two traced frames, torch ops nested in the stages, the
card-side ``gpu_user_annotation`` twins of the spans as decoys."""

import pytest

from benchmark import spec
from benchmark.timeline import Timeline

SPONZA = ("setup.host_ms", "raster.host_ms", "shade_table.host_ms", "shade.host_ms",
          "present.host_ms", "raster.resort_share", "launches_per_frame")
FLYTHROUGH = ("setup.device_ms.2160p", "raster.prologue.device_ms.2160p",
              "shade_table.device_ms.2160p", "winner.device_ms.2160p",
              "present.device_ms.2160p")


def _run(timeline):
    return type("Run", (), {"timeline": timeline})


def _trace(stage_spans=True):
    """Frame 7 (host 0-100 us) re-sorts; frame 8 (host 200-300 us) does not
    and has no scene_update span. Each launch sits in a torch op nested in
    its stage; kernels run from 1000 us. Decoys: a kernel launched in frame
    7 outside every stage span, a stage span outside any traced frame with
    a launch in it, a kernel of an earlier frame (no launch in the trace),
    and the card-side twins of the frame and stage spans."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args})

    corr = [0]

    def launch(at, kernel, k_ts, k_dur, op="aten::copy_"):
        corr[0] += 1
        x("cpu_op", op, at - 0.5, 2)
        x("cuda_runtime", "cudaLaunchKernel", at, 1, correlation=corr[0])
        x("kernel", kernel, k_ts, k_dur, correlation=corr[0])

    def stage(name, ts, dur):
        if stage_spans:
            x("user_annotation", "frame." + name, ts, dur)
            x("gpu_user_annotation", "frame." + name, 1000 + ts, 5 * dur)

    x("user_annotation", "bench.frame.7", 0, 100)
    x("gpu_user_annotation", "bench.frame.7", 1000, 400)
    stage("camera", 1, 4)              # 4 us, one fill 2 us
    launch(2, "void at::native::vectorized_elementwise_kernel<4, FillFunctor>", 1000, 2)
    stage("scene_update", 5, 3)        # 3 us, no launch
    stage("setup", 8, 12)              # 12 us, setup 10 us + a torch cat 3 us
    launch(10, "setup_kernel(float const*, float4 const*)", 1002, 10)
    launch(15, "void at::native::CatArrayBatchedCopy<float>", 1012, 3, "aten::cat")
    stage("stream_order", 20, 10)      # 10 us, a sort 6 us
    launch(22, "void at::native::radixSortKVInPlace<float>", 1015, 6, "aten::sort")
    stage("raster", 30, 20)            # 20 us, a gather 5 us and the kernel 40 us
    launch(32, "void at::native::index_elementwise_kernel<128, 4>", 1021, 5, "aten::index")
    launch(40, "void raster_kernel<4, 1>(float const*)", 1026, 40)
    stage("shade_table", 50, 5)        # 5 us, the kernel 8 us
    launch(51, "table_kernel(float const*, float const*)", 1066, 8)
    stage("winner", 55, 10)            # 10 us, two reductions 3 us + 2 us
    launch(57, "void at::native::reduce_kernel<128, 4>", 1074, 3, "aten::amin")
    launch(60, "void at::native::reduce_kernel<128, 4>", 1077, 2, "aten::mean")
    stage("shade", 65, 10)             # 10 us, the kernel 20 us
    launch(66, "void resolve_kernel<Fused>(int const*)", 1079, 20)
    stage("present", 75, 15)           # 15 us, one elementwise 4 us
    launch(80, "void at::native::elementwise_kernel<128, 4>", 1099, 4)
    launch(95, "void at::native::elementwise_kernel<128, 4>", 1103, 7)  # in no stage

    x("user_annotation", "bench.frame.8", 200, 100)
    x("gpu_user_annotation", "bench.frame.8", 1200, 300)
    stage("camera", 201, 2)            # 2 us
    launch(202, "void at::native::vectorized_elementwise_kernel<4, FillFunctor>", 1200, 2)
    stage("setup", 205, 10)            # 10 us, setup 12 us
    launch(206, "setup_kernel(float const*, float4 const*)", 1202, 12)
    stage("raster", 215, 30)           # 30 us, a gather 7 us and the kernel 50 us
    launch(216, "void at::native::index_elementwise_kernel<128, 4>", 1214, 7, "aten::index")
    launch(230, "void raster_kernel<4, 1>(float const*)", 1221, 50)
    stage("shade_table", 245, 5)       # 5 us, the kernel 10 us
    launch(246, "table_kernel(float const*, float const*)", 1271, 10)
    stage("winner", 250, 10)           # 10 us, one reduction 4 us
    launch(251, "void at::native::reduce_kernel<128, 4>", 1281, 4, "aten::amin")
    stage("shade", 260, 20)            # 20 us, the kernel 30 us
    launch(261, "void resolve_kernel<Fused>(int const*)", 1285, 30)
    stage("present", 280, 5)           # 5 us, one elementwise 6 us
    launch(281, "void at::native::elementwise_kernel<128, 4>", 1315, 6)

    stage("raster", 400, 10)           # after the traced frames
    launch(401, "void raster_kernel<4, 1>(float const*)", 1400, 50)
    x("kernel", "void resolve_kernel<Fused>(int const*)", 900, 20, correlation=999)
    return Timeline(ev)


def _read(name, timeline):
    return spec.reader(name).read(_run(timeline))


def test_host_ms_by_stage_counts_an_absent_stage_as_zero():
    t = _trace()
    assert _read("setup.host_ms", t) == pytest.approx((4 + 3 + 12 + 2 + 10) / 2 * 1e-3)
    assert _read("raster.host_ms", t) == pytest.approx((10 + 20 + 30) / 2 * 1e-3)
    assert _read("shade_table.host_ms", t) == pytest.approx((5 + 5) / 2 * 1e-3)
    assert _read("shade.host_ms", t) == pytest.approx((10 + 10 + 10 + 20) / 2 * 1e-3)
    assert _read("present.host_ms", t) == pytest.approx((15 + 5) / 2 * 1e-3)


def test_resort_share_and_launches():
    t = _trace()
    assert _read("raster.resort_share", t) == pytest.approx(50.0)
    # frame 7 launches 11 kernels in its stage spans (not the one after
    # present), frame 8 eight; the span outside the frames counts for neither
    assert _read("launches_per_frame", t) == pytest.approx((11 + 8) / 2)


def test_kernels_go_to_the_stage_of_their_launch():
    t = _trace()
    assert _read("setup.device_ms.2160p", t) == pytest.approx((2 + 10 + 3 + 2 + 12) / 2 * 1e-3)
    # the sort and the gathers, not the raster kernel
    assert _read("raster.prologue.device_ms.2160p", t) == pytest.approx((6 + 5 + 7) / 2 * 1e-3)
    assert _read("shade_table.device_ms.2160p", t) == pytest.approx((8 + 10) / 2 * 1e-3)
    assert _read("winner.device_ms.2160p", t) == pytest.approx((3 + 2 + 4) / 2 * 1e-3)
    assert _read("present.device_ms.2160p", t) == pytest.approx((4 + 6) / 2 * 1e-3)


def test_the_card_side_twins_are_not_read():
    """Without the host spans the card-side twins alone give no reading."""
    t = _trace()
    twins = Timeline([e for e in t.host + t.device if e["cat"] != "user_annotation"
                      or e["name"].startswith("bench.")])
    assert any(e["cat"] == "gpu_user_annotation" and e["name"].startswith("frame.")
               for e in twins.host)
    for name in SPONZA + FLYTHROUGH:
        assert _read(name, twins) is None, name


def test_readers_return_nothing_without_stage_spans():
    """A program without the spans (an older port), or a run without a
    trace, yields no reading, and no reader raises."""
    bare = _trace(stage_spans=False)
    assert bare.frames and bare.kernels
    for name in SPONZA + FLYTHROUGH:
        assert _read(name, bare) is None, name
        assert _read(name, None) is None, name


def test_the_traced_line_reads_the_program_s_spans(small_root, capsys):
    """The harness on the CPU (no kernel in the trace): the sponza cell's
    traced line has the host readings of the program's own spans, and no
    device reading."""
    import json

    from benchmark import run as bench_run

    argv = ["--workload", "sponza-1080p-server", "--seed", str(2 ** 33 + 17), "--seconds",
            "3.0", "--trace", "1"]
    assert bench_run.main(argv, device="cpu") == 0
    result = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in SPONZA[:5]:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms", name
    assert 0 <= metrics["raster.resort_share"]["value"] <= 100
    assert "launches_per_frame" not in metrics
    assert not set(FLYTHROUGH) & set(metrics)
