"""The harness end to end on the CPU (the kernels' plain versions, the small
courtyard at 128x64): the result line, the per-layer line, the faults the
check must catch, and what the process may load."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spec
from benchmark.tests.conftest import REPO

SEED = 2 ** 33 + 17


def _run(capsys, workload, trace=0, seconds=2.0, seed=SEED):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    assert bench_run.main(argv, device="cpu") == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_server_result_line(small_root, capsys):
    result, err = _run(capsys, "sponza-1080p-server")
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"frame_rate", "frame_latency_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= result["metrics"]["frame_rate"]["value"] * 2.0
    assert err.strip().splitlines()[-1].startswith("check worst_block_over_8")


def test_server_traced_line(small_root, capsys):
    result, err = _run(capsys, "flythrough-2160p-server", trace=1, seconds=3.0)
    assert result["correct"] is True
    assert {"dispatch_ms.2160p", "scene_build_s"} <= set(result["metrics"])
    assert not {"frame_rate", "frame_rate.2160p", "dispatch_ms"} & set(result["metrics"])
    assert "breakdown" in result and "profiled span, host and device:" in err
    # the device-only span fits in the short window too (the CPU records no
    # device operation there, so busy_s and window_s are the card's alone)
    assert "profiled span, device only:" in err


def test_the_sample_holds_every_slot_in_flight(small_root, capsys):
    """check_frames frames are compared, as many of each slot in flight
    (each slot has its own pinned buffer)."""
    result, err = _run(capsys, "sponza-1080p-server")
    _, _, traffic = spec.cell("sponza-1080p-server", spec.benchmark())
    frames = [int(line.split()[1].rstrip(":")) for line in err.splitlines()
              if line.startswith("frame ")]
    assert len(frames) == traffic["check_frames"]
    slots = [f % traffic["in_flight"] for f in frames]
    assert sorted(set(slots)) == list(range(traffic["in_flight"]))
    assert len(set(slots.count(s) for s in set(slots))) == 1


def _stale(monkeypatch):
    """A frame server that hands back its previous frame unchanged."""
    from vktf_tpu_torch.scene.scene import Scene

    real = Scene.render_async
    last = {}

    def render_async(self):
        frame = real(self)
        out = last.get("frame", frame)
        last["frame"] = frame
        return out

    monkeypatch.setattr(Scene, "render_async", render_async)


def _altered(monkeypatch):
    """A frame whose left 64x64 pixels come out black."""
    from vktf_tpu_torch.scene.scene import Scene

    real = Scene.render_async

    def render_async(self):
        frame = real(self).clone()
        frame[:, :64, :64] = 0
        return frame

    monkeypatch.setattr(Scene, "render_async", render_async)


@pytest.mark.parametrize("fault", [_stale, _altered], ids=["stale", "altered"])
@pytest.mark.parametrize("workload", ["sponza-1080p-server", "flythrough-2160p-server"])
def test_a_fault_in_the_timed_path_is_not_correct(small_root, capsys, monkeypatch, fault,
                                                  workload):
    fault(monkeypatch)
    result, _ = _run(capsys, workload)
    assert result["correct"] is False


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    monkeypatch.setitem(sys.modules, "vktf_tpu_torch_fake.x", object())
    assert bench_run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "vktf_tpu.ops.fake", object())
    assert bench_run.loaded_forbidden() == ["vktf_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run as r\n"
            "from benchmark import check, control, loops, program, reference, roofline, "
            "scene_gen, spec, timeline, walk\n"
            "print(r.loaded_forbidden())" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure it")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "sponza-1080p-server", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
