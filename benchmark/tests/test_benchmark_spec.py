"""BENCHMARK.json and the files it names: they load, their names and
units keep to the contract's characters, every cell finds its files by
name, and a new cell needs new files only."""

import json
import math
import re

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["run_seconds"] == int(BENCH["run_seconds"])
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        assert spec.NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert spec.UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                assert "\t" not in entry[key]


def test_workloads_name_known_configs_and_mixes():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert spec.NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert configs == {w["config"] for w in BENCH["workloads"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_files(workload):
    w, config, traffic = spec.cell(workload, BENCH)
    assert config["name"] == w["config"]
    assert traffic["kind"] == "server"
    assert traffic["check_frames"] % traffic["in_flight"] == 0
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["reduced"] == config["reduced"]
    assert all(spec.NAME.match(k) for k in entry["reduced"])
    assert set(config["check"]["limits"]) == {"mean_abs_step", "share_over_8",
                                              "worst_block_over_8"}
    reported = {m["name"] for m in spec.metrics_of(BENCH, workload, False)}
    assert "setup_s" in reported and len(reported) >= 2
    # every per-layer metric of the cell moves one of its end-to-end metrics
    layers = spec.metrics_of(BENCH, workload, True)
    assert layers and all(m["moves"] in reported for m in layers)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    module = spec.reader(metric["name"])
    assert module.UNIT == metric["unit"]
    if "layer" in metric:
        assert (module.LAYER, module.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    assert callable(module.read)


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(re.match(r"^[a-zA-Z ]+$", layer) for layer in layers)


def test_a_new_cell_needs_new_files_only(small_root):
    """A configuration, a mix and metrics added as files and entries are
    found by name, with no code edited: the new cell brings its own
    end-to-end metric (the existing ones list their cells) and a per-layer
    metric that moves it."""
    (small_root / "benchmark" / "configs" / "sponza-720p.json").write_text(json.dumps(
        {**json.loads((small_root / BENCH["configs"][0]["file"]).read_text()),
         "name": "sponza-720p"}))
    mix = json.loads((small_root / "benchmark" / "traffic" / "server.json").read_text())
    (small_root / "benchmark" / "traffic" / "server2.json").write_text(
        json.dumps({**mix, "in_flight": 2}))
    (small_root / "benchmark" / "metrics" / "frames_done.py").write_text(
        "UNIT, LAYER, MOVES = 'frames', 'frame dispatch', 'frame_rate.720p'\n"
        "def read(run):\n    return float(len(run.record.done))\n")
    (small_root / "benchmark" / "metrics" / "frame_rate.720p.py").write_text(
        "from benchmark.spec import reader\n"
        "UNIT, LAYER, MOVES = 'frames/s', None, None\n"
        "read = reader('frame_rate').read\n")
    bench = json.loads((small_root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "sponza-720p",
                             "file": "benchmark/configs/sponza-720p.json"})
    bench["workloads"].append({"name": "sponza-720p-server2", "config": "sponza-720p",
                               "traffic": "server2", "chips": 1, "why": "a new cell"})
    bench["end_to_end"].append({"name": "frame_rate.720p", "unit": "frames/s",
                                "better": "higher", "bound": 0.2, "source": "host_clock",
                                "workloads": ["sponza-720p-server2"]})
    bench["per_layer"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "frame dispatch",
                               "moves": "frame_rate.720p"})
    (small_root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = spec.benchmark()
    w, config, traffic = spec.cell("sponza-720p-server2", bench)
    assert config["name"] == "sponza-720p" and traffic["in_flight"] == 2
    assert {m["name"] for m in spec.metrics_of(bench, "sponza-720p-server2", False)} == {
        "frame_rate.720p", "setup_s"}
    names = [m["name"] for m in spec.metrics_of(bench, "sponza-720p-server2", True)]
    assert "frames_done" in names and "dispatch_ms" not in names
    rec = type("Rec", (), {"done": {1: 0.5, 2: 3.0}, "t1": 2.0,
                           "completed_in_window": lambda self: 1})()
    assert spec.reader("frame_rate.720p").read(type("R", (), {"record": rec,
                                                              "seconds": 2.0})) == 0.5
    assert spec.reader("frames_done").read(type("R", (), {"record": type(
        "Rec", (), {"done": {1: 0.0, 2: 0.0}})})) == 2.0


def test_run_seconds_buys_a_tail():
    """Every cell's p95 has at least ten frames beyond it at the slowest
    rate a cell is expected to keep (60 frames/s)."""
    assert math.floor(60 * BENCH["run_seconds"] * 0.05) >= 10


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_the_seed_draws_no_count(entry):
    """A configuration's triangle count is its sizes', whatever the seed, and
    fits the reference's raster key."""
    from benchmark import reference, scene_gen

    scene = spec.load_json(REPO / entry["file"])["scene"]
    counts = {scene_gen.triangle_count(scene_gen.build(scene, seed))
              for seed in (3, 2 ** 33 + 5)}
    assert len(counts) == 1 and 0 < counts.pop() < 1 << reference.TRI_BITS
