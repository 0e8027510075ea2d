"""Finds everything a cell needs by the names ``BENCHMARK.json`` gives:
its configuration file (the ``file`` of its configuration entry), its
traffic mix (``benchmark/traffic/<traffic>.json``) and each metric's
reader (``benchmark/metrics/<metric name>.py``). Adding a cell, a
configuration, a mix or a metric adds files and entries only."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict):
    """(workload entry, configuration, traffic) of the cell `name`."""
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = load_json(ROOT / entry["file"])
    traffic = load_json(ROOT / "benchmark" / "traffic" / f"{workload['traffic']}.json")
    return workload, config, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end ones
    without a trace, the per-layer ones with it. A metric without a
    ``workloads`` list belongs to every cell that reports its end-to-end
    metric (``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(name: str):
    """The module of the metric `name` (its ``read(run)``)."""
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
