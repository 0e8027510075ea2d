"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the repo's suite collects tests/)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the small courtyard the CPU tests render (the cells' own widths and
# layout, fewer columns, clutter and curtains, 64 px textures)
SMALL_SCENE = {"preset": "sponza", "tex_size": 64, "columns_per_ring": 4, "clutter": 8,
               "curtains": 2}


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    """A checkout whose every configuration renders the small courtyard at
    128x64, with the benchmark's own traffic, metrics and limits, made the
    harness's root."""
    from benchmark import spec

    (tmp_path / "benchmark").mkdir()
    shutil.copytree(REPO / "benchmark" / "traffic", tmp_path / "benchmark" / "traffic")
    shutil.copytree(REPO / "benchmark" / "metrics", tmp_path / "benchmark" / "metrics")
    (tmp_path / "benchmark" / "configs").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        config["scene"] = dict(SMALL_SCENE)
        config["render"].update(width=128, height=64)
        (tmp_path / entry["file"]).write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    return tmp_path
