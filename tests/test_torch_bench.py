"""bench_torch.py, the port's bench, on the CPU.

Mirrors tests/test_bench_harness.py on bench_torch.py (VKTF_FORCE_CPU=1,
the box preset at 192x96, msaa 1, two frames): a parseable JSON line lands
on stdout at normal completion, when the watchdog's budget expires and on
SIGTERM. Also: a bench run leaves jax out of sys.modules, its CONFIGS and
CAMERAS are bench.py's, and with no card and no VKTF_FORCE_CPU it prints
an error line and exits 1, as it does for the backends the port has not
and for a mesh of several ranks outside a launcher. Under torchrun (four
gloo ranks on the CPU) --mesh 2,2 prints one line, rank 0's, naming the
mesh.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--preset", "box", "--width", "192", "--height", "96", "--msaa", "1", "--frames", "2"]


def run_bench(extra_args, env_extra, timeout=240, send_sigterm_after=None, force_cpu=True):
    env = dict(os.environ)
    env.pop("VKTF_FORCE_CPU", None)
    if force_cpu:
        env["VKTF_FORCE_CPU"] = "1"
    env.update(env_extra)
    proc = subprocess.Popen(
        [sys.executable, "bench_torch.py", *SMALL, *extra_args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    first_err = ""
    if send_sigterm_after is not None:
        # anchor the signal to the bench running: wait for its "bench start"
        # marker (printed when the handlers arm) before timing the SIGTERM
        deadline = time.monotonic() + 120.0
        while True:
            line = proc.stderr.readline()
            first_err += line
            if "bench start" in line:
                break
            assert line and time.monotonic() < deadline, (
                f"no 'bench start' marker on stderr; got:\n{first_err}")
        time.sleep(send_sigterm_after)
        proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, first_err + err


def parse_lines(out):
    lines = [json.loads(l) for l in out.splitlines() if l.strip()]
    assert lines, f"no JSON line on stdout:\n{out}"
    for line in lines:
        assert "metric" in line and "value" in line and "unit" in line
    return lines


def test_bench_normal_completion_emits_json():
    rc, out, err = run_bench([], {})
    assert rc == 0, err[-2000:]
    lines = parse_lines(out)
    assert len(lines) == 1
    line = lines[0]
    assert line["value"] > 0 and "partial" not in line
    assert line["metric"] == "box @192x96 1xMSAA render FPS (12 tris, cpu/plain)"
    for key in ("vs_baseline", "frame_ms", "mtris_per_s", "compile_s", "session_init_s",
                "present_fps", "interactive_fps", "preview_fps", "loops"):
        assert key in line, key


def test_bench_budget_expiry_emits_partial_json():
    # a 1-second budget expires before the first measurement; the watchdog
    # thread must still land a JSON line and exit 0
    rc, out, err = run_bench(["--budget", "1"], {})
    assert rc == 0, err[-2000:]
    line = parse_lines(out)[-1]
    assert line.get("partial") == "budget", line
    assert "phase" in line


def test_bench_sigterm_emits_partial_json():
    rc, out, err = run_bench([], {}, send_sigterm_after=2.0)
    line = parse_lines(out)[-1]
    # the signal handler flushed a partial, or the run was already past its
    # print: a JSON line exists either way
    assert "value" in line


def test_bench_run_imports_no_jax():
    """A whole bench run in one interpreter, then its modules: no jax and
    nothing of the JAX package."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["bench_torch.py", *{SMALL!r}]
        try:
            runpy.run_path("bench_torch.py", run_name="__main__")
        except SystemExit as exit:
            assert not exit.code, exit.code
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "vktf_tpu."))
                        or m == "vktf_tpu")
        print("LOADED", loaded)
    """)
    env = dict(os.environ, VKTF_FORCE_CPU="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
    assert '"unit": "fps"' in out.stdout


def _module(name):
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_configs_and_cameras_are_bench_py_s():
    jax_bench, port_bench = _module("bench"), _module("bench_torch")
    assert port_bench.CONFIGS == jax_bench.CONFIGS
    assert port_bench.CAMERAS == jax_bench.CAMERAS
    assert port_bench.BASELINE_TARGET_FPS == jax_bench.BASELINE_TARGET_FPS


def test_no_card_prints_an_error_line_and_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench takes it")
    rc, out, err = run_bench([], {}, force_cpu=False)
    assert rc == 1, err[-2000:]
    lines = parse_lines(out)
    assert len(lines) == 1
    assert lines[0]["value"] == 0.0 and "no CUDA device" in lines[0]["error"]


@pytest.mark.parametrize("flags", [["--mesh", "2,2"], ["--backend", "tiled"],
                                   ["--backend", "dense"]])
def test_unported_options_print_an_error_line_and_exit_1(flags):
    """The backends the port has not, and --mesh without a launcher (it
    names torchrun; nothing re-execs or runs on one rank)."""
    rc, out, err = run_bench(flags, {})
    assert rc == 1, err[-2000:]
    line = parse_lines(out)[-1]
    cause = "torchrun" if flags[0] == "--mesh" else "not ported"
    assert line["value"] == 0.0 and cause in line["error"]


def test_mesh_under_torchrun_prints_rank_0_s_line():
    env = dict(os.environ, VKTF_FORCE_CPU="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "4", "bench_torch.py", *SMALL, "--mesh", "2,2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = parse_lines(proc.stdout)
    assert len(lines) == 1
    line = lines[0]
    assert line["mesh"] == "gp2x sp2" and line["value"] > 0 and "partial" not in line
    assert line["metric"] == "box @192x96 1xMSAA render FPS (12 tris, cpu/plain)"
