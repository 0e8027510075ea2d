"""Build and load the port's CUDA kernels.

Each source in ``vktf_tpu_torch/csrc/`` is compiled by ``nvcc`` for sm_90a
into its own shared library with a plain C interface, loaded with ctypes.
Builds happen at first use, into ``vktf_tpu_torch/_build/`` (listed in
.gitignore), one ``nvcc`` process per source, all started together. A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused.

Each wrapper module declares its C entry points' argument types once, at
import (``declare``); they are set on the library's functions when it is
loaded, so a launch only calls the function.

``--fmad=false`` keeps the compiler from contracting multiply-adds on its
own: the kernels fuse exactly where the JAX reference's XLA build does
(``ops/fmath.py``), with explicit ``__fmaf_rn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Kernel:
    """One hand-written kernel: its source, what it replaces, and how many
    times its wrapper has launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source  # file name under csrc/
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.launches = 0

    @property
    def source_path(self) -> str:
        return f"vktf_tpu_torch/csrc/{self.source}"


_libs: dict[str, ctypes.CDLL] = {}
# source -> {C entry point: its argument types}, set when a library loads
_entries: dict[str, dict[str, list]] = {}


def declare(source: str, entry: str, argtypes: list) -> None:
    """Register the argument types of one C entry point of a source (every
    entry returns its launch's cudaError_t as an int)."""
    _entries.setdefault(source, {})[entry] = argtypes


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str, csrc: Path = CSRC) -> Path:
    """The library's path, named by a hash of its source, every header in
    its directory and the flags, so an edited header rebuilds its libraries
    too, and another directory's sources get libraries of their own."""
    parts = [(csrc / source).read_bytes()]
    parts += [h.read_bytes() for h in sorted(csrc.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(sources, csrc: Path = CSRC) -> dict[str, float]:
    """Compile the given sources of ``csrc`` (the package's own by default)
    in parallel; returns seconds per source (0.0 when an up-to-date library
    already existed). Raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    times = {}
    t0 = time.perf_counter()
    for source in sources:
        out = _lib_path(source, csrc)
        if out.exists():
            times[source] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp), str(csrc / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT),
                         tmp, out, log)
    failures = []
    for source, (proc, tmp, out, log) in procs.items():
        output, _ = proc.communicate()
        times[source] = time.perf_counter() - t0
        log.write_bytes(output)
        if proc.returncode != 0:
            failures.append(f"{source}:\n{output.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return times


def build_log(source: str) -> str:
    """nvcc's output for a built source (ptxas register and spill report)."""
    log = _lib_path(source).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(source: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Load the library of one source of ``csrc``, building it first if
    needed, with the declared argument types of the entry points it has."""
    build([source], csrc)
    lib = ctypes.CDLL(str(_lib_path(source, csrc)))
    for entry, argtypes in _entries.get(source, {}).items():
        fn = getattr(lib, entry, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library(source: str) -> ctypes.CDLL:
    """The package's loaded library of one source, the kernels' wrappers use."""
    lib = _libs.get(source)
    if lib is None:
        lib = _libs[source] = load(source)
    return lib


def on_device(device):
    """A context in which `device` is the current device when it is a
    card (a null context otherwise). A kernel launch goes to the current
    device, and fails on a stream of another card; a CUDA event records on
    the current device's stream."""
    import contextlib

    import torch

    device = torch.device(device)
    if device.type != "cuda" or device.index in (None, torch.cuda.current_device()):
        return contextlib.nullcontext()  # already current: nothing to switch
    return torch.cuda.device(device)


def launch(kernel: Kernel, entry: str, args, what: str, device) -> None:
    """Count and launch one kernel through its C entry point, with its
    operands' card current."""
    kernel.launches += 1
    with on_device(device):
        status = getattr(library(kernel.source), entry)(*args)
    check(status, what)


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel operand: CUDA, dtype, shape and contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_aligned(t, name: str, nbytes: int = 16) -> None:
    """Kernels that read an operand in 16-byte pieces need its start aligned."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must start on a {nbytes}-byte boundary")
