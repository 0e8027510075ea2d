"""Build the port's host (C++) libraries with g++.

The host counterpart of ``ops/_cuda.py``: a source under
``vktf_tpu_torch/csrc/host/`` is compiled at first use into
``vktf_tpu_torch/_build/`` (listed in .gitignore), named by a hash of its
source and flags, through a temporary file and ``os.replace``, so
processes that build the same library at once each load a whole one.

Flags: no ``-ffast-math`` and no ``-march=native``, and
``-ffp-contract=off``: the float work must round one operation at a time,
as numpy's does, on any x86-64 or aarch64 host. libzstd is linked by its
soname, which needs no development package.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from vktf_tpu_torch.ops._cuda import BUILD_DIR

HOST_CSRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]
LIBS = ["-l:libzstd.so.1"]


def lib_path(source: str) -> Path:
    """The library of one source under csrc/host/, named by a hash of the
    source, the flags and the libraries."""
    text = (HOST_CSRC / source).read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile one source of csrc/host/ unless its library exists; returns
    the library's path. Raises RuntimeError with g++'s output on failure."""
    out = lib_path(source)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(HOST_CSRC / source), *LIBS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                           f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    return out
