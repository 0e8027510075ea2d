"""Processes for the multi-device frame path: one rank each.

  * ``run(fn, world_size, *args)`` spawns ``world_size`` processes
    (torch.multiprocessing, spawn), sets each rank's device, initialises the
    default process group through a rendezvous file in a temporary
    directory (no port, so concurrent runs cannot collide), calls
    ``fn(*args)`` on every rank and returns rank 0's result. Tests and
    ``chip_smoke.py`` use it; ``fn`` builds its mesh with
    ``tiles.make_render_mesh``.
  * ``launcher_mesh(gp, sp, device)``, for the command lines: a process
    group already initialised (``run``) is used as it is; under ``torchrun``
    the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR/PORT) initialises the group, one card per rank under NCCL
    (``cuda:LOCAL_RANK``), gloo on the CPU; without either a 1x1 mesh runs
    in this process and a larger one raises, naming torchrun.

NCCL takes cards, one a rank; gloo takes the CPU, and a card only when the
caller asks for it (``backend="gloo"``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from vktf_tpu_torch.parallel.tiles import RenderMesh, make_render_mesh

_RESULT = "rank0_result.pt"


def _default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def _worker(rank: int, world_size: int, device: str, backend: str, rendezvous: str,
            timeout_s: float, fn, args) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{rendezvous}/store", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        if rank == 0:
            torch.save(result, Path(rendezvous) / _RESULT)
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, *args, device: str = "cpu", backend: Optional[str] = None,
        timeout_s: float = 600.0):
    """fn(*args) on `world_size` spawned ranks; rank 0's result (pickled
    through torch.save). device "cuda" gives rank r the card r modulo the
    card count; backend defaults to NCCL on cards and gloo on the CPU. A
    rank that raises stops the others and re-raises here; a run longer than
    timeout_s is stopped and raises TimeoutError. fn must be importable by
    name (a module's top level), and a script that calls run must do so
    under its ``__main__`` check: each rank imports the caller's main
    module."""
    backend = backend or _default_backend(device)
    rendezvous = tempfile.mkdtemp(prefix="vktf_launch_")
    context = None
    try:
        context = torch.multiprocessing.spawn(
            _worker, args=(world_size, device, backend, rendezvous, timeout_s, fn, args),
            nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout_s
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks ran past {timeout_s} s")
        return torch.load(Path(rendezvous) / _RESULT, weights_only=False)
    finally:
        if context is not None:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        shutil.rmtree(rendezvous, ignore_errors=True)


@contextlib.contextmanager
def launcher_mesh(gp: int, sp: int, device: str):
    """(mesh, torch device of this rank) for a command line's --mesh GP,SP,
    a process group it initialised torn down on exit. device: "cuda" or
    "cpu"."""

    def rank_device():
        return (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
                else torch.device("cpu"))

    if dist.is_available() and dist.is_initialized():
        yield make_render_mesh(gp, sp), rank_device()
        return
    backend = _default_backend(device)
    rendezvous = None
    if "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        init = dict(init_method="env://")
    elif gp * sp == 1:
        rendezvous = tempfile.mkdtemp(prefix="vktf_launch_")
        init = dict(init_method=f"file://{rendezvous}/store", rank=0, world_size=1)
    else:
        raise RuntimeError(
            f"--mesh {gp},{sp} runs {gp * sp} processes: start it under torchrun "
            f"(python -m torch.distributed.run --standalone --nproc-per-node {gp * sp} ...)")
    dist.init_process_group(backend, **init)
    try:
        mesh: RenderMesh = make_render_mesh(gp, sp)
        yield mesh, rank_device()
    finally:
        dist.destroy_process_group()
        if rendezvous is not None:
            shutil.rmtree(rendezvous, ignore_errors=True)
