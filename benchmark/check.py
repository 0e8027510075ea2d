"""The comparison that decides ``correct``: each sampled frame of the
window against the reference's frame at the same pose.

Three numbers per frame, each over the frame's RGB bytes:
  * ``mean_abs_step``: the mean |program - reference| in u8 steps;
  * ``share_over_8``: the share of pixels with a channel more than 8 steps
    apart;
  * ``worst_block_over_8``: that share in the worst 64x64 block, which a
    wrong region the size of a tile cannot hide in.
A run is correct when every sampled frame keeps every number at or under
its limit (the configuration file's ``check.limits``).
"""

from __future__ import annotations

import numpy as np
import torch

STEP = 8
BLOCK = 64


def frame_numbers(program: np.ndarray, reference: np.ndarray) -> dict:
    a = torch.as_tensor(np.asarray(program)).to(torch.int16)
    b = torch.as_tensor(np.asarray(reference)).to(a.device).to(torch.int16)
    diff = (a - b).abs()
    over = (diff.amax(0) > STEP).float()
    h, w = over.shape
    ph, pw = -h % BLOCK, -w % BLOCK
    padded = torch.nn.functional.pad(over, (0, pw, 0, ph))
    counts = padded.reshape(padded.shape[0] // BLOCK, BLOCK, -1, BLOCK).sum((1, 3))
    pixels = torch.nn.functional.pad(torch.ones_like(over), (0, pw, 0, ph)).reshape(
        counts.shape[0], BLOCK, -1, BLOCK).sum((1, 3))
    return {"mean_abs_step": float(diff.float().mean()),
            "share_over_8": float(over.mean()),
            "worst_block_over_8": float((counts / pixels).max())}


def judge(per_frame: list, limits: dict):
    """(correct, {name: {"value": worst over the frames, "limit": limit}})."""
    worst = {name: max(n[name] for n in per_frame) for name in limits} if per_frame else {}
    ok = bool(per_frame) and all(worst[name] <= limit for name, limit in limits.items())
    return ok, {name: {"value": worst.get(name), "limit": limit} for name, limit in limits.items()}
