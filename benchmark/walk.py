"""The camera walk every cell's traffic takes: a closed loop of frames,
each at the pose of its index.

The walk is a loop of ``loop_frames`` poses, the same for every run: frame
k+1 of it is 1/60 s of walking after frame k (whatever the clock says):
the eye moves forward along its heading at the viewer's translate speed,
and the heading turns by a drag drawn uniformly within the mix's limit
(in pixels, at the viewer's drag speed in radians per pixel) from the
mix's own ``walk_seed``. The eye stays at its height, and the walk
reflects off the edges of its region. A run's seed picks the pose its
frame 0 takes in the loop, and frame i takes the i-th pose after it, so
every seed renders the same poses in another order (a window holds many
loops) and does the same work; a pose depends on the seed and the index
alone, however many poses are asked for.
"""

from __future__ import annotations

import numpy as np


def poses(walk: dict, start: dict, seed: int, count: int):
    """(positions (count, 3) float64, directions (count, 3) float64) of
    frames 0 .. count-1 of the run with this seed."""
    loop_pos, loop_dir = loop(walk, start)
    phase = int(np.random.default_rng([seed, 0]).integers(0, len(loop_pos)))
    index = (phase + np.arange(count)) % len(loop_pos)
    return loop_pos[index], loop_dir[index]


def loop(walk: dict, start: dict):
    """(positions, directions) of the loop's ``loop_frames`` poses, from the
    start pose."""
    count = walk["loop_frames"]
    direction = np.asarray(start["direction"], np.float64)
    pitch = np.arctan2(direction[1], np.hypot(direction[0], direction[2]))
    yaw = np.arctan2(direction[2], direction[0])
    drags = np.random.default_rng(walk["walk_seed"]).uniform(
        -walk["drag_px_max"], walk["drag_px_max"], size=count)
    step = walk["speed"] * walk["frame_dt"]
    (x_lo, x_hi), (z_lo, z_hi) = walk["region_x"], walk["region_z"]
    x, z = float(start["position"][0]), float(start["position"][2])
    pos = np.empty((count, 3))
    yaws = np.empty(count)
    for i in range(count):
        pos[i] = (x, walk["eye_height"], z)
        yaws[i] = yaw
        yaw += walk["drag_speed"] * drags[i]
        x += step * np.cos(yaw)
        z += step * np.sin(yaw)
        if not x_lo <= x <= x_hi:
            x = 2 * (x_lo if x < x_lo else x_hi) - x
            yaw = np.pi - yaw
        if not z_lo <= z <= z_hi:
            z = 2 * (z_lo if z < z_lo else z_hi) - z
            yaw = -yaw
    dirs = np.stack([np.cos(pitch) * np.cos(yaws), np.full(count, np.sin(pitch)),
                     np.cos(pitch) * np.sin(yaws)], axis=1)
    return pos, dirs
