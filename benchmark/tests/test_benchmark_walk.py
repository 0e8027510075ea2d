"""The camera walk is a function of the seed and the frame index, and every
seed walks the same loop of poses."""

import numpy as np
import pytest

from benchmark import spec, walk
from benchmark.tests.conftest import REPO

BENCH = spec.load_json(REPO / "BENCHMARK.json")
MIX = spec.load_json(REPO / "benchmark" / "traffic" / "server.json")
START = spec.load_json(REPO / "benchmark" / "configs" / "sponza-1080p-msaa4.json")["camera"]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 33 + 123])
def test_pose_depends_on_seed_and_index_only(seed):
    long_p, long_d = walk.poses(MIX["walk"], START, seed, 5000)
    short_p, short_d = walk.poses(MIX["walk"], START, seed, 37)
    assert np.array_equal(long_p[:37], short_p) and np.array_equal(long_d[:37], short_d)
    again_p, _ = walk.poses(MIX["walk"], START, seed, 5000)
    assert np.array_equal(long_p, again_p)


def test_seeds_walk_differently_within_the_region():
    a, _ = walk.poses(MIX["walk"], START, 1, 3000)
    b, _ = walk.poses(MIX["walk"], START, 2, 3000)
    assert np.abs(a - b).max() > 1.0
    w = MIX["walk"]
    for p in (a, b):
        assert np.all(p[:, 1] == w["eye_height"])
        assert np.all((p[:, 0] >= w["region_x"][0]) & (p[:, 0] <= w["region_x"][1]))
        assert np.all((p[:, 2] >= w["region_z"][0]) & (p[:, 2] <= w["region_z"][1]))


def test_every_seed_renders_the_same_poses_in_another_order():
    w = MIX["walk"]
    n = w["loop_frames"]
    loop_p, _ = walk.loop(w, START)
    firsts = set()
    for seed in (1, 2, 2 ** 33 + 5):
        p, _ = walk.poses(w, START, seed, 3 * n)
        # whole loops: each pose of the loop comes three times
        assert sorted(map(tuple, p.round(12))) == sorted(list(map(tuple, loop_p.round(12))) * 3)
        assert np.array_equal(p[:n], p[n:2 * n])
        firsts.add(tuple(p[0]))
    assert len(firsts) == 3


def test_steps_follow_speed_and_drag():
    w = MIX["walk"]
    p, d = walk.loop(w, START)
    step = np.linalg.norm(np.diff(p[:, [0, 2]], axis=0), axis=1)
    assert step.max() <= w["speed"] * w["frame_dt"] + 1e-9
    assert np.allclose(d[0] / np.linalg.norm(d[0]),
                       np.asarray(START["direction"]) / np.linalg.norm(START["direction"]))
    yaw = np.unwrap(np.arctan2(d[:, 2], d[:, 0]))
    turns = np.abs(np.diff(yaw))
    # a turn is a drag of at most drag_px_max pixels, or a reflection
    small = turns[turns < 0.5]
    assert small.max() <= w["drag_px_max"] * w["drag_speed"] + 1e-12
