"""The reference renderer against the port's plain CPU path at a small
size, its camera against the port's, the control failing the limits, and
the frozen roofline counts on a tiny scene."""

import numpy as np
import pytest
import torch

from benchmark import check, program, reference, roofline, scene_gen, spec, walk
from benchmark.tests.conftest import REPO, SMALL_SCENE

CONFIG = spec.load_json(REPO / "benchmark" / "configs" / "sponza-1080p-msaa4.json")
MIX = spec.load_json(REPO / "benchmark" / "traffic" / "server.json")
LIMITS = CONFIG["check"]["limits"]
W, H = 160, 96
SMALL = {**CONFIG, "render": {**CONFIG["render"], "width": W, "height": H}}


def _frames(seed, index, **kw):
    assets = scene_gen.build(SMALL_SCENE, seed)
    pos, dirs = walk.poses(MIX["walk"], CONFIG["camera"], seed, index + 1)
    scn = program.scene(assets, SMALL, "cpu")
    scn.camera = program.camera(SMALL, pos[index], dirs[index])
    ours = scn.render_async().numpy()
    vp = reference.view_projection(CONFIG["camera"], W, H, pos[index], dirs[index])
    ref = reference.ReferenceScene(assets, "cpu")
    theirs = reference.render(ref, vp, pos[index], W, H, 4, 16.0, **kw).numpy()
    return ours, theirs, scn.camera.view_projection_transform, vp


@pytest.mark.parametrize("seed,index", [(11, 0), (2 ** 33 + 5, 400)])
def test_port_within_limits_of_reference(seed, index):
    ours, theirs, vp_port, vp_ref = _frames(seed, index)
    assert np.abs(vp_port - vp_ref).max() < 1e-4
    numbers = check.frame_numbers(ours, theirs)
    ok, compared = check.judge([numbers], LIMITS)
    assert ok, compared
    assert (theirs.max(0) > 0).mean() > 0.5  # the courtyard fills the frame


def test_control_fails_the_limits():
    """The reference shaded in bfloat16 (raster float32) in the program's
    place, held to the float64 reference."""
    assets = scene_gen.build(SMALL_SCENE, 21)
    pos, dirs = walk.poses(MIX["walk"], CONFIG["camera"], 21, 1)
    vp = reference.view_projection(CONFIG["camera"], W, H, pos[0], dirs[0])
    ref = reference.ReferenceScene(assets, "cpu")
    truth = reference.render(ref, vp, pos[0], W, H, 4, 16.0)
    control = reference.render(ref, vp, pos[0], W, H, 4, 16.0, shade_dtype=torch.bfloat16,
                               raster_dtype=torch.float32)
    ok, compared = check.judge([check.frame_numbers(control, truth)], LIMITS)
    assert not ok, compared


def _one_triangle(corners):
    tex = {"levels": scene_gen.mip_chain(np.full((8, 8, 4), 200, np.uint8), True), "srgb": True,
           "sampler": {"mag_filter": "linear", "min_filter": "linear", "mipmap_mode": "linear",
                       "wrap_u": "repeat", "wrap_v": "repeat"}}
    geom = {"positions": np.asarray(corners, np.float32),
            "normals": np.tile(np.float32([0, 0, 1]), (3, 1)),
            "tangents": np.tile(np.float32([1, 0, 0, 1]), (3, 1)),
            "uvs": np.float32([[0, 0], [1, 0], [0, 1]]),
            "indices": np.uint32([[0, 1, 2]])}
    material = {"name": "m", "base_color_factor": np.ones(4, np.float32), "metallic_factor": 0.0,
                "roughness_factor": 1.0, "normal_scale": 1.0, "textures": [tex, tex, tex]}
    return [{"name": "t", "materials": [material], "meshes": [{"geometry": geom, "material": 0}],
             "nodes": [{"transform": np.eye(4, dtype=np.float32), "mesh": 0, "light": None},
                       {"transform": np.eye(4, dtype=np.float32), "mesh": None, "light": 0}],
             "lights": [{"type": "directional", "color": np.ones(3, np.float32)}]}]


def test_roofline_counts_on_one_triangle():
    """Covered pixels and box pixels against a brute-force point-in-triangle
    test of the projected corners; the least time from the counts."""
    w, h = 64, 48
    assets = _one_triangle([[-1, -1, -4], [1, -1, -4], [-1, 1, -4]])
    camera = {"fov_y_deg": 45.0, "z_near": 0.1, "z_far": 100.0}
    vp = reference.view_projection(camera, w, h, (0, 0, 0), (0, 0, -1))
    ref = reference.ReferenceScene(assets, "cpu")
    _, work = reference.render(ref, vp, (0, 0, 0), w, h, 4, 16.0, counts=True)
    clip = np.c_[np.float64([[-1, -1, -4], [1, -1, -4], [-1, 1, -4]]), np.ones(3)] @ vp.T
    sx = (clip[:, 0] / clip[:, 3] + 1) * 0.5 * w
    sy = (clip[:, 1] / clip[:, 3] + 1) * 0.5 * h
    ys, xs = np.mgrid[0:h, 0:w]
    any_cov = np.zeros((h, w), bool)
    for ox, oy in reference.SAMPLE_OFFSETS[4]:
        px, py = xs + ox, ys + oy
        e = [(sx[j] - sx[i]) * (py - sy[i]) - (sy[j] - sy[i]) * (px - sx[i])
             for i, j in ((0, 1), (1, 2), (2, 0))]
        inside = ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)) | ((e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0))
        any_cov |= inside
    assert work["covered_pixels"] == int(any_cov.sum()) > 100
    box = (np.ceil(sx.max()) - np.floor(sx.min())) * (np.ceil(sy.max()) - np.floor(sy.min()))
    assert work["box_pixels"] == int(box)
    assert work["live_triangles"] == work["shaded_triangles"] == 1
    levels = sum(l.shape[0] * l.shape[1] for l in assets[0]["materials"][0]["textures"][0]["levels"])
    assert 4 <= work["texels_read"] <= 3 * levels  # three slots, each its own texture
    peaks = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    raster = roofline.raster_least_s(work, peaks)
    assert raster == pytest.approx(max(
        (112 + 4 * w * h * 8) / 3.35e12, work["box_pixels"] * 4 * 20 / 67e12))
    assert roofline.shade_least_s(work, peaks) > 0


def test_a_back_face_is_not_drawn():
    assets = _one_triangle([[-1, -1, -4], [-1, 1, -4], [1, -1, -4]])
    camera = {"fov_y_deg": 45.0, "z_near": 0.1, "z_far": 100.0}
    vp = reference.view_projection(camera, 32, 32, (0, 0, 0), (0, 0, -1))
    frame, work = reference.render(reference.ReferenceScene(assets, "cpu"), vp, (0, 0, 0), 32, 32,
                                   4, 16.0, counts=True)
    assert work["covered_pixels"] == 0 and int(frame.max()) == 0
