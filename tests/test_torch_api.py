"""The port's public API against the JAX package's.

Every name ``vktf_tpu`` exports, and every name its ``mathx``, ``scene``
and ``models`` subpackages export, exists in the port's counterpart (which
keeps its own extra names), and computes the same result on the same
seeded inputs: the host math bit for bit (both run numpy), the meshes and
the flattened scene exactly. ``import vktf_tpu_torch`` and every lazy
export load no jax (tests/test_torch_frame.py::test_port_imports_no_jax).
"""

import importlib

import numpy as np
import pytest

import torch_parity as tp

tp.limit_threads()

SUBPACKAGES = ["", ".mathx", ".scene", ".models"]


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=["top", "mathx", "scene", "models"])
def test_port_exports_every_jax_name(sub):
    jax_mod = importlib.import_module("vktf_tpu" + sub)
    port_mod = importlib.import_module("vktf_tpu_torch" + sub)
    missing = set(jax_mod.__all__) - set(port_mod.__all__)
    assert not missing, sorted(missing)
    for name in port_mod.__all__:  # the lazy ones resolve too
        assert getattr(port_mod, name) is not None, name


def test_top_level_constants_and_log():
    import vktf_tpu
    import vktf_tpu_torch

    assert vktf_tpu_torch.MAX_RENDER_FRAMES == vktf_tpu.MAX_RENDER_FRAMES
    assert ([m.name for m in vktf_tpu_torch.Severity]
            == [m.name for m in vktf_tpu.Severity])
    assert isinstance(vktf_tpu_torch.default_log(), vktf_tpu_torch.Log)
    assert vktf_tpu_torch.Engine.__name__ == "Engine"
    assert vktf_tpu_torch.Window.__name__ == "Window"
    assert vktf_tpu_torch.scene.Scene.__name__ == "Scene"
    shared = ("width", "height", "msaa_samples", "max_anisotropy", "peel_layers",
              "aniso_taps", "present_format", "present_scale", "shading_rate")
    want, got = vktf_tpu.RenderConfig(), vktf_tpu_torch.RenderConfig()
    assert {f: getattr(got, f) for f in shared} == {f: getattr(want, f) for f in shared}


def test_select_msaa_samples_over_its_domain():
    from vktf_tpu.config import select_msaa_samples as want
    from vktf_tpu_torch.config import select_msaa_samples as got

    for requested in range(-3, 40):
        assert got(requested) == want(requested), requested


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quat_conjugate_matches_jax(dtype):
    from vktf_tpu.mathx import quat_conjugate as want
    from vktf_tpu_torch.mathx import quat_conjugate as got

    q = np.random.default_rng(4).normal(size=(7, 5, 4)).astype(dtype)
    for x in (q, q[0, 0], np.zeros(4, dtype), -q):
        a, b = got(x), np.asarray(want(x))
        assert a.dtype == b.dtype == dtype
        np.testing.assert_array_equal(a, b)


def _quat_cases(rng):
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q2 = rng.normal(size=(6, 4)).astype(np.float32)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    unit = q / np.linalg.norm(q, axis=-1, keepdims=True)
    angles = rng.uniform(-3, 3, 6).astype(np.float32)
    return {
        "quat_normalize": (q,),
        "quat_multiply": (q, q2),
        "quat_angle_axis": (angles, v / np.linalg.norm(v, axis=-1, keepdims=True)),
        "quat_rotate": (unit, v),
        "quat_to_matrix": (unit,),
        "quat_look_at": (v[0], np.asarray([0.0, 1.0, 0.0], np.float32)),
        "view_matrix": (v[1], unit[1]),
        "perspective": (float(np.radians(50.0)), 16 / 9, 0.1, 1.0e6),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases(np.random.default_rng(0))))
def test_host_math_matches_jax(name):
    import vktf_tpu.mathx as jm
    import vktf_tpu_torch.mathx as pm

    args = _quat_cases(np.random.default_rng(8))[name]
    np.testing.assert_array_equal(getattr(pm, name)(*args),
                                  np.asarray(getattr(jm, name)(*args)))


def _seeded_boxes(rng, n=64):
    """n boxes and n affine matrices: rotations about random axes, some
    scales and shears, translations."""
    lo = rng.uniform(-3, 1, (n, 3))
    boxes = np.stack([lo, lo + rng.uniform(0.01, 4, (n, 3))], axis=1).astype(np.float32)
    mats = np.tile(np.eye(4), (n, 1, 1))
    mats[:, :3, :3] = rng.normal(size=(n, 3, 3))
    mats[:, :3, 3] = rng.normal(0, 5, (n, 3))
    return boxes, mats.astype(np.float32)


def test_transform_aabbs_matches_jax():
    from vktf_tpu.mathx import transform_aabbs as want
    from vktf_tpu_torch.mathx import transform_aabbs as got

    boxes, mats = _seeded_boxes(np.random.default_rng(11))
    out = got(boxes, mats)
    assert out.shape == (64, 2, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, np.asarray(want(boxes, mats)))
    # batched over a leading axis and broadcast against one matrix
    np.testing.assert_array_equal(got(boxes.reshape(8, 8, 2, 3), mats[0]),
                                  np.asarray(want(boxes.reshape(8, 8, 2, 3), mats[0])))


def test_bounding_box_matches_jax():
    from vktf_tpu.mathx import BoundingBox as JBox, transform_aabb as jtransform
    from vktf_tpu_torch.mathx import BoundingBox, transform_aabb

    boxes, mats = _seeded_boxes(np.random.default_rng(12), 16)
    for (lo, hi), m in zip(boxes, mats):
        got, want = transform_aabb(BoundingBox(lo, hi), m), jtransform(JBox(lo, hi), m)
        np.testing.assert_array_equal(got.min, want.min)
        np.testing.assert_array_equal(got.max, want.max)
    empty, jempty = BoundingBox.empty(), JBox.empty()
    np.testing.assert_array_equal(empty.as_array(), jempty.as_array())
    a, b = BoundingBox(*boxes[0]), BoundingBox(*boxes[1])
    ja, jb = JBox(*boxes[0]), JBox(*boxes[1])
    np.testing.assert_array_equal(a.union(b).as_array(), ja.union(jb).as_array())
    np.testing.assert_array_equal(empty.union(a).as_array(), jempty.union(ja).as_array())


def test_frustum_cull_matches_jax():
    import vktf_tpu.mathx as jm
    import vktf_tpu_torch.mathx as pm

    _jcam, tcam = tp.cameras()
    vp = np.asarray(tcam.view_projection_transform, np.float32)
    planes = pm.frustum_planes(vp)
    np.testing.assert_array_equal(planes, np.asarray(jm.frustum_planes(vp)))
    boxes = _seeded_boxes(np.random.default_rng(13), 256)[0] * 8
    vis = pm.aabbs_intersect_frustum(boxes, planes)
    assert 0 < vis.sum() < len(vis)
    np.testing.assert_array_equal(vis, np.asarray(jm.aabbs_intersect_frustum(boxes, planes)))


@pytest.mark.parametrize("name, args", [
    ("box_mesh", (0.7,)), ("plane_mesh", (3.0, 4)), ("uv_sphere_mesh", (0.8, 6, 9)),
])
def test_meshes_match_jax(name, args):
    import vktf_tpu.models as jmodels
    import vktf_tpu_torch.models as models

    got, want = getattr(models, name)(*args), getattr(jmodels, name)(*args)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_flatten_assets_takes_the_jax_call():
    """flatten_assets(assets, log) returns (scene, meta, aux) as the JAX
    package's: the same SceneMeta, the same leaves, and texture entries of
    the same mip chains, colour spaces and samplers; a device passed where
    the log goes raises."""
    from vktf_tpu.scene import flatten_assets as jflatten
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.scene import RenderScene, flatten_assets
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES

    name = "sponza_small_mixed"
    scene, meta, aux = flatten_assets(tp.torch_assets(name), Log(), device="cpu")
    with tp._jax_native_mips(False):
        jscene, jmeta, jaux = jflatten(tp.jax_assets(name))
    assert isinstance(scene, RenderScene) and scene.device.type == "cpu"
    assert meta == tp.port_meta(jmeta)
    for leaf in SCENE_LEAVES:
        got = getattr(scene, leaf).numpy()
        want = np.asarray(getattr(jscene, leaf))
        if leaf == "quad_pool":
            want = np.ascontiguousarray(want, np.uint16).view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=leaf)
    entries, jentries = aux["texture_entries"], jaux["texture_entries"]
    assert sorted(aux) == sorted(jaux) and len(entries) == len(jentries) > 3
    for (data, sampler), (jdata, jsampler) in zip(entries, jentries):
        assert sampler == jsampler and data.srgb == jdata.srgb
        assert len(data.levels) == len(jdata.levels)
        for level, jlevel in zip(data.levels, jdata.levels):
            np.testing.assert_array_equal(level, jlevel)
    with pytest.raises(TypeError):
        flatten_assets(tp.torch_assets("box"), "cpu")


def _module_functions(module) -> dict:
    """The public functions and classes a module defines itself."""
    import inspect

    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_") and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__}


@pytest.mark.parametrize("module", ["native", "ops.reference"])
def test_native_and_oracle_carry_the_jax_names(module):
    """The native runtime and the numpy oracle have every public name of
    their JAX counterparts, with the same parameters."""
    import inspect

    jax_names = _module_functions(importlib.import_module("vktf_tpu." + module))
    port_names = _module_functions(importlib.import_module("vktf_tpu_torch." + module))
    assert set(jax_names) <= set(port_names), sorted(set(jax_names) - set(port_names))
    for name, obj in jax_names.items():
        assert (list(inspect.signature(port_names[name]).parameters)
                == list(inspect.signature(obj).parameters)), name


def test_scene_binning_diagnostics_reports_no_drops():
    """The streaming raster keeps no fixed-capacity lists: the JAX Scene's
    pallas-backend answer, zero drops."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    scene = Scene(tp.torch_assets("box"), RenderConfig(width=32, height=16), device="cpu")
    assert scene.binning_diagnostics() == {"dropped_pairs": 0, "dropped_large": 0}
