"""The port's paths on the card: frames through Scene, Engine, the viewer
and the mesh, held to the CPU's plain versions, to each other, to float64
and to the numpy oracle, with the kernel records each path launches.

Marked ``cuda`` and skipped where there is no CUDA device; the two-card
and four-card cases skip where the machine has fewer cards. On a machine
with a card and nvcc (it needs no jax; this directory's conftest.py does,
so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda*.py

The kernels against their plain versions at the stage level are
test_torch_cuda.py's. Inputs here are the small sponza courtyard at
256x128 4x MSAA (tests/torch_parity.py) in every shade form, the presets
at bench_torch.py's MSAA and cameras, tests/test_alpha.py's fixtures
(tests/torch_card.py) and, where only the full frame shows a check, the
sponza preset at 1920x1080 4x MSAA (the covered samples' depth, the
forced second layer, the frame composed stage by stage, the exported
files, and its opaque, translucent and mixed forms on the mesh at pixel
and sample rate).
"""

import functools
import struct
import sys

import numpy as np
import pytest
import torch

import torch_card as tc
import torch_parity as tp
from torch_card import dev  # noqa: F401 (the card fixture)

pytestmark = pytest.mark.cuda

FULL = (1920, 1080)
# forced peel_layers=2 on an opaque scene against its K = 1 frame: the
# composite returns an opaque layer 0 exactly, but the K = 1 path encodes
# sRGB inside the shade kernel (powf) and the K-layer path in torch
# (torch.pow), whose last bits may differ: one u8 step on <= 1e-4 pixels
FORCED_K2_MISMATCH = 1e-4
SAMPLE = {"shading_rate": "sample"}


def _records():
    from vktf_tpu_torch.ops import raster, setup_kernel, shade_kernel, shade_table

    return [setup_kernel.KERNEL, raster.KERNEL_STREAM, raster.KERNEL, raster.KERNEL_GROUPS,
            raster.KERNEL_LAYERS, shade_table.KERNEL, *shade_kernel.KERNELS]


def _launches(fn) -> dict:
    """{record: launches} of the kernel records fn() launched on the card
    (every counter zeroed before, read after a synchronize)."""
    records = _records()
    for k in records:
        k.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k.name: k.launches for k in records if k.launches}


def _frame_records(layers: int, shade: str) -> tuple:
    """The records a one-device frame launches once each."""
    return ("setup", "raster_stream", "raster" if layers == 1 else "raster_layers",
            "raster_groups", "shade_table", shade)


def _assets(name: str):
    """A small courtyard variant (tp.torch_assets), or the sponza preset
    under the same suffixes: "sponza", "sponza_blend", "sponza_mixed"."""
    from vktf_tpu_torch.models.scenes import (SAMPLER_PRESETS, build_preset, set_blend,
                                              set_samplers)

    if name.startswith("sponza_small"):
        return tp.torch_assets(name)
    assets = build_preset("sponza")
    for variant in name.split("_")[1:]:
        if variant == "blend":
            set_blend(assets)
        else:
            set_samplers(assets, **SAMPLER_PRESETS[variant])
    return assets


def _size(name: str) -> tuple:
    """A courtyard variant's frame is 256x128, the sponza preset's 1920x1080."""
    return (tp.WIDTH, tp.HEIGHT) if name.startswith("sponza_small") else FULL


@functools.lru_cache(maxsize=None)
def _base(name: str, device: str):
    """The scene `name` (_assets) on `device` at its _size, 4x MSAA, the
    courtyard's camera."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    width, height = _size(name)
    return Scene(_assets(name), RenderConfig(width=width, height=height, msaa_samples=4),
                 camera=tp.port_camera(width, height), device=device)


def _scene(device, name: str, **kw):
    """_base's scene under its configuration with kw replaced."""
    from vktf_tpu_torch.scene.scene import Scene

    base = _base(name, str(device))
    return Scene.from_render_scene(base.render_scene, base.meta, base.config.replace(**kw),
                                   base.camera)


def _lit(frame) -> float:
    """Share of a (3, H, W) frame's pixels that differ from the clear colour."""
    return float((frame.max(axis=0) > 0).mean())


# (courtyard variant, config overrides, the shade record its frame launches)
FORMS = [
    ("sponza_small", {}, "shade"),
    ("sponza_small", {"aniso_taps": 4}, "shade_taps"),
    ("sponza_small", {"shade_fused_pool": False}, "shade_classic"),
    ("sponza_small", {"shade_attrs_boundary": True}, "shade_attrs"),
    ("sponza_small", {"shade_attrs_boundary": True, "aniso_taps": 4}, "shade_classic_taps"),
    ("sponza_small_mirror", {}, "shade_classic"),
    ("sponza_small_mixed", {}, "shade_per_slot"),
    ("sponza_small_mixed", {"aniso_taps": 4}, "shade_per_slot_taps"),
    ("sponza_small_blend", {}, "shade_layer"),
    ("sponza_small_blend", {"aniso_taps": 4}, "shade_layer_taps"),
    ("sponza_small_blend", {"shade_fused_pool": False}, "shade_layer_classic"),
    ("sponza_small_blend", {"shade_attrs_boundary": True}, "shade_attrs_layer"),
    ("sponza_small_blend", {"shade_fused_pool": False, "aniso_taps": 4},
     "shade_layer_classic_taps"),
    ("sponza_small_blend_mixed", {}, "shade_layer_per_slot"),
    ("sponza_small_blend_mixed", {"aniso_taps": 4}, "shade_layer_per_slot_taps"),
    ("sponza_small", SAMPLE, "shade_layer"),
    ("sponza_small_blend", SAMPLE, "shade_layer"),
    ("sponza_small", {"present_format": "yuv420"}, "shade"),
    ("sponza_small", {"present_scale": 2}, "shade"),
    ("sponza_small", {"present_format": "yuv420", "present_scale": 2}, "shade"),
    ("sponza_small", {"present_format": "yuv420", "present_scale": 4}, "shade"),
]


def _form_id(name: str, kw: dict) -> str:
    return "-".join([name] + [f"{k}={v}" for k, v in kw.items()])


@pytest.mark.parametrize("name, kw, shade", FORMS, ids=[_form_id(n, kw) for n, kw, _ in FORMS])
def test_a_frame_launches_each_of_its_records_once(dev, name, kw, shade):
    """Every form of the frame on the card: setup, the raster prologue, the
    raster of its K with the group level of its cull, the shade table and
    the shade record of its form, once a frame each, and no other record
    (the translucent variants at K = 8)."""
    scene = _scene(dev, name, **kw)
    layers = scene.frame_program.layers
    assert layers == (8 if "blend" in name else 1)
    scene.render_async()
    got = _launches(lambda: [scene.render_async() for _ in range(3)])
    assert got == {record: 3 for record in _frame_records(layers, shade)}


# pixel-rate forms (courtyard variant, overrides); the sample-rate frames are
# test_torch_cuda.py's test_sample_rate_frame_on_the_card_matches_the_cpu
SMALL_FRAMES = [
    ("sponza_small", {}), ("sponza_small_blend", {}), ("sponza_small", {"aniso_taps": 4}),
    ("sponza_small_blend", {"aniso_taps": 2}), ("sponza_small", {"shade_fused_pool": False}),
    ("sponza_small", {"shade_attrs_boundary": True}),
    ("sponza_small_blend", {"shade_attrs_boundary": True}),
    ("sponza_small_mirror", {"aniso_taps": 2}), ("sponza_small_mixed", {}),
    ("sponza_small_blend_mixed", {}), ("sponza_small_mixed", {"aniso_taps": 2}),
    ("sponza_small_blend", {"shade_fused_pool": False, "aniso_taps": 2}),
    ("sponza_small_blend_mixed", {"aniso_taps": 2}),
]


@pytest.mark.parametrize("name, kw", SMALL_FRAMES,
                         ids=[_form_id(n, kw) for n, kw in SMALL_FRAMES])
def test_small_frame_on_the_card_matches_the_cpu(dev, name, kw):
    """Each form's 256x128 frame on the card against the CPU's plain
    versions, within FRAME_MISMATCH."""
    got = _scene(dev, name, **kw).render_still()
    want = _scene("cpu", name, **kw).render_still()
    assert got.shape == want.shape == (3, tp.HEIGHT, tp.WIDTH) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want).max(axis=0)
    assert _lit(want) > 0.5
    assert diff.max() <= 1 and (diff > 0).mean() <= tc.FRAME_MISMATCH, (
        int(diff.max()), float((diff > 0).mean()))


@pytest.mark.parametrize("name, base, other", [
    ("sponza_small", {}, {"shade_fused_pool": False}),
    ("sponza_small", {"shade_fused_pool": False}, {"shade_attrs_boundary": True}),
    ("sponza_small", {"aniso_taps": 4}, {"shade_attrs_boundary": True, "aniso_taps": 4}),
    ("sponza_small_blend", {"shade_fused_pool": False}, {"shade_attrs_boundary": True}),
    ("sponza_small_blend", {"aniso_taps": 4}, {"shade_fused_pool": False, "aniso_taps": 4}),
], ids=["classic-fused", "attrs-classic", "attrs_taps4-fused_taps4",
        "blend-attrs-classic", "blend-classic_taps4-fused_taps4"])
def test_two_texel_sources_render_the_same_frame_on_the_card(dev, name, base, other):
    """Where every uv of the courtyard lies in [0, 1], the two-gather pool
    renders the fused pool's frame, and the attrs boundary (the classic
    kernel with taps) renders the two-gather frame, on every pixel, at
    K = 1 and K = 8."""
    want = _scene(dev, name, **base).render_still()
    assert _lit(want) > 0.5
    np.testing.assert_array_equal(_scene(dev, name, **other).render_still(), want)


def test_four_taps_change_the_frame_on_the_card(dev):
    one = _scene(dev, "sponza_small").render_still()
    four = _scene(dev, "sponza_small", aniso_taps=4).render_still()
    assert (one != four).any(axis=0).mean() > 0.01


@pytest.mark.parametrize("name", ["sponza_small", "sponza"])
def test_forced_two_layers_equal_the_one_layer_frame(dev, name):
    """The opaque scene at a forced peel_layers=2 against its K = 1 frame
    (the courtyard and the 1080p sponza): one u8 step on at most
    FORCED_K2_MISMATCH of the pixels."""
    forced = _scene(dev, name, peel_layers=2)
    assert forced.frame_program.layers == 2
    diff = np.abs(forced.render_still().astype(np.int16)
                  - _scene(dev, name).render_still()).max(axis=0)
    assert diff.max() <= 1 and (diff > 0).mean() <= FORCED_K2_MISMATCH, (
        int(diff.max()), int((diff > 0).sum()))


@pytest.mark.parametrize("name", ["sponza_small", "sponza_small_blend", "sponza"])
def test_the_frame_is_its_stages_composed(dev, name):
    """Scene's frame on the card equals, bit for bit, the stages driven by
    hand (setup, stream, the raster's planes and pixel_winner, shade table,
    the shade kernel of the form, at K > 1 the composite) and encoded. In
    the translucent courtyard at least 5% of the pixels' nearest surface is
    translucent."""
    from vktf_tpu_torch.ops import pipeline, present, shade_kernel

    scene = _scene(dev, name)
    cfg = scene.config
    st = tp.port_stages(scene)
    if scene.frame_program.layers == 1:
        packed = shade_kernel.shade_resolve(st["tri"], st["sx"], st["sy"], st["frac"],
                                            st["table"], st["pool"], st["cam"], st["lights"],
                                            st["bg"], cfg.max_anisotropy)
    else:
        front = st["tri"][0].reshape(cfg.padded_height, cfg.padded_width)
        front = front[:cfg.height, :cfg.width]
        alpha_mode = scene.render_scene.tri_static_cols[13]
        translucent = (front >= 0) & (alpha_mode[front.clamp(min=0)] != 0)
        assert float(translucent.float().mean()) >= 0.05
        rgb, alpha = shade_kernel.shade_layer(st["tri"], st["sx"], st["sy"], st["table"],
                                              st["pool"], st["cam"], st["lights"],
                                              cfg.max_anisotropy)
        packed = pipeline.composite_resolve(rgb, alpha, st["frac"], st["bg"])
    np.testing.assert_array_equal(present.encode_rgb(packed, cfg).cpu().numpy(),
                                  scene.render_still())


@pytest.mark.parametrize("name", ["sponza_small", "sponza"])
def test_covered_sample_depth_on_the_card_within_the_float64_bound(dev, name):
    """The setup and raster kernels' depth at every covered sample (the
    courtyard and the 1080p sponza) against the float64 depth of its
    triangle through the same float32 clip corners, within
    tp.float64_depth_bound."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel
    from vktf_tpu_torch.ops.setup_kernel import instance_rowsT
    from vktf_tpu_torch.ops.vertex import clip_corners, setup_from_corners

    scene = _scene(dev, name)
    rs, cfg = scene.render_scene, scene.config
    width, height, msaa = cfg.width, cfg.height, cfg.msaa_samples
    vp = torch.as_tensor(np.asarray(scene.camera.view_projection_transform, np.float32),
                         device=dev)
    inst_rows, tri_instance, _lights = pipeline.scene_update(rs, scene.meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, width, height)
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"],
                                  raster.stream_perm(setup["bbox_rows"], setup["valid"]))
    ids, depth = raster.rasterize(*stream, cfg.padded_height, cfg.padded_width, msaa)
    ids = ids[:, :height, :width].cpu().numpy()
    depth = depth[:, :height, :width].cpu().numpy()
    corners = clip_corners(rs.tri_corner, instance_rowsT(inst_rows, tri_instance), vp)
    flat = setup_from_corners(*corners, width, height)
    x, y, z, w = ([c.double().cpu().numpy() for c in row] for row in corners)
    co, cond = tp.float64_depth_planes(x, y, z, w, width, height)
    bound = tp.float64_depth_bound(co, cond, ~flat["use_screen"].cpu().numpy(),
                                   setup["edge9"].cpu().numpy(),
                                   setup["bbox_rows"].cpu().numpy(),
                                   flat["inv_det"].cpu().numpy(), z, w)
    s, py, px = np.nonzero(ids >= 0)
    assert s.size > 0.5 * ids.size
    tri = ids[s, py, px]
    offsets = np.asarray(SAMPLE_OFFSETS[msaa], np.float64)[s]
    exact = co[tri, 0] * (px + offsets[:, 0]) + co[tri, 1] * (py + offsets[:, 1]) + co[tri, 2]
    ratio = np.abs(depth[s, py, px].astype(np.float64) - exact) / bound[tri]
    assert ratio.max() <= 1.0, float(ratio.max())


# bench_torch.py's presets and MSAA at 256x128 (its cameras, aspect 2)
PRESETS = {"box": 1, "duck": 1, "helmet": 4, "flythrough": 4}


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_preset_on_the_card_launches_once_and_matches_the_cpu(dev, preset):
    """Each preset bench_torch.py measures: its frame launches setup, the
    prologue, raster and its group level, shade table and shade once each
    and nothing else,
    and equals the CPU's within FRAME_MISMATCH."""
    import bench_torch
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.scene.scene import Scene

    assets = build_preset(preset)
    config = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=PRESETS[preset])
    camera = Camera(*bench_torch.CAMERAS[preset],
                    ViewFrustumParams(np.radians(45.0), tp.WIDTH / tp.HEIGHT, 0.1, 1.0e6))
    card = Scene(assets, config, camera=camera, device=dev)
    card.render_async()
    got = _launches(lambda: [card.render_async() for _ in range(2)])
    assert got == {record: 2 for record in _frame_records(1, "shade")}
    want = Scene(assets, config, camera=camera, device="cpu").render_still()
    diff = np.abs(card.render_still().astype(np.int16) - want).max(axis=0)
    assert _lit(want) > 0.05
    assert diff.max() <= 1 and (diff > 0).mean() <= tc.FRAME_MISMATCH


@pytest.mark.parametrize("compression", ["zlib", "zstd"])
@pytest.mark.parametrize("name", ["sponza_small", "sponza"])
def test_exported_files_render_the_in_memory_frame(dev, name, compression, tmp_path,
                                                   monkeypatch):
    """The scene exported (RGBA8 KTX2 under ZLIB, or under ZSTD through the
    native runtime's libzstd with zstandard hidden, as on a machine without
    it) and loaded by Engine.load renders the in-memory scene's frame bit
    for bit, launching the one-layer records once."""
    from vktf_tpu_torch import native
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB, SUPERCOMPRESSION_ZSTD
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.window import Window

    monkeypatch.setitem(sys.modules, "zstandard", None)
    assert native.available()
    scheme = {"zlib": SUPERCOMPRESSION_ZLIB, "zstd": SUPERCOMPRESSION_ZSTD}[compression]
    in_memory = _base(name, str(dev))
    files = [export_asset(a, tmp_path, "rgba", tc.quiet_log(), scheme) for a in _assets(name)]
    assert {struct.unpack_from("<I", f.read_bytes(), 44)[0]
            for f in tmp_path.glob("*.ktx2")} == {scheme}
    cfg = in_memory.config
    engine = Engine(Window(width=cfg.width, height=cfg.height), cfg, tc.quiet_log(), device=dev)
    loaded = engine.load(files)
    assert loaded.meta == in_memory.meta
    loaded.camera = in_memory.camera
    frames = []
    got = _launches(lambda: frames.append(loaded.render_still()))
    assert got == {record: 1 for record in _frame_records(1, "shade")}
    np.testing.assert_array_equal(frames[0], in_memory.render_still())


def test_the_box_exported_as_basis_loads_on_the_card(dev, tmp_path):
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.models.export import export_preset
    from vktf_tpu_torch.window import Window

    files = export_preset("box", tmp_path, "basis", tc.quiet_log())
    config = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4)
    engine = Engine(Window(width=tp.WIDTH, height=tp.HEIGHT), config, tc.quiet_log(), device=dev)
    box = engine.load(files)
    assert box.light_count == 1 and box.meta.num_triangles == 12
    assert box.render_still().shape == (3, tp.HEIGHT, tp.WIDTH)


def test_viewer_launches_once_a_presented_frame_and_dumps_it(dev, tmp_path, monkeypatch):
    """game.main on the courtyard's files: the one-layer records once per
    presented frame and nothing else; each --frame-dir PNG decodes to the
    frame the window was given; the frames are lit."""
    from vktf_tpu_torch import game
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.window import Window

    files = [export_asset(a, tmp_path / "files", "rgba", tc.quiet_log(), SUPERCOMPRESSION_ZLIB)
             for a in tp.torch_assets("sponza_small")]
    presented = []
    present = Window.present

    def recording_present(self, frame):
        present(self, frame)
        presented.append(self.last_frame.copy())

    monkeypatch.setattr(Window, "present", recording_present)
    argv = [*map(str, files), "--width", str(tp.WIDTH), "--height", str(tp.HEIGHT), "--msaa",
            "4", "--frames", "6", "--display", "off", "--frame-dir", str(tmp_path / "dump")]
    codes = []
    got = _launches(lambda: codes.append(game.main(argv)))
    assert codes == [0]
    assert got == {record: len(presented) for record in _frame_records(1, "shade")}
    pngs = sorted((tmp_path / "dump").glob("frame_*.png"))
    assert len(pngs) == len(presented) == 7
    for png, frame in zip(pngs, presented):
        np.testing.assert_array_equal(tc.read_png(png), frame)
    assert (presented[-1][..., :3] > 0).any(axis=-1).mean() >= 0.5


@pytest.mark.parametrize("tag, fixture, msaa", tc.ORACLE_FIXTURES,
                         ids=[tag for tag, _, _ in tc.ORACLE_FIXTURES])
def test_alpha_fixture_on_the_card_matches_the_oracle(dev, tag, fixture, msaa, tmp_path):
    """tests/test_alpha.py's fixtures through the kernels (every sample
    shaded, as the oracle does) against the port's numpy oracle, within
    assert_images_close's default budget."""
    from vktf_tpu_torch.config import SAMPLE_OFFSETS, RenderConfig
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.ops.reference import reference_scene, render_reference
    from vktf_tpu_torch.scene.scene import Scene

    width, height = tc.ORACLE_SIZE
    camera = Camera(*tc.ORACLE_CAMERA, ViewFrustumParams(np.radians(45.0), width / height,
                                                         0.1, 100.0))
    path = fixture(tmp_path)
    config = RenderConfig(width=width, height=height, msaa_samples=msaa, shading_rate="sample")
    scene = Scene([load_gltf(path)], config, camera=camera, device=dev)
    frames = []
    launched = _launches(lambda: frames.append(np.moveaxis(scene.render_still(), 0, -1)))
    ref = reference_scene([load_gltf(path)])
    expected = render_reference(ref, camera.view_projection_transform, camera.position,
                                width, height, SAMPLE_OFFSETS[msaa],
                                max_anisotropy=config.max_anisotropy,
                                peel_layers=max(ref.meta.peel_layers, 2))
    assert (expected[..., :3].max(axis=-1) > 0).mean() > 0.2
    raster = "raster" if scene.frame_program.layers == 1 else "raster_layers"
    assert launched == {r: 1 for r in ("setup", "raster_stream", raster, "raster_groups",
                                       "shade_table", "shade_layer")}
    mean, outliers = tc.image_difference(frames[0], expected)
    assert mean <= tc.ORACLE_MAX_MEAN and outliers <= tc.ORACLE_MAX_OUTLIERS, (mean, outliers)


def test_bench_torch_measures_the_card(dev):
    import bench_torch

    stats = bench_torch.run_bench("box", 192, 96, 1, frames=2)
    assert stats["platform"] == "cuda" and stats["fps"] > 0 and "preview_fps" in stats


def test_nccl_mesh_of_one_rank_renders_the_single_device_frame(dev):
    """NCCL at world size 1 in this process: the (1, 1) mesh's frame equals
    the one-device frame bit for bit, through the one-layer records."""
    from vktf_tpu_torch.parallel import launch
    from vktf_tpu_torch.scene.scene import Scene

    base = _base("sponza_small", str(dev))
    frames = []
    with launch.launcher_mesh(1, 1, "cuda") as (mesh, _device):
        assert mesh.backend == "nccl"
        scene = Scene.from_render_scene(base.render_scene, base.meta, base.config, base.camera,
                                        mesh=mesh)
        got = _launches(lambda: frames.append(scene.render_still()))
    assert set(got) == set(_frame_records(1, "shade"))
    np.testing.assert_array_equal(frames[0], base.render_still())


# (tag, scene, gp, sp, config overrides): the courtyard at 256x128, and the
# sponza preset at 1920x1080 (whose bands and merge only a full frame shows)
MESH_CASES = [(prefix + tag, name + suffix, gp, sp, kw)
              for prefix, name in (("", "sponza_small"), ("sponza_", "sponza"))
              for tag, suffix, gp, sp, kw in (
                  ("opaque_2x2", "", 2, 2, {}), ("opaque_4x1", "", 4, 1, {}),
                  ("opaque_1x4", "", 1, 4, {}), ("translucent_2x2", "_blend", 2, 2, {}),
                  ("mixed_2x2", "_mixed", 2, 2, {}), ("sample_2x2", "", 2, 2, SAMPLE),
                  ("sample_translucent_2x2", "_blend", 2, 2, SAMPLE),
                  ("sample_mixed_2x2", "_mixed", 2, 2, SAMPLE))]


@functools.lru_cache(maxsize=None)
def _leaves(name: str):
    """(leaves as numpy arrays, SceneMeta) of the scene `name`."""
    from vktf_tpu_torch.scene.flatten import flatten_assets_numpy

    return flatten_assets_numpy(_assets(name))


def _mesh_ranks() -> dict:
    """On every rank of a 4-rank group: each of MESH_CASES' frames on the
    rank's card and the records every rank launched over two frames;
    {tag: (frame, [launches of each rank])}."""
    import torch.distributed as dist

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.parallel import make_render_mesh
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for tag, name, gp, sp, kw in MESH_CASES:
        arrays, meta = _leaves(name)
        width, height = _size(name)
        config = RenderConfig(width=width, height=height, msaa_samples=4, **kw)
        scene = Scene.from_render_scene(scene_from_numpy(arrays, dev), meta, config,
                                        tp.port_camera(width, height),
                                        mesh=make_render_mesh(gp, sp))
        scene.render_async()
        launched = _launches(lambda: [scene.render_async() for _ in range(2)])
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, launched)
        out[tag] = (scene.render_still(), every)
        del scene
        torch.cuda.empty_cache()
    return out


def _mesh_frames(backend: str) -> dict:
    from vktf_tpu_torch.parallel import launch

    return launch.run(_mesh_ranks, 4, device="cuda", backend=backend, timeout_s=600)


def _assert_mesh_case(dev, frames: dict, case) -> None:
    """The case's frame equals the one-device frame at its rate bit for
    bit, and every rank launched setup, the prologue, a raster with the
    group level of its cull, the shade table and a shade record twice (at
    sample rate a layer record)."""
    tag, name, _gp, _sp, kw = case
    frame, every = frames[tag]
    np.testing.assert_array_equal(frame, _scene(dev, name, **kw).render_still())
    for launched in every:
        assert len(launched) == 6 and set(launched.values()) == {2}, launched
        shade = [r for r in launched if r.startswith("shade") and r != "shade_table"]
        assert len(shade) == 1
        if kw:
            assert shade[0].startswith("shade_layer"), launched


@pytest.fixture(scope="module")
def gloo_frames(dev):
    return _mesh_frames("gloo")


@pytest.fixture(scope="module")
def nccl_frames(dev):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four cards, one a rank; this machine has "
                    f"{torch.cuda.device_count()}")
    return _mesh_frames("nccl")


@pytest.mark.parametrize("case", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_mesh_frame_of_four_ranks_sharing_the_card_over_gloo(dev, gloo_frames, case):
    _assert_mesh_case(dev, gloo_frames, case)


@pytest.mark.parametrize("case", MESH_CASES, ids=[c[0] for c in MESH_CASES])
def test_mesh_frame_on_four_cards_over_nccl(dev, nccl_frames, case):
    _assert_mesh_case(dev, nccl_frames, case)


def test_launch_on_a_card_that_is_not_the_current_one(dev, tmp_path):
    """A Scene on cuda:1 while card 0 is current renders on cuda:1, leaves
    card 0 current and gives card 0's frame; an Engine made after
    torch.cuda.set_device(1) takes cuda:1 and presents the same frame."""
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.scene.scene import Scene
    from vktf_tpu_torch.window import Window

    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards; this machine has {torch.cuda.device_count()}")
    base = _base("sponza_small", str(dev))
    want = base.render_still()
    torch.cuda.set_device(0)
    other = Scene(tp.torch_assets("sponza_small"), base.config, camera=base.camera,
                  device="cuda:1")
    frames = [other.render_async() for _ in range(4)]
    assert torch.cuda.current_device() == 0
    for frame in frames:
        assert frame.device == torch.device("cuda", 1)
        np.testing.assert_array_equal(frame.cpu().numpy(), want)
    files = [export_asset(a, tmp_path, "rgba", tc.quiet_log(), SUPERCOMPRESSION_ZLIB)
             for a in tp.torch_assets("sponza_small")]
    torch.cuda.set_device(1)
    try:
        engine = Engine(Window(width=tp.WIDTH, height=tp.HEIGHT), base.config, tc.quiet_log())
        assert engine.device == torch.device("cuda", 1)
        loaded = engine.load(files)
        loaded.camera = base.camera
        for _ in range(3):
            engine.render(loaded)
        engine.wait_idle()
        np.testing.assert_array_equal(
            np.moveaxis(engine.window.last_frame[..., :3], -1, 0), want)
    finally:
        torch.cuda.set_device(0)
