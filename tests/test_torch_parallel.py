"""The port's multi-device frame path (vktf_tpu_torch.parallel) on the CPU.

Processes: two spawns through ``parallel.launch.run`` over gloo, one of
four ranks and one of two, render every case once (module fixtures); each
frame must equal the port's single-device frame of the same configuration
bit for bit, as the JAX sharded frame equals the JAX single-chip frame
(tests/test_parallel.py). Cases: the small courtyard (torch_parity) at
256x128, 4x MSAA, on (2, 1), (1, 2), (2, 2), (4, 1) and (1, 4); its blend
variant (K = 8), its mixed-sampler variant, four anisotropic taps and the
attrs boundary on (2, 2); 256x192, whose three tile rows pad to four
bands' worth on (2, 2); the yuv420 x2 preview stream; sample-rate shading
(every sample shaded through the layer record at its global position) on
(2, 2), (4, 1) and (1, 2), blend (K = 8), mixed samplers and four taps on
the two-gather pool on (2, 2), each equal to the single-device
sample-rate frame bit for bit; ``Engine(mesh=)``
against the plain Engine; ``game.main --mesh 2,2`` against ``game.main``
(rank 0's dumped frames).

Without processes: the sort-last merge against a numpy transcription of
vktf_tpu/parallel/tiles.py:316-344 on seeded keys with background and depth
ties, the raster's band offset against the full frame's rows, and the
configurations the path refuses.

The JAX comparisons (merged visibility, frames, the reference's
sample-rate fault) are in test_torch_parallel_jax.py.
"""

import io
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

COURT = "sponza_small"


def _config(**kw):
    from vktf_tpu_torch.config import RenderConfig

    kw.setdefault("width", tp.WIDTH)
    kw.setdefault("height", tp.HEIGHT)
    return RenderConfig(msaa_samples=4, **kw)


# (key, scene name, gp, sp, config overrides) rendered by the four-rank spawn
FOUR_RANK_CASES = [
    ("opaque_2x2", COURT, 2, 2, {}),
    ("opaque_4x1", COURT, 4, 1, {}),
    ("opaque_1x4", COURT, 1, 4, {}),
    ("blend_2x2", COURT + "_blend", 2, 2, {}),
    ("mixed_2x2", COURT + "_mixed", 2, 2, {}),
    ("taps4_2x2", COURT, 2, 2, {"aniso_taps": 4}),
    ("attrs_2x2", COURT, 2, 2, {"shade_attrs_boundary": True}),
    ("uneven_2x2", COURT, 2, 2, {"height": 192}),
    ("preview_2x2", COURT, 2, 2, {"present_format": "yuv420", "present_scale": 2}),
    ("sample_2x2", COURT, 2, 2, {"shading_rate": "sample"}),
    ("sample_4x1", COURT, 4, 1, {"shading_rate": "sample"}),
    ("sample_blend_2x2", COURT + "_blend", 2, 2, {"shading_rate": "sample"}),
    ("sample_mixed_2x2", COURT + "_mixed", 2, 2, {"shading_rate": "sample"}),
    ("sample_taps_classic_2x2", COURT, 2, 2,
     {"shading_rate": "sample", "aniso_taps": 4, "shade_fused_pool": False}),
]
TWO_RANK_CASES = [
    ("opaque_2x1", COURT, 2, 1, {}),
    ("opaque_1x2", COURT, 1, 2, {}),
    ("sample_1x2", COURT, 1, 2, {"shading_rate": "sample"}),
]


def _scene(leaves, meta, overrides, mesh=None):
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    config = _config(**overrides)
    return Scene.from_render_scene(scene_from_numpy(leaves, "cpu"), meta, config,
                                   camera=tp.port_camera(config.width, config.height),
                                   mesh=mesh)


def _render_cases(cases, scenes):
    """On every rank: each case's presented frame (render_async)."""
    from vktf_tpu_torch.parallel import make_render_mesh

    tp.limit_threads()
    return {key: _scene(*scenes[name], overrides, make_render_mesh(gp, sp)).render_async().numpy()
            for key, name, gp, sp, overrides in cases}


def _engine_frames(path, config, mesh=None):
    """Two Engine.render calls and the window's last frame."""
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.window import Window

    window = Window(width=config.width, height=config.height)
    engine = Engine(window, config, Log(io.StringIO(), io.StringIO()), device="cpu", mesh=mesh)
    scene = engine.load([path])
    engine.render(scene)
    engine.render(scene)
    engine.wait_idle()
    return window.last_frame


class _FixedDeltaTime:
    def update(self) -> float:
        return 1.0 / 30.0


def _game_frames(argv, frame_dir):
    """game.main with a fixed frame time; the dumped frames' bytes."""
    import vktf_tpu_torch.engine as engine_mod
    from vktf_tpu_torch.game import main

    engine_mod.DeltaTime = _FixedDeltaTime
    assert main([*argv, "--frame-dir", str(frame_dir)], device="cpu") == 0
    return {p.name: p.read_bytes() for p in sorted(Path(frame_dir).glob("*.png"))}


def _four_ranks(scenes, box_path, engine_config, game_argv, game_dir):
    from vktf_tpu_torch.parallel import make_render_mesh

    out = _render_cases(FOUR_RANK_CASES, scenes)
    out["engine"] = _engine_frames(box_path, engine_config, make_render_mesh(2, 2))
    out["game"] = _game_frames([*game_argv, "--mesh", "2,2"], game_dir)
    return out


def _two_ranks(scenes):
    return _render_cases(TWO_RANK_CASES, scenes)


def _box(directory):
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.1, 0.1, 1.0), metallic_factor=0.0)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=w.add_mesh(box_mesh(), material=mat), translation=(2, 1, 0)),
                 w.add_node(light=light)])
    return str(w.write(Path(directory) / "box.gltf"))


@pytest.fixture(scope="module")
def scenes():
    return {name: tp.torch_leaves(name) for name in {c[1] for c in FOUR_RANK_CASES}}


@pytest.fixture(scope="module")
def rendered(scenes, tmp_path_factory):
    """Every case of both spawns: {key: frame}, the engine's and the
    viewer's output, and the single-device counterparts."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.parallel import launch

    root = tmp_path_factory.mktemp("parallel")
    box = _box(root)
    engine_config = RenderConfig(width=128, height=64, msaa_samples=1, tile_shape=(32, 64))
    game_argv = [box, "--width", "64", "--height", "48", "--msaa", "4", "--frames", "3",
                 "--display", "off"]
    out = launch.run(_four_ranks, 4, scenes, box, engine_config, game_argv,
                     str(root / "mesh_frames"), device="cpu")
    out.update(launch.run(_two_ranks, 2, scenes, device="cpu"))
    out["engine_single"] = _engine_frames(box, engine_config)
    out["game_single"] = _game_frames(game_argv, root / "frames")
    return out


def _single(scenes, name, overrides):
    return _scene(*scenes[name], overrides).render_async().numpy()


@pytest.mark.parametrize("case", FOUR_RANK_CASES + TWO_RANK_CASES, ids=lambda c: c[0])
def test_sharded_frame_equals_single_device(case, scenes, rendered):
    key, name, gp, sp, overrides = case
    got = rendered[key]
    want = _single(scenes, name, overrides)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if "present_format" not in overrides:
        lit = (got.max(axis=0) > 0).mean()
        assert lit > 0.5, lit


def test_engine_mesh_renders_the_plain_engine_s_pixels(rendered):
    """Engine(mesh=) routes its scenes through the sharded program (the
    counterpart of tests/test_engine.py's sharded test)."""
    got, want = rendered["engine"], rendered["engine_single"]
    assert got is not None and got.shape == (64, 128, 4)
    np.testing.assert_array_equal(got, want)
    assert (got[..., :3].max(axis=-1) > 0).mean() > 0.05


def test_game_mesh_dumps_the_single_device_frames(rendered):
    """game.main --mesh 2,2 on four ranks: rank 0's dumped frames are the
    one-device viewer's, byte for byte (the ranks follow rank 0's camera
    and end of loop)."""
    got, want = rendered["game"], rendered["game_single"]
    assert len(want) == 5 and list(got) == list(want)
    assert got == want


# ---------------------------------------------------------------------------
# without processes
# ---------------------------------------------------------------------------


def _jax_merge(depth, ids):
    """numpy transcription of vktf_tpu/parallel/tiles.py:316-344: depth,
    ids (gp, K, N) sorted per rank -> (K, N) each."""
    imax = np.int32(2 ** 31 - 1)

    def lexmin(d, i):
        gd = d.min(axis=0)
        gi = np.where(d == gd, i, imax).min(axis=0)
        return gd, gi

    gp, layers, n = ids.shape
    if layers == 1:
        gd, gi = lexmin(depth[:, 0], ids[:, 0])
        return gd[None], gi[None]
    ptr = np.zeros((gp, n), np.int64)
    cols = np.arange(n)
    out_d, out_i = [], []
    for _ in range(layers):
        head_d = np.stack([depth[g, np.minimum(ptr[g], layers - 1), cols] for g in range(gp)])
        head_i = np.stack([ids[g, np.minimum(ptr[g], layers - 1), cols] for g in range(gp)])
        gd, gi = lexmin(head_d, head_i)
        ptr += (head_d == gd) & (head_i == gi)
        out_d.append(gd)
        out_i.append(gi)
    return np.stack(out_d), np.stack(out_i)


def _seeded_lists(gp, layers, n, seed):
    """Per rank and sample, a sorted list of K (depth, id) entries: 0..K
    real fragments (ids of the rank's own block, depths from a few values
    so ranks tie on depth), then the background (1.0, -1)."""
    rng = np.random.default_rng(seed)
    depth = np.ones((gp, layers, n), np.float32)
    ids = np.full((gp, layers, n), -1, np.int32)
    levels = np.asarray([0.125, 0.25, 0.5, 0.75, 0.999], np.float32)
    for g in range(gp):
        for c in range(n):
            k = rng.integers(0, layers + 1)
            d = rng.choice(levels, size=k)
            i = g * 1000 + rng.choice(1000, size=k, replace=False)
            order = np.lexsort((i, d))
            depth[g, :k, c], ids[g, :k, c] = d[order], i[order]
    return depth, ids


@pytest.mark.parametrize("gp, layers", [(2, 1), (4, 1), (2, 3), (4, 8)])
def test_merge_keys_is_the_jax_head_merge(gp, layers):
    from vktf_tpu_torch.parallel import merge_keys, pack_keys, unpack_keys

    depth, ids = _seeded_lists(gp, layers, 512, seed=gp * 10 + layers)
    want_d, want_i = _jax_merge(depth, ids)
    keys = pack_keys(torch.from_numpy(ids), torch.from_numpy(depth))
    got_i, got_d = unpack_keys(merge_keys(keys if layers > 1 else keys[:, 0], layers))
    got_i, got_d = got_i.numpy().reshape(layers, -1), got_d.numpy().reshape(layers, -1)
    np.testing.assert_array_equal(got_i, want_i)
    tp.assert_bits_equal(got_d, want_d, "merged depth")
    assert (want_i == -1).any() and (want_i >= 0).any()
    # the keys round-trip, and order (depth, id) with the background last
    back_i, back_d = unpack_keys(keys)
    np.testing.assert_array_equal(back_i.numpy(), ids)
    tp.assert_bits_equal(back_d.numpy(), depth, "unpacked depth")


@pytest.mark.parametrize("layers", [1, 3])
def test_band_raster_equals_the_full_frame_rows(layers):
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel

    scene = _scene(*tp.torch_leaves(COURT + "_blend"), {})
    rs = scene.render_scene
    vp = torch.as_tensor(np.asarray(scene.camera.view_projection_transform, np.float32))
    inst_rows, tri_instance, _lights = pipeline.scene_update(rs, scene.meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, tp.WIDTH,
                                    tp.HEIGHT)
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"],
                                  raster.stream_perm(setup["bbox_rows"], setup["valid"]))
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, layers)
    for y0, rows in ((0, 64), (64, 64), (16, 48), (96, 64)):
        band_ids, band_depth = raster.rasterize(*stream, rows, tp.WIDTH, 4, layers,
                                                y_offset=y0)
        want_rows = slice(y0, min(y0 + rows, tp.HEIGHT))
        n = want_rows.stop - want_rows.start
        np.testing.assert_array_equal(band_ids[..., :n, :], ids[..., want_rows, :])
        tp.assert_bits_equal(band_depth[..., :n, :], depth[..., want_rows, :],
                             f"band depth at {y0}")
        # rows past the frame are empty: no bbox reaches them
        assert (band_ids[..., n:, :] == -1).all()
    assert (ids[0] if layers > 1 else ids).ge(0).float().mean() > 0.5
    with pytest.raises(ValueError, match="y_offset"):
        raster.rasterize(*stream, 64, tp.WIDTH, 4, layers, y_offset=8)


def test_refusals():
    """Band pixels that gp does not divide and a mesh that is not the
    process group's size raise ValueError; a mesh outside an initialised
    process group raises RuntimeError."""
    import torch.distributed as dist

    from vktf_tpu_torch.parallel import RenderMesh, ShardedFrameProgram, make_render_mesh

    _leaves, meta = tp.torch_leaves(COURT)
    for rate in ("pixel", "sample"):
        with pytest.raises(ValueError, match="not divisible by gp=3"):
            ShardedFrameProgram(meta, _config(shading_rate=rate),
                                RenderMesh(3, 1, "gloo", 0, None, None, None))
    with pytest.raises(RuntimeError, match="initialised default process group"):
        make_render_mesh(1, 1)
    with tempfile.TemporaryDirectory() as rendezvous:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}/store", rank=0,
                                world_size=1)
        try:
            with pytest.raises(ValueError, match=r"gp\*sp = 2\*2 != 1"):
                make_render_mesh(2, 2)
            mesh = make_render_mesh(1, 1)
            assert (mesh.shape, mesh.gp_rank, mesh.sp_rank, str(mesh)) == (
                (1, 1), 0, 0, "gp1x sp1")
        finally:
            dist.destroy_process_group()


def test_game_mesh_without_a_launcher_names_torchrun(tmp_path, capsys):
    """A mesh of several ranks outside torchrun ends main with 1 before
    anything renders; no re-exec, no fallback to one rank."""
    from vktf_tpu_torch.game import main

    frames = tmp_path / "frames"
    rc = main([_box(tmp_path), "--width", "64", "--height", "48", "--frames", "1",
               "--display", "off", "--frame-dir", str(frames), "--mesh", "2,1"], device="cpu")
    assert rc == 1
    assert "torchrun" in capsys.readouterr().err
    assert not frames.exists()


def test_run_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """launch.run's ranks run on the card by default; with no card it
    raises before it spawns anything, naming device="cpu"."""
    from vktf_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.multiprocessing, "spawn", lambda *a, **k: pytest.fail("spawned"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        launch.run(_two_ranks, 2, {})
