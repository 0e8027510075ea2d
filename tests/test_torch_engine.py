"""The port's viewer layer on the CPU: Log, utils, Window, X11 helpers,
Engine, game, the frame-program registry and the Scene signature.

Mirrors tests/test_engine.py (its sharded test is in
test_torch_parallel.py, with the multi-device path), tests/test_log.py and tests/test_x11.py against the
port's modules, on glTF files written in ``tmp_path`` by the JAX package's
GltfWriter, rendering with ``device="cpu"`` (the kernels' plain versions).
Also: the Scene signature of the JAX package (``Scene(assets, config,
log)``, ``light_count``), scenes sharing one program, the viewer options
the port refuses, and the PNG frame dump read back with PIL.
"""

import io
import re
import threading

import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()


def quiet_log():
    from vktf_tpu_torch.log import Log

    return Log(out_stream=io.StringIO(), err_stream=io.StringIO())


def write_box(tmp_path, name="box.gltf"):
    from vktf_tpu.models.gltf_writer import GltfWriter
    from vktf_tpu.models.primitives import box_mesh

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.1, 0.1, 1.0), metallic_factor=0.0)
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(2, 1, 0)), w.add_node(light=light)])
    return w.write(tmp_path / name)


def small_config(msaa_samples=1, **kw):
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(width=64, height=48, msaa_samples=msaa_samples, tile_shape=(16, 64),
                        **kw)


def cpu_engine(window=None, config=None, log=None):
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.window import Window

    return Engine(window or Window(width=64, height=48), config or small_config(),
                  log=log or quiet_log(), device="cpu")


def _camera():
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams

    return Camera((0.0, 1.0, 0.0), (1.0, 0.0, 0.0),
                  ViewFrustumParams(np.radians(45), 4 / 3, 0.1, 1e6))


# ---------------------------------------------------------------------------
# tests/test_engine.py, on the port
# ---------------------------------------------------------------------------


class TestWindow:
    def test_key_events_and_listeners(self):
        from vktf_tpu_torch.window import Window

        window = Window(width=64, height=48)
        events = []
        window.add_key_event_listener(lambda e: events.append((e.key, e.action)))
        window.press_key("w")
        assert window.is_key_pressed("w")
        window.release_key("w")
        assert not window.is_key_pressed("w")
        assert events == [("w", "press"), ("w", "release")]

    def test_escape_closes_via_game_listener(self):
        from vktf_tpu_torch.game import create_window
        from vktf_tpu_torch.window import KEY_ESCAPE

        window = create_window(64, 48, display=None)
        assert not window.is_closed()
        window.press_key(KEY_ESCAPE)
        assert window.is_closed()

    def test_script_closes_at_end(self):
        from vktf_tpu_torch.window import ScriptedInput, Window

        window = Window(width=8, height=8)
        window.attach_script(ScriptedInput([None, None]))
        window.update()
        window.update()
        assert not window.is_closed()
        window.update()
        assert window.is_closed()


class TestEngineLoad:
    def test_filters_bad_extension_with_log(self, tmp_path):
        from vktf_tpu_torch.log import Log

        err = io.StringIO()
        engine = cpu_engine(log=Log(out_stream=io.StringIO(), err_stream=err))
        bad = tmp_path / "model.obj"
        bad.write_text("not gltf")
        scene = engine.load([bad, write_box(tmp_path)])
        assert scene is not None
        assert "unsupported file extension" in err.getvalue()
        assert set(engine.load_seconds) == {"parse", "decode", "flatten", "upload"}

    def test_returns_none_when_nothing_loadable(self, tmp_path):
        bad = tmp_path / "model.obj"
        bad.write_text("x")
        assert cpu_engine().load([bad]) is None

    def test_scene_camera_defaults(self, tmp_path):
        scene = cpu_engine().load([write_box(tmp_path)])
        np.testing.assert_allclose(scene.camera.position, [0.0, 1.0, 0.0])
        assert scene.light_count == 1
        assert scene.render_scene.device.type == "cpu"


class TestRenderLoop:
    def test_frames_pipeline_and_present(self, tmp_path):
        from vktf_tpu_torch.window import Window

        window = Window(width=64, height=48)
        engine = cpu_engine(window)
        scene = engine.load([write_box(tmp_path)])
        engine.render(scene)  # first frame: still in flight
        assert window.last_frame is None
        engine.render(scene)  # queue full: oldest presented
        assert window.last_frame is not None
        assert window.last_frame.shape == (48, 64, 4)
        still = scene.render_still()
        np.testing.assert_array_equal(np.moveaxis(window.last_frame[..., :3], -1, 0), still)
        assert (window.last_frame[..., 3] == 255).all()
        engine.wait_idle()
        assert len(engine._in_flight) == 0

    def test_run_loop_with_script(self, tmp_path):
        from vktf_tpu_torch.window import ScriptedInput, Window

        window = Window(width=64, height=48)
        window.attach_script(ScriptedInput([None] * 3))
        engine = cpu_engine(window)
        scene = engine.load([write_box(tmp_path)])
        frames = []

        def callback(dt):
            engine.render(scene)
            frames.append(dt)

        engine.run(callback)
        assert window.is_closed()
        assert len(frames) == 4  # 3 scripted steps + closing update
        assert window.last_frame is not None
        assert engine.frame_timer.summary()["frames"] == 4


class TestControls:
    def test_wasd_translation_matches_reference_math(self):
        from vktf_tpu_torch.game import handle_key_events
        from vktf_tpu_torch.window import KEY_W, Window

        window = Window(width=64, height=48)
        cam = _camera()
        window.press_key(KEY_W)
        handle_key_events(window, cam, delta_time=0.5)
        # W: (0, 0, -6 * 0.5) in the camera frame, which looks along +x
        np.testing.assert_allclose(cam.position, [3.0, 1.0, 0.0], atol=1e-5)

    def test_mouse_drag_rotates(self):
        from vktf_tpu_torch.game import DRAG_SPEED, MouseLook
        from vktf_tpu_torch.mathx.quaternion import quat_rotate
        from vktf_tpu_torch.window import MOUSE_BUTTON_LEFT, Window

        window = Window(width=64, height=48)
        cam = _camera()
        look = MouseLook()
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(0, 0)
        look.handle(window, cam)  # records the start, no rotation yet
        q0 = cam.orientation.copy()
        window.move_cursor(100, 0)
        look.handle(window, cam)
        assert not np.allclose(cam.orientation, q0)
        fwd = np.asarray(quat_rotate(cam.orientation, np.asarray([0.0, 0.0, -1.0])))
        yaw = -100 * DRAG_SPEED
        np.testing.assert_allclose(fwd, [np.cos(yaw), 0.0, -np.sin(yaw)], atol=1e-5)

    def test_release_resets_drag_anchor(self):
        from vktf_tpu_torch.game import MouseLook
        from vktf_tpu_torch.window import MOUSE_BUTTON_LEFT, Window

        window = Window(width=64, height=48)
        cam = _camera()
        look = MouseLook()
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(0, 0)
        look.handle(window, cam)
        window.release_mouse(MOUSE_BUTTON_LEFT)
        look.handle(window, cam)
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(500, 500)  # a fresh anchor: no rotation
        q0 = cam.orientation.copy()
        look.handle(window, cam)
        np.testing.assert_allclose(cam.orientation, q0)


def test_game_start_end_to_end(tmp_path):
    from vktf_tpu_torch.game import fly_through_script, start

    window = start([str(write_box(tmp_path))], width=64, height=48, config=small_config(),
                   script=fly_through_script(num_frames=6), display=None, device="cpu")
    assert window.is_closed()
    assert window.last_frame is not None
    assert window.last_frame.shape == (48, 64, 4)


# ---------------------------------------------------------------------------
# devices: the card by default, the CPU only when asked for
# ---------------------------------------------------------------------------


def test_rank_devices_orders_cuda_by_index():
    from vktf_tpu_torch.engine import rank_devices

    ranked = rank_devices([torch.device("cuda", 1), torch.device("cpu"), "cuda:0"])
    assert ranked == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("entry", ["engine", "scene", "main"])
def test_no_card_raises_unless_cpu_asked(entry, tmp_path, capsys):
    """Without a card, Engine, Scene and game.main refuse to pick the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default takes it")
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.game import main
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.scene.scene import Scene
    from vktf_tpu_torch.window import Window

    if entry == "engine":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(Window(width=64, height=48), small_config(), quiet_log())
    elif entry == "scene":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Scene(build_preset("box"), small_config(), quiet_log())
    else:
        assert main([str(write_box(tmp_path)), "--frames", "1", "--display", "off"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--backend", "tiled"], ["--backend", "dense"], ["--mesh", "2,2"]])
def test_refused_viewer_flags(flags, tmp_path, capsys):
    """Options the port cannot honour end main with 1 and the cause, before
    anything renders; nothing falls back. A mesh of several ranks outside a
    launcher names torchrun (it neither re-execs nor renders on one rank)."""
    from vktf_tpu_torch.game import main

    frames = tmp_path / "frames"
    rc = main([str(write_box(tmp_path)), "--width", "64", "--height", "48", "--frames", "1",
               "--display", "off", "--frame-dir", str(frames), *flags], device="cpu")
    assert rc == 1
    cause = "torchrun" if flags[0] == "--mesh" else "not ported"
    assert re.search(rf"^Error: .*{cause}", capsys.readouterr().err, re.M)
    assert not frames.exists()


class _FixedDeltaTime:
    def update(self) -> float:
        return 1.0 / 30.0


@pytest.mark.parametrize("flags, config", [
    (["--preview"], ("yuv420", 2)),
    (["--present-format", "yuv420"], ("yuv420", 1)),
    (["--present-scale", "2"], ("rgb", 2)),
    (["--preview", "--present-scale", "4"], ("yuv420", 4)),
])
def test_preview_viewer_flags(flags, config, tmp_path, monkeypatch):
    """The present flags render as the JAX viewer maps them (--preview is
    yuv420 at scale >= 2): each dumped frame is the host decode of the
    device encoding of the exact frame at the same fixed-step pose, and
    the engine ran the configuration asked for."""
    import vktf_tpu_torch.engine as engine_mod
    from PIL import Image

    from vktf_tpu_torch.game import main
    from vktf_tpu_torch.ops.present import decode_present, make_present_encoder

    monkeypatch.setattr(engine_mod, "DeltaTime", _FixedDeltaTime)
    configs = []
    init = engine_mod.Engine.__init__

    def recording_init(self, window, config=None, *args, **kwargs):
        configs.append(config)
        init(self, window, config, *args, **kwargs)

    monkeypatch.setattr(engine_mod.Engine, "__init__", recording_init)
    args = [str(write_box(tmp_path)), "--width", "64", "--height", "48", "--msaa", "1",
            "--frames", "3", "--display", "off"]
    assert main(args + ["--frame-dir", str(tmp_path / "exact")], device="cpu") == 0
    assert main(args + ["--frame-dir", str(tmp_path / "preview"), *flags], device="cpu") == 0
    cfg = configs[-1]
    assert (cfg.present_format, cfg.present_scale) == config
    exact = sorted((tmp_path / "exact").glob("frame_*.png"))
    preview = sorted((tmp_path / "preview").glob("frame_*.png"))
    assert len(exact) == len(preview) == 5
    encode = make_present_encoder(cfg)
    for e, p in zip(exact, preview):
        frame = torch.from_numpy(np.moveaxis(np.asarray(Image.open(e))[..., :3], -1, 0).copy())
        want = decode_present(encode(frame).numpy(), cfg)
        np.testing.assert_array_equal(np.moveaxis(np.asarray(Image.open(p))[..., :3], -1, 0),
                                      want)


# ---------------------------------------------------------------------------
# the Scene signature, the program registry
# ---------------------------------------------------------------------------


def _box_assets(tmp_path):
    """The box of write_box, in front of the default camera."""
    from vktf_tpu_torch.loaders.gltf import load_gltf

    return [load_gltf(write_box(tmp_path), quiet_log())]


def test_scene_takes_log_third_like_jax(tmp_path):
    """Scene(assets, config, log) as in the JAX package: the log is not
    taken for a camera, the default camera renders, light_count exists,
    and a mesh (the multi-device path) at sample rate is refused."""
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.scene.scene import Scene

    out = io.StringIO()
    config = small_config(msaa_samples=4)
    scene = Scene(_box_assets(tmp_path), config, Log(out, io.StringIO()), device="cpu")
    assert "Scene ready" in out.getvalue()
    assert scene.light_count == scene.meta.num_lights == 1
    np.testing.assert_allclose(scene.camera.position, [0.0, 1.0, 0.0])
    by_keyword = Scene(_box_assets(tmp_path), config, camera=_camera(), device="cpu")
    frame = scene.render_still()
    assert frame.shape == (3, 48, 64)
    assert (frame.max(axis=0) > 0).mean() > 0.05
    # the default camera: (0, 1, 0) looking +x, 45 degrees, the config's 4:3
    np.testing.assert_array_equal(by_keyword.render_still(), frame)
    from vktf_tpu_torch.parallel import RenderMesh

    with pytest.raises(ValueError, match="shading_rate='sample' with a mesh"):
        Scene(_box_assets(tmp_path), config.replace(shading_rate="sample"), quiet_log(),
              device="cpu", mesh=RenderMesh(1, 1, "gloo", 0, None, None, None))


def test_scenes_of_one_shape_share_a_program(tmp_path):
    """Two Scenes of one shape and config share the registry's program and
    each renders its own frame, in any order (the scene update follows
    each leaf's identity and version)."""
    from vktf_tpu_torch.runtime import frame_program, program_cache_info
    from vktf_tpu_torch.scene.scene import Scene

    config = small_config(msaa_samples=4)
    a = Scene(_box_assets(tmp_path), config, quiet_log(), device="cpu")
    b = Scene(_box_assets(tmp_path), config, quiet_log(), device="cpu")
    assert a.frame_program is b.frame_program is frame_program(a.meta, config)
    assert program_cache_info()["programs"] >= 1
    first_a = a.render_still()
    b.render_scene.light_color.mul_(0.25)
    b.render_scene.node_local[:, 2, 3] += 0.4
    frames = [s.render_still() for s in (b, a, b, a)]
    fresh_b = Scene.from_render_scene(b.render_scene, b.meta, config.replace(resort_threshold=0.0),
                                      b.camera).render_still()
    np.testing.assert_array_equal(frames[1], first_a)
    np.testing.assert_array_equal(frames[3], first_a)
    np.testing.assert_array_equal(frames[0], fresh_b)
    np.testing.assert_array_equal(frames[2], fresh_b)
    assert (frames[0] != first_a).any()


def test_warmup_and_cache_dir():
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.ops import _cuda
    from vktf_tpu_torch.runtime import enable_persistent_cache, warmup
    from vktf_tpu_torch.scene.scene import Scene

    assert enable_persistent_cache() == str(_cuda.BUILD_DIR)
    scene = Scene(build_preset("box"), small_config(), quiet_log(), device="cpu")
    seconds = warmup(scene.render_scene, scene.meta, scene.config,
                     scene.camera.view_projection_transform, scene.camera.position)
    assert seconds > 0.0


def test_engine_logs_device_and_cache(tmp_path):
    from vktf_tpu_torch.log import Log

    out = io.StringIO()
    engine = cpu_engine(log=Log(out_stream=out, err_stream=io.StringIO()))
    engine.load([write_box(tmp_path)])
    text = out.getvalue()
    assert "Engine using cpu device" in text
    assert "Kernel build cache at" in text and "Load seconds: parse" in text


# ---------------------------------------------------------------------------
# frame dumps
# ---------------------------------------------------------------------------


def test_write_png_reads_back_with_pil(tmp_path):
    from PIL import Image

    from vktf_tpu_torch.window import write_png

    rgba = np.random.default_rng(2).integers(0, 256, (13, 21, 4), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(write_png(tmp_path / "x.png", rgba))),
                                  rgba)
    with pytest.raises(ValueError):
        write_png(tmp_path / "y.png", rgba[..., :3])


def test_frame_dir_pngs_are_the_presented_frames(tmp_path):
    """--frame-dir dumps every presented frame; each PNG decodes (PIL) to
    the frame the window received, and the last to the final frame."""
    from PIL import Image

    from vktf_tpu_torch.game import fly_through_script, start
    from vktf_tpu_torch.window import Window

    presented = []
    present = Window.present

    def record(self, frame):
        present(self, frame)
        presented.append(self.last_frame.copy())

    Window.present = record
    try:
        window = start([str(write_box(tmp_path))], width=64, height=48,
                       config=small_config(msaa_samples=4), script=fly_through_script(3),
                       frame_dir=tmp_path / "frames", display=None, device="cpu")
    finally:
        Window.present = present
    pngs = sorted((tmp_path / "frames").glob("frame_*.png"))
    assert len(pngs) == len(presented) == 5
    for path, frame in zip(pngs, presented):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), frame)
    np.testing.assert_array_equal(presented[-1], window.last_frame)


def test_present_keeps_its_own_copy():
    """The window never aliases the caller's buffer (the engine reuses its
    pinned host buffers), for planar and interleaved frames alike."""
    from vktf_tpu_torch.window import Window

    window = Window(width=4, height=3)
    for frame in (np.full((3, 3, 4), 7, np.uint8), np.full((3, 4, 4), 9, np.uint8)):
        window.present(frame)
        kept = window.last_frame.copy()
        frame[...] = 0
        np.testing.assert_array_equal(window.last_frame, kept)


# ---------------------------------------------------------------------------
# log.py (tests/test_log.py), x11.py (tests/test_x11.py), utils
# ---------------------------------------------------------------------------


def make_log():
    from vktf_tpu_torch.log import Log

    out, err = io.StringIO(), io.StringIO()
    return Log(out_stream=out, err_stream=err), out, err


def test_log_routes_severities():
    from vktf_tpu_torch.log import Severity

    log, out, err = make_log()
    log.info("hello", 42)
    assert "hello 42" in out.getvalue() and err.getvalue() == ""
    log.warn("w")
    log.error("e")
    log.print(Severity.ERROR, "boom")
    lines = err.getvalue().strip().splitlines()
    assert "WARNING: w" in lines[0] and "ERROR: e" in lines[1] and "ERROR: boom" in lines[2]
    assert out.getvalue().count("\n") == 1


def test_log_preamble_has_file_and_line():
    log, out, _ = make_log()
    log.info("x")
    assert re.match(r"^\[test_torch_engine\.py:\d+\] INFO: x$", out.getvalue().strip())


def test_log_thread_safety_whole_lines():
    log, out, _ = make_log()

    def worker(tag):
        for _ in range(50):
            log.info(tag * 8)

    threads = [threading.Thread(target=worker, args=(t,)) for t in "abcd"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 200
    assert all(len(set(line.split("INFO: ")[1])) == 1 for line in lines)


def test_default_log_singleton():
    from vktf_tpu_torch.log import default_log

    assert default_log() is default_log()


@pytest.mark.parametrize("channels", [3, 4])
def test_rgba_to_bgrx(channels):
    from vktf_tpu_torch.x11 import rgba_to_bgrx

    frame = np.zeros((2, 3, channels), np.uint8)
    frame[0, 0] = (10, 20, 30, 40)[:channels]
    frame[1, 2] = (200, 100, 50, 255)[:channels]
    out = rgba_to_bgrx(frame)
    assert out.shape == (2, 3, 4)
    assert tuple(out[0, 0]) == (30, 20, 10, 255)
    assert tuple(out[1, 2]) == (50, 100, 200, 255)


def test_x11_degrades_to_headless(monkeypatch):
    from vktf_tpu_torch.window import Window
    from vktf_tpu_torch.x11 import X11Display

    monkeypatch.delenv("DISPLAY", raising=False)
    assert not X11Display.available()
    w = Window("t", 32, 16, display="auto")
    assert not w.has_display
    w.present(np.zeros((3, 16, 32), np.uint8))
    assert w.last_frame.shape == (16, 32, 4)
    with pytest.raises(RuntimeError):
        Window("t", 32, 16, display="x11")
    monkeypatch.setenv("DISPLAY", ":9999")
    assert Window("t", 32, 16, display=None)._display is None
    assert Window("t", 8, 8).has_display is False


def test_interactive_without_display_refuses():
    from vktf_tpu_torch.game import start

    with pytest.raises(RuntimeError, match="interactive"):
        start(["missing.gltf"], width=8, height=8, script=None, display=None, device="cpu")


def test_utils(tmp_path):
    from vktf_tpu_torch.utils import DeltaTime, FrameTimer, as_view, size_bytes
    from vktf_tpu_torch.utils.profiling import Counters, annotate, trace

    assert as_view(3.0).shape == (1,) and size_bytes(np.zeros((2, 3), np.float32)) == 24
    with pytest.raises(TypeError):
        as_view(None)
    dt = DeltaTime()
    assert dt.update() >= 0.0 and float(dt) == dt.value
    timer = FrameTimer()
    for _ in range(3):
        timer.tick()
    summary = timer.summary()
    assert summary["frames"] == 3 and summary["frame_ms_p99"] >= summary["frame_ms_p50"] >= 0
    counters = Counters()
    counters.add("textures.decode_failed", 2)
    assert counters.snapshot() == {"textures.decode_failed": 2}
    with trace(str(tmp_path / "trace")):
        with annotate("engine.dispatch"):
            torch.ones(4).sum()
    assert "engine.dispatch" in (tmp_path / "trace" / "trace.json").read_text()
