"""Port parity of the present encodings (vktf_tpu_torch/ops/present.py).

The torch encoders (box downsample, yuv420 pack, the configuration's
encode chain) must equal the JAX package's functions bit for bit, on
seeded random frames, the 0 and 255 extremes and gray, with the JAX
function given numpy and jnp input alike; the numpy decodes equal the JAX
package's too. The configuration rejects what the JAX configuration
rejects. Through the port's Engine and Window (tests/test_present.py's
end-to-end tests): the preview stream presents the host upsample of the
device downsample of the exact frame, the yuv420 present approximates the
exact one, and ``render_still`` under a preview configuration is the
exact frame bit for bit.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()


def _frames():
    """(name, (3, H, W) uint8) test frames: random bytes, the extremes,
    gray, a random gray ramp and tests/test_present.py's gradient with a
    hard edge."""
    rng = np.random.default_rng(11)
    h, w = 16, 32
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    y, x = np.mgrid[:h, :w]
    edge = np.stack([(x * 255 // (w - 1)).astype(np.uint8),
                     (y * 255 // (h - 1)).astype(np.uint8),
                     rng.integers(0, 256, (h, w), dtype=np.uint8)])
    edge[2, :, : w // 2] = 30
    return [
        ("random", rng.integers(0, 256, (3, h, w), dtype=np.uint8)),
        ("zeros", np.zeros((3, h, w), np.uint8)),
        ("full", np.full((3, h, w), 255, np.uint8)),
        ("extremes", rng.choice(np.array([0, 255], np.uint8), (3, h, w))),
        ("gray", np.broadcast_to(gray, (3, h, w)).copy()),
        ("edge", edge),
    ]


FRAMES = _frames()


def _jax_in(frame, kind):
    return jnp.asarray(frame) if kind == "jnp" else frame


@pytest.mark.parametrize("kind", ["numpy", "jnp"])
@pytest.mark.parametrize("name, frame", FRAMES, ids=[n for n, _ in FRAMES])
def test_encoders_match_jax(name, frame, kind):
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu.ops import present as jp
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops import present as tpr

    t = torch.from_numpy(frame)
    for scale in (1, 2, 4):
        want = np.asarray(jp.downsample_box(_jax_in(frame, kind), scale))
        got = tpr.downsample_box(t, scale).numpy()
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"downsample {scale}")
    want = np.asarray(jp.encode_yuv420(_jax_in(frame, kind)))
    got = tpr.encode_yuv420(t).numpy()
    assert got.shape == (tpr.encoded_size(16, 32),) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want, err_msg="yuv420")
    for fmt in ("rgb", "yuv420"):
        for scale in (1, 2, 4):
            kw = dict(width=32, height=16, present_format=fmt, present_scale=scale)
            if fmt == "yuv420" and scale == 4:  # an odd preview: rejected
                continue
            want = np.asarray(jp.make_present_encoder(JConfig(**kw))(_jax_in(frame, kind)))
            got = tpr.make_present_encoder(RenderConfig(**kw))(t).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"encoder {fmt} {scale}")


@pytest.mark.parametrize("name, frame", FRAMES, ids=[n for n, _ in FRAMES])
def test_decode_present_matches_jax(name, frame):
    """The host decodes of the encoded frames, bit for bit: decode_yuv420,
    upsample_nearest (planar and interleaved) and decode_present."""
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu.ops import present as jp
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops import present as tpr

    packed = jp.encode_yuv420(frame)
    np.testing.assert_array_equal(tpr.decode_yuv420(packed, 16, 32),
                                  jp.decode_yuv420(packed, 16, 32))
    for scale in (1, 2, 4):
        np.testing.assert_array_equal(tpr.upsample_nearest(frame, scale),
                                      jp.upsample_nearest(frame, scale))
        hwc = np.moveaxis(frame, 0, -1)
        np.testing.assert_array_equal(tpr.upsample_nearest(hwc, scale, planar=False),
                                      jp.upsample_nearest(hwc, scale, planar=False))
    for fmt, scale in (("rgb", 1), ("rgb", 2), ("rgb", 4), ("yuv420", 1), ("yuv420", 2)):
        kw = dict(width=64, height=32, present_format=fmt, present_scale=scale)
        big = np.repeat(np.repeat(frame, 2, axis=1), 2, axis=2)
        encoded = np.asarray(jp.make_present_encoder(JConfig(**kw))(big))
        got = tpr.decode_present(encoded, RenderConfig(**kw))
        assert got.shape == (3, 32, 64)
        np.testing.assert_array_equal(got, jp.decode_present(encoded, JConfig(**kw)))


def test_gray_roundtrips_and_layout():
    """Gray round-trips bit-exact; the bytes are Y, then Cb, then Cr."""
    from vktf_tpu_torch.ops.present import decode_yuv420, encode_yuv420

    ramp = np.ascontiguousarray(
        np.tile(np.arange(256, dtype=np.uint8), (2, 1))[None].repeat(3, 0))
    out = decode_yuv420(encode_yuv420(torch.from_numpy(ramp)).numpy(), 2, 256)
    np.testing.assert_array_equal(out, ramp)
    packed = encode_yuv420(torch.full((3, 4, 4), 200, dtype=torch.uint8)).tolist()
    assert packed[:16] == [200] * 16 and packed[16:] == [128] * 8


_VALIDATION = [  # (config fields, rejected)
    (dict(width=63, height=48, present_format="yuv420"), True),
    (dict(width=64, height=48, present_format="nope"), True),
    (dict(width=64, height=48, present_scale=3), True),
    (dict(width=66, height=48, present_scale=4), True),
    (dict(width=66, height=48, present_format="yuv420", present_scale=2), True),
    (dict(width=64, height=48, shading_rate="quad"), True),
    (dict(width=68, height=48, present_format="yuv420", present_scale=2), False),
    (dict(width=64, height=48, present_format="yuv420", present_scale=4), False),
    (dict(width=64, height=48, present_scale=4), False),
    (dict(width=64, height=48, shading_rate="sample"), False),
]


@pytest.mark.parametrize("kw, rejected", _VALIDATION,
                         ids=["-".join(f"{k}={v}" for k, v in kw.items())
                              for kw, _ in _VALIDATION])
def test_config_validation_matches_jax(kw, rejected):
    """tests/test_present.py's validation cases and the ones beside them:
    the port raises exactly where the JAX configuration raises."""
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu_torch.config import RenderConfig

    def raises(cls):
        try:
            cls(**kw)
        except ValueError:
            return True
        return False

    assert raises(JConfig) == rejected
    assert raises(RenderConfig) == rejected


# ---------------------------------------------------------------------------
# end to end through the port's Engine and Window (tests/test_present.py)
# ---------------------------------------------------------------------------


def _box_path(tmp_path):
    from vktf_tpu.models.gltf_writer import GltfWriter
    from vktf_tpu.models.primitives import box_mesh

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.3, 0.1, 1.0), metallic_factor=0.0)
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(2, 1, 0)), w.add_node(light=light)])
    return w.write(tmp_path / "box.gltf")


def _engine(config):
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.window import Window

    return Engine(Window(width=64, height=48), config,
                  Log(out_stream=io.StringIO(), err_stream=io.StringIO()), device="cpu")


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return np.inf if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_engine_yuv420_present_end_to_end(tmp_path):
    from vktf_tpu_torch.config import RenderConfig

    path = _box_path(tmp_path)
    frames = {}
    for fmt in ("rgb", "yuv420"):
        engine = _engine(RenderConfig(width=64, height=48, msaa_samples=1,
                                      tile_shape=(16, 64), present_format=fmt))
        scene = engine.load([path])
        for _ in range(3):
            engine.render(scene)
        engine.wait_idle()
        assert engine.window.last_frame.shape == (48, 64, 4)
        frames[fmt] = engine.window.last_frame
    assert _psnr(frames["yuv420"][..., :3], frames["rgb"][..., :3]) > 30.0


def test_preview_stream_end_to_end_and_exact_still(tmp_path):
    """The preview config presents exactly the host upsample of the device
    downsample of the exact frame, and render_still under the preview
    config, and under preview + yuv420, is the exact frame bit for bit."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops.present import downsample_box, upsample_nearest

    path = _box_path(tmp_path)
    exact_cfg = RenderConfig(width=64, height=48, msaa_samples=1, tile_shape=(16, 64))
    exact = _engine(exact_cfg).load([path]).render_still()
    assert (exact.max(axis=0) > 0).mean() > 0.05

    engine = _engine(exact_cfg.replace(present_scale=2))
    scene = engine.load([path])
    for _ in range(3):
        engine.render(scene)
    engine.wait_idle()
    assert engine.window.last_frame.shape == (48, 64, 4)
    expected = upsample_nearest(downsample_box(torch.from_numpy(exact), 2).numpy(), 2)
    np.testing.assert_array_equal(np.moveaxis(engine.window.last_frame[..., :3], -1, 0),
                                  expected)
    assert tuple(scene.render_async().shape) == (3, 24, 32)
    np.testing.assert_array_equal(scene.render_still(), exact)
    scene3 = _engine(exact_cfg.replace(present_scale=2, present_format="yuv420")).load([path])
    assert tuple(scene3.render_async().shape) == (24 * 32 * 3 // 2,)
    np.testing.assert_array_equal(scene3.render_still(), exact)


def test_presented_frames_are_the_jax_encoding_of_the_exact_frame():
    """The frame program's last stage on the small courtyard at msaa 4:
    each encoded frame (yuv420, preview 2 and 4) equals the JAX package's
    encoding of the port's own exact frame, and each scene's still is that
    exact frame."""
    from vktf_tpu.config import RenderConfig as JConfig
    from vktf_tpu.ops.present import make_present_encoder
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    _jcam, tcam = tp.cameras()
    base = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4)
    exact = Scene(tp.torch_assets("sponza_small"), base, camera=tcam,
                  device="cpu").render_still()
    for fmt, scale in (("yuv420", 1), ("rgb", 2), ("yuv420", 2), ("yuv420", 4)):
        scene = Scene(tp.torch_assets("sponza_small"),
                      base.replace(present_format=fmt, present_scale=scale), camera=tcam,
                      device="cpu")
        want = np.asarray(make_present_encoder(JConfig(
            width=tp.WIDTH, height=tp.HEIGHT, present_format=fmt, present_scale=scale))(exact))
        np.testing.assert_array_equal(scene.render_async().numpy(), want)
        np.testing.assert_array_equal(scene.render_still(), exact)
