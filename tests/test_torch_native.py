"""The port's native host runtime (``vktf_tpu_torch/native.py``) against
its numpy versions and the JAX package's native runtime.

Each native function must equal the port's numpy version (its call
site's fallback, taken with VKTF_NATIVE=0) bit for bit on seeded inputs:
mips on odd and pow2 sizes, sRGB and linear; block-pool packing under
every wrap mode and at the last level; accessor unpack over every
component type, normalized and strided; ETC1S blocks. Each is also
compared with ``vktf_tpu.native`` on the same inputs: exactly, except
mips, which keep tests/test_native.py's one-step bound, and normalized
accessors, one ulp (the JAX library is built with -ffast-math). ZSTD both ways through libzstd, and KTX2 and
the exporter at their ZSTD default with ``zstandard`` hidden. Needs g++
and libzstd.so.1; no card.
"""

import io
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import numpy as np
import pytest

import torch_parity as tp
from vktf_tpu_torch import native

tp.limit_threads()

MIP_SIZES = [(1, 1), (1, 7), (5, 3), (16, 16), (33, 64), (64, 64)]
WRAPS = [[(0, 0)] * 3, [(1, 1)] * 3, [(2, 2)] * 3, [(1, 2), (0, 0), (2, 1)]]
# glTF componentType -> numpy dtype
COMPONENT_TYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
                   5125: np.uint32, 5126: np.float32}


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native runtime, or a skip when it is not built."""
    from vktf_tpu import native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    return jnative


def test_runtime_builds_and_loads():
    assert native.available()


@pytest.mark.parametrize("srgb", [True, False], ids=["srgb", "linear"])
@pytest.mark.parametrize("size", MIP_SIZES, ids=[f"{h}x{w}" for h, w in MIP_SIZES])
def test_mips_equal_numpy(size, srgb, monkeypatch, jax_native):
    from vktf_tpu_torch.loaders import images

    base = np.random.default_rng(size[0] * 100 + size[1]).integers(
        0, 256, (*size, 4), dtype=np.uint8)
    got = native.generate_mips(base, srgb)
    jax_levels = jax_native.generate_mips(base, srgb)
    monkeypatch.setenv("VKTF_NATIVE", "0")
    want = images.generate_mips(base, srgb)
    assert len(got) == len(want) == len(jax_levels)
    for level, (a, b, c) in enumerate(zip(got, want, jax_levels)):
        np.testing.assert_array_equal(a, b, f"level {level}")
        assert np.abs(a.astype(int) - c.astype(int)).max() <= 1, level


def test_srgb_tables_reproduce_numpy_everywhere():
    """Every float32 sRGB-encoded value near each of the 255 thresholds and
    on a seeded sweep of [0, 1] quantizes as numpy does."""
    from vktf_tpu_torch.loaders.images import linear_to_srgb, srgb_to_linear

    to_linear, thresholds = native._srgb_tables()
    np.testing.assert_array_equal(
        to_linear, srgb_to_linear(np.arange(256).astype(np.float32) / 255.0))
    values = np.concatenate([
        np.random.default_rng(0).random(1 << 20, dtype=np.float32),
        (thresholds.view(np.int32)[:, None] + np.arange(-300, 300)).clip(0)
        .astype(np.int32).view(np.float32).reshape(-1),
        np.asarray([0.0, 1.0, -0.5, 1.5], np.float32)])
    assert values.dtype == np.float32
    want = (np.clip(linear_to_srgb(values), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(np.searchsorted(thresholds, values, side="right"), want)


@pytest.mark.parametrize("wraps", WRAPS, ids=["repeat", "clamp", "mirror", "mixed"])
@pytest.mark.parametrize("w", [16, 2, 1])
def test_pack_blocks_equal_numpy(w, wraps, jax_native):
    from vktf_tpu_torch.ops import texture_pack

    rng = np.random.default_rng(w)
    level = [rng.integers(0, 2**32, (w, w), dtype=np.uint32) for _ in range(3)]
    w1 = max(w >> 1, 1)
    following = [rng.integers(0, 2**32, (w1, w1), dtype=np.uint32) for _ in range(3)]
    for nxt in (following, None):  # None: the last level, slot B zero
        got = native.pack_blocks_level(level, nxt, wraps)
        want = texture_pack._pack_blocks_level(level, w, wraps, nxt)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_native.pack_blocks_level(level, nxt, wraps))
    assert not want[:, texture_pack.SLOT_U32:].any()


def _accessor_gltf(values: np.ndarray, comp_type: int, normalized: bool, stride: int):
    """A glTF dict and buffer cache holding `values` (count, 3) as one
    accessor at byte offset 4 of a view with the given stride."""
    from vktf_tpu_torch.loaders.gltf import _BufferCache

    count, comps = values.shape
    elem = values.dtype.itemsize * comps
    blob = bytearray(np.random.default_rng(1).integers(0, 256, 4 + stride * count + 8,
                                                      dtype=np.uint8).tobytes())
    for i in range(count):
        blob[4 + i * stride:4 + i * stride + elem] = values[i].tobytes()
    gltf = {
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(blob),
                         **({"byteStride": stride} if stride != elem else {})}],
        "accessors": [{"bufferView": 0, "byteOffset": 4, "componentType": comp_type,
                       "count": count, "type": "VEC3", "normalized": normalized}],
    }
    return gltf, _BufferCache(gltf, None, bytes(blob)), bytes(blob[4:])


@pytest.mark.parametrize("strided", [False, True], ids=["tight", "strided"])
@pytest.mark.parametrize("normalized", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("comp_type", sorted(COMPONENT_TYPES))
def test_accessor_unpack_equals_numpy(comp_type, normalized, strided, monkeypatch, jax_native):
    from vktf_tpu_torch.loaders.gltf import accessor_to_float

    dtype = np.dtype(COMPONENT_TYPES[comp_type])
    rng = np.random.default_rng(comp_type)
    if dtype.kind == "f":
        values = rng.normal(0, 100, (37, 3)).astype(dtype)
    else:
        info = np.iinfo(dtype)
        values = rng.integers(info.min, info.max, (37, 3), endpoint=True).astype(dtype)
        values[0] = [info.min, info.max, 0]
    stride = 3 * dtype.itemsize + (8 if strided else 0)
    gltf, buffers, raw = _accessor_gltf(values, comp_type, normalized, stride)
    got = native.unpack_accessor(raw[:stride * 36 + 3 * dtype.itemsize], 37, 3, comp_type,
                                 normalized, stride)
    through_loader = accessor_to_float(gltf, buffers, 0)
    monkeypatch.setenv("VKTF_NATIVE", "0")
    want = accessor_to_float(gltf, buffers, 0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(through_loader.view(np.int32), want.view(np.int32))
    jax_got = jax_native.unpack_accessor(raw[:stride * 36 + 3 * dtype.itemsize], 37, 3,
                                         comp_type, normalized, stride)
    # the JAX library's -ffast-math multiplies by the scale's reciprocal:
    # its normalized values may lie one ulp off the division numpy does
    ulp = 1 if normalized and comp_type in (5120, 5121, 5122, 5123) else 0
    assert np.abs(tp.ulp_diff(got, jax_got)).max() <= ulp


@pytest.mark.parametrize("raw_len, count, stride", [(0, 10, 12), (119, 10, 12), (288, 24, -12),
                                                   (288, 24, 4), (288, -1, 12)],
                         ids=["empty", "one_short", "stride_neg", "stride_short", "count_neg"])
def test_accessor_unpack_refuses_bytes_it_would_overrun(raw_len, count, stride):
    """unpack_accessor returns None, and reads nothing, when raw cannot hold
    count elements of 3 floats at the stride."""
    assert native.available()
    assert native.unpack_accessor(bytes(raw_len), count, 3, 5126, False, stride) is None
    assert native.unpack_accessor(bytes(120), 10, 3, 5126, False, 12).shape == (10, 3)


@pytest.mark.parametrize("size", [(16, 16), (13, 7)], ids=["16x16", "13x7"])
def test_etc1s_equals_numpy(size, monkeypatch, jax_native):
    from vktf_tpu_torch.loaders import basis

    height, width = size
    rng = np.random.default_rng(height)
    bh, bw = (height + 3) // 4, (width + 3) // 4
    endpoints = np.concatenate([rng.integers(0, 32, (9, 3)), rng.integers(0, 8, (9, 1))],
                               axis=1).astype(np.int32)
    endpoints[0] = [31, 0, 31, 7]  # clamps at both ends
    selectors = rng.integers(0, 4, (5, 16)).astype(np.uint8)
    ids = (rng.integers(0, 9, (bh, bw)).astype(np.int32),
           rng.integers(0, 5, (bh, bw)).astype(np.int32))
    got = native.decode_etc1s(*ids, endpoints, selectors, width, height)
    through_loader = basis.decode_etc1s_blocks(*ids, endpoints, selectors, width, height)
    monkeypatch.setenv("VKTF_NATIVE", "0")
    want = basis.decode_etc1s_blocks(*ids, endpoints, selectors, width, height)
    assert got.shape == want.shape == (height, width, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(through_loader, want)
    np.testing.assert_array_equal(
        got, jax_native.decode_etc1s(*ids, endpoints, selectors, width, height))
    # an id out of range leaves the decode to numpy, which raises
    bad = (ids[0] + 9, ids[1])
    assert native.decode_etc1s(*bad, endpoints, selectors, width, height) is None


def test_zstd_round_trips():
    import zstandard

    data = np.random.default_rng(2).integers(0, 6, 200_000, dtype=np.uint8).tobytes()
    packed = native.compress_zstd(data)
    assert len(packed) < len(data) // 2
    assert native.decompress_zstd(packed, len(data)) == data
    assert zstandard.ZstdDecompressor().decompress(packed) == data
    assert native.decompress_zstd(zstandard.ZstdCompressor().compress(data), len(data)) == data
    assert native.decompress_zstd(packed, len(data) - 1) is None  # longer than allowed
    assert native.decompress_zstd(packed[:-9], len(data)) is None  # truncated
    assert native.inflate_zlib(zlib.compress(data), len(data)) == data
    assert native.inflate_zlib(zlib.compress(data), len(data) - 1) is None


def test_ktx2_zstd_without_zstandard(monkeypatch):
    """encode_ktx2 writes ZSTD levels and parse_ktx2 reads them back with
    zstandard hidden: the native runtime's libzstd both ways."""
    from vktf_tpu_torch.loaders import images, ktx

    monkeypatch.setitem(sys.modules, "zstandard", None)
    base = np.random.default_rng(3).integers(0, 256, (24, 40, 4), dtype=np.uint8)
    levels = images.generate_mips(base, True)
    blob = ktx.encode_ktx2(levels, True, ktx.SUPERCOMPRESSION_ZSTD)
    assert int.from_bytes(blob[44:48], "little") == ktx.SUPERCOMPRESSION_ZSTD
    back = ktx.parse_ktx2(blob)
    assert back.srgb and len(back.levels) == len(levels)
    for a, b in zip(back.levels, levels):
        np.testing.assert_array_equal(a, b)
    corrupt = bytearray(blob)
    corrupt[-6:] = b"\xff" * 6
    with pytest.raises(ktx.KtxError, match="zstd"):
        ktx.parse_ktx2(bytes(corrupt))


def test_export_at_its_defaults_without_zstandard(monkeypatch, tmp_path):
    """export_asset at its ZSTD default with zstandard hidden: every .ktx2
    is ZSTD, and the files load back to the asset's texels."""
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.loaders.images import decode_texture
    from vktf_tpu_torch.log import Log
    from vktf_tpu_torch.models.export import export_asset

    monkeypatch.setitem(sys.modules, "zstandard", None)
    asset = tp.plane_asset(**tp.MIXED_PLANE)
    quiet = Log(io.StringIO(), io.StringIO())
    path = export_asset(asset, tmp_path, "rgba", quiet)
    files = sorted(tmp_path.glob("*.ktx2"))
    assert len(files) == 3
    assert {int.from_bytes(f.read_bytes()[44:48], "little") for f in files} == {2}
    material = asset.meshes[0].primitives[0].material
    loaded = load_gltf(path, quiet).meshes[0].primitives[0].material
    pairs = [(material.pbr_metallic_roughness.base_color_texture,
              loaded.pbr_metallic_roughness.base_color_texture, "base_color"),
             (material.pbr_metallic_roughness.metallic_roughness_texture,
              loaded.pbr_metallic_roughness.metallic_roughness_texture, "metallic_roughness"),
             (material.normal_texture, loaded.normal_texture, "normal")]
    for want, got, kind in pairs:
        decoded = decode_texture(got, kind, quiet)
        assert len(decoded.levels) == len(want.decoded.levels)
        for a, b in zip(decoded.levels, want.decoded.levels):
            np.testing.assert_array_equal(a, b)


def test_vktf_native_0_takes_numpy(monkeypatch):
    """VKTF_NATIVE=0: the runtime reports itself unavailable, every entry
    returns None, and the call sites' numpy versions do the work."""
    from vktf_tpu_torch.loaders import images

    monkeypatch.setenv("VKTF_NATIVE", "0")
    base = np.full((4, 4, 4), 77, np.uint8)
    assert not native.available()
    assert native.generate_mips(base, True) is None
    assert native.decompress_zstd(b"\0", 1) is None and native.compress_zstd(b"x") is None
    calls = []
    monkeypatch.setattr(images, "_halve", lambda level: calls.append(1) or level[::2, ::2])
    images.generate_mips(base, False)
    assert calls  # the numpy filter ran
    monkeypatch.setenv("VKTF_NATIVE", "1")
    assert native.available()


def test_build_failure_is_logged_once(monkeypatch, tmp_path):
    """A source g++ refuses leaves the runtime unavailable, with g++'s
    output logged once, however often it is asked for."""
    from vktf_tpu_torch import log
    from vktf_tpu_torch.ops import _host

    out = io.StringIO()
    monkeypatch.setattr(log, "default_log", lambda: log.Log(out, out))

    (tmp_path / "vktf_native.cpp").write_text("this is not C++ at all;\n")
    monkeypatch.setattr(_host, "HOST_CSRC", tmp_path)
    monkeypatch.setattr(_host, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available() and not native.available()
    assert native.generate_mips(np.zeros((2, 2, 4), np.uint8), True) is None
    err = out.getvalue()
    assert err.count("native host runtime unavailable") == 1
    assert "this is not C++" in err  # g++'s own diagnostic, quoting the line


def test_two_processes_build_at_once(tmp_path):
    """Two processes that build the library into an empty directory at the
    same time both load a whole library, and leave no temporary file."""
    code = textwrap.dedent("""
        import ctypes, sys
        from pathlib import Path
        from vktf_tpu_torch.ops import _host
        _host.BUILD_DIR = Path(sys.argv[1])
        lib = ctypes.CDLL(str(_host.build("vktf_native.cpp")))
        print(lib.vktf_mip_chain_texels(4, 4))
    """)
    repo = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "21"  # 16 + 4 + 1 texels
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
