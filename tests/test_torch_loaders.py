"""The port's file loaders and exporter against the JAX package's.

The same files, written in ``tmp_path`` by the JAX package's GltfWriter,
export_asset and KTX2 encoders (or hand-built containers from
test_ktx_conformance.py), go through both packages:

  * ``load_gltf``: every leaf of the Asset equal (positions, indices,
    normals, tangents, uvs, materials and factors, textures' sources,
    samplers, node transforms, lights and scenes), the same logged errors,
    and the same GltfError cases (mirroring tests/test_gltf_loader.py);
  * KTX2 and Basis: the same outcome for each container (decoded levels
    exactly equal, None after a logged skip, or KtxError), mirroring the
    key cases of test_ktx_conformance.py and test_basis.py; the encoders
    write the same bytes;
  * ``export_asset``: byte-identical .gltf and .ktx2 files;
  * ``flatten_assets`` of an exported and loaded preset equals the
    in-memory preset leaf for leaf (lossless textures).

Tolerance: exact everywhere. The JAX package's optional native library is
switched off around its calls (torch_parity._jax_native_mips): the port
implements its numpy definitions.
"""

import copy
import dataclasses
import io
import json
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import test_ktx_conformance as kc
import torch_parity as tp

tp.limit_threads()


def _logs():
    """(port Log, JAX Log, their error streams)."""
    from vktf_tpu.log import Log as JLog
    from vktf_tpu_torch.log import Log

    t_err, j_err = io.StringIO(), io.StringIO()
    return Log(io.StringIO(), t_err), JLog(io.StringIO(), j_err), t_err, j_err


def _messages(stream) -> list[str]:
    """Logged lines without their [file:line] preamble."""
    return [re.sub(r"^\[[^\]]*\] ", "", line) for line in stream.getvalue().splitlines()]


def _value(x):
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, Path):
        return ("path", str(x))
    return x


def _plain(obj, skip=()):
    """A dataclass as a dict of comparable values (arrays by dtype, shape
    and bytes), without the fields in `skip`."""
    return {f.name: _value(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if f.name not in skip}


def asset_tree(asset) -> dict:
    """Every leaf of an Asset, with textures, materials and samplers named
    by their index in the asset (the object graph's identity)."""
    textures = asset.textures
    materials = asset.materials

    def tex_ref(t):
        return None if t is None else next(i for i, x in enumerate(textures) if x is t)

    def mat_tree(m):
        out = _plain(m, skip=("pbr_metallic_roughness", "normal_texture"))
        out["normal_texture"] = tex_ref(m.normal_texture)
        pbr = m.pbr_metallic_roughness
        if pbr is not None:
            out["pbr"] = _plain(pbr, skip=("base_color_texture", "metallic_roughness_texture"))
            out["pbr"]["base_color_texture"] = tex_ref(pbr.base_color_texture)
            out["pbr"]["metallic_roughness_texture"] = tex_ref(pbr.metallic_roughness_texture)
        return out

    def tex_tree(t):
        out = _plain(t, skip=("sampler", "decoded"))
        out["sampler"] = None if t.sampler is None else _plain(t.sampler)
        return out

    def prim_tree(p):
        out = _plain(p, skip=("material",))
        out["material"] = (None if p.material is None
                           else next(i for i, x in enumerate(materials) if x is p.material))
        return out

    return {
        "name": asset.name,
        "samplers": [_plain(s) for s in asset.samplers],
        "textures": [tex_tree(t) for t in textures],
        "materials": [mat_tree(m) for m in materials],
        "meshes": [{"name": m.name, "primitives": [prim_tree(p) for p in m.primitives]}
                   for m in asset.meshes],
        "lights": [_plain(light) for light in asset.lights],
        "nodes": [_plain(n) for n in asset.nodes],
        "scenes": [_plain(s) for s in asset.scenes],
        "default_scene": asset.default_scene,
    }


def _load_both(path):
    """(port asset, JAX asset, port messages, JAX messages)."""
    from vktf_tpu.loaders.gltf import load_gltf as jload
    from vktf_tpu_torch.loaders.gltf import load_gltf

    log_t, log_j, t_err, j_err = _logs()
    got = load_gltf(path, log_t)
    with tp._jax_native_mips(False):
        want = jload(path, log_j)
    return got, want, _messages(t_err), _messages(j_err)


# ---------------------------------------------------------------------------
# glTF files, written by the JAX package's GltfWriter
# ---------------------------------------------------------------------------


def _writer():
    from vktf_tpu.models.gltf_writer import GltfWriter

    return GltfWriter()


def _meshes():
    from vktf_tpu.models import primitives

    return primitives


def _box(tmp_path):
    w = _writer()
    material = w.add_material(name="red", base_color_factor=(0.8, 0.1, 0.1, 1.0),
                              metallic_factor=0.0, roughness_factor=0.9)
    mesh = w.add_mesh(_meshes().box_mesh(), material=material, name="box")
    light = w.add_light(type="directional", color=(1.0, 0.9, 0.8))
    w.add_scene([w.add_node(mesh=mesh, translation=(0, 0, -3), name="box_node"),
                 w.add_node(light=light, rotation=(0, 0, 0, 1), name="sun")], name="main")
    return w.write(tmp_path / "box.gltf")


def _hierarchy(tmp_path):
    """Nested nodes, a two-primitive mesh, two scenes, a point light."""
    w = _writer()
    sphere = w.add_mesh(_meshes().uv_sphere_mesh(rings=4, sectors=6), name="sphere")
    plane = w.add_mesh(_meshes().plane_mesh(segments=2), name="plane")
    extra = w.add_mesh(_meshes().box_mesh(0.25))
    w.gltf["meshes"][plane]["primitives"].append(w.gltf["meshes"][extra]["primitives"][0])
    a = w.add_node(mesh=sphere, translation=(0, 1, 0))
    b = w.add_node(mesh=plane, children=[a], scale=(2, 1, 2))
    c = w.add_node(light=w.add_light(type="point", color=(0.2, 1.0, 0.4)),
                   translation=(1, 3, 1))
    w.add_scene([b, c], name="first")
    w.add_scene([w.add_node(mesh=extra)], name="second", default=False)
    return w.write(tmp_path / "hierarchy.gltf")


def _u16_indices(tmp_path):
    w = _writer()
    geometry = _meshes().plane_mesh()
    attributes = {"POSITION": w.add_accessor(geometry["positions"], with_min_max=True)}
    indices = w.add_accessor(geometry["indices"].reshape(-1).astype(np.uint16))
    w.gltf["meshes"].append(
        {"primitives": [{"attributes": attributes, "indices": indices, "mode": 4}]})
    w.add_scene([w.add_node(mesh=0)])
    return w.write(tmp_path / "u16.gltf")


def _normalized(tmp_path):
    """Normalized int8/uint8/int16/uint16 attributes (including -128 and
    -32768, which clamp to -1) and an accessor with a byteOffset."""
    w = _writer()
    rng = np.random.default_rng(11)
    n = 9
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    normals = rng.integers(-128, 128, (n, 3)).astype(np.int8)
    normals[0] = (-128, 127, 0)
    tangents = rng.integers(-32768, 32768, (n, 4)).astype(np.int16)
    tangents[1] = (-32768, 32767, 0, 1)
    uvs = rng.integers(0, 65536, (n, 2)).astype(np.uint16)
    colors = rng.integers(0, 256, (n, 4)).astype(np.uint8)

    def raw(array, comp, typ, normalized=True, offset=0):
        view = w._add_buffer_view(b"\0" * offset + array.tobytes())
        w.gltf["accessors"].append({"bufferView": view, "byteOffset": offset,
                                    "componentType": comp, "count": n, "type": typ,
                                    "normalized": normalized})
        return len(w.gltf["accessors"]) - 1

    attributes = {"POSITION": w.add_accessor(pos, with_min_max=True),
                  "NORMAL": raw(normals, 5120, "VEC3"),
                  "TANGENT": raw(tangents, 5122, "VEC4", offset=8),
                  "TEXCOORD_0": raw(uvs, 5123, "VEC2"),
                  "COLOR_0": raw(colors, 5121, "VEC4")}
    indices = w.add_accessor(np.arange(n, dtype=np.uint8))
    w.gltf["meshes"].append(
        {"primitives": [{"attributes": attributes, "indices": indices, "mode": 4}]})
    w.add_scene([w.add_node(mesh=0)])
    return w.write(tmp_path / "normalized.gltf")


def _interleaved(tmp_path):
    w = _writer()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    view = w._add_buffer_view(np.concatenate([pos, uv], axis=1).astype(np.float32).tobytes())
    w.gltf["bufferViews"][view]["byteStride"] = 20
    w.gltf["accessors"].append({"bufferView": view, "byteOffset": 0, "componentType": 5126,
                                "count": 4, "type": "VEC3"})
    w.gltf["accessors"].append({"bufferView": view, "byteOffset": 12, "componentType": 5126,
                                "count": 4, "type": "VEC2"})
    indices = w.add_accessor(np.array([0, 1, 2, 2, 1, 3], np.uint32))
    w.gltf["meshes"].append({"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                             "indices": indices, "mode": 4}]})
    w.add_scene([w.add_node(mesh=0)])
    return w.write(tmp_path / "interleaved.gltf")


def _sparse(tmp_path):
    """A sparse accessor over a buffer view and one over zeros."""
    w = _writer()
    pos = np.arange(18, dtype=np.float32).reshape(6, 3)
    base = w.add_accessor(pos, with_min_max=True)
    idx_view = w._add_buffer_view(np.array([1, 4], np.uint32).tobytes())
    val_view = w._add_buffer_view(np.array([[9, 9, 9], [7, 7, 7]], np.float32).tobytes())
    sparse = {"count": 2, "indices": {"bufferView": idx_view, "componentType": 5125},
              "values": {"bufferView": val_view}}
    w.gltf["accessors"][base]["sparse"] = sparse
    uv_vals = w._add_buffer_view(np.array([[0.5, 0.25], [1, 1]], np.float32).tobytes())
    w.gltf["accessors"].append({"componentType": 5126, "count": 6, "type": "VEC2",
                                "sparse": dict(sparse, values={"bufferView": uv_vals})})
    indices = w.add_accessor(np.arange(6, dtype=np.uint32))
    w.gltf["meshes"].append({"primitives": [{"attributes": {"POSITION": base,
                                                            "TEXCOORD_0": base + 1},
                                             "indices": indices, "mode": 4}]})
    w.add_scene([w.add_node(mesh=0)])
    return w.write(tmp_path / "sparse.gltf")


def _skip_and_log(tmp_path):
    """A LINES primitive, a spot light (dropped, lights re-indexed), a
    NORMAL count mismatch, a primitive without positions, an index out of
    bounds and a texture without an image: each skipped with a logged
    error."""
    w = _writer()
    plane = _meshes().plane_mesh()
    lines = w.add_mesh(plane, material=w.add_material())
    w.gltf["meshes"][lines]["primitives"][0]["mode"] = 1
    short = w.add_mesh(dict(plane, normals=plane["normals"][:-1]))
    w.gltf["meshes"][short]["primitives"].append({"attributes": {}, "mode": 4})
    oob = w.add_mesh(plane)
    accessor = w.gltf["accessors"][w.gltf["meshes"][oob]["primitives"][0]["indices"]]
    bad = plane["indices"].reshape(-1).astype(np.uint32).copy()
    bad[0] = 99999
    accessor["bufferView"] = w._add_buffer_view(bad.tobytes())
    w.gltf.setdefault("textures", []).append({"name": "no_image"})
    w.add_material(base_color_texture=0)
    spot = w.add_light(type="spot")
    point = w.add_light(type="point", color=(0.0, 1.0, 0.0))
    w.add_scene([w.add_node(mesh=m) for m in (lines, short, oob)]
                + [w.add_node(light=spot), w.add_node(light=point)])
    return w.write(tmp_path / "skips.gltf")


def _transforms(tmp_path):
    w = _writer()
    mesh = w.add_mesh(_meshes().plane_mesh())
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [4, 5, 6]
    m[0, 1] = 0.25
    trs = w.add_node(mesh=mesh, translation=(1, 2, 3),
                     rotation=(0, np.sin(np.pi / 5), 0, np.cos(np.pi / 5)), scale=(2, 0.5, 2))
    w.add_scene([trs, w.add_node(mesh=mesh, matrix=m),
                 w.add_node(mesh=mesh, rotation=(0.1, 0.2, 0.3, 0.927))])
    return w.write(tmp_path / "transforms.gltf")


def _glb_blob(tmp_path) -> bytes:
    w = _writer()
    w.add_mesh(_meshes().box_mesh(), material=w.add_material(roughness_factor=0.3))
    w.add_scene([w.add_node(mesh=0)])
    gltf = json.loads(w.write(tmp_path / "for_glb.gltf").read_text())
    import base64

    payload = base64.b64decode(gltf["buffers"][0]["uri"].split(",", 1)[1])
    del gltf["buffers"][0]["uri"]
    json_chunk = json.dumps(gltf).encode()
    json_chunk += b" " * (-len(json_chunk) % 4)
    bin_chunk = payload + b"\0" * (-len(payload) % 4)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(json_chunk), 0x4E4F534A) + json_chunk
            + struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk)


def _glb(tmp_path):
    path = tmp_path / "box.glb"
    path.write_bytes(_glb_blob(tmp_path))
    return path


def _textures(tmp_path):
    """Image sources of every kind: a .ktx2 file, a PNG data URI, an image
    in a buffer view, KHR_texture_basisu preferred over a PNG source;
    samplers of every filter and wrap; a texture without a sampler; an
    external .bin buffer."""
    import base64

    from vktf_tpu.loaders.ktx import SUPERCOMPRESSION_ZLIB, write_ktx2

    rng = np.random.default_rng(5)
    rgba = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    write_ktx2(tmp_path / "base.ktx2", [rgba, rgba[::2, ::2]], True, SUPERCOMPRESSION_ZLIB)
    from PIL import Image

    png = io.BytesIO()
    Image.fromarray(rgba[..., :3], "RGB").save(png, format="PNG")
    w = _writer()
    s_near = w.add_sampler(mag=9728, min=9984, wrap_s=33071, wrap_t=33648)
    s_mixed = w.add_sampler(mag=9729, min=9986, wrap_s=33648, wrap_t=10497)
    s_lin = w.add_sampler(mag=9729, min=9985)
    ktx_image = w.add_image_uri("base.ktx2")
    png_image = w.add_image_bytes(png.getvalue(), "image/png")
    w.gltf["images"].append({"bufferView": w._add_buffer_view(png.getvalue()),
                             "mimeType": "image/png"})
    t_ktx = w.add_texture(ktx_image, s_near)
    t_png = w.add_texture(png_image, s_mixed)
    t_view = w.add_texture(2)
    t_basisu = w.add_texture(ktx_image, s_lin, basisu=True)
    w.gltf["textures"][t_basisu]["source"] = png_image  # fallback, not taken
    mat = w.add_material(name="textured", base_color_texture=t_ktx,
                         metallic_roughness_texture=t_png, normal_texture=t_view,
                         normal_scale=0.5, alpha_mode="MASK", alpha_cutoff=0.3,
                         double_sided=True)
    w.add_material(name="blend", base_color_texture=t_basisu, alpha_mode="BLEND")
    mesh = w.add_mesh(_meshes().plane_mesh(), material=mat)
    w.add_scene([w.add_node(mesh=mesh)])
    path = w.write(tmp_path / "textured.gltf")
    gltf = json.loads(path.read_text())
    (tmp_path / "buffer 0.bin").write_bytes(
        base64.b64decode(gltf["buffers"][0]["uri"].split(",", 1)[1]))
    gltf["buffers"][0]["uri"] = "buffer%200.bin"
    path.write_text(json.dumps(gltf))
    return path


def _courtyard(tmp_path):
    """The small sponza courtyard as the JAX package exports it (ZSTD
    RGBA8 KTX2 textures beside the .gltf)."""
    from vktf_tpu.log import Log as JLog
    from vktf_tpu.models.export import export_asset

    with tp._jax_native_mips(False):
        return export_asset(tp.jax_assets("sponza_small")[0], tmp_path, "rgba",
                            JLog(io.StringIO(), io.StringIO()))


GLTF_FILES = {f.__name__[1:]: f for f in (
    _box, _hierarchy, _u16_indices, _normalized, _interleaved, _sparse, _skip_and_log,
    _transforms, _glb, _textures, _courtyard)}


@pytest.mark.parametrize("name", sorted(GLTF_FILES))
def test_load_gltf_matches_jax(name, tmp_path):
    got, want, got_log, want_log = _load_both(GLTF_FILES[name](tmp_path))
    assert asset_tree(got) == asset_tree(want)
    assert got_log == want_log
    if name == "skip_and_log":
        assert len(got_log) >= 6
    else:
        assert got_log == []


def test_textures_decode_like_jax(tmp_path):
    """Each texture of the textured file (KTX2 file, PNG data URI, PNG in
    a buffer view, the basisu source) decodes to the JAX package's chain."""
    from vktf_tpu.loaders.images import decode_texture as jdecode
    from vktf_tpu_torch.loaders.images import decode_texture

    got, want, _, _ = _load_both(_textures(tmp_path))
    assert len(got.textures) == len(want.textures) == 4
    for kind in ("base_color", "normal"):
        for tt, jt in zip(got.textures, want.textures):
            t_data = decode_texture(tt, kind)
            with tp._jax_native_mips(False):
                j_data = jdecode(jt, kind)
            assert t_data.srgb == j_data.srgb
            assert len(t_data.levels) == len(j_data.levels) > 1
            for a, b in zip(t_data.levels, j_data.levels):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the fatal tier: GltfError in both packages
# ---------------------------------------------------------------------------

_MUTATIONS = {
    "acc_count_huge": lambda g: g["accessors"][0].__setitem__("count", 1 << 40),
    "acc_count_neg": lambda g: g["accessors"][0].__setitem__("count", -5),
    "bv_offset_huge": lambda g: g["bufferViews"][0].__setitem__("byteOffset", 1 << 40),
    "acc_bad_type": lambda g: g["accessors"][0].__setitem__("type", "MAT9"),
    "acc_bad_comp": lambda g: g["accessors"][0].__setitem__("componentType", 9999),
    "acc_str_count": lambda g: g["accessors"][0].__setitem__("count", "many"),
    "node_child_self": lambda g: g["nodes"][0].__setitem__("children", [0]),
    "node_child_oob": lambda g: g["nodes"][0].__setitem__("children", [99]),
    "root_is_child": lambda g: (g["nodes"].append({"children": [0]}),
                                g["scenes"][0]["nodes"].append(1)),
    "two_parents": lambda g: g["nodes"].extend([{"children": [0]}, {"children": [0]}]),
    "cycle_2": lambda g: g["nodes"].extend([{"children": [2]}, {"children": [1]}]),
    "mesh_oob": lambda g: g["nodes"][0].__setitem__("mesh", 99),
    "scene_oob": lambda g: g.__setitem__("scene", 99),
    "scene_root_oob": lambda g: g["scenes"][0].__setitem__("nodes", [5]),
    "prim_attr_oob": lambda g: g["meshes"][0]["primitives"][0]["attributes"].__setitem__(
        "POSITION", 99),
    "nodes_not_list": lambda g: g.__setitem__("nodes", 7),
    "buffer_missing_file": lambda g: g["buffers"][0].__setitem__("uri", "absent.bin"),
    "buffer_short": lambda g: g["buffers"][0].__setitem__("byteLength", 1 << 20),
    "data_uri_not_base64": lambda g: g["buffers"][0].__setitem__(
        "uri", "data:application/octet-stream,abc"),
}


def _raises_both(path):
    """Both loaders raise their GltfError. The JAX package runs as its own
    tests run it: its native accessor unpack rejects the negative and
    non-integer counts its numpy path would read."""
    from vktf_tpu.loaders.gltf import GltfError as JGltfError
    from vktf_tpu.loaders.gltf import load_gltf as jload
    from vktf_tpu_torch.loaders.gltf import GltfError, load_gltf

    log_t, log_j, _, _ = _logs()
    with pytest.raises(GltfError) as got:
        load_gltf(path, log_t)
    with pytest.raises(JGltfError):
        jload(path, log_j)
    return str(got.value)


@pytest.mark.parametrize("mutation", sorted(_MUTATIONS))
def test_hostile_fields_raise_like_jax(mutation, tmp_path):
    base = json.loads(_box(tmp_path).read_text())
    g = copy.deepcopy(base)
    _MUTATIONS[mutation](g)
    path = tmp_path / f"{mutation}.gltf"
    path.write_text(json.dumps(g))
    _raises_both(path)


@pytest.mark.parametrize("body", ["[]", "null", "3", "{not json", "MISSING"])
def test_bad_files_raise_like_jax(body, tmp_path):
    path = tmp_path / "bad.gltf"
    if body != "MISSING":
        path.write_text(body)
    assert str(path) in _raises_both(path)


def test_truncations_fail_like_jax(tmp_path):
    """Every prefix of a .glb and a .gltf either loads (the same asset in
    both) or raises GltfError in both."""
    from vktf_tpu.loaders.gltf import GltfError as JGltfError
    from vktf_tpu.loaders.gltf import load_gltf as jload
    from vktf_tpu_torch.loaders.gltf import GltfError, load_gltf

    glb = _glb_blob(tmp_path)
    text = _box(tmp_path).read_bytes()
    rng = np.random.default_rng(7)
    cuts = [(".glb", glb, c) for c in sorted({int(c) for c in rng.integers(0, len(glb), 20)}
                                             | {0, 1, 11, 12, 19, 20, len(glb) - 1})]
    cuts += [(".gltf", text, int(c)) for c in rng.integers(0, len(text), 12)]
    outcomes = set()
    for suffix, blob, cut in cuts:
        path = tmp_path / f"t{cut}{suffix}"
        path.write_bytes(blob[:cut])
        log_t, log_j, _, _ = _logs()
        try:
            got = asset_tree(load_gltf(path, log_t))
        except GltfError as error:
            got = ("GltfError", str(error))
        try:
            with tp._jax_native_mips(False):
                want = asset_tree(jload(path, log_j))
        except JGltfError as error:
            want = ("GltfError", str(error))
        assert got == want, (suffix, cut)
        outcomes.add(isinstance(got, tuple))
    assert True in outcomes


def test_flatten_guards_hostile_indices(tmp_path):
    """An index past the vertices that reaches flatten raises GltfError."""
    from vktf_tpu_torch.loaders.gltf import GltfError, load_gltf
    from vktf_tpu_torch.scene.flatten import flatten_assets_numpy

    log_t, _, _, _ = _logs()
    asset = load_gltf(_box(tmp_path), log_t)
    asset.meshes[0].primitives[0].indices[0, 0] = 99999
    with pytest.raises(GltfError, match="out of bounds"):
        flatten_assets_numpy([asset], log_t)


# ---------------------------------------------------------------------------
# KTX2 and Basis
# ---------------------------------------------------------------------------


def _test_image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 0] = (xx * 255 // max(w, 1)).astype(np.uint8)
    img[..., 1] = (yy * 255 // max(h, 1)).astype(np.uint8)
    img[..., 2] = ((xx // 4 + yy // 4) % 2) * 200 + 30
    img[..., 3] = rng.integers(128, 256, (h, w))
    return img


def _jax_encoded(fn, *args, **kw):
    from vktf_tpu.loaders import ktx as jktx

    with tp._jax_native_mips(False):
        return getattr(jktx, fn)(*args, **kw)


def _mips(img, srgb):
    from vktf_tpu_torch.loaders.images import generate_mips

    return generate_mips(img, srgb)


def _uastc_zstd():
    import zstandard

    raw = kc.uastc_blocks(2, 2, 0x11)
    blob = bytearray(kc.basis_container(sgd=b"", payload=zstandard.ZstdCompressor().compress(raw),
                                        width=8, height=8, model=166, scheme=2))
    struct.pack_into("<Q", blob, 12 + 36 + 16 + 16 + 16, len(raw))
    return bytes(blob)


def _truncated_slice():
    b = kc.Bits()
    for _ in range(2):
        b.put(0, 14).put(0, 5)
    sgd = kc.sgd_header(endpoint_count=0, selector_count=0, endpoints=b.bytes(), selectors=b"")
    return kc.basis_container(sgd=sgd, payload=b"")


def _sgd_offset_beyond_eof():
    blob = bytearray(kc.basis_container(sgd=kc.sgd_header()))
    struct.pack_into("<2Q", blob, 64, 1 << 40, 64)
    return bytes(blob)


def _one_channel_formats():
    """R8, RG8 and RGB8 (UNORM and SRGB) levels, channel-expanded."""
    img = _test_image(5, 6, 3)
    return [kc.build_ktx2([np.ascontiguousarray(img[..., :c])], vk_format=f)
            for c, f in ((1, 9), (1, 15), (2, 16), (2, 22), (3, 23), (3, 29))]


def _solid_blocks():
    img = np.zeros((16, 12, 4), np.uint8)
    img[:8] = (200, 40, 40, 255)
    img[8:] = (40, 40, 200, 128)
    return img


KTX_CASES = {
    "none_srgb": lambda: _jax_encoded("encode_ktx2", _mips(_test_image(13, 7, 1), True), True, 0),
    "zlib_unorm": lambda: _jax_encoded("encode_ktx2", _mips(_test_image(16, 16, 2), False),
                                       False, 3),
    "zstd_srgb": lambda: _jax_encoded("encode_ktx2", _mips(_test_image(9, 12, 3), True), True, 2),
    "etc1s": lambda: _jax_encoded("encode_ktx2_basis", _mips(_test_image(32, 32, 4), True), True,
                                  "etc1s"),
    "etc1s_npot": lambda: _jax_encoded("encode_ktx2_basis", [_test_image(20, 28, 5)], False,
                                       "etc1s"),
    "uastc_solid": lambda: _jax_encoded("encode_ktx2_basis", [_solid_blocks()], True, "uastc"),
    "mip_padding_kvd": lambda: kc.build_ktx2(
        kc.two_levels(), kvd=kc.kv_entry("KTXwriter", b"fixture\0"), mip_padding=13),
    "largest_first": lambda: kc.build_ktx2(kc.two_levels(), smallest_first=False),
    "dfd_linear_on_srgb": lambda: kc.build_ktx2([kc.two_levels()[0]],
                                                dfd=kc.basic_dfd(transfer=1)),
    "dfd_truncated": lambda: kc.build_ktx2([kc.two_levels()[0]], dfd=b"\x08\0\0\0\0\0\0\0"),
    "level_offset_beyond_eof": lambda: kc.build_ktx2(
        [kc.two_levels()[0]], level_overrides={0: (1 << 40, 256, 256)}),
    "level_length_zero": lambda: kc.build_ktx2([kc.two_levels()[0]],
                                               level_overrides={0: (200, 0, 0)}),
    "basislz_sgd_too_short": lambda: kc.basis_container(sgd=b"\x01\0\x01\0"),
    "basislz_sgd_offset_beyond_eof": _sgd_offset_beyond_eof,
    "basislz_endpoint_overrun": lambda: kc.basis_container(sgd=kc.sgd_header(endpoints=b"")),
    "basislz_truncated_slice": _truncated_slice,
    "basislz_with_vkformat": lambda: kc.build_ktx2([np.zeros((4, 4, 4), np.uint8)], scheme=1),
    "uastc_truncated": lambda: kc.basis_container(sgd=b"", payload=b"\0" * 16, width=8, height=8,
                                                  model=166, scheme=0),
    "uastc_foreign_mode": lambda: kc.basis_container(
        sgd=b"", payload=kc.uastc_blocks(2, 2, 0x01), width=8, height=8, model=166, scheme=0),
    "uastc_foreign_mode_zstd": _uastc_zstd,
    "not_ktx2": lambda: b"\x89PNG\r\n\x1a\n" + b"\0" * 64,
    "cubemap": lambda: kc.build_ktx2([kc.two_levels()[0]])[:12] + struct.pack(
        "<9I", 43, 1, 8, 8, 0, 0, 6, 1, 0) + kc.build_ktx2([kc.two_levels()[0]])[48:],
}


def _parse_outcome(parse, error_type, blob, log):
    try:
        tex = parse(blob, "case", log)
    except error_type as error:
        return ("KtxError", str(error))
    if tex is None:
        return None
    return (tex.srgb, [_value(level) for level in tex.levels])


def _ktx_both(blob):
    from vktf_tpu.loaders.ktx import KtxError as JKtxError
    from vktf_tpu.loaders.ktx import parse_ktx2 as jparse
    from vktf_tpu_torch.loaders.ktx import KtxError, parse_ktx2

    log_t, log_j, t_err, j_err = _logs()
    got = _parse_outcome(parse_ktx2, KtxError, blob, log_t)
    with tp._jax_native_mips(False):
        want = _parse_outcome(jparse, JKtxError, blob, log_j)
    return got, want, _messages(t_err), _messages(j_err)


@pytest.mark.parametrize("case", sorted(KTX_CASES))
def test_ktx2_decode_matches_jax(case):
    blobs = KTX_CASES[case]()
    for blob in blobs if isinstance(blobs, list) else [blobs]:
        got, want, got_log, want_log = _ktx_both(blob)
        assert got == want
        assert got_log == want_log
        if case in ("none_srgb", "zlib_unorm", "zstd_srgb", "etc1s", "uastc_solid"):
            assert got is not None and got[0] != "KtxError" and len(got[1]) >= 1


def test_ktx2_truncations_match_jax():
    """Every prefix of an ETC1S and a ZLIB container: the same outcome."""
    blobs = [KTX_CASES["etc1s"](), KTX_CASES["zlib_unorm"]()]
    rng = np.random.default_rng(3)
    for blob in blobs:
        for cut in sorted({int(c) for c in rng.integers(0, len(blob), 24)} | {0, 12, 48, 80}):
            got, want, got_log, want_log = _ktx_both(blob[:cut])
            assert got == want, cut
            assert got_log == want_log, cut


@pytest.mark.parametrize("case", ["none", "zlib", "zstd", "etc1s", "uastc"])
def test_ktx2_encoders_match_jax(case):
    from vktf_tpu_torch.loaders import ktx

    if case in ("etc1s", "uastc"):
        levels = ([_solid_blocks()] if case == "uastc"
                  else _mips(_test_image(24, 20, 6), True))
        got = ktx.encode_ktx2_basis(levels, True, case)
        want = _jax_encoded("encode_ktx2_basis", levels, True, case)
    else:
        scheme = {"none": ktx.SUPERCOMPRESSION_NONE, "zlib": ktx.SUPERCOMPRESSION_ZLIB,
                  "zstd": ktx.SUPERCOMPRESSION_ZSTD}[case]
        levels = _mips(_test_image(11, 17, 7), False)
        got = ktx.encode_ktx2(levels, False, scheme)
        want = _jax_encoded("encode_ktx2", levels, False, scheme)
    assert got == want


def test_basis_huffman_and_uastc_hook():
    """The Huffman layer round-trips, and a registered UASTC transcoder
    decodes a foreign-mode container through the unchanged loader (then the
    built-in subset rejects it again)."""
    from vktf_tpu_torch.loaders import basis
    from vktf_tpu_torch.loaders.ktx import parse_ktx2

    rng = np.random.default_rng(1)
    freqs = rng.integers(0, 100, 40).tolist()
    freqs[7] = 1000
    wr = basis.BitWriter()
    enc = basis.write_huffman_table(wr, basis._code_lengths_for(freqs))
    symbols = [int(s) for s in rng.integers(0, 40, 500) if freqs[int(s)] > 0]
    for s in symbols:
        enc.write(wr, s)
    reader = basis.BitReader(wr.getvalue())
    dec = basis.read_huffman_table(reader)
    assert [dec.read(reader) for _ in symbols] == symbols

    def transcoder(data, width, height):
        blocks = np.frombuffer(data, np.uint8).reshape((height + 3) // 4, (width + 3) // 4, 16)
        return np.repeat(np.repeat(blocks[..., 1:5], 4, 0), 4, 1)[:height, :width]

    blob = KTX_CASES["uastc_foreign_mode"]()
    log_t, _, t_err, _ = _logs()
    prev = basis.register_uastc_transcoder(transcoder)
    try:
        tex = parse_ktx2(blob, "hook", log_t)
    finally:
        basis.register_uastc_transcoder(prev)
    np.testing.assert_array_equal(tex.levels[0][0, 0], [10, 20, 30, 255])
    assert parse_ktx2(blob, "hook", log_t) is None
    assert "unsupported block modes" in t_err.getvalue()


def test_zstd_without_zstandard_raises(monkeypatch, tmp_path):
    """Without the zstandard module, ZSTD levels raise KtxError naming it,
    in parse, encode, texture decode and scene build (no default texture),
    while ZLIB and NONE still decode."""
    from vktf_tpu_torch.loaders import ktx
    from vktf_tpu_torch.loaders.gltf import Texture
    from vktf_tpu_torch.loaders.images import decode_texture
    from vktf_tpu_torch.scene.flatten import flatten_assets_numpy

    zstd_blob = KTX_CASES["zstd_srgb"]()
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ktx.KtxError, match="zstandard"):
        ktx.parse_ktx2(zstd_blob)
    with pytest.raises(ktx.KtxError, match="zstandard"):
        ktx.encode_ktx2([np.zeros((2, 2, 4), np.uint8)], True, ktx.SUPERCOMPRESSION_ZSTD)
    with pytest.raises(ktx.KtxError, match="zstandard"):
        decode_texture(Texture(data=zstd_blob), "base_color")
    assert ktx.parse_ktx2(KTX_CASES["zlib_unorm"]()) is not None
    assert ktx.parse_ktx2(KTX_CASES["none_srgb"]()) is not None
    assets = tp.torch_assets("box")
    material = assets[0].meshes[0].primitives[0].material
    material.pbr_metallic_roughness.base_color_texture = Texture(data=zstd_blob)
    with pytest.raises(ktx.KtxError, match="zstandard"):
        flatten_assets_numpy(assets, _logs()[0])


def test_png_without_pil_raises(monkeypatch):
    from vktf_tpu_torch.loaders.gltf import Texture
    from vktf_tpu_torch.loaders.images import decode_texture

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ModuleNotFoundError, match="PIL"):
        decode_texture(Texture(data=b"\x89PNG\r\n\x1a\n" + b"\0" * 16), "base_color")


def test_decode_failure_takes_logged_default(tmp_path):
    """A texture that fails to decode (a foreign-mode UASTC .ktx2) takes the
    default texture with a logged error and the textures.decode_failed
    counter, and the scene's leaves equal the JAX package's."""
    from vktf_tpu.scene.flatten import flatten_assets as jflatten
    from vktf_tpu_torch.scene.flatten import SCENE_LEAVES, flatten_assets_numpy
    from vktf_tpu_torch.utils.profiling import counters

    w = _writer()
    image = w.add_image_bytes(KTX_CASES["uastc_foreign_mode"](), "image/ktx2")
    mat = w.add_material(base_color_texture=w.add_texture(image))
    w.add_scene([w.add_node(mesh=w.add_mesh(_meshes().plane_mesh(1.0), material=mat)),
                 w.add_node(light=w.add_light(type="directional"))])
    got, want, _, _ = _load_both(w.write(tmp_path / "uastc.gltf"))
    log_t, log_j, t_err, j_err = _logs()
    before = counters.get("textures.decode_failed")
    leaves, meta = flatten_assets_numpy([got], log_t)
    assert counters.get("textures.decode_failed") == before + 1
    assert "Using default base_color texture after decode failure" in t_err.getvalue()
    with tp._jax_native_mips(False):
        jscene, jmeta, _aux = jflatten([want], log_j)
    assert meta.num_triangles == jmeta.num_triangles
    for name in SCENE_LEAVES:
        np.testing.assert_array_equal(leaves[name], np.asarray(getattr(jscene, name)), name)
    assert _messages(t_err) == _messages(j_err)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _files(directory: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir())}


@pytest.mark.parametrize("name,texture_format", [
    ("box", "basis"), ("sponza_small", "rgba"), ("textured_plane", "basis")])
def test_export_matches_jax(name, texture_format, tmp_path):
    """export_asset writes byte-identical .gltf and .ktx2 files."""
    from vktf_tpu.log import Log as JLog
    from vktf_tpu.models.export import export_asset as jexport
    from vktf_tpu_torch.models.export import export_asset

    if name == "textured_plane":
        t_assets = [tp.plane_asset(**tp.MIXED_PLANE)]
        j_assets = [_jax_plane(t_assets[0])]
    else:
        t_assets, j_assets = tp.torch_assets(name), tp.jax_assets(name)
    log_t = _logs()[0]
    for asset in t_assets:
        export_asset(asset, tmp_path / "port", texture_format, log_t)
    with tp._jax_native_mips(False):
        for asset in j_assets:
            jexport(asset, tmp_path / "jax", texture_format, JLog(io.StringIO(), io.StringIO()))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys()
    assert any(k.endswith(".ktx2") for k in got) == (name != "box")
    for key in want:
        assert got[key] == want[key], key


def _jax_plane(asset):
    """The JAX package's Asset of the same scene as a port asset built from
    decoded textures: each texture becomes its ZSTD KTX2 payload."""
    from vktf_tpu.loaders import gltf as jg
    from vktf_tpu.loaders.ktx import SUPERCOMPRESSION_ZSTD, encode_ktx2

    textures = {}

    def tex(t):
        if t is None:
            return None
        if id(t) not in textures:
            textures[id(t)] = jg.Texture(
                name=t.name, data=encode_ktx2(t.decoded.levels, t.decoded.srgb,
                                              SUPERCOMPRESSION_ZSTD),
                mime_type="image/ktx2", sampler=jg.Sampler(**_plain(t.sampler)))
        return textures[id(t)]

    materials = {}

    def mat(m):
        if m is None:
            return None
        if id(m) not in materials:
            pbr = m.pbr_metallic_roughness
            materials[id(m)] = jg.Material(
                name=m.name, normal_scale=m.normal_scale, normal_texture=tex(m.normal_texture),
                alpha_mode=m.alpha_mode, alpha_cutoff=m.alpha_cutoff,
                double_sided=m.double_sided,
                pbr_metallic_roughness=None if pbr is None else jg.PbrMetallicRoughness(
                    base_color_factor=pbr.base_color_factor,
                    base_color_texture=tex(pbr.base_color_texture),
                    metallic_factor=pbr.metallic_factor, roughness_factor=pbr.roughness_factor,
                    metallic_roughness_texture=tex(pbr.metallic_roughness_texture)))
        return materials[id(m)]

    meshes = [jg.Mesh(name=m.name, primitives=[
        jg.Primitive(**dict(_plain_arrays(p), material=mat(p.material)))
        for p in m.primitives]) for m in asset.meshes]
    return jg.Asset(name=asset.name, meshes=meshes,
                    lights=[jg.Light(**_plain_arrays(light)) for light in asset.lights],
                    nodes=[jg.Node(**_plain_arrays(n)) for n in asset.nodes],
                    scenes=[jg.Scene(**_plain_arrays(s)) for s in asset.scenes],
                    default_scene=asset.default_scene)


def _plain_arrays(obj, skip=("material",)):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.name not in skip}


@pytest.mark.parametrize("name", ["box", "sponza_small"])
def test_export_zlib_load_flatten_equals_preset(name, tmp_path):
    """The preset exported with ZLIB KTX2 (lossless, no zstandard needed),
    loaded and flattened, equals the in-memory preset leaf for leaf."""
    from vktf_tpu_torch.loaders.gltf import load_gltf
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB
    from vktf_tpu_torch.models.export import export_asset
    from vktf_tpu_torch.scene.flatten import flatten_assets_numpy

    log_t, _, t_err, _ = _logs()
    paths = [export_asset(asset, tmp_path, "rgba", log_t, SUPERCOMPRESSION_ZLIB)
             for asset in tp.torch_assets(name)]
    leaves, meta = flatten_assets_numpy([load_gltf(p, log_t) for p in paths], log_t)
    want, want_meta = tp.torch_leaves(name)
    assert meta == want_meta
    for key, value in want.items():
        assert leaves[key].dtype == value.dtype, key
        np.testing.assert_array_equal(leaves[key], value, key)
    assert t_err.getvalue() == ""


def test_export_cli(tmp_path, capsys):
    from vktf_tpu_torch.models.export import main

    assert main(["--preset", "box", "--out", str(tmp_path / "out")]) == 0
    written = capsys.readouterr().out.split()
    assert written and all(Path(p).exists() for p in written)
    # every preset of models.scenes, duck among them; an unknown one is refused
    assert main(["--preset", "duck", "--out", str(tmp_path / "duck"), "--texture-format",
                 "rgba", "--supercompression", "zlib"]) == 0
    assert [Path(p).name for p in capsys.readouterr().out.split()] == ["duck.gltf"]
    with pytest.raises(SystemExit):
        main(["--preset", "teapot", "--out", str(tmp_path / "x")])
