"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where there is no CUDA device. On a machine
with a card and nvcc (it needs no jax; this directory's conftest.py does,
so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are the seeded special-case triangles of test_torch_setup.py, the
small sponza courtyard at 256x128 (every MSAA count, K = 1, 2, 4, 8 peel
layers), the hand-computed fill-rule geometry of test_torch_raster.py, a
9-deep stack of equal-depth quads, and textured planes at 96x64 (mirror,
clamp and mixed samplers over uvs in [-0.75, 1.75]; repeat and nearest
over uvs far outside [0, 1] up to the mip chain's top) for every texel
source, tap count and the attrs boundary; a plane whose textures hold
every byte value in every channel (the decode tables); streams whose
chunks overlap a block with few touching triangles, chunks whose triangles
all touch one block (full compacted lists), and a 300-deep equal-depth
stack shuffled across chunks; shade tables of random rows at 1, 129 and
896 triangles and over 1,000 instances; setup with and without an id row;
frames enqueued behind a sleeping stream, through Scene and through
Engine.render; the Engine's pinned host ring over a moving camera; the
viewer (game.main) on a small file written by the port's exporter, on the
card against the CPU (chip_smoke.py's FRAME_MISMATCH); the present
encodings on the card bit for bit the CPU's; sample-rate frames and the
duck and box presets on the card against the CPU (FRAME_MISMATCH), the
sample-rate frame's launches, the raster's band offset against the full
frame's rows, and two gloo ranks sharing the card against its one-device
frame. Tolerance otherwise: bit-equal (the
kernels run the plain versions' operations in the same order, with fused
multiply-adds at the same places and the same CUDA math library).
"""

import functools

import numpy as np
import pytest
import torch

import torch_parity as tp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _small_scene(device):
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    leaves, meta = tp.torch_leaves("sponza_small")
    return scene_from_numpy(leaves, device), meta


def _stages(device, msaa):
    """Setup, stream and raster of the small sponza frame on `device`."""
    from vktf_tpu_torch.ops import pipeline, raster, setup_kernel

    rs, meta = _small_scene(device)
    vp = torch.as_tensor(
        np.asarray(tp.port_camera().view_projection_transform, np.float32),
        device=device)
    inst_rows, tri_instance, lights = pipeline.scene_update(rs, meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp, tp.WIDTH,
                                    tp.HEIGHT)
    perm = raster.stream_perm(setup["bbox_rows"], setup["valid"])
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"], perm)
    return rs, (inst_rows, tri_instance), lights, vp, setup, stream


def _assert_dicts_bit_equal(got, want):
    for key in want:
        g, w = got[key], want[key]
        if g.dtype == torch.float32:
            tp.assert_bits_equal(g.cpu().numpy(), w.cpu().numpy(), key)
        else:
            assert torch.equal(g, w), key


def test_setup_kernel_special_cases(dev):
    from vktf_tpu_torch.ops import setup_kernel

    tri_corner, inst_rows, tri_instance = tp.seeded_triangles()
    vp = np.asarray(tp.port_camera().view_projection_transform, np.float32)
    args = (torch.from_numpy(tri_corner).to(dev), torch.from_numpy(inst_rows).to(dev),
            torch.from_numpy(tri_instance).to(dev), torch.from_numpy(vp).to(dev), tp.WIDTH,
            tp.HEIGHT)
    before = setup_kernel.KERNEL.launches
    got = setup_kernel.setup_pack(*args)
    assert setup_kernel.KERNEL.launches == before + 1
    _assert_dicts_bit_equal(got, setup_kernel.setup_pack_plain(*args))


def test_setup_kernel_sponza(dev):
    from vktf_tpu_torch.ops import setup_kernel

    rs, inst, _lights, vp, setup, _stream = _stages(dev, 4)
    want = setup_kernel.setup_pack_plain(rs.tri_corner, *inst, vp, tp.WIDTH, tp.HEIGHT)
    _assert_dicts_bit_equal(setup, want)


def test_setup_kernel_ids_null_equals_arange(dev):
    """ids=None (the kernel writes each triangle's index) against an
    explicit arange, and an explicit permuted id row, bit for bit."""
    from vktf_tpu_torch.ops import setup_kernel

    rs, inst, _lights, vp, setup, _stream = _stages(dev, 4)
    t = rs.tri_corner.shape[1]
    ids = torch.arange(t, dtype=torch.float32, device=dev)
    _assert_dicts_bit_equal(setup, setup_kernel.setup_pack(rs.tri_corner, *inst, vp, tp.WIDTH,
                                                           tp.HEIGHT, ids))
    shuffled = ids[torch.randperm(t, device=dev)]
    args = (rs.tri_corner, *inst, vp, tp.WIDTH, tp.HEIGHT, shuffled)
    _assert_dicts_bit_equal(setup_kernel.setup_pack(*args), setup_kernel.setup_pack_plain(*args))


@pytest.mark.parametrize("msaa", [1, 2, 4, 8])
def test_raster_kernel(dev, msaa):
    from vktf_tpu_torch.ops import raster

    _rs, _m, _l, _vp, _setup, stream = _stages(dev, msaa)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, msaa)
    ids_p, depth_p = raster.rasterize_plain(*stream, tp.HEIGHT, tp.WIDTH, msaa)
    assert 0.5 < float((ids >= 0).float().mean()) < 1.0
    assert torch.equal(ids, ids_p)
    tp.assert_bits_equal(depth.cpu().numpy(), depth_p.cpu().numpy(), "depth")


@pytest.mark.parametrize("msaa", [1, 4])
def test_raster_kernel_fill_rules(dev, msaa):
    from vktf_tpu_torch.ops import raster

    tris = [[(2, 2), (10, 10), (10, 2)], [(2, 2), (2, 10), (10, 10)],
            [(2.5, 18.5), (6.5, 20.5), (6.5, 18.5)], [(2.5, 18.5), (2.5, 20.5), (6.5, 20.5)],
            [(35.375, 0), (35.625, 32), (35.625, 0)], [(35.375, 0), (35.375, 32), (35.625, 32)],
            [(48, 26.375), (128, 26.625), (128, 26.375)],
            [(48, 26.375), (48, 26.625), (128, 26.625)]]
    s = tp.setup_px(tris, 128, 32)
    args = [s[k].to(dev) for k in ("tri_data", "bbox_rows", "valid")]
    perm = raster.stream_perm(args[1], args[2])
    stream = raster.raster_stream(args[0], args[1], perm)
    ids, depth = raster.rasterize(*stream, 32, 128, msaa)
    ids_p, depth_p = raster.rasterize_plain(*stream, 32, 128, msaa)
    assert (ids >= 0).any()
    assert torch.equal(ids, ids_p)
    tp.assert_bits_equal(depth.cpu().numpy(), depth_p.cpu().numpy(), "depth")


def test_shade_table_kernel(dev):
    from vktf_tpu_torch.ops import shade_table

    rs, inst, _lights, _vp, setup, _stream = _stages(dev, 4)
    args = (setup["edge9"], rs.tri_corner, rs.tri_static_cols, setup["anchor2"], *inst)
    got = shade_table.build_shade_table(*args)
    tp.assert_bits_equal(got.cpu().numpy(),
                         shade_table.build_shade_table_plain(*args).cpu().numpy(), "table")


def _random_table_inputs(dev, t, instances, seed=0):
    """Seeded (edge9, tri_corner, static_cols, anchor2, inst_rows,
    tri_instance) on `dev`: every instance index in [0, instances) used
    when t allows."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).to(dev)

    idx = np.arange(t) % instances
    rng.shuffle(idx)
    return (f(9, t), f(36, t), f(15, t), f(2, t), f(instances, 16),
            torch.from_numpy(idx.astype(np.int32)).to(dev))


@pytest.mark.parametrize("t", [1, 129, 128 * 7])
def test_shade_table_kernel_ragged_blocks(dev, t):
    """One triangle, a ragged last block of one row, and whole blocks."""
    from vktf_tpu_torch.ops import shade_table

    args = _random_table_inputs(dev, t, 3)
    got = shade_table.build_shade_table(*args)
    want = shade_table.build_shade_table_plain(*args)
    assert got.shape == (t, 64)
    assert bool((got[:, 56:] == 0).all())
    tp.assert_bits_equal(got.cpu().numpy(), want.cpu().numpy(), "table")


def test_shade_table_kernel_many_instances(dev):
    """1,000 instances, every index from 0 to 999 used, shuffled."""
    from vktf_tpu_torch.ops import shade_table

    args = _random_table_inputs(dev, 5000, 1000, seed=1)
    assert int(args[-1].unique().numel()) == 1000
    got = shade_table.build_shade_table(*args)
    tp.assert_bits_equal(got.cpu().numpy(),
                         shade_table.build_shade_table_plain(*args).cpu().numpy(), "table")


def test_shade_kernel(dev):
    from vktf_tpu_torch.ops import pipeline, raster, shade_kernel, shade_table

    rs, inst, lights, _vp, setup, stream = _stages(dev, 4)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                          rs.tri_static_cols, setup["anchor2"], *inst)
    tri, frac = pipeline.pixel_winner(ids, depth)
    sx, sy = pipeline.pixel_centers(tp.HEIGHT, tp.WIDTH, dev)
    cam = torch.tensor(tp.CAMERA_POSITION, dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    for aniso in (16.0, 1.0):
        args = (tri, sx, sy, frac, table, rs.quad_pool, cam, lights, bg, aniso)
        got = shade_kernel.shade_resolve(*args)
        want = shade_kernel.shade_resolve_plain(*args)
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("layers", [2, 4, 8])
@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_raster_kernel_layers(dev, msaa, layers):
    from vktf_tpu_torch.ops import raster

    _rs, _m, _l, _vp, _setup, stream = _stages(dev, msaa)
    before = raster.KERNEL_LAYERS.launches
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, msaa, layers)
    assert raster.KERNEL_LAYERS.launches == before + 1
    ids_p, depth_p = raster.rasterize_plain(*stream, tp.HEIGHT, tp.WIDTH, msaa, layers)
    assert ids.shape == (layers, msaa, tp.HEIGHT, tp.WIDTH)
    assert float((ids[1] >= 0).float().mean()) > 0.1
    assert torch.equal(ids, ids_p)
    tp.assert_bits_equal(depth.cpu().numpy(), depth_p.cpu().numpy(), "depth")


@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_raster_kernel_equal_depth_stack(dev, msaa):
    """A 9-deep stack of equal-depth quads: ties break on draw order and
    the 9th is cut at K = 8."""
    from vktf_tpu_torch.ops import raster

    tris = []
    for q in range(9):
        x0, x1 = 4 + q, 40 + q
        tris += [[(x0, 2), (x1, 20), (x1, 2)], [(x0, 2), (x0, 20), (x1, 20)]]
    s = tp.setup_px(tris, 64, 32)
    args = [s[k].to(dev) for k in ("tri_data", "bbox_rows", "valid")]
    stream = raster.raster_stream(args[0], args[1], raster.stream_perm(args[1], args[2]))
    ids, depth = raster.rasterize(*stream, 32, 64, msaa, 8)
    ids_p, depth_p = raster.rasterize_plain(*stream, 32, 64, msaa, 8)
    assert (ids[:, :, 10, 20] // 2 == torch.arange(8, device=dev)[:, None]).all()
    assert torch.equal(ids, ids_p)
    tp.assert_bits_equal(depth.cpu().numpy(), depth_p.cpu().numpy(), "depth")


def test_shade_layer_kernel(dev):
    from vktf_tpu_torch.ops import pipeline, raster, shade_kernel, shade_table

    rs, inst, lights, _vp, setup, stream = _stages(dev, 4)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, 3)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                          rs.tri_static_cols, setup["anchor2"], *inst)
    tri, _frac = pipeline.pixel_winner(ids, depth)
    sx, sy = pipeline.pixel_centers(tp.HEIGHT, tp.WIDTH, dev)
    cam = torch.tensor(tp.CAMERA_POSITION, dtype=torch.float32, device=dev)
    for aniso in (16.0, 1.0):
        args = (tri, sx, sy, table, rs.quad_pool, cam, lights, aniso)
        before = shade_kernel.KERNEL_LAYER.launches
        rgb, alpha = shade_kernel.shade_layer(*args)
        assert shade_kernel.KERNEL_LAYER.launches == before + 1
        rgb_p, alpha_p = shade_kernel.shade_layer_plain(*args)
        tp.assert_bits_equal(rgb.cpu().numpy(), rgb_p.cpu().numpy(), "rgb")
        tp.assert_bits_equal(alpha.cpu().numpy(), alpha_p.cpu().numpy(), "alpha")
        one = shade_kernel.shade_layer(tri[1:2], *args[1:])  # a single layer
        tp.assert_bits_equal(one[0].cpu().numpy(), rgb[1:2].cpu().numpy(), "rgb layer 1")


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    from vktf_tpu_torch.ops import raster, setup_kernel, shade_table

    rs, (inst_rows, tri_instance), _lights, vp, setup, stream = _stages(dev, 4)
    with pytest.raises(ValueError):  # float64 corners
        setup_kernel.setup_pack(rs.tri_corner.double(), inst_rows, tri_instance, vp, 8, 8)
    with pytest.raises(ValueError):  # operands on two devices
        setup_kernel.setup_pack(rs.tri_corner, inst_rows.cpu(), tri_instance, vp, 8, 8)
    with pytest.raises(ValueError):  # the view projection still on the host
        setup_kernel.setup_pack(rs.tri_corner, inst_rows, tri_instance, vp.cpu(), 8, 8)
    t_args = (setup["edge9"], rs.tri_corner, rs.tri_static_cols, setup["anchor2"])
    for bad in (tri_instance.long(), tri_instance[:-1]):  # not int32; one short
        with pytest.raises(ValueError):
            setup_kernel.setup_pack(rs.tri_corner, inst_rows, bad, vp, 8, 8)
        with pytest.raises(ValueError):
            shade_table.build_shade_table(*t_args, inst_rows, bad)
    with pytest.raises(ValueError):  # instance rows not (I, 16)
        shade_table.build_shade_table(*t_args, inst_rows.reshape(-1, 8), tri_instance)
    with pytest.raises(ValueError):  # non-contiguous
        shade_table.build_shade_table(setup["edge9"][:, ::2], rs.tri_corner[:, ::2],
                                      rs.tri_static_cols[:, ::2],
                                      setup["anchor2"][:, ::2], inst_rows, tri_instance[::2])
    with pytest.raises(ValueError):  # frame not a multiple of the 16 px block
        raster.rasterize(*stream, 100, 100, 4)
    for layers in (0, 9):  # the kernel keeps 1..8 layers
        with pytest.raises(ValueError):
            raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, layers)


@pytest.mark.parametrize("name", ["sponza_small", "sponza_small_blend"])
def test_render_async_returns_while_the_stream_is_busy(dev, name):
    """Nothing on the frame path waits for the card, at K = 1 and K = 8:
    with the stream held by a ~0.1 s sleep kernel, four render_async calls
    return before it ends, and their frames are the synchronized one."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    scene = Scene(tp.torch_assets(name), RenderConfig(width=tp.WIDTH, height=tp.HEIGHT,
                                                      msaa_samples=4),
                  camera=tp.port_camera(), device=dev)
    assert scene.frame_program.layers == (8 if name.endswith("blend") else 1)
    want = scene.render_still()  # builds the kernels and the scene state
    stream = torch.cuda.current_stream(dev)
    torch.cuda._sleep(200_000_000)
    frames = [scene.render_async() for _ in range(4)]
    busy = not stream.query()
    torch.cuda.synchronize()
    assert busy, "render_async waited for the card"
    for frame in frames:
        np.testing.assert_array_equal(frame.cpu().numpy(), want)


_CLAMP = {"wrap_u": "clamp_to_edge", "wrap_v": "clamp_to_edge"}
_MIRROR = {"wrap_u": "mirrored_repeat", "wrap_v": "mirrored_repeat"}
_PLANES = {  # the texture side paths' plane scenes (tests/torch_parity.py)
    "mirror": dict(tp.MIXED_PLANE, samplers=(_MIRROR,) * 3),
    "clamp": dict(tp.MIXED_PLANE, samplers=(_CLAMP,) * 3),
    "mixed": tp.MIXED_PLANE,
    # uv far outside [0, 1], lod up to the chain top (l1 == l0), 8 px chain
    "edge_repeat": tp.EDGE_PLANE,
    "edge_nearest": dict(tp.EDGE_PLANE, samplers=(
        {"mag_filter": "nearest", "min_filter": "nearest", "mipmap_mode": "nearest"},) * 3),
}


@functools.lru_cache(maxsize=None)
def _plane(device, which, msaa, layers):
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    spec = tp.BYTE_PLANE if which == "bytes" else _PLANES[which]
    config = RenderConfig(width=96, height=64, msaa_samples=msaa, tile_shape=(32, 64),
                          peel_layers=layers)
    return Scene([tp.plane_asset(**spec, blend=layers > 1)], config,
                 camera=tp.plane_camera(spec, 96, 64), device=device)


def _assert_same(got, want, what):
    if got.dtype == torch.float32:
        tp.assert_bits_equal(got.cpu().numpy(), want.cpu().numpy(), what)
    else:
        assert torch.equal(got, want), (what, int((got != want).sum()))


@pytest.mark.parametrize("layers", [1, 4])
@pytest.mark.parametrize("msaa", [1, 4])
@pytest.mark.parametrize("which", sorted(_PLANES))
def test_texture_kernels_on_planes(dev, which, msaa, layers):
    """Every texel source at 1, 2, 4 and 8 taps, and the attrs boundary,
    against the plain versions (resolve form at K = 1, layer form at K = 4)."""
    from vktf_tpu_torch.ops import shade_kernel as sk

    st = tp.port_stages(_plane(str(dev), which, msaa, layers))
    tri = st["tri"]
    assert float((tri.reshape(-1, tri.shape[-1])[0] >= 0).float().mean()) > 0.2
    if layers > 1:  # the floating plane covers a second layer
        assert bool((tri[1] >= 0).any())
    common = (st["sx"], st["sy"])
    for texels in sk.TEXELS:
        for taps in sk.TAPS:
            kernel = sk._COLS_KERNELS[(texels, taps > 1)][0 if layers == 1 else 1]
            before = kernel.launches
            if layers == 1:
                args = (tri, *common, st["frac"], st["table"], st["pool"], st["cam"],
                        st["lights"], st["bg"], 16.0, texels, taps)
                _assert_same(sk.shade_resolve(*args), sk.shade_resolve_plain(*args),
                             f"{texels} x{taps}")
            else:
                args = (tri, *common, st["table"], st["pool"], st["cam"], st["lights"], 16.0,
                        texels, taps)
                for got, want, what in zip(sk.shade_layer(*args), sk.shade_layer_plain(*args),
                                           ("rgb", "alpha")):
                    _assert_same(got, want, f"{texels} x{taps} {what}")
            assert kernel.launches == before + 1
    attrs = sk.fragment_attrs(tri, *common, st["table"], 16.0)
    if layers == 1:
        args = (*attrs, tri, st["frac"], st["pool"], st["cam"], st["lights"], st["bg"])
        _assert_same(sk.shade_attrs_resolve(*args), sk.shade_attrs_resolve_plain(*args), "attrs")
    else:
        args = (*attrs, tri, st["pool"], st["cam"], st["lights"])
        for got, want, what in zip(sk.shade_attrs_layer(*args), sk.shade_attrs_layer_plain(*args),
                                   ("rgb", "alpha")):
            _assert_same(got, want, f"attrs {what}")


@pytest.mark.parametrize("which", ["edge_repeat", "edge_nearest", "clamp"])
def test_classic_equals_fused_on_the_card(dev, which):
    """Repeat and clamp scenes: the two-gather kernel renders the fused
    kernel's frame, and the attrs kernels render it too."""
    from vktf_tpu_torch.scene.scene import Scene

    scene = _plane(str(dev), which, 4, 1)
    frames = [Scene.from_render_scene(scene.render_scene, scene.meta,
                                      scene.config.replace(**kw), scene.camera).render_still()
              for kw in ({}, {"shade_fused_pool": False}, {"shade_attrs_boundary": True})]
    assert (frames[0].max(axis=0) > 0).mean() > 0.3
    np.testing.assert_array_equal(frames[1], frames[0])
    np.testing.assert_array_equal(frames[2], frames[0])


def test_texture_kernels_raise_on_inputs_they_do_not_take(dev):
    from vktf_tpu_torch.ops import shade_kernel as sk

    st = tp.port_stages(_plane(str(dev), "mirror", 4, 1))
    args = (st["tri"], st["sx"], st["sy"], st["frac"], st["table"], st["pool"], st["cam"],
            st["lights"], st["bg"], 16.0)
    with pytest.raises(ValueError):
        sk.shade_resolve(*args, "bilinear")
    with pytest.raises(ValueError):
        sk.shade_resolve(*args, "classic", 3)
    attrs, r0, r1 = sk.fragment_attrs(st["tri"], st["sx"], st["sy"], st["table"], 16.0)
    with pytest.raises(ValueError):  # 32 padded rows, as the TPU kernel took them
        sk.shade_attrs_resolve(torch.cat([attrs, attrs[:4]]), r0, r1, st["tri"], st["frac"],
                               st["pool"], st["cam"], st["lights"], st["bg"])


def _level0_texels_read(st):
    """(16, 16) bool: the level-0 texels to which a covered entry's one-tap
    sample gives a nonzero weight (the plain version's addressing; the byte
    plane's three samplers are the same repeat-wrap bilinear one)."""
    from vktf_tpu_torch.ops import shade_kernel as sk
    from vktf_tpu_torch.ops.fmath import f32

    tri = st["tri"].reshape(-1)
    reps = tri.numel() // st["sx"].numel()
    covered = tri >= 0
    sx, sy = st["sx"].repeat(reps)[covered], st["sy"].repeat(reps)[covered]
    rows = st["table"][tri[covered].long()]

    def cf(v):
        return f32(v, sx)

    def col(c):
        return rows[:, c]

    tpm = sk._texture_params(cf, col, *sk._anchored(cf, col, sx, sy), 16.0, 0)
    (_row, fx, fy, x0, y0), _ = sk.pool_window_addr(cf, tpm)
    level0 = (tpm["l0"] == 0) & (tpm["lfrac"] < 1.0)
    seen = torch.zeros((16, 16), dtype=torch.bool, device=tri.device)
    for i, j, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)), (1, 0, (1 - fx) * fy),
                    (1, 1, fx * fy)):
        keep = level0 & (w > 0)
        seen[((y0 + i) % 16)[keep].long(), ((x0 + j) % 16)[keep].long()] = True
    return seen


@pytest.mark.parametrize("layers", [1, 4])
def test_shade_decode_every_byte_value(dev, layers):
    """Textures holding every byte value in every channel (the base colour
    decoded as sRGB, the other two linear): the decode tables equal the
    plain version's division and pow for each value, through every texel
    source at one and four taps, resolve form (K = 1) and layer form. Each
    channel of a 16x16 texture is a permutation of 0..255, and the frame's
    level-0 footprints weight every texel above zero, so every byte value
    of every channel and slot is decoded."""
    from vktf_tpu_torch.ops import shade_kernel as sk

    st = tp.port_stages(_plane(str(dev), "bytes", 4, layers))
    tri = st["tri"]
    assert bool(_level0_texels_read(st).all())
    for texels in sk.TEXELS:
        for taps in (1, 4):
            if layers == 1:
                args = (tri, st["sx"], st["sy"], st["frac"], st["table"], st["pool"], st["cam"],
                        st["lights"], st["bg"], 16.0, texels, taps)
                _assert_same(sk.shade_resolve(*args), sk.shade_resolve_plain(*args),
                             f"{texels} x{taps}")
            else:
                args = (tri, st["sx"], st["sy"], st["table"], st["pool"], st["cam"],
                        st["lights"], 16.0, texels, taps)
                for got, want, what in zip(sk.shade_layer(*args), sk.shade_layer_plain(*args),
                                           ("rgb", "alpha")):
                    _assert_same(got, want, f"{texels} x{taps} {what}")


def _raster_both(dev, tris, width, height, msaa, layers, z=0.5, perm=None):
    """The kernel's and the plain version's (ids, depth) of pixel-space
    triangles, streamed in `perm` order (stream_perm when None)."""
    from vktf_tpu_torch.ops import raster

    s = tp.setup_px(tris, width, height, z)
    tri_data, bbox_rows, valid = (s[k].to(dev) for k in ("tri_data", "bbox_rows", "valid"))
    if perm is None:
        perm = raster.stream_perm(bbox_rows, valid)
    stream = raster.raster_stream(tri_data, bbox_rows, torch.as_tensor(perm, device=dev))
    got = raster.rasterize(*stream, height, width, msaa, layers)
    want = raster.rasterize_plain(*stream, height, width, msaa, layers)
    assert torch.equal(got[0], want[0])
    tp.assert_bits_equal(got[1].cpu().numpy(), want[1].cpu().numpy(), "depth")
    return stream, got, int(valid.sum())


def _small_tri(cx, cy, r):
    """A triangle of the fill-rule tests' winding around (cx, cy)."""
    return [(cx - r, cy - r), (cx + r, cy + r), (cx + r, cy - r)]


@pytest.mark.parametrize("layers", [1, 4])
def test_raster_sparse_chunks_over_one_block(dev, layers):
    """Eight chunks, each spanning the frame from its left to its right edge,
    so every block hits all eight, while only one triangle of each touches
    the middle blocks: most tested triangles are skipped before staging."""
    rng = np.random.default_rng(5)
    tris = []
    for c in range(8):
        for k in range(255):
            x = 2.0 + 0.5 * rng.integers(0, 4) if k % 2 else 122.0 + 0.5 * rng.integers(0, 4)
            tris.append(_small_tri(x, 2.0 + 0.5 * rng.integers(0, 120), 1.5))
        tris.append(_small_tri(48.0 + 4 * c, 8.0 + 6 * c, 6.0))
    stream, (ids, _depth), n_valid = _raster_both(dev, tris, 128, 64, 4, layers,
                                                  perm=np.arange(len(tris)))
    chunk_bbox = stream[2]
    assert n_valid == len(tris)
    assert bool(((chunk_bbox[0] < 48) & (chunk_bbox[2] > 80)).all())
    middle = [256 * c + 255 for c in range(8)]
    for m in middle:
        assert bool((ids == m).any()), m


@pytest.mark.parametrize("layers", [1, 8])
@pytest.mark.parametrize("msaa", [1, 4])
def test_raster_full_chunks_in_one_block(dev, msaa, layers):
    """Two chunks whose 512 triangles all touch one 16x16 block at seeded
    depths: the compacted list fills (256) and is evaluated before the
    second chunk's triangles are listed."""
    rng = np.random.default_rng(6)
    tris, z = [], []
    for _ in range(512):
        cx, cy = 16.0 + 0.125 * rng.integers(24, 104, size=2)
        tris.append(_small_tri(cx, cy, 0.125 * rng.integers(8, 40)))
        z.append(rng.integers(1, 255) / 256.0)
    stream, (ids, _depth), n_valid = _raster_both(dev, tris, 64, 48, msaa, layers, z=z)
    assert n_valid == 512
    first = ids if layers == 1 else ids[0]
    assert float((first[:, 16:32, 16:32] >= 0).float().mean()) > 0.5


@pytest.mark.parametrize("msaa", [1, 4, 8])
def test_raster_equal_depth_stack_across_chunks(dev, msaa):
    """300 equal-depth quads over the whole frame, streamed in a seeded
    shuffle across three chunks: at K = 8 every sample keeps the eight
    lowest draw-order ids, whatever order the lists visit them in."""
    rng = np.random.default_rng(7)
    tris = []
    for q in range(300):
        tris += [[(0, 0), (64, 32), (64, 0)], [(0, 0), (0, 32), (64, 32)]]
    t_pad = -(-len(tris) // 256) * 256
    _stream, (ids, depth), _n = _raster_both(dev, tris, 64, 32, msaa, 8,
                                             perm=rng.permutation(t_pad))
    assert (ids[:, :, 10, 20] // 2 == torch.arange(8, device=dev)[:, None]).all()
    assert bool((depth[:, :, 10, 20] == depth[0, 0, 10, 20]).all())


class _FixedDeltaTime:
    def update(self) -> float:
        return 1.0 / 30.0


def _quiet_log():
    import io

    from vktf_tpu_torch.log import Log

    return Log(io.StringIO(), io.StringIO())


def _small_engine(device, window=None):
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.engine import Engine
    from vktf_tpu_torch.scene.scene import Scene
    from vktf_tpu_torch.window import Window

    config = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4)
    window = window or Window(width=tp.WIDTH, height=tp.HEIGHT)
    engine = Engine(window, config, _quiet_log(), device=device)
    scene = Scene(tp.torch_assets("sponza_small"), config, _quiet_log(),
                  camera=tp.port_camera(), device=device)
    return engine, scene, window


def test_engine_render_returns_while_the_stream_is_busy(dev):
    """Engine.render's first call (frame, pinned copy, event) returns while
    a ~0.1 s sleep kernel holds the stream, and the frame it presents later
    is the synchronized frame."""
    engine, scene, window = _small_engine(dev)
    want = scene.render_still()  # builds the kernels and the scene state
    stream = torch.cuda.current_stream(dev)
    torch.cuda._sleep(200_000_000)
    engine.render(scene)
    busy = not stream.query()
    assert window.last_frame is None
    engine.wait_idle()
    assert busy, "Engine.render waited for the card"
    np.testing.assert_array_equal(np.moveaxis(window.last_frame[..., :3], -1, 0), want)


def test_engine_pinned_ring_is_not_reused_early(dev):
    """Over 12 frames of a moving camera, each presented frame equals that
    camera's frame rendered alone: no pinned buffer is overwritten before
    the window has consumed its frame."""
    engine, scene, window = _small_engine(dev)
    presented = []
    present = window.present

    def record(frame):
        present(frame)
        presented.append(window.last_frame.copy())

    window.present = record
    for i in range(12):
        scene.camera.translate((0.15 * (i % 3), 0.0, -0.2))
        scene.camera.rotate(0.0, 0.03)
        engine.render(scene)
    engine.wait_idle()
    assert len(presented) == 12
    alone = []
    camera = tp.port_camera()
    for i in range(12):
        camera.translate((0.15 * (i % 3), 0.0, -0.2))
        camera.rotate(0.0, 0.03)
        scene.camera = camera
        alone.append(scene.render_still())
    assert len({f.tobytes() for f in alone}) == 12
    for got, want in zip(presented, alone):
        np.testing.assert_array_equal(np.moveaxis(got[..., :3], -1, 0), want)


@pytest.mark.parametrize("msaa", [1, 4])
def test_game_main_on_the_card_matches_the_cpu(dev, msaa, tmp_path, monkeypatch):
    """The viewer on a textured box written by the port's own writer (a
    ZLIB KTX2 texture): the card's frames against the CPU's plain versions,
    within chip_smoke.py's FRAME_MISMATCH (one u8 step on 0.5% of pixels;
    chip_smoke.read_png decodes the dumps: the card's machine has no PIL)."""
    import vktf_tpu_torch.engine
    from chip_smoke import FRAME_MISMATCH, read_png
    from vktf_tpu_torch.game import main
    from vktf_tpu_torch.loaders.images import generate_mips
    from vktf_tpu_torch.loaders.ktx import SUPERCOMPRESSION_ZLIB, write_ktx2
    from vktf_tpu_torch.models.gltf_writer import GltfWriter
    from vktf_tpu_torch.models.primitives import box_mesh

    rgba = np.random.default_rng(3).integers(0, 256, (16, 16, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    write_ktx2(tmp_path / "base.ktx2", generate_mips(rgba, True), True, SUPERCOMPRESSION_ZLIB)
    w = GltfWriter()
    texture = w.add_texture(w.add_image_uri("base.ktx2"), w.add_sampler())
    mesh = w.add_mesh(box_mesh(), material=w.add_material(base_color_texture=texture,
                                                          roughness_factor=0.6))
    w.add_scene([w.add_node(mesh=mesh, translation=(3, 1, 0), rotation=(0, 0.38, 0, 0.92)),
                 w.add_node(light=w.add_light(type="directional"),
                            rotation=(-0.38, 0, 0, 0.92))])
    path = str(w.write(tmp_path / "box.gltf"))
    monkeypatch.setattr(vktf_tpu_torch.engine, "DeltaTime", _FixedDeltaTime)
    args = [path, "--width", "96", "--height", "64", "--msaa", str(msaa), "--frames", "6",
            "--display", "off"]
    assert main(args + ["--frame-dir", str(tmp_path / "card")]) == 0
    assert main(args + ["--frame-dir", str(tmp_path / "cpu")], device="cpu") == 0
    got = sorted((tmp_path / "card").glob("frame_*.png"))
    want = sorted((tmp_path / "cpu").glob("frame_*.png"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 7
    for g, c in zip(got, want):
        a, b = read_png(g).astype(np.int16), read_png(c).astype(np.int16)
        diff = np.abs(a - b).max(axis=-1)
        assert diff.max() <= 1 and (diff > 0).mean() <= FRAME_MISMATCH, g.name
        assert (a[..., :3].max(axis=-1) > 0).mean() > 0.05


@pytest.mark.parametrize("fmt, scale", [("yuv420", 1), ("rgb", 2), ("yuv420", 2), ("rgb", 4),
                                        ("yuv420", 4)])
def test_present_encodings_on_the_card_equal_the_cpu(dev, fmt, scale):
    """The encode chain on the card, bit for bit the CPU encode of the same
    frame (random bytes, the 0/255 extremes, gray), and the frame program's
    encoded frame the CPU encode of its own exact frame."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops.present import make_present_encoder
    from vktf_tpu_torch.scene.scene import Scene

    cfg = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4, present_format=fmt,
                       present_scale=scale)
    encode = make_present_encoder(cfg)
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (tp.HEIGHT, tp.WIDTH), dtype=np.uint8)
    for frame in (rng.integers(0, 256, (3, tp.HEIGHT, tp.WIDTH), dtype=np.uint8),
                  rng.choice(np.array([0, 255], np.uint8), (3, tp.HEIGHT, tp.WIDTH)),
                  np.broadcast_to(gray, (3, tp.HEIGHT, tp.WIDTH)).copy()):
        t = torch.from_numpy(frame)
        got = encode(t.to(dev))
        assert got.is_cuda
        assert torch.equal(got.cpu(), encode(t))
    scene = Scene(tp.torch_assets("sponza_small"), cfg, camera=tp.port_camera(), device=dev)
    encoded = scene.render_async()
    exact = scene.render_still()
    assert torch.equal(encoded.cpu(), encode(torch.from_numpy(exact)))
    exact_scene = Scene(tp.torch_assets("sponza_small"), cfg.replace(present_format="rgb",
                                                                      present_scale=1),
                        camera=tp.port_camera(), device=dev)
    np.testing.assert_array_equal(exact, exact_scene.render_still())


@pytest.mark.parametrize("name, kw", [("sponza_small", {}), ("sponza_small_blend", {}),
                                      ("sponza_small_mixed", {}),
                                      ("sponza_small", {"aniso_taps": 2})])
def test_sample_rate_frame_on_the_card_matches_the_cpu(dev, name, kw):
    """A sample-rate frame (4x MSAA, the layer records over every sample)
    on the card against the CPU's, within chip_smoke.py's FRAME_MISMATCH."""
    from chip_smoke import FRAME_MISMATCH

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.scene.scene import Scene

    cfg = RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4, shading_rate="sample",
                       **kw)
    frames = [Scene(tp.torch_assets(name), cfg, camera=tp.port_camera(),
                    device=device).render_still() for device in (dev, "cpu")]
    diff = np.abs(frames[0].astype(np.int16) - frames[1]).max(axis=0)
    assert diff.max() <= 1 and (diff > 0).mean() <= FRAME_MISMATCH


def test_sample_rate_launches_the_layer_record(dev):
    """At K = 1 the sample-rate frame launches the layer record once, and
    the resolve record never."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.ops import shade_kernel
    from vktf_tpu_torch.scene.scene import Scene

    scene = Scene(tp.torch_assets("sponza_small"),
                  RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4,
                               shading_rate="sample"),
                  camera=tp.port_camera(), device=dev)
    scene.render_async()
    for k in shade_kernel.KERNELS:
        k.launches = 0
    scene.render_async()
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in shade_kernel.KERNELS if k.launches} == {
        "shade_layer": 1}


def test_duck_frame_on_the_card_matches_the_cpu(dev):
    """One duck frame (4,096 triangles, exactly 16 raster chunks; bench.py's
    msaa 1 and camera) and one box frame (12 triangles, less than one
    chunk) on the card against the CPU."""
    from chip_smoke import FRAME_MISMATCH

    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.mathx import Camera, ViewFrustumParams
    from vktf_tpu_torch.models.scenes import build_preset
    from vktf_tpu_torch.scene.scene import Scene

    for preset, pose in (("duck", ((0.0, 0.5, 2.0), (0.0, -0.2, -1.0))),
                         ("box", ((0.0, 0.8, 2.4), (0.0, -0.25, -1.0)))):
        cfg = RenderConfig(width=320, height=192, msaa_samples=1)
        frames = [Scene(build_preset(preset), cfg,
                        camera=Camera(*pose, ViewFrustumParams(np.radians(45.0), 320 / 192,
                                                               0.1, 1.0e6)),
                        device=device).render_still() for device in (dev, "cpu")]
        diff = np.abs(frames[0].astype(np.int16) - frames[1]).max(axis=0)
        assert (frames[1].max(axis=0) > 0).mean() > 0.05, preset
        assert diff.max() <= 1 and (diff > 0).mean() <= FRAME_MISMATCH, preset


@pytest.mark.parametrize("layers", [1, 8])
def test_band_raster_kernel(dev, layers):
    """The raster kernel's band offset: a band of rows equals those rows of
    the full frame's raster (ids and depth bits) and the plain version at
    the band's shape; rows past the frame stay empty."""
    from vktf_tpu_torch.ops import raster

    _rs, _m, _l, _vp, _setup, stream = _stages(dev, 4)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, layers)
    for y0, rows in ((0, 64), (64, 64), (16, 48), (96, 64)):
        got = raster.rasterize(*stream, rows, tp.WIDTH, 4, layers, y_offset=y0)
        want = raster.rasterize_plain(*stream, rows, tp.WIDTH, 4, layers, y0)
        assert torch.equal(got[0], want[0]), y0
        tp.assert_bits_equal(got[1].cpu().numpy(), want[1].cpu().numpy(), f"band {y0}")
        n = min(rows, tp.HEIGHT - y0)
        assert torch.equal(got[0][..., :n, :], ids[..., y0:y0 + n, :]), y0
        tp.assert_bits_equal(got[1][..., :n, :].cpu().numpy(),
                             depth[..., y0:y0 + n, :].cpu().numpy(), f"band rows {y0}")
        assert bool((got[0][..., n:, :] == -1).all())


def _gloo_ranks_frame(leaves, meta, gp, sp):
    """On every rank of a gloo group sharing the card: the courtyard's
    sharded frame on the card."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.parallel import make_render_mesh
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda", torch.cuda.current_device())
    scene = Scene.from_render_scene(
        scene_from_numpy(leaves, dev), meta,
        RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4),
        camera=tp.port_camera(), mesh=make_render_mesh(gp, sp))
    return scene.render_still()


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)])
def test_gloo_ranks_on_one_card_render_the_single_device_frame(dev, mesh):
    """Two ranks sharing the card over gloo (its collectives staged through
    host memory): the sharded frame equals the card's single-device frame."""
    from vktf_tpu_torch.config import RenderConfig
    from vktf_tpu_torch.parallel import launch
    from vktf_tpu_torch.scene.scene import Scene

    leaves, meta = tp.torch_leaves("sponza_small")
    got = launch.run(_gloo_ranks_frame, 2, leaves, meta, *mesh, device="cuda",
                     backend="gloo", timeout_s=300)
    want = Scene(tp.torch_assets("sponza_small"),
                 RenderConfig(width=tp.WIDTH, height=tp.HEIGHT, msaa_samples=4),
                 camera=tp.port_camera(), device=dev).render_still()
    np.testing.assert_array_equal(got, want)
