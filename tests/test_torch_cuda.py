"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda`` and skipped where there is no CUDA device. On a machine
with a card and nvcc (it needs no jax; this directory's conftest.py does,
so skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are the seeded special-case triangles of test_torch_setup.py, the
small sponza courtyard at 256x128 (every MSAA count, K = 1, 2, 4, 8 peel
layers), the hand-computed fill-rule geometry of test_torch_raster.py and
a 9-deep stack of equal-depth quads. Tolerance: bit-equal (the
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
    mrowsT, lights = pipeline.scene_update(rs, meta)
    setup = setup_kernel.setup_pack(rs.tri_corner, mrowsT, vp, tp.WIDTH, tp.HEIGHT)
    perm = raster.stream_perm(setup["bbox_rows"], setup["valid"])
    stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"], perm)
    return rs, mrowsT, lights, vp, setup, stream


def _assert_dicts_bit_equal(got, want):
    for key in want:
        g, w = got[key], want[key]
        if g.dtype == torch.float32:
            tp.assert_bits_equal(g.cpu().numpy(), w.cpu().numpy(), key)
        else:
            assert torch.equal(g, w), key


def test_setup_kernel_special_cases(dev):
    from vktf_tpu_torch.ops import setup_kernel

    tri_corner, mrowsT = tp.seeded_triangles()
    vp = np.asarray(tp.port_camera().view_projection_transform, np.float32)
    args = (torch.from_numpy(tri_corner).to(dev), torch.from_numpy(mrowsT).to(dev),
            torch.from_numpy(vp).to(dev), tp.WIDTH, tp.HEIGHT)
    before = setup_kernel.KERNEL.launches
    got = setup_kernel.setup_pack(*args)
    assert setup_kernel.KERNEL.launches == before + 1
    _assert_dicts_bit_equal(got, setup_kernel.setup_pack_plain(*args))


def test_setup_kernel_sponza(dev):
    from vktf_tpu_torch.ops import setup_kernel

    rs, mrowsT, _lights, vp, setup, _stream = _stages(dev, 4)
    want = setup_kernel.setup_pack_plain(rs.tri_corner, mrowsT, vp, tp.WIDTH, tp.HEIGHT)
    _assert_dicts_bit_equal(setup, want)


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

    rs, mrowsT, _lights, _vp, setup, _stream = _stages(dev, 4)
    args = (setup["edge9"], rs.tri_corner, rs.tri_static_cols, setup["anchor2"], mrowsT)
    got = shade_table.build_shade_table(*args)
    tp.assert_bits_equal(got.cpu().numpy(),
                         shade_table.build_shade_table_plain(*args).cpu().numpy(), "table")


def test_shade_kernel(dev):
    from vktf_tpu_torch.ops import pipeline, raster, shade_kernel, shade_table

    rs, mrowsT, lights, _vp, setup, stream = _stages(dev, 4)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                          rs.tri_static_cols, setup["anchor2"], mrowsT)
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

    rs, mrowsT, lights, _vp, setup, stream = _stages(dev, 4)
    ids, depth = raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, 3)
    table = shade_table.build_shade_table(setup["edge9"], rs.tri_corner,
                                          rs.tri_static_cols, setup["anchor2"], mrowsT)
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

    rs, mrowsT, _lights, vp, setup, stream = _stages(dev, 4)
    with pytest.raises(ValueError):  # float64 corners
        setup_kernel.setup_pack(rs.tri_corner.double(), mrowsT, vp, 8, 8)
    with pytest.raises(ValueError):  # operands on two devices
        setup_kernel.setup_pack(rs.tri_corner, mrowsT.cpu(), vp, 8, 8)
    with pytest.raises(ValueError):  # non-contiguous
        shade_table.build_shade_table(setup["edge9"][:, ::2], rs.tri_corner[:, ::2],
                                      rs.tri_static_cols[:, ::2],
                                      setup["anchor2"][:, ::2], mrowsT[:, ::2])
    with pytest.raises(ValueError):  # frame not a multiple of the 16 px block
        raster.rasterize(*stream, 100, 100, 4)
    for layers in (0, 9):  # the kernel keeps 1..8 layers
        with pytest.raises(ValueError):
            raster.rasterize(*stream, tp.HEIGHT, tp.WIDTH, 4, layers)
