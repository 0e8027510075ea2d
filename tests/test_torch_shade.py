"""Port parity: shade table, phase A (per-pixel winner) and the fused
shade + resolve against the JAX production frame program's own stages on
the small sponza frame (256x128, 4x MSAA, interpret mode).

* Table: bit for bit against ``build_shade_table_pallas`` unpacked from
  its u16 hi|lo halves to f32.
* Phase A: the winner (min depth, then min id) and coverage fraction,
  exactly, against ``pallas_shade_addr_tiled``'s.
* Shade + resolve: packed pixels against ``shade_final_chunk(...,
  frac=...)`` fed the same pixels. Tolerance: one u8 step on at most 0.1%
  of the pixels' channels. The two sides evaluate pow, log2 and rsqrt with
  different libraries (XLA's CPU expansions, PyTorch's vectorized ones),
  which differ by float32 ULPs; an ULP can carry a value across a u8
  rounding boundary, and a knife-edge floor of the mip level or texel
  coordinate can move a filter weight.
"""

import functools

import numpy as np
import jax
import torch

import torch_parity as tp

tp.limit_threads()


@functools.lru_cache(maxsize=None)
def _jax_frame_stages():
    """The production program's stages up to phase A (numpy out)."""
    prog = tp.jax_program("sponza_small", 4)
    scene, _meta = tp.jax_scene("sponza_small")
    jcam, _ = tp.cameras()
    vp = jcam.view_projection_transform
    setup, lights = prog._prepare(scene, vp, jcam.position)
    assert prog._prestream and prog._two_phase
    state = prog._maybe_restream(scene, setup, vp)
    tri_id, depth = prog._raster_stream(prog._stream_cam(*state, vp))
    table = prog._table(setup, scene)
    addr = prog._shade_addr(tri_id, depth, table)
    return dict(setup=setup, lights=lights, cam=jcam.position, tri_id=tri_id,
                depth=depth, table=table, addr=addr, prog=prog, scene=scene)


def _assemble(vec, cfg):
    """Block-layout flat (n_px,) -> row-major (H, W) (the JAX program's
    _tiled_assemble, one channel)."""
    from vktf_tpu.ops.pipeline import _tiled_assemble

    v = np.asarray(vec)
    return np.asarray(_tiled_assemble(np.stack([v, v, v]), cfg))[0]


def test_table_matches_jax_bit_for_bit():
    from vktf_tpu_torch.ops.shade_table import build_shade_table

    st = _jax_frame_stages()
    setup, scene = st["setup"], st["scene"]
    want = tp.unpack_table(st["table"])
    inst_rows, tri_instance = tp.instances_of(setup["mrows"], scene.tri_instance,
                                              scene.inst_node.shape[0])
    got = build_shade_table(
        tp.as_torch(setup["edge9"]), tp.as_torch(scene.tri_corner),
        tp.as_torch(scene.tri_static_cols), tp.as_torch(setup["anchor2"]),
        tp.as_torch(inst_rows), tp.as_torch(tri_instance))
    assert got.shape == want.shape == (scene.tri_corner.shape[1], 64)
    tp.assert_bits_equal(got.numpy(), want, "shade table")


def test_table_matches_jax_on_seven_rigid_instances():
    """The seeded special-case triangles under 7 random rigid instances (a
    random one per triangle) and random material columns: the port's table
    indexes the (I, 16) rows by the int32 index, the JAX kernel reads their
    gather; bit for bit."""
    import types

    from vktf_tpu.ops.setup_kernel import setup_pack_kernel
    from vktf_tpu.ops.shade_table import build_shade_table_pallas
    from vktf_tpu_torch.ops.shade_table import build_shade_table

    tri_corner, _rows, _idx = tp.seeded_triangles()
    t = tri_corner.shape[1]
    inst_rows, tri_instance = tp.seeded_instances(t)
    assert len(np.unique(tri_instance)) == inst_rows.shape[0] == 7
    mrowsT = tp.gathered_rowsT(inst_rows, tri_instance)
    static_cols = np.random.default_rng(11).uniform(0, 4, (15, t)).astype(np.float32)
    vp = np.asarray(tp.cameras()[0].view_projection_transform, np.float32)
    setup = jax.jit(lambda tc, m, v, p: setup_pack_kernel(
        tc, m, v, p, tp.WIDTH, tp.HEIGHT, interpret=True))(
            tri_corner, mrowsT, np.ones((1, t), np.float32), vp)
    jsetup = dict(valid=setup["valid"], edge9=setup["edge9"], anchor2=setup["anchor2"],
                  mrows=mrowsT.T)
    jscene = types.SimpleNamespace(tri_corner=tri_corner, tri_static_cols=static_cols)
    want = tp.unpack_table(build_shade_table_pallas(jsetup, jscene, None, interpret=True))
    got = build_shade_table(
        tp.as_torch(setup["edge9"]), tp.as_torch(tri_corner), tp.as_torch(static_cols),
        tp.as_torch(setup["anchor2"]), tp.as_torch(inst_rows), tp.as_torch(tri_instance))
    assert got.shape == want.shape == (t, 64)
    tp.assert_bits_equal(got.numpy(), want, "shade table")


def test_pixel_winner_matches_jax():
    from vktf_tpu_torch.ops.pipeline import pixel_winner

    st = _jax_frame_stages()
    cfg = tp.jax_config(4)
    # the raster's block layout, assembled to (S, H, W) the way
    # rasterize_pallas(assemble=True) does
    th, tw = cfg.tile_shape
    ty, tx, m, s = cfg.tiles_y, cfg.tiles_x, cfg.resolved_interleave(), 4

    def to_shw(blocks):
        b = np.asarray(blocks)
        return (b.reshape(ty, tx, m, th * s // m, m, tw // m)
                .reshape(ty, tx, m, th, s, tw // m)
                .transpose(4, 0, 3, 1, 2, 5)
                .reshape(s, ty * th, tx * tw))

    ids, depth = to_shw(st["tri_id"]), to_shw(st["depth"])
    tri, frac = pixel_winner(tp.as_torch(ids), tp.as_torch(depth))
    want_tri = _assemble(st["addr"]["ids"][0][:ids[0].size], cfg)
    want_frac = _assemble(st["addr"]["frac"], cfg)
    np.testing.assert_array_equal(tri.numpy().reshape(want_tri.shape), want_tri)
    np.testing.assert_array_equal(frac.numpy().reshape(want_frac.shape), want_frac)
    assert 0.0 < (want_frac == 1.0).mean() < 1.0
    assert ((want_frac > 0) & (want_frac < 1)).any()  # edge pixels resolve


def test_shade_resolve_matches_jax():
    from vktf_tpu.ops.shade_kernel import shade_final_chunk
    from vktf_tpu_torch.ops.shade_kernel import shade_resolve
    from vktf_tpu_torch.scene.flatten import scene_from_numpy

    st = _jax_frame_stages()
    cfg = tp.jax_config(4)
    addr, scene = st["addr"], st["scene"]
    n = addr["frac"].shape[0]
    assert len(addr["ids"]) == 1 and addr["ids"][0].shape[0] == n
    background = np.asarray(cfg.clear_color, np.float32)
    want = np.asarray(jax.jit(lambda a, q, cam, lights: shade_final_chunk(
        a["trow"][0], a["r0"][0], None, a["ids"][0], a["sx"][0], a["sy"][0],
        q, cam, lights, max_anisotropy=cfg.max_anisotropy, interpret=True,
        frac=a["frac"], background=background, fused_pool=True))(
            addr, scene.quad_pool, st["cam"], st["lights"]))

    pool = scene_from_numpy(tp.jax_leaves("sponza_small"), "cpu").quad_pool
    got = shade_resolve(
        tp.as_torch(addr["ids"][0]), tp.as_torch(addr["sx"][0]),
        tp.as_torch(addr["sy"][0]), tp.as_torch(addr["frac"]),
        torch.from_numpy(tp.unpack_table(st["table"])), pool,
        tp.as_torch(st["cam"]), tp.as_torch(st["lights"]),
        torch.from_numpy(background[:3]), cfg.max_anisotropy).numpy()
    assert got.shape == want.shape == (n,)
    step = np.zeros(n, np.int64)
    for c in range(3):
        d = np.abs(((got >> (8 * c)) & 0xFF).astype(np.int64)
                   - ((want >> (8 * c)) & 0xFF))
        step = np.maximum(step, d)
    assert step.max() <= 1, int(step.max())
    assert (step > 0).mean() <= 1e-3, float((step > 0).mean())
    lit = ((want & 0xFFFFFF) != 0).mean()
    assert lit > 0.5  # most of the view is lit courtyard
