"""Port parity of the texture side paths of the deferred shade: multi-tap
anisotropy, the two-gather ("classic") pool, per-slot samplers and the
attrs boundary, each against the JAX function it replaces, fed the same
stage outputs (the port's setup, raster and table on the CPU; the tests
of those stages hold them to the JAX ones).

* Multi-tap, taps 2, 4 and 8: ``shade_resolve(texels="fused", taps=N)``
  against ``shade_addr_chunk`` + ``shade_final_chunk(fused_pool=True,
  aniso_taps=N, interpret=True)`` on every 32nd pixel of the small
  courtyard (1,024 pixels, one block of the JAX kernel, which runs in
  interpret mode).
* Classic: ``shade_resolve(texels="classic")`` against
  ``shade_final_chunk(fused_pool=False)`` on a mirror-wrap plane whose uvs
  run over [-0.75, 1.75].
* Resolved pixels: one u8 step on at most STEP_SHARE of the pixels. The
  two sides evaluate pow, log2 and rsqrt with different libraries
  (test_torch_shade.py), and an ULP can carry a value across a u8 rounding
  boundary or move a knife-edge floor.
* Classic equals fused bit for bit, frames at K = 1 and K = 2, on the
  edge-case plane (uv far outside [0, 1], lod reaching the chain top where
  l1 == l0, an 8 px chain) for repeat trilinear, clamp and nearest
  samplers (tests/test_textures.py:285-324).
* Per-slot samplers (taps 1 and 4) and classic taps against the XLA form
  ``shade_table_layer(per_slot_samplers=..., aniso_taps=...)``, layer
  outputs: alpha within ALPHA_ULP units in the last place on all but
  ALPHA_ULP_SHARE of the pixels, radiance within RGB_ULP on all but
  RGB_ULP_SHARE of the values and within RGB_ULP_MAX everywhere
  (test_torch_peel.py's bounds: the light sum cancels, so a library ULP
  grows).
* The attrs boundary: ``fragment_attrs`` against ``shade_attrs_chunk``
  (row by row, bounds below), and ``shade_attrs_resolve`` /
  ``shade_attrs_layer`` against ``shade_final_attrs_chunk(interpret=True)``
  fed the JAX package's own rows.
* Routing: FrameProgram takes the form PallasFrameProgram takes for every
  flag and scene combination, and ``aniso_taps`` outside 1, 2, 4, 8
  raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp

tp.limit_threads()

STEP_SHARE = 1e-3
RGB_ULP = 64
RGB_ULP_SHARE = 1e-2
RGB_ULP_MAX = 1024
ALPHA_ULP = 2
ALPHA_ULP_SHARE = 1e-4
MIRROR = {"wrap_u": "mirrored_repeat", "wrap_v": "mirrored_repeat"}
MIRROR_PLANE = dict(tp.MIXED_PLANE, samplers=(MIRROR,) * 3)
PLANE_W, PLANE_H = 96, 64


def _config(**kw):
    from vktf_tpu_torch.config import RenderConfig

    return RenderConfig(**{"width": tp.WIDTH, "height": tp.HEIGHT, "msaa_samples": 4, **kw})


@functools.lru_cache(maxsize=None)
def _sponza_stages():
    """The small courtyard (the JAX package's scene) through the port's
    stages, as numpy."""
    from vktf_tpu_torch.scene.flatten import scene_from_numpy
    from vktf_tpu_torch.scene.scene import Scene

    _scene, jmeta = tp.jax_scene("sponza_small")
    _jcam, tcam = tp.cameras()
    scene = Scene.from_render_scene(scene_from_numpy(tp.jax_leaves("sponza_small"), "cpu"),
                                    tp.port_meta(jmeta), _config(), camera=tcam)
    return {k: v.numpy() for k, v in tp.port_stages(scene).items()}


@functools.lru_cache(maxsize=None)
def _plane_stages(which: str):
    from vktf_tpu_torch.scene.scene import Scene

    spec = {"mirror": MIRROR_PLANE, "mixed": tp.MIXED_PLANE}[which]
    scene = Scene([tp.plane_asset(**spec)],
                  _config(width=PLANE_W, height=PLANE_H, tile_shape=(32, 64)),
                  camera=tp.plane_camera(spec, PLANE_W, PLANE_H), device="cpu")
    assert scene.meta.mirror_wrap and scene.meta.mixed_samplers == (which == "mixed")
    return {k: v.numpy() for k, v in tp.port_stages(scene).items()}


def _port(st, *names):
    return [torch.from_numpy(np.ascontiguousarray(st[n])) for n in names]


def _u8_step(got, want):
    step = np.zeros(got.shape, np.int64)
    for c in range(3):
        step = np.maximum(step, np.abs(((got >> (8 * c)) & 0xFF).astype(np.int64)
                                       - ((want >> (8 * c)) & 0xFF)))
    return step


def _assert_packed_close(got, want):
    assert got.shape == want.shape
    step = _u8_step(got, want)
    assert step.max() <= 1, int(step.max())
    assert (step > 0).mean() <= STEP_SHARE, float((step > 0).mean())


def _assert_layer_close(rgb, alpha, want_rgb, want_alpha, covered):
    alpha_ulp = tp.ulp_diff(alpha, want_alpha)
    assert alpha_ulp.max() <= ALPHA_ULP, int(alpha_ulp.max())
    assert (alpha_ulp > 0).mean() <= ALPHA_ULP_SHARE, float((alpha_ulp > 0).mean())
    assert (rgb[:, ~covered] == 0).all()
    ulp = tp.ulp_diff(rgb[:, covered], want_rgb[:, covered])
    assert ulp.max() <= RGB_ULP_MAX, int(ulp.max())
    assert (ulp > RGB_ULP).mean() <= RGB_ULP_SHARE, float((ulp > RGB_ULP).mean())


def _jax_args(st):
    return (st["tri"], st["sx"], st["sy"], tp.pack_table(st["table"]), tp.pool_u16(st["pool"]),
            st["cam"], st["lights"])


@pytest.mark.parametrize("taps", [2, 4, 8])
def test_multi_tap_matches_jax_kernel(taps):
    from vktf_tpu.ops.shade_kernel import shade_addr_chunk, shade_final_chunk
    from vktf_tpu_torch.ops.shade_kernel import shade_resolve

    full = _sponza_stages()
    st = dict(full, **{k: full[k][::32] for k in ("tri", "frac", "sx", "sy")})
    ma = _config().max_anisotropy
    background = np.zeros(4, np.float32)

    @jax.jit
    def reference(tri, sx, sy, table, pool, cam, lights, frac):
        trow, r0, r1 = shade_addr_chunk(tri, sx, sy, table, ma, fused_pool=True, aniso_taps=taps)
        return shade_final_chunk(trow, r0, r1, tri, sx, sy, pool, cam, lights,
                                 max_anisotropy=ma, interpret=True, frac=frac,
                                 background=background, fused_pool=True, aniso_taps=taps)

    want = np.asarray(reference(*_jax_args(st), st["frac"]))
    args = _port(st, "tri", "sx", "sy", "frac", "table", "pool", "cam", "lights", "bg")
    got = shade_resolve(*args, ma, "fused", taps).numpy()
    _assert_packed_close(got, want)
    # the taps act: the frame differs from the one-tap frame
    one = shade_resolve(*args, ma).numpy()
    assert (_u8_step(got, one) > 1).mean() > 0.01


def test_classic_matches_jax_kernel_on_a_mirror_plane():
    from vktf_tpu.ops.shade_kernel import shade_addr_chunk, shade_final_chunk
    from vktf_tpu_torch.ops.shade_kernel import shade_resolve

    st = _plane_stages("mirror")
    ma = _config().max_anisotropy
    background = np.zeros(4, np.float32)

    @jax.jit
    def reference(tri, sx, sy, table, pool, cam, lights, frac):
        trow, r0, r1 = shade_addr_chunk(tri, sx, sy, table, ma, fused_pool=False)
        return shade_final_chunk(trow, r0, r1, tri, sx, sy, pool, cam, lights,
                                 max_anisotropy=ma, interpret=True, frac=frac,
                                 background=background, fused_pool=False)

    want = np.asarray(reference(*_jax_args(st), st["frac"]))
    args = _port(st, "tri", "sx", "sy", "frac", "table", "pool", "cam", "lights", "bg")
    got = shade_resolve(*args, ma, "classic").numpy()
    assert ((want & 0xFFFFFF) != 0).mean() > 0.3
    _assert_packed_close(got, want)
    # mirror wrap matters here: the fused row's slot B would read other texels
    assert (_u8_step(shade_resolve(*args, ma, "fused").numpy(), got) > 0).any()


@pytest.mark.parametrize("samplers", [
    {},  # repeat, trilinear
    {"wrap_u": "clamp_to_edge", "wrap_v": "clamp_to_edge"},
    {"mag_filter": "nearest", "min_filter": "nearest", "mipmap_mode": "nearest"},
], ids=["repeat_trilinear", "clamp", "nearest"])
def test_classic_equals_fused_bitwise(samplers):
    from vktf_tpu_torch.scene.scene import Scene

    spec = dict(tp.EDGE_PLANE, samplers=(samplers,) * 3)
    camera = tp.plane_camera(spec, PLANE_W, PLANE_H)
    for layers in (1, 2):
        frames = {}
        for fused in (None, False):
            scene = Scene([tp.plane_asset(**spec)],
                          _config(width=PLANE_W, height=PLANE_H, tile_shape=(32, 64),
                                  peel_layers=layers, shade_fused_pool=fused),
                          camera=camera, device="cpu")
            assert not scene.meta.mirror_wrap and not scene.meta.mixed_samplers
            frames[scene.frame_program.form.texels] = scene.render_still()
        assert (frames["fused"].max(axis=0) > 0).mean() > 0.5
        np.testing.assert_array_equal(frames["classic"], frames["fused"])


@pytest.mark.parametrize("which, texels, taps", [
    ("mixed", "per_slot", 1), ("mixed", "per_slot", 4), ("mirror", "classic", 4)])
def test_per_slot_and_classic_taps_match_jax_xla(which, texels, taps):
    from vktf_tpu.ops.shade_table import shade_table_layer
    from vktf_tpu_torch.ops.shade_kernel import shade_layer

    st = _plane_stages(which)
    ma = _config().max_anisotropy
    rgb_j, alpha_j, covered = (np.asarray(a) for a in jax.jit(
        lambda *a: shade_table_layer(*a, max_anisotropy=ma,
                                     per_slot_samplers=texels == "per_slot",
                                     aniso_taps=taps))(*_jax_args(st)))
    tri, sx, sy, table, pool, cam, lights = _port(
        st, "tri", "sx", "sy", "table", "pool", "cam", "lights")
    rgb, alpha = shade_layer(tri[None], sx, sy, table, pool, cam, lights, ma, texels, taps)
    assert covered.mean() > 0.3
    _assert_layer_close(rgb[0].numpy(), alpha[0].numpy(), rgb_j, alpha_j, covered)
    if taps > 1:  # the taps act
        one, _ = shade_layer(tri[None], sx, sy, table, pool, cam, lights, ma, texels)
        assert (np.abs(one[0].numpy() - rgb[0].numpy()) > 1e-3).any(axis=0).mean() > 0.01


@functools.lru_cache(maxsize=None)
def _jax_attrs():
    from vktf_tpu.ops.shade_kernel import shade_attrs_chunk

    st = _sponza_stages()
    tri, sx, sy, table = _jax_args(st)[:4]
    attrs, r0, r1 = jax.jit(lambda *a: shade_attrs_chunk(*a, _config().max_anisotropy))(
        tri, sx, sy, table)
    return np.asarray(attrs), np.asarray(r0), np.asarray(r1)


def test_attrs_phase_a_matches_jax():
    """Rows bit for bit but where log2 differs by an ULP: the lerp weight
    within LFRAC_ABS (two ULPs of a lod below 8), and a knife-edge floor of
    the mip level or texel coordinate moving the footprint rows and pool
    rows of at most MOVED_SHARE of the pixels."""
    from vktf_tpu_torch.ops.shade_kernel import A_LFRAC, A_WPOS, ATTR_ROWS, fragment_attrs

    lfrac_abs, moved_share = 2e-6, 1e-3
    st = _sponza_stages()
    attrs, r0, r1 = fragment_attrs(*_port(st, "tri", "sx", "sy", "table"),
                                   _config().max_anisotropy)
    want, want_r0, want_r1 = _jax_attrs()
    attrs = attrs.numpy()
    assert attrs.shape == (ATTR_ROWS, st["tri"].shape[0]) and want.shape[0] >= ATTR_ROWS
    tp.assert_bits_equal(attrs[A_WPOS:], want[A_WPOS:ATTR_ROWS], "interpolated and material rows")
    footprint = np.delete(np.arange(A_WPOS), A_LFRAC)
    moved = ((r0.numpy() != want_r0) | (r1.numpy() != want_r1)
             | (attrs[footprint] != want[footprint]).any(axis=0))
    assert moved.mean() <= moved_share, float(moved.mean())
    lfrac_err = np.abs(attrs[A_LFRAC] - want[A_LFRAC])[~moved]
    assert lfrac_err.max() <= lfrac_abs, float(lfrac_err.max())


@pytest.mark.parametrize("form", ["resolve", "layer"])
def test_attrs_shade_matches_jax_kernel(form):
    from vktf_tpu.ops.shade_kernel import shade_final_attrs_chunk
    from vktf_tpu_torch.ops.shade_kernel import ATTR_ROWS, shade_attrs_layer, shade_attrs_resolve

    st = _sponza_stages()
    attrs, r0, r1 = _jax_attrs()
    tri, pool, cam, lights = _port(st, "tri", "pool", "cam", "lights")
    port_attrs = torch.from_numpy(np.array(attrs[:ATTR_ROWS]))
    p_r0, p_r1 = torch.from_numpy(np.array(r0)), torch.from_numpy(np.array(r1))
    background = np.zeros(4, np.float32)
    frac = st["frac"] if form == "resolve" else None
    want = jax.jit(lambda a, b, c, t, q, cm, li, f: shade_final_attrs_chunk(
        a, b, c, t, q, cm, li, interpret=True, frac=f, background=background))(
            attrs, r0, r1, st["tri"], tp.pool_u16(st["pool"]), st["cam"], st["lights"], frac)
    if form == "resolve":
        got = shade_attrs_resolve(port_attrs, p_r0, p_r1, tri, torch.from_numpy(st["frac"]),
                                  pool, cam, lights, torch.zeros(3))
        _assert_packed_close(got.numpy(), np.asarray(want))
        assert ((np.asarray(want) & 0xFFFFFF) != 0).mean() > 0.5
    else:
        rgb, alpha = shade_attrs_layer(port_attrs[None], p_r0[None], p_r1[None], tri[None],
                                       pool, cam, lights)
        _assert_layer_close(rgb[0].numpy(), alpha[0].numpy(), np.asarray(want[0]),
                            np.asarray(want[1]), st["tri"] >= 0)


_ROUTES = [  # (scene: mirror_wrap, mixed_samplers), config overrides
    ((False, False), {}),
    ((False, False), {"shade_fused_pool": False}),
    ((False, False), {"shade_fused_pool": True}),
    ((False, False), {"aniso_taps": 4}),
    ((False, False), {"aniso_taps": 2, "shade_fused_pool": False}),
    ((False, False), {"shade_attrs_boundary": True}),
    ((False, False), {"shade_attrs_boundary": True, "aniso_taps": 8}),
    ((True, False), {}),
    ((True, False), {"shade_fused_pool": True}),
    ((True, False), {"aniso_taps": 4}),
    ((True, False), {"shade_attrs_boundary": True}),
    ((True, True), {}),
    ((True, True), {"aniso_taps": 2}),
    ((True, True), {"shade_attrs_boundary": True}),
    ((False, True), {"shade_attrs_boundary": True, "aniso_taps": 4}),
]


def _jax_form(prog, config, meta):
    """(texels, taps, attrs) of the shade PallasFrameProgram built: the
    two-phase kernels (attrs, or fused / classic with the kernel's taps),
    else the XLA form (per-slot rows for mixed samplers)."""
    taps = config.aniso_taps
    if not prog._two_phase:
        return ("per_slot" if meta.mixed_samplers else "classic", taps, False)
    if config.resolved_attrs_boundary():
        return ("classic", 1, True)
    fused = config.resolved_fused_pool(mirror_wrap=meta.mirror_wrap,
                                       mixed_samplers=meta.mixed_samplers)
    return ("fused", taps, False) if fused else ("classic", 1, False)


@pytest.mark.parametrize("flags, overrides", _ROUTES)
def test_frame_program_routes_as_jax(flags, overrides):
    from vktf_tpu.ops.pipeline import PallasFrameProgram
    from vktf_tpu.scene.flatten import SceneMeta as JMeta
    from vktf_tpu_torch.ops.pipeline import FrameProgram
    from vktf_tpu_torch.scene.flatten import SceneMeta

    fields = dict(level_slices=((0, 1),), num_lights=1, num_instances=1,
                  num_triangles=100_000, num_vertices=3, mirror_wrap=flags[0],
                  mixed_samplers=flags[1])
    jconfig = tp.jax_config(**overrides)
    jprog = PallasFrameProgram(JMeta(**fields), jconfig)
    form = FrameProgram(SceneMeta(**fields), _config(**overrides)).form
    assert (form.texels, form.taps, form.attrs) == _jax_form(jprog, jconfig, JMeta(**fields))


@pytest.mark.parametrize("taps", [0, 3, 16])
def test_aniso_taps_outside_1_2_4_8_raise(taps):
    from vktf_tpu_torch.ops.shade_kernel import shade_resolve

    with pytest.raises(ValueError, match="aniso_taps"):
        _config(aniso_taps=taps)
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="taps"):
        shade_resolve(torch.zeros(1, dtype=torch.int32), z, z, z, torch.zeros(1, 64),
                      torch.zeros(1, 64, dtype=torch.int32), torch.zeros(3),
                      torch.zeros(0, 8), torch.zeros(3), 16.0, "fused", taps)


def test_every_kernel_instantiation_has_its_own_record():
    """Each (texel source, one tap or N taps, resolve or layer) template
    instantiation counts its launches in a record of its own, so a frame's
    counters show which compiled kernel ran."""
    from vktf_tpu_torch.ops import shade_kernel as sk

    records = [k for pair in sk._COLS_KERNELS.values() for k in pair]
    assert sorted(sk._COLS_KERNELS) == sorted(
        (texels, multi) for texels in sk.TEXELS for multi in (False, True))
    assert len({k.name for k in records}) == len(records) == 2 * 2 * len(sk.TEXELS)
    assert set(records) | {sk.KERNEL_ATTRS, sk.KERNEL_ATTRS_LAYER} == set(sk.KERNELS)
    assert len(sk.KERNELS) == len({k.name for k in sk.KERNELS})
