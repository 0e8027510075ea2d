"""The frame program: scene update, setup, stream order, raster, shade
table, per-pixel winner, shade and resolve, on one device.

Counterpart of ``vktf_tpu/ops/pipeline.py`` ``PallasFrameProgram``: pixel-
or sample-rate shading, K = 1..8 depth-peel layers, every texture
configuration, every present encoding. K is
``config.resolved_peel_layers(meta.peel_layers)``: 1 for opaque scenes,
1 + the translucent instances (at most 8) for MASK/BLEND ones. The shade
form (``shade_form``) follows the JAX program's routing
(``vktf_tpu/ops/pipeline.py:1082-1131``, ``:346-462``): the fused-mip pool
by default; the two-gather ("classic") pool for mirror-wrap scenes or
``shade_fused_pool=False``; per-slot rows for mixed-sampler scenes;
``aniso_taps`` N > 1 taps on whichever of these the scene takes (the JAX
package runs the taps of a two-gather scene in XLA; here the same CUDA
template runs them); ``shade_attrs_boundary`` the attrs kernels, unless
taps or mixed samplers send the frame to the two-gather multi-tap or
per-slot form, as in the JAX program. Nothing falls back to a cheaper
form. Stages, in order:

  1. scene update (cached per scene and per in-place edit of its tensors):
     node transforms, world lights, the (I, 16) instance matrices and the
     int32 per-triangle instance index;
  2. setup kernel (``ops/setup_kernel.py``), once per frame;
  3. screen-Morton stream order (``ops/raster.stream_perm``), kept across
     frames until the camera moves past ``config.resort_threshold``;
  4. raster prologue (``ops/raster.raster_stream``) and raster kernel,
     which keeps the K nearest (depth, id) fragments of every sample and,
     in its winner form (``raster.rasterize_winner``), writes phase A from
     them: per layer, the per-pixel winner (min depth, then min id) and
     layer 0's sample coverage fraction (``pixel_winner``, the plain
     version);
  5. shade-table kernel (``ops/shade_table.py``);
  6. with the attrs boundary, the 28 attribute rows and two pool rows of
     every (layer, pixel) (``shade_kernel.fragment_attrs``, stage "attrs");
  7. K = 1: the shade + resolve kernel of the form (``ops/shade_kernel.py``),
     which gathers the table and pool rows itself. K > 1: the layer shade
     kernel of the form, one launch over all K layers (linear radiance and
     alpha per layer and pixel), then in plain torch the front-to-back
     composite over the clear colour, the coverage resolve and the sRGB
     encode (``composite_resolve``; XLA ops outside any kernel in the JAX
     package, too);
  8. present: unpack the bytes, crop the tile padding and apply the
     configuration's encoding (``ops/present.py``: the exact planar frame,
     the preview downsample, the yuv420 pack).

Sample-rate shading (``shading_rate="sample"``, the JAX program's
non-tiled path, ``pallas_shade_resolve``'s sample branch) replaces phase A
and stages 6 and 7 at every K: the raster's planes form gives the
(K, S, H, W) ids, which go, flattened sample-major, through the layer
shade kernel of the form at each sample's own position (the pixel plus its
``SAMPLE_OFFSETS`` entry); the layers are composited over the clear colour
per sample, and the samples are averaged (``composite_samples``). It has
no per-pixel winner and no attrs boundary, as the JAX path has neither.

Nothing on the frame path waits for the card: the camera reaches it
through pinned memory with a non-blocking copy, the clear colour is made
once per device, constants are filled on the device (``fmath.f32``), and
no stage reads device data on the host. So ``Scene.render_async`` returns
once the frame is enqueued, and several frames can be in flight. Stage
and frame times on the card, synchronized and with frames in flight:
PERF.md.

Under ``torch.profiler`` each stage is a span ``frame.<stage>``, flat and
covering the frame's launches, in this order: camera (the staged copy),
scene_update, setup, stream_order (only in a frame that re-sorts), raster
(prologue and kernel, phase A included), shade_table, attrs, shade,
composite (K > 1 and sample rate) and present. The mesh program's stages
are spans likewise (``parallel/tiles.py``); there phase A is a stage of its
own, winner, after the devices' planes are merged. With no profiler
running a stage is one shared no-op context.

The JAX program ran the setup kernel twice (a second pass over
Morton-permuted inputs) and split the shade into two programs; both were
TPU layout economies that leave the frame unchanged, and are not copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vktf_tpu_torch.config import PEEL_LAYERS_MAX, SAMPLE_OFFSETS, RenderConfig
from vktf_tpu_torch.ops import _cuda, present, raster, setup_kernel, shade_kernel, shade_table
from vktf_tpu_torch.ops.fmath import f32, fma
from vktf_tpu_torch.ops.vertex import propagate_transforms
from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta
from vktf_tpu_torch.utils import profiling


def gather_world_lights(node_global, light_node, light_type, light_color):
    """World-space lights (L, 8): position (w = 1) or normalized +z
    direction (w = 0), then colour and a pad of 1."""
    if light_node.shape[0] == 0:
        return torch.zeros((0, 8), dtype=torch.float32, device=node_global.device)
    transforms = node_global[light_node]
    z_axis = transforms[:, :3, 2]
    direction = z_axis / torch.linalg.vector_norm(z_axis, dim=-1, keepdim=True)
    position = transforms[:, :3, 3]
    is_point = (light_type == 1)[:, None]
    pos_or_dir = torch.where(is_point, position, direction)
    pad = torch.ones_like(is_point, dtype=torch.float32)
    return torch.cat([pos_or_dir, is_point.float(), light_color, pad], dim=-1)


def scene_update(scene: RenderScene, meta: SceneMeta):
    """The camera-independent half of the frame: (inst_rows (I, 16) f32
    row-major instance matrices, tri_instance (T,) i32, lights (L, 8) f32)."""
    node_global = propagate_transforms(scene.node_local, scene.node_parent,
                                       meta.level_slices)
    lights = gather_world_lights(node_global, scene.light_node,
                                 scene.light_type, scene.light_color)
    inst_rows = node_global[scene.inst_node].reshape(-1, 16).contiguous()
    return inst_rows, scene.tri_instance.to(torch.int32), lights


def to_device(values, dev) -> torch.Tensor:
    """Host values as a float32 tensor on `dev`. A CUDA device gets them by
    a non-blocking copy from a fresh pinned buffer, so the host does not
    wait for the card (the pinned allocator reuses a buffer only once its
    copy has completed)."""
    host = torch.from_numpy(np.array(values, dtype=np.float32))
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


def pixel_winner(ids, depth):
    """Phase A: per pixel (and per peel layer), the sample winner (min
    depth, then min id among the covered samples; -1 when none) and the
    covered-sample fraction of layer 0.
    ids/depth (S, H, W) -> (tri (H*W,) i32, frac (H*W,) f32);
    (K, S, H, W) -> (tri (K, H*W) i32, frac (H*W,) f32)."""
    sample_dim = ids.dim() - 3
    d_min = depth.amin(dim=sample_dim, keepdim=True)
    imax = torch.iinfo(torch.int32).max
    cand = torch.where((depth == d_min) & (ids >= 0), ids,
                       torch.full_like(ids, imax))
    tri = cand.amin(dim=sample_dim)
    tri = torch.where(tri == imax, torch.full_like(tri, -1), tri)
    first = ids if ids.dim() == 3 else ids[0]
    frac = (first >= 0).float().mean(dim=0)
    return tri.reshape(*ids.shape[:sample_dim], -1), frac.reshape(-1)


def _composite(rgb, alpha, bg):
    """The K shaded layers composited front to back over the clear colour
    bg (3, 1): (3, N). XLA fuses each a * b + c * d with the left product
    (ops/fmath.py)."""
    one = f32(1.0, rgb)
    comp = bg.expand(rgb.shape[1:])
    for l in reversed(range(rgb.shape[0])):
        comp = fma(rgb[l], alpha[l], comp * (one - alpha[l]))
    return comp


def _pack_srgb(resolved):
    """Clamp, sRGB encode and u8 quantization of (3, N) linear values,
    packed r | g << 8 | b << 16: (N,) i32."""
    zero, one = f32(0.0, resolved), f32(1.0, resolved)
    u8 = shade_kernel.linear_to_srgb_u8(torch.minimum(torch.maximum(resolved, zero), one))
    return u8[0] | (u8[1] << 8) | (u8[2] << 16)


def composite_resolve(rgb, alpha, frac, background):
    """The depth-peel tail (vktf_tpu/ops/pipeline.py:502-509): the layers'
    composite, the coverage resolve and the sRGB encode, packed.
    rgb (K, 3, N), alpha (K, N), frac (N,), background (3,) -> (N,) i32."""
    bg = background.to(torch.float32)[:, None]
    comp = _composite(rgb, alpha, bg)
    return _pack_srgb(fma(comp, frac, bg * (f32(1.0, rgb) - frac)))


def composite_samples(rgb, alpha, background, samples: int):
    """The sample-rate tail (vktf_tpu/ops/pipeline.py:703-714): each
    sample's layers composited over the clear colour, the mean over the
    samples (summed in sample order, then scaled by 1/S, which equals the
    division by a power of two), the sRGB encode, packed.
    rgb (K, 3, S*N) and alpha (K, S*N) sample-major, background (3,) ->
    (N,) i32."""
    comp = _composite(rgb, alpha, background.to(torch.float32)[:, None])
    comp = comp.reshape(3, samples, -1)
    total = comp[:, 0]
    for s in range(1, samples):
        total = total + comp[:, s]
    return _pack_srgb(total * f32(1.0 / samples, rgb))


def pixel_centers(height: int, width: int, device, y0: int = 0):
    """Row-major pixel centres (sx, sy), each (H*W,) f32, of the rows
    y0 .. y0 + height (a band of the frame, exact in f32)."""
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return ((xs.float() + 0.5).reshape(-1).contiguous(),
            (ys.float() + 0.5).reshape(-1).contiguous())


def sample_centers(height: int, width: int, msaa_samples: int, device, y0: int = 0):
    """Every sample's position (sx, sy), each (S*H*W,) f32, sample-major
    (the order of the raster's flattened (S, H, W) ids), of the rows
    y0 .. y0 + height: the pixel index plus the sample's SAMPLE_OFFSETS
    entry (k / 16 for integer k, so each float32 sum is exact)."""
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    xs, ys = xs.float(), ys.float()
    offsets = SAMPLE_OFFSETS[msaa_samples]
    return (torch.stack([xs + ox for ox, _ in offsets]).reshape(-1),
            torch.stack([ys + oy for _, oy in offsets]).reshape(-1))


@dataclasses.dataclass(frozen=True)
class ShadeForm:
    """The shade FrameProgram runs: the texel source (one of
    shade_kernel.TEXELS), the tap count, and whether the attrs boundary
    splits it."""

    texels: str
    taps: int
    attrs: bool = False


def shade_form(config: RenderConfig, meta: SceneMeta) -> ShadeForm:
    """The JAX frame program's choice for this configuration and scene:
    its XLA form shades mixed-sampler scenes per slot and the taps of a
    two-gather scene (attrs boundary included), its attrs kernels the
    attrs boundary at one tap, its fused or classic kernel the rest. At
    sample rate the JAX program has no attrs form (``_shade_layer_fn``), so
    the attrs boundary is not taken there."""
    fused = config.resolved_fused_pool(mirror_wrap=meta.mirror_wrap,
                                       mixed_samplers=meta.mixed_samplers)
    attrs = config.shade_attrs_boundary and config.shading_rate == "pixel"
    taps = config.aniso_taps
    if meta.mixed_samplers:
        return ShadeForm("per_slot", taps)
    if taps > 1 and (attrs or not fused):
        return ShadeForm("classic", taps)
    if attrs:
        return ShadeForm("classic", 1, attrs=True)
    return ShadeForm("fused" if fused else "classic", taps)


class FrameProgram:
    """Renders one presented frame per call from a RenderScene and a
    camera, on the scene's device (plain versions of every kernel on the
    CPU, the CUDA kernels on a card): (3, H, W) u8, or (3, H/s, W/s) at
    present_scale s, or the flat yuv420 bytes."""

    def __init__(self, meta: SceneMeta, config: RenderConfig):
        self.meta = meta
        self.config = config
        self.layers = config.resolved_peel_layers(meta.peel_layers)
        if not 1 <= self.layers <= PEEL_LAYERS_MAX:
            raise ValueError(f"the scene asks for {self.layers} peel layers; the raster "
                             f"kernel keeps 1..{PEEL_LAYERS_MAX}")
        self.form = shade_form(config, meta)
        self._encode = present.make_present_encoder(config)
        self._samples = len(SAMPLE_OFFSETS[config.msaa_samples])
        self._scene_key = None
        self._scene_state = None
        self._perm = None
        self._sort_vp = None
        self._centers = None
        self._background = None

    def _maybe_scene_update(self, scene: RenderScene):
        """The scene update, rerun when a leaf it reads is replaced or edited
        in place (each tensor's identity and version counter). The stream
        order (``_maybe_resort``) only orders the raster's input and never
        changes the frame, so it follows the camera alone, as in the JAX
        program."""
        key = [(t, t._version) for t in (
            scene.node_local, scene.node_parent, scene.light_node, scene.light_type,
            scene.light_color, scene.inst_node, scene.tri_instance)]
        if self._scene_state is None or any(
                a is not b or va != vb for (a, va), (b, vb) in zip(key, self._scene_key)):
            self._scene_state = scene_update(scene, self.meta)
            self._scene_key = key
        return self._scene_state

    def _maybe_resort(self, setup, view_projection):
        """The stream order, rebuilt (stage "stream_order", so a frame has
        that span only when it re-sorts) when there is none on the setup's
        device or the camera moved past ``config.resort_threshold``."""
        vp = np.asarray(view_projection, dtype=np.float64)
        # scenes of one shape may share this program (runtime/cache.py): any
        # permutation orders any of their streams, but only on its device
        if (self._perm is not None and self.config.resort_threshold > 0
                and self._perm.device == setup["valid"].device):
            ref = self._sort_vp
            if (np.linalg.norm(vp - ref)
                    <= self.config.resort_threshold * np.linalg.norm(ref)):
                return self._perm
        with self._stage("stream_order"):
            self._perm = raster.stream_perm(setup["bbox_rows"], setup["valid"],
                                            chunk=self.config.pallas_chunk)
        self._sort_vp = vp
        return self._perm

    def _stage(self, name: str):
        """Stage `name` of the frame: the profiler span ``frame.<name>``, or
        the shared no-op context while no profiler runs."""
        return profiling.annotate("frame." + name)

    def __call__(self, scene: RenderScene, view_projection,
                 camera_position) -> torch.Tensor:
        # the scene's card is current for the whole frame: its launches go
        # there whichever device the caller had current
        with _cuda.on_device(scene.device):
            return self._frame(scene, view_projection, camera_position)

    def _frame(self, scene: RenderScene, view_projection, camera_position) -> torch.Tensor:
        cfg = self.config
        dev = scene.device
        ph, pw = cfg.padded_height, cfg.padded_width
        with self._stage("camera"):
            # one staged copy: vp (4, 4) and the camera position behind it
            staged = to_device(np.concatenate([np.ravel(view_projection),
                                               np.ravel(camera_position)]), dev)
            vp, cam = staged[:16].view(4, 4), staged[16:19]
            if self._centers is None or self._centers[0].device != dev:
                self._centers = (sample_centers(ph, pw, cfg.msaa_samples, dev)
                                 if cfg.shading_rate == "sample" else pixel_centers(ph, pw, dev))
                self._background = to_device(cfg.clear_color[:3], dev)
        background = self._background

        with self._stage("scene_update"):
            inst_rows, tri_instance, lights = self._maybe_scene_update(scene)
        with self._stage("setup"):
            setup = setup_kernel.setup_pack(scene.tri_corner, inst_rows, tri_instance,
                                            vp, cfg.width, cfg.height)
        perm = self._maybe_resort(setup, view_projection)
        sample_rate = cfg.shading_rate == "sample"
        with self._stage("raster"):
            stream = raster.raster_stream(setup["tri_data"], setup["bbox_rows"],
                                          perm, chunk=cfg.pallas_chunk)
            if sample_rate:  # every sample's ids are shaded
                ids, _depth = raster.rasterize(*stream, ph, pw, cfg.msaa_samples, self.layers)
            else:  # phase A in the kernel's epilogue: no planes are written
                tri, frac = raster.rasterize_winner(*stream, ph, pw, cfg.msaa_samples,
                                                    self.layers)
        with self._stage("shade_table"):
            table = shade_table.build_shade_table(
                setup["edge9"], scene.tri_corner, scene.tri_static_cols,
                setup["anchor2"], inst_rows, tri_instance)
        pool = scene.quad_pool
        if sample_rate:
            return self._present(self._shade_samples(ids, *self._centers, table, pool, cam,
                                                     lights, background))
        return self._present(self._shade_pixels(tri, frac, *self._centers, table, pool, cam,
                                                lights, background))

    def _shade_samples(self, ids, sx, sy, table, pool, cam, lights, background):
        """Sample-rate shading of the sample-major ids ((K, S*N), or the
        raster's (K, S, H, W)) at the given sample positions, composited and
        averaged per pixel: (N,) i32 packed."""
        form, cfg = self.form, self.config
        with self._stage("shade"):
            rgb, alpha = shade_kernel.shade_layer(ids.reshape(self.layers, -1), sx, sy, table,
                                                  pool, cam, lights, cfg.max_anisotropy,
                                                  form.texels, form.taps)
        with self._stage("composite"):
            return composite_samples(rgb, alpha, background, self._samples)

    def _shade_pixels(self, tri, frac, sx, sy, table, pool, cam, lights, background):
        """Stages 6 (attrs) and 7 of pixel-rate shading on the pixels whose
        winners, coverage and centres are given: (N,) i32 packed."""
        form, cfg = self.form, self.config
        if form.attrs:
            with self._stage("attrs"):
                attrs = shade_kernel.fragment_attrs(tri, sx, sy, table, cfg.max_anisotropy)
        if self.layers == 1:
            with self._stage("shade"):
                if form.attrs:
                    return shade_kernel.shade_attrs_resolve(
                        *attrs, tri, frac, pool, cam, lights, background)
                return shade_kernel.shade_resolve(
                    tri, sx, sy, frac, table, pool, cam, lights, background,
                    cfg.max_anisotropy, form.texels, form.taps)
        with self._stage("shade"):
            if form.attrs:
                rgb, alpha = shade_kernel.shade_attrs_layer(*attrs, tri, pool, cam, lights)
            else:
                rgb, alpha = shade_kernel.shade_layer(
                    tri, sx, sy, table, pool, cam, lights, cfg.max_anisotropy, form.texels,
                    form.taps)
        with self._stage("composite"):
            return composite_resolve(rgb, alpha, frac, background)

    def _present(self, packed: torch.Tensor) -> torch.Tensor:
        with self._stage("present"):
            return self._encode(present.encode_rgb(packed, self.config))
