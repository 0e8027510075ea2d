"""The multi-device frame: bands of rows x geometry shards over
torch.distributed, one process per device.

Counterpart of ``vktf_tpu/parallel/tiles.py`` (``make_render_mesh``,
``render_frame_sharded``, ``make_sharded_frame_fn``). The JAX package runs
one program over a ``jax.sharding.Mesh``; here every rank of a process
group runs the same ``ShardedFrameProgram`` on its own device, and the
collectives are torch.distributed's (NCCL across cards, one card a rank;
gloo on the CPU, or on a card when asked for). The mesh has two axes:

  * ``sp`` (bands): the framebuffer pads to a whole number of tile rows per
    band (``tiles_y`` rounded up to a multiple of sp) and each sp rank
    rasterizes the band of rows ``sp_rank * band_h ..`` through the raster
    kernel's band offset (``ops/raster.rasterize(y_offset=)``);
  * ``gp`` (geometry): each gp rank rasterizes the contiguous 1/gp of the
    triangles for its band; the per-sample results merge over gp by the
    single-device rule (min depth, then min id; background (1.0, -1)).

Rank r is (gp_rank, sp_rank) = divmod(r, sp), the order of the JAX mesh's
``reshape(gp, sp)``, so rank order is the order of the triangle micro-
shards. Per frame, in order:

  a. the scene update, replicated (cached per scene, as on one device);
     rank 0's camera (the staged view projection and position) broadcast;
  b. setup and the shade table on this rank's micro-shard, 1/(gp*sp) of
     the triangles padded to a multiple of gp*sp, with GLOBAL ids; the
     kernels run on the real columns only, and the padding is explicit
     (id -1, slim, empty bbox; zero table rows, which no sample can name);
  c. the table gathered over the whole mesh, issued asynchronously and
     waited for only before the shade;
  d. the setup rows gathered over sp (this gp rank's contiguous shard), the
     stream order (kept across frames as on one device), the band raster;
  e. the sort-last merge over gp: each sample's (depth, id) packed into one
     int64 key (``pack_keys``), K = 1 one all_reduce(MIN), K > 1 one
     all-gather of the K keys and ``merge_keys``;
  f. the per-pixel winner on the merged band; this gp rank shades its
     contiguous 1/gp of the band's row-major pixels at their global centres
     (the same shade forms, and the composite at K > 1, as on one device);
  g. the u8 pixels gathered over gp, then the bands over sp, so every rank
     returns the whole frame, cropped and presented by the same encoder.

Every kernel sees each triangle and each pixel with the same inputs as on
one device, and the merge keeps the same K nearest keys, so the frame
equals the single-device frame bit for bit. A collective over a group of
one rank is skipped (its result is its input): a (1, 1) mesh adds only the
camera broadcast to the single-device frame.

Sample-rate shading with a mesh raises: the JAX sharded path shades at
pixel rate whatever the configuration asks (``tiled_shade``,
``vktf_tpu/parallel/tiles.py:146-148``, never reads ``shading_rate``),
a silent downgrade that is not copied. The camera is rank 0's, so ranks
whose viewers run different clocks still render one view. The stream order
follows this rank's own camera (it orders the raster's input and never
changes a pixel). The frustum cull of the JAX path's XLA setup branch is
not needed: the setup kernel culls per triangle, as on one device.

A gloo mesh on a card stages every collective through host memory
(``RenderMesh._staged``): the several-ranks-on-one-card rehearsal, never a
scaling number. Times: PERF.md.
"""

from __future__ import annotations

import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vktf_tpu_torch.config import RenderConfig
from vktf_tpu_torch.ops import raster, setup_kernel, shade_table
from vktf_tpu_torch.ops.pipeline import FrameProgram, pixel_centers, pixel_winner, to_device
from vktf_tpu_torch.scene.flatten import RenderScene, SceneMeta

_BIG = float(2 ** 30)
# torch 2.13 renamed all_gather_into_tensor (same arguments); earlier
# releases have the old name only
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
# the rows gathered over sp: the 24 stream rows, then the 4 bbox rows
_SETUP_ROWS = setup_kernel.TRI_ROWS + 4


class _Pending:
    """A gather in flight; wait() completes it (and a staged copy back to
    the device) and returns the gathered tensor."""

    def __init__(self, out: torch.Tensor, work=None, finish=None):
        self._out = out
        self._work = work
        self._finish = finish

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        if self._finish is not None:
            self._finish()
        return self._out


class RenderMesh:
    """A (gp, sp) mesh over the default process group (``make_render_mesh``):
    this rank's place and the groups its collectives run over."""

    def __init__(self, gp: int, sp: int, backend: str, rank: int, group, gp_group, sp_group):
        self.gp, self.sp = gp, sp
        self.backend = backend
        self.rank = rank
        self.gp_rank, self.sp_rank = divmod(rank, sp)
        self.group = group  # every rank, in rank order
        self.gp_group = gp_group  # the ranks with this sp_rank
        self.sp_group = sp_group  # the ranks with this gp_rank

    @property
    def shape(self) -> tuple[int, int]:
        return self.gp, self.sp

    def __repr__(self) -> str:
        return f"gp{self.gp}x sp{self.sp}"

    def _axis(self, axis: str):
        """(group, its size) of "mesh" (every rank), "gp" or "sp"."""
        return {"mesh": (self.group, self.gp * self.sp), "gp": (self.gp_group, self.gp),
                "sp": (self.sp_group, self.sp)}[axis]

    def _staged(self, t: torch.Tensor) -> bool:
        """Gloo reduces host tensors: a card tensor is staged through host
        memory."""
        return self.backend == "gloo" and t.is_cuda

    def all_gather(self, inp: torch.Tensor, axis: str, async_op: bool = False) -> _Pending:
        """The axis group's inp blocks in rank order, (n * inp.shape[0], ...);
        a group of one rank is inp itself."""
        group, n = self._axis(axis)
        if n == 1:
            return _Pending(inp)
        shape = (n * inp.shape[0], *inp.shape[1:])
        out = torch.empty(shape, dtype=inp.dtype, device=inp.device)
        if not self._staged(inp):
            return _Pending(out, _all_gather(out, inp, group=group, async_op=async_op))
        host_out = torch.empty(shape, dtype=inp.dtype)
        work = _all_gather(host_out, inp.cpu(), group=group, async_op=async_op)
        return _Pending(out, work, lambda: out.copy_(host_out))

    def all_reduce_min(self, t: torch.Tensor, axis: str) -> None:
        """In place: the elementwise minimum over the axis group."""
        group, n = self._axis(axis)
        if n == 1:
            return
        if not self._staged(t):
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            return
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MIN, group=group)
        t.copy_(host)

    def broadcast_to(self, values, device) -> torch.Tensor:
        """Rank 0's host values, as float32 on `device` on every rank: an
        NCCL mesh uploads and broadcasts on the card (nothing waits for it),
        a gloo mesh broadcasts the host values and uploads them."""
        if self.backend == "gloo":
            host = torch.from_numpy(np.array(values, dtype=np.float32))
            dist.broadcast(host, 0, group=self.group)
            return to_device(host.numpy(), device)
        staged = to_device(values, device)
        dist.broadcast(staged, 0, group=self.group)
        return staged

    def broadcast_host(self, values) -> np.ndarray:
        """Rank 0's few float64 values on every rank's host (a viewer's or a
        bench's control; an NCCL mesh waits for the card here)."""
        host = torch.from_numpy(np.array(values, dtype=np.float64))
        if self.backend == "gloo":
            dist.broadcast(host, 0, group=self.group)
            return host.numpy()
        dev = torch.device("cuda", torch.cuda.current_device())
        staged = host.to(dev)
        dist.broadcast(staged, 0, group=self.group)
        return staged.cpu().numpy()


def _card_identity() -> str:
    index = torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
    return str(uuid) if uuid is not None else f"{socket.gethostname()}:{index}"


def _require_distinct_cards(world: int) -> None:
    """NCCL takes one card per rank: raise on every rank when two share one
    (compared over a temporary gloo group, before any NCCL call)."""
    probe = dist.new_group(list(range(world)), backend="gloo")
    cards = [None] * world
    dist.all_gather_object(cards, _card_identity(), group=probe)
    dist.destroy_process_group(probe)
    seen = {}
    for rank, card in enumerate(cards):
        if card in seen:
            raise ValueError(
                f"ranks {seen[card]} and {rank} share one card ({card}): an NCCL mesh takes "
                "one card per rank; give each rank its own card, or ask for a gloo mesh")
        seen[card] = rank


def make_render_mesh(gp: int, sp: int, backend: Optional[str] = None) -> RenderMesh:
    """The (gp, sp) mesh over the initialised default process group, whose
    world size must be gp * sp. Rank r is (gp_rank, sp_rank) = divmod(r, sp).
    backend: the mesh's collectives' backend, the default group's unless
    given. Every rank calls this, in the same order as its other groups."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_render_mesh needs an initialised default process group "
                           "(torchrun, or vktf_tpu_torch.parallel.launch)")
    if gp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be positive, got gp={gp}, sp={sp}")
    world = dist.get_world_size()
    if gp * sp != world:
        raise ValueError(f"mesh gp*sp = {gp}*{sp} != {world} processes")
    backend = str(backend or dist.get_backend())
    if backend == "nccl":
        _require_distinct_cards(world)
    group = dist.new_group(list(range(world)), backend=backend)
    gp_groups = [dist.new_group([g * sp + s for g in range(gp)], backend=backend)
                 for s in range(sp)]
    sp_groups = [dist.new_group([g * sp + s for s in range(sp)], backend=backend)
                 for g in range(gp)]
    rank = dist.get_rank()
    gp_rank, sp_rank = divmod(rank, sp)
    return RenderMesh(gp, sp, backend, rank, group, gp_groups[sp_rank], sp_groups[gp_rank])


def pack_keys(ids: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """One int64 key per entry ordering (depth, id) lexicographically: the
    depth's order-preserving integer in the high word, id + 1 in the low
    word (the background's id -1 is 0)."""
    return raster._order_key(depth) | (ids.to(torch.int64) + 1)


def unpack_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids i32, depth f32) of pack_keys' keys."""
    ids = ((keys & 0xFFFFFFFF) - 1).to(torch.int32)
    ordered = keys >> 32
    bits = torch.where(ordered >= 0, ordered, ordered ^ 0x7FFFFFFF).to(torch.int32)
    return ids, bits.view(torch.float32)


def merge_keys(keys: torch.Tensor, layers: int) -> torch.Tensor:
    """The sort-last merge over gp of the gathered keys (gp, [K,] S, H, W):
    the K smallest of each sample's gp * K keys, nearest first — the K
    rounds of head merges of ``vktf_tpu/parallel/tiles.py:316-344``. Real
    triangles' keys are distinct (global ids) and nearer than the
    background's, whose copies are all equal, so the sorted union's head
    is that merge's output."""
    if layers == 1:
        return keys.amin(dim=0)
    flat = keys.reshape(keys.shape[0] * layers, *keys.shape[2:])
    return torch.sort(flat, dim=0).values[:layers]


class ShardedFrameProgram(FrameProgram):
    """``FrameProgram`` over a RenderMesh: the same call and output (the
    presented frame, on every rank), the frame split as the module
    docstring says. Every rank of the mesh calls it once per frame."""

    def __init__(self, meta: SceneMeta, config: RenderConfig, mesh: RenderMesh):
        if config.shading_rate == "sample":
            raise ValueError(
                "shading_rate='sample' with a mesh: the multi-device frame shades at pixel "
                "rate (the JAX sharded path ignores the sample rate; the port refuses it)")
        super().__init__(meta, config)
        self.mesh = mesh
        gp, sp = mesh.shape
        th = config.tile_shape[0]
        tiles_y = config.tiles_y + (-config.tiles_y) % sp
        self.frame_height = tiles_y * th
        self.band_h = self.frame_height // sp
        n_band = self.band_h * config.padded_width
        if n_band % gp:
            raise ValueError(f"band pixels {n_band} ({self.band_h} rows of "
                             f"{config.padded_width}) not divisible by gp={gp}")
        self.rank_px = n_band // gp
        n_dev = gp * sp
        t = meta.num_triangles
        t_pad = -(-t // n_dev) * n_dev
        if t_pad >= 1 << 24:
            raise ValueError("triangle ids ride f32 rows: exact only below 2^24")
        self.t_pad = t_pad
        self.t_micro = t_pad // n_dev
        self.row0 = mesh.rank * self.t_micro
        self.real = max(0, min(self.t_micro, t - self.row0))
        self.band_y0 = mesh.sp_rank * self.band_h
        self._micro_key = None
        self._micro = None
        self._shard_consts = None

    def _maybe_micro(self, scene: RenderScene):
        """This rank's micro-shard of the per-triangle inputs (contiguous
        copies of its real columns), refreshed when the scene's tensors are
        replaced or edited in place."""
        key = [(t, t._version) for t in (scene.tri_corner, scene.tri_static_cols)]
        if self._micro is None or any(
                a is not b or va != vb for (a, va), (b, vb) in zip(key, self._micro_key)):
            cols = slice(self.row0, self.row0 + self.real)
            self._micro = (scene.tri_corner[:, cols].contiguous(),
                           scene.tri_static_cols[:, cols].contiguous())
            self._micro_key = key
        return self._micro

    def _consts(self, dev):
        """Per device: the global ids of the real columns, the padding's
        setup column, and the centres of this rank's pixels."""
        if self._shard_consts is None or self._shard_consts[0].device != dev:
            ids = torch.arange(self.row0, self.row0 + self.real, dtype=torch.float32,
                               device=dev)
            pad = torch.zeros((_SETUP_ROWS, 1), dtype=torch.float32, device=dev)
            pad[15] = -1.0  # invalid id
            pad[19] = 1.0  # slim: no test reads the planes
            pad[24:26] = _BIG  # empty bbox
            pad[26:28] = -_BIG
            sx, sy = pixel_centers(self.band_h, self.config.padded_width, dev, self.band_y0)
            px = slice(self.mesh.gp_rank * self.rank_px, (self.mesh.gp_rank + 1) * self.rank_px)
            self._shard_consts = (ids, pad, sx[px].contiguous(), sy[px].contiguous(), px)
            self._background = to_device(self.config.clear_color[:3], dev)
        return self._shard_consts

    def __call__(self, scene: RenderScene, view_projection, camera_position) -> torch.Tensor:
        cfg, mesh = self.config, self.mesh
        dev = scene.device
        ids_micro, pad, sx, sy, px = self._consts(dev)
        pw = cfg.padded_width

        with self._stage("scene_update"):
            inst_rows, tri_instance, lights = self._maybe_scene_update(scene)
            tc_micro, stat_micro = self._maybe_micro(scene)
            tin_micro = tri_instance[self.row0:self.row0 + self.real]
        with self._stage("camera_broadcast"):
            staged = mesh.broadcast_to(np.concatenate([np.ravel(view_projection),
                                                       np.ravel(camera_position)]), dev)
        vp, cam = staged[:16].view(4, 4), staged[16:19]

        with self._stage("setup"):
            setup = setup_kernel.setup_pack(tc_micro, inst_rows, tin_micro, vp, cfg.width,
                                            cfg.height, ids=ids_micro)
            rows = torch.cat([setup["tri_data"], setup["bbox_rows"]])
            if self.real < self.t_micro:
                rows = torch.cat([rows, pad.expand(-1, self.t_micro - self.real)], dim=1)
        with self._stage("shade_table"):
            table_micro = shade_table.build_shade_table(
                setup["edge9"], tc_micro, stat_micro, setup["anchor2"], inst_rows, tin_micro)
            if self.real < self.t_micro:
                table_micro = torch.cat([table_micro, table_micro.new_zeros(
                    (self.t_micro - self.real, table_micro.shape[1]))])
        with self._stage("table_gather"):
            table_pending = mesh.all_gather(table_micro, "mesh", async_op=True)
        with self._stage("setup_gather"):
            gathered = mesh.all_gather(rows, "sp").wait()
            local = gathered.view(mesh.sp, _SETUP_ROWS, self.t_micro).permute(1, 0, 2).reshape(
                _SETUP_ROWS, mesh.sp * self.t_micro)
        with self._stage("raster"):
            tri_data, bbox_rows = local[:setup_kernel.TRI_ROWS], local[setup_kernel.TRI_ROWS:]
            perm = self._maybe_resort({"bbox_rows": bbox_rows, "valid": tri_data[15] >= 0.0},
                                      view_projection)
            stream = raster.raster_stream(tri_data, bbox_rows, perm, chunk=cfg.pallas_chunk)
            ids, depth = raster.rasterize(*stream, self.band_h, pw, cfg.msaa_samples,
                                          self.layers, y_offset=self.band_y0)
        if mesh.gp > 1:
            with self._stage("merge"):
                keys = pack_keys(ids, depth)
                if self.layers == 1:
                    mesh.all_reduce_min(keys, "gp")
                else:
                    every = mesh.all_gather(keys, "gp").wait()
                    keys = merge_keys(every.view(mesh.gp, *keys.shape), self.layers)
                ids, depth = unpack_keys(keys)
        with self._stage("winner"):
            tri, frac = pixel_winner(ids, depth)
            tri, frac = tri[..., px].contiguous(), frac[px].contiguous()
        with self._stage("table_wait"):
            table = table_pending.wait()
        packed = self._shade_pixels(tri, frac, sx, sy, table, scene.quad_pool, cam, lights,
                                    self._background)
        with self._stage("slice_gather"):
            rgb = torch.stack([((packed >> (8 * c)) & 0xFF).to(torch.uint8) for c in range(3)],
                              dim=1)  # (rank_px, 3)
            band = mesh.all_gather(rgb, "gp").wait()
        with self._stage("band_gather"):
            whole = mesh.all_gather(band, "sp").wait()
        with self._stage("present"):
            frame = whole.view(self.frame_height, pw, 3)[:cfg.height, :cfg.width]
            return self._encode(frame.permute(2, 0, 1).contiguous())
