"""Material texel pool: fused-mip 3x3-texel blocks (numpy).

Counterpart of ``vktf_tpu/ops/texture_pack.py`` (its module docstring has
the full layout). Each pool row of mip level l holds, for the three
textures of a material (base, metallic-roughness, normal):

  * slot A (u32 lanes 0..26): 3x3 texels of level l anchored at even
    coordinates (2bx + j, 2by + i), lane t*9 + i*3 + j;
  * slot B (u32 lanes 27..53): 3x3 texels of level l+1 anchored at
    (bx-1, by-1), wrapped — for repeat/clamp samplers it holds every l+1
    bilinear footprint of a sample whose level-l footprint lies in block
    (bx, by), so one row serves a trilinear sample of all three textures.

Rows are 64 u32 lanes stored as 128 u16 halves (little-endian). Per-level
block-row offsets have a closed form for pow2-square chains, so the shade
needs no offset table. Rows come from the native runtime when it is built
(``vktf_tpu_torch.native.pack_blocks_level``, equal bit for bit), from
numpy otherwise. The row budget of the JAX package (its TPU gather
cliff) is kept so both packages build the same pool.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from vktf_tpu_torch import native
from vktf_tpu_torch.loaders.images import TextureData, default_texture_data, generate_mips

log = logging.getLogger(__name__)

SLOT_U32 = 27  # 3 textures x 9 texels per slot (3x3 window)
ROW_U32 = 64  # padded row width (pow2)
SLOT_B_U16 = 2 * SLOT_U32  # u16 lane base of slot B

# The JAX package's row budget (its fast-gather limit on the TPU). Kept so
# the two packages pack identical pools from identical assets.
FAST_GATHER_ROWS = 458_752

WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2
_WRAP_CODES = {"repeat": WRAP_REPEAT, "clamp_to_edge": WRAP_CLAMP,
               "mirrored_repeat": WRAP_MIRROR}


@dataclasses.dataclass
class MaterialPool:
    """Block-packed texel rows + per-material scalar metadata."""

    quads: np.ndarray  # (P, 2 * ROW_U32) uint16
    base_row: np.ndarray  # (M,) int64 — first block row of the chain
    width0: np.ndarray  # (M,) int32 — level-0 width (pow2 square)
    num_levels: np.ndarray  # (M,) int32
    sampler_codes: np.ndarray  # (M, 3) int32, per slot (sampler_code)
    mixed: bool  # any material's three slot samplers differ
    mirror: bool = False  # any sampler uses MIRRORED_REPEAT


def sampler_code(sampler: dict) -> int:
    """Pack one glTF sampler: wrap_u | wrap_v<<2 | magN<<4 | minN<<5 |
    mipN<<6."""
    wrap_u = _WRAP_CODES.get(sampler.get("wrap_u", "repeat"), WRAP_REPEAT)
    wrap_v = _WRAP_CODES.get(sampler.get("wrap_v", "repeat"), WRAP_REPEAT)
    return (
        wrap_u
        | (wrap_v << 2)
        | (int(sampler.get("mag_filter", "linear") == "nearest") << 4)
        | (int(sampler.get("min_filter", "linear") == "nearest") << 5)
        | (int(sampler.get("mipmap_mode", "linear") == "nearest") << 6)
    )


def _wrap_index(i: np.ndarray, size: int, mode: int) -> np.ndarray:
    if mode == WRAP_REPEAT:
        return i % size
    if mode == WRAP_CLAMP:
        return np.clip(i, 0, size - 1)
    m = i % max(2 * size, 1)
    return np.where(m >= size, 2 * size - 1 - m, m)


def _pack_u32(level: np.ndarray) -> np.ndarray:
    return (
        level[..., 0].astype(np.uint32)
        | (level[..., 1].astype(np.uint32) << 8)
        | (level[..., 2].astype(np.uint32) << 16)
        | (level[..., 3].astype(np.uint32) << 24)
    )


def _resample_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return img[ys][:, xs]


def _to_pow2_square_chain(tex: TextureData, size: int) -> list[np.ndarray]:
    base = tex.levels[0]
    if base.shape[0] == size and base.shape[1] == size:
        if len(tex.levels) >= int(np.log2(size)) + 1:
            ok = all(
                lvl.shape[0] == lvl.shape[1] == max(size >> i, 1)
                for i, lvl in enumerate(tex.levels)
            )
            if ok:
                return tex.levels
        return generate_mips(base, tex.srgb)
    return generate_mips(_resample_nearest(base, size), tex.srgb)


def blocks_per_level(w0: int, level: int) -> int:
    return max(w0 >> (level + 1), 1)


def block_level_offset(w0: int, level: int) -> int:
    """Closed-form block-row offset of a mip level in a pow2-square chain."""
    b0 = max(w0 >> 1, 1)
    bl = max(b0 >> level, 1)
    n = int(np.log2(max(w0, 1)))
    extra = 1 if (level == n and n > 0) else 0
    return 4 * (b0 * b0 - bl * bl) // 3 + extra


def _chain_block_rows(size: int) -> int:
    levels = int(np.log2(max(size, 1))) + 1
    return block_level_offset(size, levels - 1) + blocks_per_level(size, levels - 1) ** 2


def _pack_blocks_level(packed: list[np.ndarray], w: int,
                       wraps: list[tuple[int, int]],
                       packed_next: list[np.ndarray] | None) -> np.ndarray:
    """(bw*bw, ROW_U32) fused-mip block rows for one level."""
    bw = max(w >> 1, 1)
    out = np.zeros((bw, bw, ROW_U32), np.uint32)
    ax = 2 * np.arange(bw)
    bx = np.arange(bw)
    w1 = max(w >> 1, 1)
    for t, lvl in enumerate(packed):
        wrap_u, wrap_v = wraps[t]
        for i in range(3):
            ty = _wrap_index(ax + i, w, wrap_v)
            for j in range(3):
                tx = _wrap_index(ax + j, w, wrap_u)
                out[:, :, t * 9 + i * 3 + j] = lvl[ty][:, tx]
        if packed_next is not None:
            nxt = packed_next[t]
            for i in range(3):
                ny = _wrap_index(bx - 1 + i, w1, wrap_v)
                for j in range(3):
                    nx = _wrap_index(bx - 1 + j, w1, wrap_u)
                    out[:, :, SLOT_U32 + t * 9 + i * 3 + j] = nxt[ny][:, nx]
    return out.reshape(-1, ROW_U32)


def build_material_pool(
    materials: list[dict],
    max_pool_bytes: int = 4 << 30,
    max_pool_rows: int = FAST_GATHER_ROWS,
) -> MaterialPool:
    """Pack per-material texture triplets.

    materials: dicts with keys base/mr/normal (TextureData or None) and
    samplers (three sampler dicts: base, mr, normal). Chains are resampled
    to one pow2 square per material; over budget, the largest chains are
    halved until the pool fits (logged).
    """
    if not materials:
        materials = [{"base": None, "mr": None, "normal": None, "samplers": [{}] * 3}]
    count = len(materials)
    base_row = np.zeros(count, np.int64)
    width0 = np.ones(count, np.int32)
    num_levels = np.ones(count, np.int32)
    codes = np.zeros((count, 3), np.int32)
    mixed = False
    mirror = False

    def slot_textures(spec):
        return (spec.get("base") or default_texture_data("base_color"),
                spec.get("mr") or default_texture_data("metallic_roughness"),
                spec.get("normal") or default_texture_data("normal"))

    sizes_m = np.ones(count, np.int64)
    for m, spec in enumerate(materials):
        texs = slot_textures(spec)
        sizes = {t.levels[0].shape[0] for t in texs} | {
            t.levels[0].shape[1] for t in texs}
        size = 1 << int(np.ceil(np.log2(max(sizes))))
        if len(sizes) > 1 or size != max(sizes):
            log.error("Material %d: textures resampled to %dx%d pow2 square "
                      "for the packed pool (sizes %s)", m, size, size,
                      sorted(sizes))
        sizes_m[m] = size

    max_rows = min((1 << 24) - 1, max_pool_bytes // (4 * ROW_U32), max_pool_rows)
    orig_sizes = sizes_m.copy()
    while sum(_chain_block_rows(int(s)) for s in sizes_m) > max_rows and (
        sizes_m.max() > 1
    ):
        top = sizes_m.max()
        sizes_m[sizes_m == top] = top >> 1
    if not np.array_equal(orig_sizes, sizes_m):
        log.error("Material pool over budget (%d block rows): downsampled %d "
                  "of %d material chains", max_rows,
                  int((orig_sizes != sizes_m).sum()), count)

    blobs: list[np.ndarray] = []
    row_cursor = 0
    for m, spec in enumerate(materials):
        samplers = spec.get("samplers") or [{}] * 3
        size = int(sizes_m[m])
        chains = [_to_pow2_square_chain(t, size) for t in slot_textures(spec)]
        levels = len(chains[0])
        wraps = [
            (
                _WRAP_CODES.get(s.get("wrap_u", "repeat"), WRAP_REPEAT),
                _WRAP_CODES.get(s.get("wrap_v", "repeat"), WRAP_REPEAT),
            )
            for s in samplers
        ]
        base_row[m] = row_cursor
        width0[m] = size
        num_levels[m] = levels
        codes[m] = [sampler_code(s) for s in samplers]
        if codes[m, 0] != codes[m, 1] or codes[m, 0] != codes[m, 2]:
            mixed = True
        if any(WRAP_MIRROR in wu_wv for wu_wv in wraps):
            mirror = True
        packed_levels = [
            [_pack_u32(chain[l]) for chain in chains] for l in range(levels)
        ]
        for l in range(levels):
            w = max(size >> l, 1)
            packed_next = packed_levels[l + 1] if l + 1 < levels else None
            rows_native = native.pack_blocks_level(packed_levels[l], packed_next, wraps)
            blobs.append(rows_native if rows_native is not None else
                         _pack_blocks_level(packed_levels[l], w, wraps, packed_next))
            row_cursor += max(w >> 1, 1) ** 2

    rows = np.concatenate(blobs) if blobs else np.zeros((1, ROW_U32), np.uint32)
    # pool row indices ride f32 shade-table columns: exact only below 2^24
    if rows.shape[0] >= 1 << 24:
        raise ValueError(f"material pool has {rows.shape[0]} block rows "
                         "(>= 2^24); texel addresses would lose f32 exactness")
    rows_u16 = rows.view(np.uint16).reshape(rows.shape[0], 2 * ROW_U32)
    return MaterialPool(
        quads=rows_u16,
        base_row=base_row,
        width0=width0,
        num_levels=num_levels,
        sampler_codes=codes,
        mixed=mixed,
        mirror=mirror,
    )
