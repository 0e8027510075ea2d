"""ctypes bindings of the port's native host runtime
(``csrc/host/vktf_native.cpp``).

The port's counterpart of ``vktf_tpu/native.py``: the asset pipeline's
host hot loops in C++ (mip chains, block-pool packing, accessor unpack,
ETC1S expansion) and KTX2's ZSTD supercompression both ways through
libzstd, which needs no ``zstandard`` module. zlib inflate stays with
Python's ``zlib`` module, which is already C.

The library is built with g++ at first use (``ops/_host.py``). Each host
loop has its numpy version at its call site, taken when the library cannot
be built (the failure is logged once, with g++'s output) or when
``VKTF_NATIVE=0``; every function here returns None then. Each function
equals its numpy version bit for bit: the mip chains' sRGB conversions
are tables computed here with the numpy functions themselves
(``_srgb_tables``), since libm's powf and numpy's vectorised float32
power round differently.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
import zlib
from typing import Optional

import numpy as np

ZSTD_LEVEL = 3  # zstandard's default level

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32

_ENTRIES = {
    "vktf_mip_chain_texels": (_i64, [_i32, _i32]),
    "vktf_generate_mips": (None, [_u8p, _i32, _i32, _i32, _f32p, _f32p, _u8p]),
    "vktf_pack_blocks_level": (None, [_u32p, _u32p, _u32p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_void_p, _i32, _i32p,
                                      _u32p]),
    "vktf_unpack_accessor": (_i32, [_u8p, _i64, _i32, _i32, _i32, _i64, _f32p]),
    "vktf_decompress_zstd": (_i64, [_u8p, _i64, _u8p, _i64]),
    "vktf_zstd_compress_bound": (_i64, [_i64]),
    "vktf_compress_zstd": (_i64, [_u8p, _i64, _u8p, _i64, _i32]),
    "vktf_decode_etc1s": (None, [_i32p, _i32p, _i32p, _u8p, _i32, _i32, _u8p]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None when VKTF_NATIVE=0
    or when it cannot be built or loaded (logged once)."""
    global _lib, _tried
    if os.environ.get("VKTF_NATIVE", "1") == "0":
        return None
    with _lock:
        if not _tried:
            _tried = True
            try:
                from vktf_tpu_torch.ops import _host

                lib = ctypes.CDLL(str(_host.build("vktf_native.cpp")))
                for name, (restype, argtypes) in _ENTRIES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as error:
                from vktf_tpu_torch.log import default_log

                default_log().error(f"native host runtime unavailable, numpy takes "
                                    f"its place: {error}")
    return _lib


def available() -> bool:
    return _load() is not None


@functools.cache
def _srgb_tables() -> Optional[tuple[np.ndarray, np.ndarray]]:
    """(to_linear (256,), thresholds (255,)) f32, or None.

    to_linear[b] is numpy's ``srgb_to_linear`` of the 8-bit code b as
    ``generate_mips`` computes it; thresholds[k - 1] is the least float32
    whose 8-bit sRGB code, as ``generate_mips`` quantizes it, is k, found
    by bisection over float32 bit patterns. The code is then the count of
    thresholds at or below a value, which holds while numpy's quantization
    is monotone: checked here within 64 ulps of every threshold, the only
    place where an error of an ulp or two could break it. None when the
    check fails (logged)."""
    from vktf_tpu_torch.loaders.images import linear_to_srgb, quantize_u8, srgb_to_linear

    def code(v):
        return quantize_u8(linear_to_srgb(v))

    to_linear = srgb_to_linear(np.arange(256).astype(np.float32) / 255.0)
    target = np.arange(1, 256)
    lo = np.zeros(255, np.int64)
    hi = np.full(255, np.float32(1.0).view(np.int32), np.int64)
    while np.any(lo < hi):
        mid = (lo + hi) // 2
        ok = code(mid.astype(np.int32).view(np.float32)) >= target
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    thresholds = lo.astype(np.int32).view(np.float32)
    window = (lo[:, None] + np.arange(-64, 65)[None, :]).clip(0).astype(np.int32)
    values = window.view(np.float32).reshape(-1)
    predicted = np.searchsorted(thresholds, values, side="right")
    if not np.array_equal(predicted, code(values)):
        from vktf_tpu_torch.log import default_log

        default_log().error("numpy's sRGB encode is not monotone near a threshold: mip "
                            "chains stay with numpy")
        return None
    return np.ascontiguousarray(to_linear, np.float32), np.ascontiguousarray(thresholds)


def generate_mips(base: np.ndarray, srgb: bool) -> Optional[list[np.ndarray]]:
    """The full RGBA8 mip chain of an (H, W, 4) base level, level 0 first
    (``loaders/images.generate_mips``); None if the library is unavailable."""
    lib = _load()
    tables = _srgb_tables() if lib is not None else None
    if tables is None:
        return None
    base = np.ascontiguousarray(base, np.uint8)
    h, w = int(base.shape[0]), int(base.shape[1])
    out = np.empty(lib.vktf_mip_chain_texels(h, w) * 4, np.uint8)
    lib.vktf_generate_mips(base.reshape(-1), h, w, int(srgb), *tables, out)
    levels, offset = [], 0
    lh, lw = h, w
    while True:
        n = lh * lw * 4
        levels.append(out[offset:offset + n].reshape(lh, lw, 4))
        offset += n
        if lh == 1 and lw == 1:
            break
        lh, lw = max(lh // 2, 1), max(lw // 2, 1)
    return levels


def pack_blocks_level(packed, packed_next, wraps) -> Optional[np.ndarray]:
    """Fused-mip block-pool rows (bw*bw, 64) u32 of one pow2-square level
    (``ops/texture_pack._pack_blocks_level``); None if unavailable.

    packed: the level's [base, mr, normal] packed-u32 (w, w) arrays;
    packed_next: the next level's, or None for the last level (slot B
    stays zero); wraps: [(wrap_u, wrap_v)] of the three slots."""
    lib = _load()
    if lib is None:
        return None
    w = int(packed[0].shape[0])
    bw = max(w >> 1, 1)
    out = np.empty((bw * bw, 64), np.uint32)
    wrap_arr = np.ascontiguousarray(np.asarray(wraps, np.int32).reshape(6))
    cur = [np.ascontiguousarray(p, np.uint32).reshape(-1) for p in packed]
    nxt = ([np.ascontiguousarray(p, np.uint32).reshape(-1) for p in packed_next]
           if packed_next is not None else [])
    ptrs = [p.ctypes.data_as(ctypes.c_void_p) for p in nxt] or [None] * 3
    lib.vktf_pack_blocks_level(*cur, *ptrs, w, wrap_arr, out.reshape(-1))
    return out


_COMPONENT_SIZES = {5120: 1, 5121: 1, 5122: 2, 5123: 2, 5125: 4, 5126: 4}


def unpack_accessor(raw: bytes, count: int, comps: int, comp_type: int,
                    normalized: bool, stride: int) -> Optional[np.ndarray]:
    """Strided glTF accessor bytes -> (count, comps) f32, normalized per
    glTF 2.0 (``loaders/gltf.accessor_to_float``); None if unavailable or
    the component type is unknown, the stride is shorter than an element,
    or raw does not hold every element."""
    lib = _load()
    size = _COMPONENT_SIZES.get(comp_type)
    if lib is None or size is None or count < 0 or comps < 1:
        return None
    if count and (stride < size * comps or len(raw) < stride * (count - 1) + size * comps):
        return None
    src = np.frombuffer(raw, np.uint8)
    dst = np.empty(count * comps, np.float32)
    if lib.vktf_unpack_accessor(src, count, comps, comp_type, int(normalized), stride,
                                dst) != 0:
        return None
    return dst.reshape(count, comps)


def decode_etc1s(endpoint_ids: np.ndarray, selector_ids: np.ndarray,
                 endpoints: np.ndarray, selectors: np.ndarray,
                 width: int, height: int) -> Optional[np.ndarray]:
    """ETC1S blocks -> (height, width, 4) RGBA8
    (``loaders/basis.decode_etc1s_blocks``); None if unavailable, or when an
    id, intensity, selector or 5-bit color is out of range (numpy's indexing
    then raises as it always has)."""
    lib = _load()
    if lib is None:
        return None
    endpoint_ids = np.ascontiguousarray(endpoint_ids, np.int32)
    selector_ids = np.ascontiguousarray(selector_ids, np.int32)
    endpoints = np.ascontiguousarray(endpoints, np.int32)
    selectors = np.ascontiguousarray(selectors, np.uint8)
    bh, bw = endpoint_ids.shape
    in_range = (
        endpoints.ndim == 2 and endpoints.shape[1] == 4 and selectors.ndim == 2
        and selectors.shape[1] == 16 and endpoint_ids.size > 0
        and 0 <= endpoint_ids.min() and endpoint_ids.max() < endpoints.shape[0]
        and 0 <= selector_ids.min() and selector_ids.max() < selectors.shape[0]
        and 0 <= endpoints.min() and endpoints[:, :3].max() < 32
        and endpoints[:, 3].max() < 8 and selectors.max() < 4)
    if not in_range:
        return None
    out = np.empty((bh * 4, bw * 4, 4), np.uint8)
    lib.vktf_decode_etc1s(endpoint_ids.reshape(-1), selector_ids.reshape(-1),
                          endpoints.reshape(-1), selectors.reshape(-1), bh, bw,
                          out.reshape(-1))
    return out[:height, :width]


def inflate_zlib(data: bytes, out_len: int) -> Optional[bytes]:
    """A zlib stream of at most out_len bytes, through Python's zlib; None
    when it is corrupt or longer."""
    inflater = zlib.decompressobj()
    try:
        out = inflater.decompress(data, out_len + 1)
    except zlib.error:
        return None
    return out if inflater.eof and len(out) <= out_len else None


def decompress_zstd(data: bytes, out_len: int) -> Optional[bytes]:
    """A ZSTD frame of at most out_len bytes through libzstd; None if the
    library is unavailable or the frame is corrupt or longer."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(out_len, np.uint8)
    n = lib.vktf_decompress_zstd(src, len(data), dst, out_len)
    return dst[:n].tobytes() if n >= 0 else None


def compress_zstd(data: bytes) -> Optional[bytes]:
    """One ZSTD frame of data through libzstd at ZSTD_LEVEL; None if the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    dst = np.empty(lib.vktf_zstd_compress_bound(len(data)), np.uint8)
    n = lib.vktf_compress_zstd(src, len(data), dst, dst.size, ZSTD_LEVEL)
    if n < 0:
        raise RuntimeError(f"ZSTD_compress failed on {len(data)} bytes")
    return dst[:n].tobytes()
