"""ctypes bindings for the native host-transform library (native/).

Loads native/libdctpu_host.so, building it from native/host_transforms.cpp
with `make -C native` at first use (the library is not tracked by git).
Every entry point has a numpy fallback, so the package works without the
native library — just slower host assembly; `load_error` says why the
fallback was taken.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_LIB_PATH = _REPO / "native" / "libdctpu_host.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error: Optional[str] = None  # why the numpy fallback is in use

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_REPO / "native")],
                check=True, capture_output=True, text=True, timeout=120,
            )
        except subprocess.CalledProcessError as e:
            load_error = f"make -C native failed: {e.stderr.strip()[-500:]}"
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            load_error = f"make -C native: {e}"
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        load_error = f"loading {_LIB_PATH.name}: {e}"
        return None
    lib.dctpu_vert_block_words.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, _i64p,
    ]
    lib.dctpu_vert_compact.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, _i64p, _u32p,
    ]
    lib.dctpu_vert_stage.argtypes = [
        _u32p, _i64p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        _u32p, ctypes.c_int64,
    ]
    lib.dctpu_segment_gather.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_int64, _i64p, _u32p,
    ]
    lib.dctpu_segment_scatter.argtypes = [
        _u32p, _i64p, ctypes.c_int64, _u32p, ctypes.c_int64,
    ]
    lib.dctpu_squeeze.argtypes = [
        _u32p, _i64p, _i64p, ctypes.c_int64, _u32p,
    ]
    lib.dctpu_build_blocks.argtypes = [
        _i32p, _i64p, _i64p, ctypes.c_int64, ctypes.c_uint32,
        _i32p, _i32p, _i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def vert_compact(payload: np.ndarray, block_len: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native compact_vertical; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    payload = np.ascontiguousarray(payload, dtype=np.uint32)
    B, W = payload.shape
    wc = np.zeros(B, dtype=np.int64)
    lib.dctpu_vert_block_words(payload, B, W, block_len, wc)
    off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(wc, out=off[1:])
    out = np.zeros(int(off[-1]), dtype=np.uint32)
    from dctpu.kernels.vertical_xla import REGION_PAD

    lib.dctpu_vert_compact(payload, B, W, block_len, REGION_PAD, off, out)
    return out, wc


def vert_stage(
    disk_words: np.ndarray, word_off: np.ndarray, block_len: int, width: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    disk_words = np.ascontiguousarray(disk_words, dtype=np.uint32)
    word_off = np.ascontiguousarray(word_off, dtype=np.int64)
    B = word_off.size - 1
    out = np.zeros((B, width), dtype=np.uint32)
    if B:
        from dctpu.kernels.vertical_xla import REGION_PAD

        lib.dctpu_vert_stage(
            disk_words, word_off, B, block_len, REGION_PAD, out, width
        )
    return out


def segment_gather(rows: np.ndarray, word_off: np.ndarray) -> Optional[np.ndarray]:
    """rows [B, W] -> concatenated words per word_off (rice compaction)."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    word_off = np.ascontiguousarray(word_off, dtype=np.int64)
    B, W = rows.shape
    out = np.zeros(int(word_off[-1]), dtype=np.uint32)
    if B:
        lib.dctpu_segment_gather(rows, B, W, word_off, out)
    return out


def squeeze(
    semi: np.ndarray, src_off: np.ndarray, dst_off: np.ndarray
) -> Optional[np.ndarray]:
    """Concatenate semi[src_off[s] : src_off[s]+len[s]]; len = diff(dst_off).

    OpenMP per-segment memcpy — replaces the numpy fancy-index squeeze
    (which materializes three index arrays the size of the output).
    """
    lib = _load()
    if lib is None:
        return None
    semi = np.ascontiguousarray(semi, dtype=np.uint32)
    src_off = np.ascontiguousarray(src_off, dtype=np.int64)
    dst_off = np.ascontiguousarray(dst_off, dtype=np.int64)
    nseg = src_off.size
    out = np.empty(int(dst_off[-1]), dtype=np.uint32)
    if nseg:
        lib.dctpu_squeeze(semi, src_off, dst_off, nseg, out)
    return out


def segment_scatter(
    words: np.ndarray, word_off: np.ndarray, width: int
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    word_off = np.ascontiguousarray(word_off, dtype=np.int64)
    B = word_off.size - 1
    out = np.zeros((B, width), dtype=np.uint32)
    if B:
        lib.dctpu_segment_scatter(words, word_off, B, out, width)
    return out


def build_blocks(
    flat: np.ndarray, sstart: np.ndarray, first: np.ndarray,
    block_len: int, num_blocks: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native build_blocks_flat core: (x, n, hist) or None.

    Every row of x is fully written (memcpy + tail memset), so x is
    np.empty — the config-5 feed never pays a redundant zeroing pass.
    """
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    sstart = np.ascontiguousarray(sstart, dtype=np.int64)
    first = np.ascontiguousarray(first, dtype=np.int64)
    S = sstart.size - 1
    x = np.empty((num_blocks, block_len), dtype=np.int32)
    n = np.empty(num_blocks, dtype=np.int32)
    hist = np.empty((num_blocks, 4), dtype=np.int32)
    if S:
        lib.dctpu_build_blocks(flat, sstart, first, S, block_len, x, n, hist)
    return x, n, hist
