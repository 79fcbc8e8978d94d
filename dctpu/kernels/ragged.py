"""Device-side ragged layout transforms (compaction + staging).

Doing the ragged work on the host would mean fetching the *padded* device
payload rows (several times the compressed size) through the host link.
These jitted transforms keep the ragged permutations on device so only
~compressed-size bytes cross the link.

Every transform below is built from: (a) gathers of TILE-word rows, so the
index count, not the element count, sets the gather's size; (b) dense
funnel selects to un-align; (c) the scatter-max + cummax forward-fill to
build segment maps without small-table gathers. The scatter-max is
order-independent, so duplicate indices give the same result under GPU
atomics.

Compaction emits a tile-aligned "semi-compact" stream (each segment starts
on a TILE boundary, zero-padded gaps); the host squeezes the gaps while
assembling the frame (squeeze_host). Staging accepts the exact disk words.

Host-side equivalents (codec.vertical_host, codec.api.compact_payload,
kernels.unpack_scan.stage_rice_scan) remain the tested fallbacks; byte
equality with them is enforced in tests/test_ragged.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from dctpu.constants import (
    SUB_BLOCK,
    sub_caps,
    subs_per_block,
    sync_words,
)
from dctpu.kernels.vertical_xla import REGION_PAD

# Tile sizes of the compaction and staging gathers. They trade alignment
# waste (<= TILE-1 words per segment, link bytes only — squeeze_host drops
# it before disk) against the gather's index count. Not yet tuned on the
# H100.
RICE_TILE = 64     # block-granular semi alignment (waste <= 63 words/block)
VERT_TILE = 64
assert REGION_PAD % VERT_TILE == 0
# Decode-staging window gathers read at tile granularity INDEPENDENT of the
# semi/disk lattice (the barrel realign handles any alignment).
STAGE_GATHER_TILE = 64


def _cdiv(a, b):
    return (a + b - 1) // b


def tile_bucket(live_tiles: int, floor: int = 1 << 16) -> int:
    """Output-capacity bucket for the segment-compact gather.

    The gather in tile_segment_compact costs per OUTPUT index, so sizing
    total_tiles at the full uncompressed capacity wastes ~4x at typical
    ratios. Buckets keep 2 significant bits (mantissa 4..7 x 2^k), bounding
    dead-gather waste to 25% while keeping the compiled-variant count
    ~4 log2(range).
    """
    v = max(live_tiles, floor)
    k = max(v.bit_length() - 3, 0)  # mantissa in [4, 8] after the ceil
    return -(-v >> k) << k


def exclusive_scan(wc: jnp.ndarray) -> jnp.ndarray:
    """[N] counts -> [N+1] exclusive offsets (int32)."""
    inc = jnp.cumsum(wc.astype(jnp.int32))
    return jnp.concatenate([jnp.zeros(1, jnp.int32), inc])


def _ffill_at(pos: jnp.ndarray, vals: jnp.ndarray, total: int) -> jnp.ndarray:
    """Forward fill: out[i] = vals[s] for the largest s with pos[s] <= i.

    Requires vals nondecreasing in s (scatter-max at shared positions then
    picks the last segment starting there — the owner of the following
    span). Built from one scatter-max + one cummax; no gathers.
    """
    lo = jnp.iinfo(jnp.int32).min
    buf = jnp.full(total, lo, jnp.int32).at[pos].max(vals, mode="drop")
    return jax.lax.cummax(buf)


def tile_segment_compact(
    src_tiles: jnp.ndarray,  # [T, TILE] source tiles
    src_start: jnp.ndarray,  # [Nseg] i32 first source tile of each segment
    tc: jnp.ndarray,         # [Nseg] live tiles per segment (prefix)
    total_tiles: int,        # static >= sum(tc); tail zeroed
) -> jnp.ndarray:
    """Concatenate per-segment live tile prefixes -> [total_tiles, TILE].

    Exactness requires src_start[s+1] - src_start[s] >= tc[s] (live tiles
    never exceed the segment's source stride), which makes the forward-fill
    value src_start[s] - off[s] nondecreasing.
    """
    off = exclusive_scan(tc)
    ff = _ffill_at(off[:-1], src_start - off[:-1], total_tiles)
    i = jnp.arange(total_tiles, dtype=jnp.int32)
    src = jnp.clip(ff + i, 0, src_tiles.shape[0] - 1)
    out = src_tiles[src]
    valid = i < off[-1]
    return jnp.where(valid[:, None], out, jnp.uint32(0))


def tile_window_gather(
    flat: jnp.ndarray,    # [N] u32
    starts: jnp.ndarray,  # [Nwin] i32 word offsets (arbitrary alignment)
    width: int,           # static window width (words)
    tile: int = VERT_TILE,
) -> jnp.ndarray:
    """[Nwin, width] windows via tile-row gather + barrel un-alignment.

    Gather cost scales with the tile INDEX count, so coarser tiles cut the
    dominant cost; the in-row
    realignment is a log2(tile)-pass barrel shift (was a tile-way funnel
    select — r4: barrel is O(log tile) passes instead of O(tile)).
    """
    N = int(flat.shape[0])
    T = max(_cdiv(N, tile), 1)
    pad = T * tile - N
    if pad:
        flat = jnp.pad(flat, (0, pad))
    tiles = flat.reshape(T, tile)
    K = _cdiv(width, tile) + 1
    ti = starts[:, None] // tile + jnp.arange(K, dtype=jnp.int32)[None, :]
    wide = tiles[jnp.clip(ti, 0, T - 1)].reshape(-1, K * tile)
    r = starts % tile
    # barrel: shift wide left by r words, then keep the first `width`
    y = wide
    for j in range((tile - 1).bit_length()):  # covers every r < tile
        sh = 1 << j
        shifted = jnp.pad(y[:, sh:], ((0, 0), (0, sh)))
        y = jnp.where(((r >> j) & 1 == 1)[:, None], shifted, y)
    out = y[:, :width]
    # zero-fill out-of-range words (clipped tile reads would repeat data)
    wpos = starts[:, None] + jnp.arange(width, dtype=jnp.int32)[None, :]
    return jnp.where((wpos >= 0) & (wpos < N), out, jnp.uint32(0))


# ------------------------------------------------------------ host squeeze


def squeeze_host(
    semi: np.ndarray, src_off: np.ndarray, lens: np.ndarray
) -> np.ndarray:
    """Drop tile-alignment gaps: semi[src_off[s] : src_off[s]+lens[s]] concat.

    Vectorized numpy (one fancy-index pass); segments are in output order.
    """
    lens = lens.astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.uint32)
    dst_off = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=dst_off[1:])

    from dctpu import native

    fast = native.squeeze(semi, src_off.astype(np.int64), dst_off)
    if fast is not None:
        return fast

    seg = np.repeat(np.arange(lens.size, dtype=np.int64), lens)
    pos = np.arange(total, dtype=np.int64) - dst_off[seg]
    return semi[src_off.astype(np.int64)[seg] + pos]


# ------------------------------------------------------------ rice


@functools.partial(jax.jit, static_argnames=("total_tiles",))
def compact_rice_semi(
    rows: jnp.ndarray,  # [B, W] u32 padded payload rows (live prefix)
    tc: jnp.ndarray,    # [B] i32 live tiles (= ceil(wc / RICE_TILE))
    total_tiles: int,
) -> jnp.ndarray:
    """[B, W] -> [total_tiles*RICE_TILE] semi-compact words (device)."""
    B, W = rows.shape
    W_pad = _cdiv(W, RICE_TILE) * RICE_TILE
    if W_pad != W:
        rows = jnp.pad(rows, ((0, 0), (0, W_pad - W)))
    W8 = W_pad // RICE_TILE
    src_tiles = rows.reshape(B * W8, RICE_TILE)
    src_start = jnp.arange(B, dtype=jnp.int32) * W8
    out = tile_segment_compact(src_tiles, src_start, tc, total_tiles)
    return out.reshape(-1)


def _sync_u16(sync: jnp.ndarray, subs: int) -> jnp.ndarray:
    """[B, SW] u32 -> [B, S] i32 u16 entries (little-endian pairs)."""
    lo = (sync & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = (sync >> jnp.uint32(16)).astype(jnp.int32)
    return jnp.stack([lo, hi], axis=2).reshape(sync.shape[0], -1)[:, :subs]


@functools.partial(jax.jit, static_argnames=("block_len", "buf_words"))
def stage_rice_scan_device(
    flat: jnp.ndarray,      # [N] u32 disk words (whole frame or subset)
    word_off: jnp.ndarray,  # [B+1] i32
    block_len: int,
    buf_words: int,
) -> jnp.ndarray:
    """Device twin of kernels.unpack_scan.stage_rice_scan.

    [N] disk words -> [B, SW + S*(UB+1)] rows: sync table verbatim, then
    each sub-block's raw words starting at the u32 containing its first
    code bit. Window gathers + funnel; no elementwise gathers.
    """
    B = int(word_off.shape[0]) - 1
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    UB1 = buf_words + 1
    if B == 0 or flat.shape[0] == 0:
        return jnp.zeros((B, SW + S * UB1), jnp.uint32)
    sync = tile_window_gather(flat, word_off[:-1], SW)
    sub_lens = _sync_u16(sync, S)  # [B, S]
    boff = SW * 32 + jnp.cumsum(sub_lens, axis=1) - sub_lens
    start = word_off[:-1, None] + (boff >> 5)  # [B, S]
    subsw = tile_window_gather(
        flat, start.reshape(-1), UB1, STAGE_GATHER_TILE
    )
    return jnp.concatenate([sync, subsw.reshape(B, S * UB1)], axis=1)


# ------------------------------------------------------------ vertical

# Round 4: device payload rows are PACKED (each sub's REGION_PAD slot holds
# its live disk words — vertical_xla REGION_PAD note), so compaction is a
# pure segment gather and staging a pure window gather. The pack/unpack
# barrel rolls live inside encode_vertical / decode_vertical, fused with
# the plane transposes.

from dctpu.kernels.vertical_xla import _pw_groups  # noqa: E402


def vertical_parse_sync(entries: jnp.ndarray):
    """[B, S] sync entries -> (b, n_exc, vw) per FORMAT §2.2."""
    b = entries & 0x3F
    n_exc = (entries >> 6) & 0x1F
    e = ((entries >> 11) & 0x1F) + 1  # valid only where n_exc > 0
    vw = jnp.where(n_exc > 0, jnp.minimum(n_exc, (e + 1) // 2), 0)
    return b, n_exc, vw


def vertical_wc_sub(entries: jnp.ndarray, pw: jnp.ndarray) -> jnp.ndarray:
    """[B, S] sync entries + [S] pw -> [B, S] live words per sub."""
    b, n_exc, vw = vertical_parse_sync(entries)
    return pw[None, :] * b + (n_exc + 3) // 4 + vw


@functools.partial(jax.jit, static_argnames=("block_len", "total_tiles"))
def compact_vertical_semi(
    rows: jnp.ndarray,  # [B, SW + S*REGION_PAD] u32 PACKED payload rows
    block_len: int,
    total_tiles: int,
) -> jnp.ndarray:
    """Packed device rows -> [total_tiles*VERT_TILE] semi-compact words.

    Segment order: per block, the sync table then each sub's live prefix,
    every segment VERT_TILE-aligned (host squeezes gaps). Rows are already
    packed (encode_vertical emits live prefixes), so this is sync parsing
    plus ONE live-tile segment gather — the r3 repack pass is gone.
    """
    B = rows.shape[0]
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    _, pws = _pw_groups(block_len)

    sync = rows[:, :SW]
    entries = _sync_u16(sync, S)
    pw_d = jnp.asarray(pws)
    wc_sub = vertical_wc_sub(entries, pw_d)

    # combined per-block source: [SWT sync tiles | S * RPT region tiles].
    # When SW is already a VERT_TILE multiple (block_len % 4096 geometry),
    # rows IS the combined layout — skip the whole-payload concat copy.
    SWT = _cdiv(SW, VERT_TILE)
    RPT = REGION_PAD // VERT_TILE
    if SW == SWT * VERT_TILE:
        combined = rows
    else:
        sync_pad = jnp.pad(sync, ((0, 0), (0, SWT * VERT_TILE - SW)))
        combined = jnp.concatenate([sync_pad, rows[:, SW:]], axis=1)
    src_tiles = combined.reshape(-1, VERT_TILE)

    tc_sub = _cdiv_arr(wc_sub, VERT_TILE)
    tc = jnp.concatenate(
        [jnp.full((B, 1), SWT, jnp.int32), tc_sub.astype(jnp.int32)], axis=1
    ).reshape(-1)
    # per-segment source tile starts: block stride SWT + S*RPT; within a
    # block: sync at 0, sub s at SWT + s*RPT
    stride = SWT + S * RPT
    within = jnp.concatenate(
        [jnp.zeros(1, jnp.int32),
         SWT + jnp.arange(S, dtype=jnp.int32) * RPT]
    )
    src_start = (
        jnp.arange(B, dtype=jnp.int32)[:, None] * stride + within[None, :]
    ).reshape(-1)
    out = tile_segment_compact(src_tiles, src_start, tc, total_tiles)
    return out.reshape(-1), wc_sub


def _cdiv_arr(x, d):
    return (x + (d - 1)) // d


@functools.partial(jax.jit, static_argnames=("block_len",))
def vertical_sync_entries_device(
    flat: jnp.ndarray, word_off: jnp.ndarray, block_len: int
) -> jnp.ndarray:
    """[B, S] sync entries from disk words (for host bucket/offset math)."""
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    sync = tile_window_gather(flat, word_off[:-1], SW)
    return _sync_u16(sync, S)


def span_bucket(max_b: int) -> int:
    """Static gather width covering every sub at max plane width max_b.

    Live words per sub <= 4*b + POS words + vals <= 4*b + 20; bucketing by
    the plane buckets bounds compile variants while the gather reads only
    ~the live width instead of the full REGION_PAD window (fewer tile
    indices — the staging gather is index-count-bound)."""
    from dctpu.kernels.vertical_xla import plane_bucket

    return min(4 * plane_bucket(max_b) + 20, REGION_PAD)


@functools.partial(jax.jit, static_argnames=("block_len", "span_words"))
def stage_vertical_device(
    flat: jnp.ndarray,      # [N] u32 disk words
    word_off: jnp.ndarray,  # [B+1] i32
    block_len: int,
    span_words: int = REGION_PAD,
) -> jnp.ndarray:
    """Disk words -> [B, SW + S*REGION_PAD] PACKED rows (device).

    A pure window gather: each sub's live span lands verbatim in its
    REGION_PAD slot, zero-masked past its live word count (decode_vertical
    requires that). The r3 fixed-layout expansion (plane regroup + rolls)
    moved into decode_vertical where it fuses with the plane transpose.

    span_words: static gather width (span_bucket(max_b) from a host sync
    parse); every sub's live count must be <= span_words — asserted cheaply
    via the zero-mask contract (words beyond are zero-filled, so a too-
    small span would corrupt decode, which the callers' bucketing rules
    out: wc_sub <= 4*b_max + 20).
    """
    B = int(word_off.shape[0]) - 1
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    W = SW + S * REGION_PAD
    if B == 0 or flat.shape[0] == 0:
        return jnp.zeros((B, W), jnp.uint32)
    _, pws = _pw_groups(block_len)

    sync = tile_window_gather(flat, word_off[:-1], SW)
    entries = _sync_u16(sync, S)
    pw_d = jnp.asarray(pws)
    wc_sub = vertical_wc_sub(entries, pw_d)
    suboff = jnp.cumsum(wc_sub, axis=1) - wc_sub  # [B, S] within block body

    starts = (word_off[:-1, None] + SW + suboff).reshape(-1)
    span = tile_window_gather(
        flat, starts, span_words, STAGE_GATHER_TILE
    ).reshape(B, S, span_words)
    if span_words < REGION_PAD:
        span = jnp.pad(span, ((0, 0), (0, 0), (0, REGION_PAD - span_words)))
    # zero-mask beyond each sub's live words (decode's contract)
    slot = jnp.arange(REGION_PAD, dtype=jnp.int32)[None, None, :]
    span = jnp.where(slot < wc_sub[:, :, None], span, jnp.uint32(0))
    return jnp.concatenate([sync, span.reshape(B, S * REGION_PAD)], axis=1)


# ------------------------------------------------------------ subsets


@functools.partial(jax.jit, static_argnames=("total_tiles",))
def subset_semi(
    flat: jnp.ndarray,      # [N] u32 whole-frame disk words
    starts: jnp.ndarray,    # [G] i32 selected block word starts, ascending
    wc: jnp.ndarray,        # [G] i32 exact word count per selected block
    total_tiles: int,
) -> jnp.ndarray:
    """Gather a block subset into a VERT_TILE-aligned semi stream.

    Source spans start at arbitrary word offsets (and skip unselected
    blocks), so each output tile row is funnel-selected from a 2-tile
    window at a forward-filled word offset. Subsets preserve block order,
    so `starts` is nondecreasing and the forward fills are exact.
    """
    tc = _cdiv_arr(wc, VERT_TILE).astype(jnp.int32)
    off = exclusive_scan(tc)
    total = total_tiles
    i = jnp.arange(total, dtype=jnp.int32)
    off_ff = _ffill_at(off[:-1], off[:-1], total)     # off[s(i)]
    start_ff = _ffill_at(off[:-1], starts, total)     # starts[s(i)]
    wc_ff = _ffill_at(off[:-1], starts + wc, total) - start_ff  # wc[s(i)]
    tile_in_seg = i - off_ff
    word_start = start_ff + tile_in_seg * VERT_TILE
    out = tile_window_gather(flat, jnp.maximum(word_start, 0), VERT_TILE)
    # zero the per-segment alignment pad and the global tail
    wslot = tile_in_seg[:, None] * VERT_TILE + jnp.arange(
        VERT_TILE, dtype=jnp.int32
    )[None, :]
    live = (wslot < wc_ff[:, None]) & (i < off[-1])[:, None]
    return jnp.where(live, out, jnp.uint32(0)).reshape(-1)
