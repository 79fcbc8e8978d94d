"""Shift-buffer Rice unpacker: gather-free decode scan (the default decoder).

Same DCF1 §2/§2.1 bitstream as kernels/unpack_xla.py, different machine
mapping. unpack_xla keeps a per-lane *bit pointer* and re-fetches 3 payload
words per scan step with take_along_axis. Here each 128-sample sub-block
instead carries its whole remaining bitstream as scan state (a [B, S, UB]
u32 shift buffer):

  stage (host):  word-granular copy of each sub-block's payload span into a
                 fixed [UB+1]-word slot (dctpu.codec.api staging, same
                 ragged-on-host pattern as the VERTICAL coder).
  align (device, once): funnel-shift by the sub-block's bit offset mod 32 so
                 buffer bit 0 == first code bit. Dense; offsets come from the
                 sync table.
  scan (device, 128 steps): decode one codeword per lane from buffer words
                 0-1, then funnel-shift the whole buffer down by its length.
                 Every op is an elementwise u32 shift/or/where — no gathers.

UB (buffer words) is a static bucket chosen per batch from the sync tables'
max sub-block bit length, so the O(UB) per-step shift cost tracks the data's
actual compressed size instead of the 192-word worst case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dctpu.constants import (
    ESCAPE_Q,
    MAX_CODE_BITS,
    SUB_BLOCK,
    subs_per_block,
    sync_words,
)
from dctpu.kernels.unpack_xla import _trailing_ones, read_sync_table

# Static buffer-size buckets (words); 192 = ceil(128*48/32) is the format's
# worst case (all-escape sub-block). Bucketing bounds recompiles.
BUF_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 96, 128, 192)


def buf_bucket(max_sub_bits: int) -> int:
    need = max(3, (int(max_sub_bits) + 31) // 32)
    if need > BUF_BUCKETS[-1]:
        # 192 words == 128 * MAX_CODE_BITS bits is the format's normative
        # worst case; anything larger means a corrupt sync table. Failing
        # here beats silently decoding garbage from a clamped buffer.
        raise ValueError(
            f"sync table claims a {max_sub_bits}-bit sub-block; format max "
            f"is {SUB_BLOCK * MAX_CODE_BITS}"
        )
    for b in BUF_BUCKETS:
        if need <= b:
            return b
    raise AssertionError("unreachable")


# ------------------------------------------------------------ host staging


def _sync_sub_lens_host(
    disk_words: np.ndarray, word_off: np.ndarray, block_len: int
) -> np.ndarray:
    """Per-sub-block code bit lengths [B, S] from each block's sync table."""
    B = word_off.size - 1
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    if B == 0:
        return np.zeros((0, S), np.int64)
    idx = word_off[:B, None] + np.arange(SW, dtype=np.int64)[None, :]
    sync = np.ascontiguousarray(disk_words[idx], dtype="<u4")
    u16 = sync.view("<u2").reshape(B, -1)[:, :S]
    return u16.astype(np.int64)


def max_sub_bits_host(
    disk_words: np.ndarray, word_off: np.ndarray, block_len: int
) -> int:
    lens = _sync_sub_lens_host(disk_words, word_off, block_len)
    return int(lens.max()) if lens.size else 0


def stage_rice_scan(
    disk_words: np.ndarray,
    word_off: np.ndarray,  # [B+1] per-block disk word offsets
    block_len: int,
    buf_words: int,
) -> np.ndarray:
    """Disk words -> [B, SW + S*(UB+1)] staged rows for unpack_scan.

    Row layout: [sync table | sub 0: UB+1 raw words | sub 1 | ...] where each
    sub's raw words start at the u32 containing its first code bit (bit-level
    alignment happens on device). Word-granular copies only — no host bit math.
    """
    B = word_off.size - 1
    S = subs_per_block(block_len)
    SW = sync_words(block_len)
    UB1 = buf_words + 1
    out = np.zeros((B, SW + S * UB1), dtype=np.uint32)
    if B == 0 or disk_words.size == 0:
        return out
    sync_idx = word_off[:B, None] + np.arange(SW, dtype=np.int64)[None, :]
    out[:, :SW] = disk_words[sync_idx]
    sub_lens = _sync_sub_lens_host(disk_words, word_off, block_len)
    boff = SW * 32 + np.cumsum(sub_lens, axis=1) - sub_lens  # [B, S] bits
    start = word_off[:B, None] + (boff >> 5)
    # Chunk over blocks so the [Bc, S, UB+1] transient index array stays
    # bounded (~16 MB) instead of materializing B*S*(UB+1) int64 at once
    # (~400 MB at the bench geometry); int32 indices when the word count fits.
    idt = np.int32 if disk_words.size < 2**31 else np.int64
    span = np.arange(UB1, dtype=idt)[None, None, :]
    chunk = max(1, (4 << 20) // max(1, S * UB1))
    for c0 in range(0, B, chunk):
        c1 = min(c0 + chunk, B)
        idx = start[c0:c1, :, None].astype(idt) + span
        # zero-fill past the end (same convention as the device staging in
        # kernels/ragged.py; these words are never read by the decoder)
        oob = idx >= disk_words.size
        np.clip(idx, 0, disk_words.size - 1, out=idx)
        vals = disk_words[idx.reshape(c1 - c0, -1)]
        vals[oob.reshape(c1 - c0, -1)] = 0
        out[c0:c1, SW:] = vals
    return out


def staged_width(block_len: int, buf_words: int) -> int:
    return sync_words(block_len) + subs_per_block(block_len) * (buf_words + 1)


# ------------------------------------------------------------ device kernel


def _funnel_arr(lo: jnp.ndarray, hi: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(lo >> s) | (hi << (32-s)) elementwise, s in [0, 32)."""
    hi_part = jnp.where(
        s == 0, jnp.uint32(0), hi << ((jnp.uint32(32) - s) & jnp.uint32(31))
    )
    return (lo >> s) | hi_part


def _unroll_factor(buf_words: int, T: int) -> int:
    """Codewords decoded per scan step (see unpack_scan).

    U codewords span <= 48*U bits; the last extraction reads 64 bits past
    its start, so the lookahead window needs floor(48*(U-1)/32) + 2 + 1
    buffer words. U=4 needs 7 (buckets >= 8); U=2 needs 4 (the minimum
    bucket). T must stay divisible by U.
    """
    for U in (4, 2):
        need = (48 * (U - 1)) // 32 + 3
        if buf_words >= need and T % U == 0:
            return U
    return 1


def unpack_scan(
    staged: jnp.ndarray,  # [B, SW + S*(UB+1)] u32 (stage_rice_scan rows)
    k: jnp.ndarray,       # [B] i32
    n: jnp.ndarray,       # [B] i32 valid samples
    block_len: int,
    buf_words: int,
) -> jnp.ndarray:
    """Returns z [B, L] uint32 (zeros past n). No gathers anywhere.

    The scan is unrolled U codewords per step (U = 2 or 4): the dominant
    cost is reading+writing the [B, S, UB] shift-buffer scan state once per
    step, so decoding U codewords from a local lookahead window before the
    one whole-buffer shift cuts state traffic by U.
    Per step: U extractions at cumulative bit offset c (each a (d in
    0..ceil(48*(U-1)/32))-way word select + 64-bit funnel), then one
    buffer shift by c (word step 0..ceil(48U/32), sub-word funnel).
    """
    B = staged.shape[0]
    L = block_len
    SW = sync_words(L)
    subs = subs_per_block(L)
    UB = buf_words
    T = min(SUB_BLOCK, L)
    U = _unroll_factor(UB, T)

    sub_lens = read_sync_table(staged, L)  # [B, S] i32
    boff = jnp.cumsum(sub_lens, axis=1) - sub_lens + SW * 32
    s0 = (boff & 31).astype(jnp.uint32)[:, :, None]  # in-word bit offset

    raw = staged[:, SW:].reshape(B, subs, UB + 1)
    buf = _funnel_arr(raw[:, :, :UB], raw[:, :, 1:], s0)  # bit 0 = code bit 0

    # valid samples per sub-block
    sub_start = jnp.arange(subs, dtype=jnp.int32) * SUB_BLOCK
    cap = jnp.minimum(jnp.int32(T), jnp.int32(L) - sub_start)
    n_sub = jnp.clip(n[:, None] - sub_start[None, :], 0, cap[None, :])

    ku = k.astype(jnp.uint32)[:, None]
    kmask = (jnp.uint32(1) << ku) - jnp.uint32(1)
    ki = k.astype(jnp.int32)[:, None]

    def word_at(buf, d):
        """buf[:, :, d] with zero fill past the end (static d)."""
        if d < UB:
            return buf[:, :, d]
        return jnp.zeros_like(buf[:, :, 0])

    def decode_at(buf, c, t_abs):
        """Decode one codeword at dynamic bit offset c (c <= 48*(U-1)).

        Returns (z, new_c). The two window words at bit c come from a
        static-d select over the possible word offsets, then a funnel by
        c mod 32 — no gathers, no dynamic slices.
        """
        dmax = (48 * (U - 1)) // 32  # max word offset of the window
        d = c >> 5
        r = (c & 31).astype(jnp.uint32)
        u0 = word_at(buf, 0)
        u1 = word_at(buf, 1)
        u2 = word_at(buf, 2)
        for dd in range(1, dmax + 1):
            sel = d == dd
            u0 = jnp.where(sel, word_at(buf, dd), u0)
            u1 = jnp.where(sel, word_at(buf, dd + 1), u1)
            u2 = jnp.where(sel, word_at(buf, dd + 2), u2)
        w0 = _funnel_arr(u0, u1, r)
        w1 = _funnel_arr(u1, u2, r)

        ones = _trailing_ones(w0)
        esc = ones >= ESCAPE_Q
        q = jnp.minimum(ones, ESCAPE_Q - 1).astype(jnp.uint32)
        # k remainder bits start at bit q+1 (q <= 15, so the 32-bit window
        # (w0 >> (q+1)) | (w1 << (31-q)) holds all of them for k <= 30).
        v = (w0 >> (q + jnp.uint32(1))) | (w1 << (jnp.uint32(31) - q))
        z_norm = (q << ku) | (v & kmask)
        z_esc = (w0 >> jnp.uint32(ESCAPE_Q)) | (w1 << jnp.uint32(32 - ESCAPE_Q))
        z = jnp.where(esc, z_esc, z_norm)

        length = jnp.where(esc, MAX_CODE_BITS, q.astype(jnp.int32) + 1 + ki)
        active = t_abs < n_sub
        z = jnp.where(active, z, jnp.uint32(0))
        return z, c + jnp.where(active, length, 0)

    zero = jnp.zeros((B, subs), jnp.int32)

    def step(buf, t):
        zs, c = [], zero
        for j in range(U):
            z, c = decode_at(buf, c, t * U + j)
            zs.append(z)

        # shift the whole buffer down by c bits: static-word-step select
        # (c <= 48*U -> d in [0, ceil(48U/32)]), then a sub-word funnel.
        d = (c >> 5)[:, :, None]
        s2 = (c & 31).astype(jnp.uint32)[:, :, None]
        pad_cols = jnp.zeros((B, subs, (48 * U) // 32 + 2), jnp.uint32)
        ext = jnp.concatenate([buf, pad_cols], axis=2)
        lo = ext[:, :, :UB]
        hi = ext[:, :, 1 : UB + 1]
        for dd in range(1, (48 * U) // 32 + 1):
            sel = d == dd
            lo = jnp.where(sel, ext[:, :, dd : dd + UB], lo)
            hi = jnp.where(sel, ext[:, :, dd + 1 : dd + 1 + UB], hi)
        buf = _funnel_arr(lo, hi, s2)
        return buf, jnp.stack(zs, axis=-1)  # [B, S, U]

    _, zs = jax.lax.scan(step, buf, jnp.arange(T // U, dtype=jnp.int32))
    z = jnp.moveaxis(zs, 0, 2).reshape(
        B, subs, T
    )  # [T/U, B, S, U] -> [B, S, T/U*U], sample t = U*step + j

    if subs == 1:
        return z[:, 0, :L]
    last_cap = L - SUB_BLOCK * (subs - 1)
    body = z[:, :-1, :].reshape(B, -1)
    tail = z[:, -1, :last_cap]
    return jnp.concatenate([body, tail], axis=1)
