"""Chunked-scan Rice bit packer: bounded-depth merge, compile-stable at any B.

Bit-identical to pack_xla/pack_merge (same DCF1 §2/§2.1 stream), but built to
fix pack_merge's two compile-time problems (round-1 VERDICT weak #3):

  * pack_merge unrolls log2(L) = 12 merge levels into HLO whose tensor shapes
    change at every level — XLA's layout/fusion passes take minutes at
    B = 8192.
  * the early levels carry word-lists of [B, nodes] arrays whose count grows
    to 48, another HLO-size multiplier.

Here the bottom of the tree is a `lax.scan` (compiles once, 16 steps) and
only the top log2(L/16) levels are unrolled merges:

  scan   (16 steps): each 16-sample chunk prepends codewords into its own
         24-word buffer — state [B, P, 24], P = L/16 chunks. Prepending
         (reverse sample order) keeps every append at the buffer's bit 0:
         shift-up by the code length (a 0/1 word select + an in-word funnel,
         all elementwise) then OR the code into words 0-1. This is the same
         shift-buffer idiom as the unpack_scan decoder, run backwards.
  merge  (log2(P) levels, 8 at L=4096): pack_merge's tensor-form funnel
         merge combines chunk buffers pairwise into the block bitstream.

Bit-string concatenation is associative with zero-length identities, so the
different grouping yields byte-identical output (cross-tested in
tests/test_pack_merge.py). The scan writes its [B, P, 24] state to device
memory at every step; a fused kernel that keeps it on chip is the obvious
optimisation, once a profile ranks this stage.

Reference interface parity: SURVEY.md §2.1 "Bit-packer (hot)"; replaces the
serial put_bits loop of SURVEY.md §3 (encode hot loop).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dctpu.constants import MAX_CODE_BITS, SUB_BLOCK, subs_per_block, sync_words
from dctpu.kernels.pack_merge import _merge_tensor
from dctpu.kernels.pack_xla import make_sync_table, padded_words

CHUNK = 16                                    # samples per scan chunk
PART_WORDS = (CHUNK * MAX_CODE_BITS + 31) // 32  # 24: max words per chunk
BATCH_ROWS = 1024  # lax.map chunk: XLA pass time grows superlinearly with B
                   # (pack_merge took minutes at B=8192 — VERDICT weak #3);
                   # mapping fixed-size chunks bounds compile at any B


def _prepend_step(buf: jnp.ndarray, code):
    """buf'[bits] = code_t ++ buf[bits]; buf [B, P, W] u32, code ([B,P]x3)."""
    lo, hi, ln = code
    zero = jnp.zeros_like(buf[:, :, :1])
    d1 = (ln >= 32)[:, :, None]
    up1 = jnp.concatenate([zero, buf[:, :, :-1]], axis=2)
    base = jnp.where(d1, up1, buf)
    up_b = jnp.concatenate([zero, base[:, :, :-1]], axis=2)
    s = (ln & 31).astype(jnp.uint32)[:, :, None]
    shifted = (base << s) | jnp.where(
        s == 0, jnp.uint32(0), up_b >> ((jnp.uint32(32) - s) & jnp.uint32(31))
    )
    w0 = shifted[:, :, :1] | lo[:, :, None]
    w1 = shifted[:, :, 1:2] | hi[:, :, None]
    return jnp.concatenate([w0, w1, shifted[:, :, 2:]], axis=2), None


def pack_scan(
    code_lo: jnp.ndarray,  # [B, L] u32
    code_hi: jnp.ndarray,  # [B, L] u32
    length: jnp.ndarray,   # [B, L] i32
    valid: jnp.ndarray,    # [B, L] bool
    block_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (payload [B, W] u32 incl. sync table, bit_len [B] i32)."""
    B = code_lo.shape[0]
    if B > BATCH_ROWS:
        Bp = (B + BATCH_ROWS - 1) // BATCH_ROWS * BATCH_ROWS
        pad = ((0, Bp - B), (0, 0))

        def padto(a):
            return jnp.pad(a, pad) if Bp != B else a

        G = Bp // BATCH_ROWS

        def body(args):
            return _pack_scan_rows(*args, block_len)

        payload, bit_len = jax.lax.map(
            body,
            tuple(
                padto(a).reshape(G, BATCH_ROWS, -1)
                for a in (code_lo, code_hi, length, valid)
            ),
        )
        return payload.reshape(Bp, -1)[:B], bit_len.reshape(Bp)[:B]
    return _pack_scan_rows(code_lo, code_hi, length, valid, block_len)


def _pack_scan_rows(
    code_lo: jnp.ndarray,
    code_hi: jnp.ndarray,
    length: jnp.ndarray,
    valid: jnp.ndarray,
    block_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    B, L = code_lo.shape
    SW = sync_words(block_len)
    Wbits = padded_words(block_len) - SW
    subs = subs_per_block(block_len)
    Lp = subs * SUB_BLOCK
    P = Lp // CHUNK

    length = jnp.where(valid, length, 0)
    code_lo = jnp.where(valid, code_lo, jnp.uint32(0))
    code_hi = jnp.where(valid, code_hi, jnp.uint32(0))
    sync = make_sync_table(length, block_len)
    bit_len = jnp.sum(length, axis=1)

    if Lp != L:
        pad = ((0, 0), (0, Lp - L))
        code_lo = jnp.pad(code_lo, pad)
        code_hi = jnp.pad(code_hi, pad)
        length = jnp.pad(length, pad)

    # [B, P, CHUNK] -> scan over the sample-in-chunk axis, reverse order so
    # each step prepends and the chunk stream ends at buffer bit 0.
    lo_c = jnp.moveaxis(code_lo.reshape(B, P, CHUNK), 2, 0)
    hi_c = jnp.moveaxis(code_hi.reshape(B, P, CHUNK), 2, 0)
    ln_c = jnp.moveaxis(length.reshape(B, P, CHUNK), 2, 0)

    buf0 = jnp.zeros((B, P, PART_WORDS), jnp.uint32)
    buf, _ = jax.lax.scan(
        _prepend_step, buf0, (lo_c, hi_c, ln_c), reverse=True
    )

    lens = jnp.sum(length.reshape(B, P, CHUNK), axis=2)  # [B, P]
    mb = CHUNK * MAX_CODE_BITS
    while lens.shape[1] > 1:
        buf, lens, mb = _merge_tensor(buf, lens, mb)

    out = buf[:, 0, :]
    if out.shape[1] < Wbits:
        out = jnp.pad(out, ((0, 0), (0, Wbits - out.shape[1])))
    else:
        out = out[:, :Wbits]
    payload = jnp.concatenate([sync, out], axis=1)
    return payload, bit_len
