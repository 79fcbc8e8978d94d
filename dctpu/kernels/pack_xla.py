"""Pure-XLA bit packer: variable-length codewords -> dense u32 words.

Replaces the reference's serial put_bits loop (SURVEY.md §3 encode hot loop)
with the parallel-entropy-coding pattern mandated by the north star [B:5]:

  1. exclusive prefix sum of codeword bit lengths -> every sample knows its
     absolute output bit offset (no serial dependency),
  2. per-sub-block (128-sample) length sums become the payload's leading sync
     table (docs/FORMAT.md §2.1) so decode parallelizes within blocks,
  3. each codeword is split into <=3 aligned u32 contributions (a 48-bit max
     code starting at any bit offset spans at most 3 words),
  4. contributions from different codewords occupy disjoint bit ranges, so a
     scatter-ADD over the payload words is exactly a scatter-OR.

All shifts are uint32 with explicit s==0 guards (no 64-bit ops on the hot
path). The scatter-ADD is order-independent for integers, so GPU atomics give
the same words in any order. Fixed-shape output: W = sync_words +
ceil(L*48/32) words per block (XLA needs static shapes); compaction to
actual sizes happens at frame assembly.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from dctpu.constants import MAX_CODE_BITS, SUB_BLOCK, subs_per_block, sync_words


def padded_words(block_len: int) -> int:
    """Worst-case payload words per block (sync table + all-escape bitstream)."""
    return sync_words(block_len) + (block_len * MAX_CODE_BITS + 31) // 32


def _shr_funnel(lo: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """lo >> (32 - s) with the s == 0 case mapped to 0 (avoids UB shift-by-32)."""
    return jnp.where(
        s == 0, jnp.uint32(0), lo >> ((jnp.uint32(32) - s) & jnp.uint32(31))
    )


def make_sync_table(length: jnp.ndarray, block_len: int) -> jnp.ndarray:
    """[B, L] code bit lengths -> [B, sync_words] u32 sync table."""
    B, L = length.shape
    subs = subs_per_block(block_len)
    pad = subs * SUB_BLOCK - L
    lens = jnp.pad(length, ((0, 0), (0, pad))) if pad else length
    sub_lens = jnp.sum(lens.reshape(B, subs, SUB_BLOCK), axis=2).astype(jnp.uint32)
    if subs % 2:
        sub_lens = jnp.pad(sub_lens, ((0, 0), (0, 1)))
    pairs = sub_lens.reshape(B, -1, 2)
    return pairs[:, :, 0] | (pairs[:, :, 1] << jnp.uint32(16))


def pack_xla(
    code_lo: jnp.ndarray,  # [B, L] u32
    code_hi: jnp.ndarray,  # [B, L] u32 (bits 32.. of each codeword)
    length: jnp.ndarray,   # [B, L] i32 (0 for invalid samples)
    valid: jnp.ndarray,    # [B, L] bool
    block_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (payload [B, W] u32 incl. sync table, bit_len [B] i32)."""
    B, L = code_lo.shape
    SW = sync_words(block_len)
    Wbits = padded_words(block_len) - SW

    length = jnp.where(valid, length, 0)
    code_lo = jnp.where(valid, code_lo, jnp.uint32(0))
    code_hi = jnp.where(valid, code_hi, jnp.uint32(0))

    # Exclusive scan of lengths -> absolute bit offsets; total bits per block.
    incl = jnp.cumsum(length, axis=1)
    off = incl - length
    bit_len = incl[:, -1]

    sync = make_sync_table(length, block_len)  # [B, SW]

    s = (off & 31).astype(jnp.uint32)
    w = off >> 5  # word index within the bitstream section

    # Codeword shifted to its bit offset, expressed as 3 word contributions.
    v0 = code_lo << s
    v1 = _shr_funnel(code_lo, s) | (code_hi << s)
    v2 = _shr_funnel(code_hi, s)

    flat_idx = jnp.arange(B, dtype=jnp.int32)[:, None] * Wbits + w
    bits = jnp.zeros(B * Wbits, dtype=jnp.uint32)
    # Disjoint bit ranges -> add == or. OOB (zero-valued) contributions drop.
    bits = bits.at[flat_idx].add(v0, mode="drop")
    bits = bits.at[flat_idx + 1].add(v1, mode="drop")
    bits = bits.at[flat_idx + 2].add(v2, mode="drop")
    payload = jnp.concatenate([sync, bits.reshape(B, Wbits)], axis=1)
    return payload, bit_len
