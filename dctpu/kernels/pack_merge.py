"""Dense Rice bit packer: hierarchical funnel-shift merge, no scatter/gather.

Replaces pack_xla's scatter-OR with a balanced merge tree over bit-strings:

  level 0:  every sample is a (codeword, length<=48) bit-string
  level l:  merge node pairs:  (a, la) + (b, lb) -> (a | b << la, la + lb)

`b << la` is a word-funnel shift (dense u32 ops) followed by a barrel word
roll (log2(max words) masked static shifts) — every step is an elementwise op
or a static slice. Output is bit-identical
to pack_xla (same LSB-first stream, same sync table, zero padding).

Two phases keep the minor dimension wide:
  A. word-of-lists: the node buffer is W separate [B, nodes] arrays
     (nodes is the minor dim) while W < nodes;
  B. tensor: one [B, nodes, W] array once W >= nodes (W is the minor dim).

Reference interface parity: SURVEY.md §2.1 "Bit-packer (hot)"; the serial
put_bits loop it replaces is described at SURVEY.md §3 (encode hot loop).
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from dctpu.constants import MAX_CODE_BITS, sync_words
from dctpu.kernels.pack_xla import make_sync_table, padded_words


def _funnel_split(
    words: List[jnp.ndarray], s: jnp.ndarray, w2: int
) -> List[jnp.ndarray]:
    """Bit-shift a W-word string left by s in [0,32): W+1 live words, pad to w2."""
    zero = jnp.zeros_like(words[0])
    out = []
    for i in range(min(len(words) + 1, w2)):
        lo = (words[i] << s) if i < len(words) else zero
        if i >= 1:
            hi = jnp.where(s == 0, jnp.uint32(0),
                           words[i - 1] >> ((jnp.uint32(32) - s) & jnp.uint32(31)))
            out.append(lo | hi)
        else:
            out.append(lo)
    out += [zero] * (w2 - len(out))
    return out


def _merge_split(
    words: List[jnp.ndarray], lens: jnp.ndarray, mb: int
) -> Tuple[List[jnp.ndarray], jnp.ndarray, int]:
    """One merge level in word-of-lists form. mb = static max bits per node."""
    nodes = lens.shape[1]
    if nodes % 2:
        words = [jnp.pad(w, ((0, 0), (0, 1))) for w in words]
        lens = jnp.pad(lens, ((0, 0), (0, 1)))
    a = [w[:, 0::2] for w in words]
    b = [w[:, 1::2] for w in words]
    la, lb = lens[:, 0::2], lens[:, 1::2]
    s = (la & 31).astype(jnp.uint32)
    wsh = la >> 5
    w2 = (2 * mb + 31) // 32

    bf = _funnel_split(b, s, w2)
    zero = jnp.zeros_like(bf[0])
    d = 1
    while d <= (mb >> 5):
        cond = (wsh & d) != 0
        bf = [
            jnp.where(cond, bf[i - d] if i >= d else zero, bf[i])
            for i in range(w2)
        ]
        d *= 2
    out = [(a[i] | bf[i]) if i < len(a) else bf[i] for i in range(w2)]
    return out, la + lb, 2 * mb


def _merge_tensor(
    buf: jnp.ndarray, lens: jnp.ndarray, mb: int
) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """One merge level in tensor form. buf: [B, nodes, W]."""
    _, nodes, w = buf.shape
    if nodes % 2:
        buf = jnp.pad(buf, ((0, 0), (0, 1), (0, 0)))
        lens = jnp.pad(lens, ((0, 0), (0, 1)))
    a = buf[:, 0::2, :]
    b = buf[:, 1::2, :]
    la, lb = lens[:, 0::2], lens[:, 1::2]
    s = (la & 31).astype(jnp.uint32)[:, :, None]
    wsh = la >> 5
    w2 = (2 * mb + 31) // 32

    bp = jnp.pad(b, ((0, 0), (0, 0), (0, w2 - w)))
    prev = jnp.pad(bp[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
    bf = jnp.where(
        s == 0,
        bp,
        (bp << s) | (prev >> ((jnp.uint32(32) - s) & jnp.uint32(31))),
    )
    d = 1
    while d <= (mb >> 5):
        cond = ((wsh & d) != 0)[:, :, None]
        shifted = jnp.pad(bf[:, :, :-d], ((0, 0), (0, 0), (d, 0)))
        bf = jnp.where(cond, shifted, bf)
        d *= 2
    out = jnp.pad(a, ((0, 0), (0, 0), (0, w2 - w))) | bf
    return out, la + lb, 2 * mb


def pack_merge(
    code_lo: jnp.ndarray,  # [B, L] u32
    code_hi: jnp.ndarray,  # [B, L] u32
    length: jnp.ndarray,   # [B, L] i32
    valid: jnp.ndarray,    # [B, L] bool
    block_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (payload [B, W] u32 incl. sync table, bit_len [B] i32).

    Bit-identical to pack_xla.pack_xla.
    """
    B, L = code_lo.shape
    SW = sync_words(block_len)
    Wbits = padded_words(block_len) - SW

    length = jnp.where(valid, length, 0)
    code_lo = jnp.where(valid, code_lo, jnp.uint32(0))
    code_hi = jnp.where(valid, code_hi, jnp.uint32(0))
    sync = make_sync_table(length, block_len)
    bit_len = jnp.sum(length, axis=1)

    words: List[jnp.ndarray] = [code_lo, code_hi]
    lens = length
    mb = MAX_CODE_BITS
    # Phase A: lists of [B, nodes] arrays while the word count is below the
    # node count (keeps the minor dim wide).
    while lens.shape[1] > 1 and len(words) < 48:
        words, lens, mb = _merge_split(words, lens, mb)

    buf = jnp.stack(words, axis=2)  # [B, nodes, W]
    while lens.shape[1] > 1:
        buf, lens, mb = _merge_tensor(buf, lens, mb)

    out = buf[:, 0, :]
    if out.shape[1] < Wbits:
        out = jnp.pad(out, ((0, 0), (0, Wbits - out.shape[1])))
    else:
        out = out[:, :Wbits]
    payload = jnp.concatenate([sync, out], axis=1)
    return payload, bit_len
