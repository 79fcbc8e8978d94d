"""Vectorized zigzag + Golomb-Rice codeword math (docs/FORMAT.md §2, §4).

Everything here is elementwise uint32 work: codeword values/lengths for a
whole [B, L] block batch at once, and the exact per-block k selection as a
static sweep over k ∈ [0, K_MAX]. Replaces the reference's per-sample
rice_encode loop (SURVEY.md §3 hot loop) with batched array ops.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dctpu.constants import ESCAPE_Q, K_MAX, MAX_CODE_BITS


def zigzag(r: jnp.ndarray) -> jnp.ndarray:
    u = r.astype(jnp.uint32)
    return (u << jnp.uint32(1)) ^ (r >> 31).astype(jnp.uint32)


def unzigzag(z: jnp.ndarray) -> jnp.ndarray:
    return ((z >> jnp.uint32(1)) ^ (jnp.uint32(0) - (z & jnp.uint32(1)))).astype(
        jnp.int32
    )


def code_lengths(z: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Codeword bit lengths, int32. k broadcasts against z."""
    k = k.astype(jnp.uint32)
    q = z >> k  # stay uint32: the escape compare must be unsigned
    esc = q >= ESCAPE_Q
    # q.astype(int32) is only read on non-escape lanes, where q <= 15.
    return jnp.where(
        esc, MAX_CODE_BITS, q.astype(jnp.int32) + 1 + k.astype(jnp.int32)
    )


def choose_k(z: jnp.ndarray, valid: jnp.ndarray, k_max: int = K_MAX) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact per-block argmin_k of total coded bits over valid samples.

    z: [..., L] uint32, valid: [..., L] bool. Returns (k [...], bits [...]).
    Ties choose the smallest k (argmin returns the first minimum).
    """
    # The packed-key min below encodes (totals, k) as totals*32 + k. That is
    # only injective/ordered while k fits in 5 bits and totals*32 fits in
    # int31: totals <= L * MAX_CODE_BITS, so L is bounded accordingly.
    assert k_max < 32, f"packed key holds 5 bits of k; k_max={k_max}"
    L = z.shape[-1]
    assert L * MAX_CODE_BITS < 2**26, (
        f"packed key needs totals*32 < 2^31: block_len={L} too large"
    )
    ks = jnp.arange(k_max + 1, dtype=jnp.uint32)  # [K+1]
    # One reduction per k laid out [..., K+1, L] so the reduced (sample) axis
    # is MINOR — XLA fuses the per-k length math into the reduce; a non-minor
    # reduce materializes the [..., L, K+1] expansion.
    q = z[..., None, :] >> ks[:, None]
    lens = jnp.where(
        q >= ESCAPE_Q,
        MAX_CODE_BITS,
        q.astype(jnp.int32) + 1 + ks.astype(jnp.int32)[:, None],
    )
    totals = jnp.sum(
        jnp.where(valid[..., None, :], lens, 0), axis=-1
    )  # [..., K+1]
    # Packed-key min: totals <= L*MAX_CODE_BITS < 2^26, ties -> smallest k.
    key = jnp.min(totals * 32 + ks.astype(jnp.int32), axis=-1)
    return (key & 31).astype(jnp.int32), key >> 5


def choose_k_planes(
    z: jnp.ndarray, n: jnp.ndarray, block_len: int, k_max: int = K_MAX
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact per-block argmin_k — bit-plane formulation, 2 passes over z.

    Bit-identical to choose_k (tested), but instead of re-reading z once per
    k (33 reduction passes — the round-1 Rice encode bottleneck), it reads z
    twice and gets every k's exact total from per-block popcount tables:

      P[p] = popcount of bit-plane p           (one 32x32 bit transpose)
      E[m] = #{t : bitlen(z_t) > m}            (transpose of the OR-smear)

    Escape at k  <=>  q = z>>k >= 16  <=>  bitlen > k+4, so the escaped
    samples are exactly those counted by E[k+4]. A non-escaped sample t has
    q_t = (z_t >> k) & 15, and summing that over ALL samples gives
    D_k = sum_t ((z_t>>k) & 15) = sum_{j<4} 2^j * P[k+j]; subtracting the
    escaped samples' share R_k = sum_{j<4} 2^j * #{bit_{k+j} set & bitlen >
    k+4} (4 tiny plane&smear popcounts per k) leaves exactly the non-escape
    q-sum. Exact total coded bits, all int32 (totals < 2^26 by the assert,
    D_k <= 15n, no 64-bit ops, which a GPU would emulate on its 32-bit
    integer units):

      L(k) = 48*E[k+4] + (k+1)*(n - E[k+4]) + D_k - R_k

    z: [..., L] u32 (any leading batch dims), n broadcastable [...] valid
    counts. Returns (k [...], bits [...]) int32.
    """
    from dctpu.constants import SUB_BLOCK, subs_per_block
    from dctpu.kernels.vertical_xla import _smear, bit_transpose32

    assert k_max < 32 and k_max + 4 <= 28
    L = z.shape[-1]
    assert L * MAX_CODE_BITS < 2**26  # packed-key bound, as in choose_k
    subs = subs_per_block(block_len)
    pad = subs * SUB_BLOCK - L
    lead = z.shape[:-1]
    valid = (
        jnp.arange(L, dtype=jnp.int32) < jnp.asarray(n)[..., None]
    )
    zm = jnp.where(valid, z, jnp.uint32(0))
    if pad:
        zm = jnp.pad(zm, [(0, 0)] * len(lead) + [(0, pad)])
    zs = zm.reshape(lead + (subs, 4, 32))

    pt = bit_transpose32(zs)            # [..., S, 4w, 32p] plane words
    st = bit_transpose32(
        _smear(zm).reshape(lead + (subs, 4, 32))
    )                                    # smear planes: bit set <=> bitlen>p

    pc = jax.lax.population_count(pt).astype(jnp.int32)
    sc = jax.lax.population_count(st).astype(jnp.int32)
    # per-block tables: sum over sub and word axes -> [..., 32]
    P = jnp.sum(pc, axis=(-3, -2))
    E = jnp.sum(sc, axis=(-3, -2))

    ks = jnp.arange(k_max + 1, dtype=jnp.int32)
    # D_k = sum_{j<4} 2^j * P[k+j]: slice P so element k of each slice is
    # P[k+j] (k+j <= k_max+3 <= 27 < 32 planes).
    D = sum((1 << j) * P[..., j : j + k_max + 1] for j in range(4))

    # R_k: 4 plane&smear popcounts per k (tiny: static slices of pt/st)
    R = []
    for k in range(k_max + 1):
        acc = jnp.zeros(lead, jnp.int32)
        for j in range(4):
            both = pt[..., :, :, k + j] & st[..., :, :, k + 4]
            cnt = jnp.sum(
                jax.lax.population_count(both).astype(jnp.int32), axis=(-2, -1)
            )
            acc = acc + (1 << j) * cnt
        R.append(acc)
    R = jnp.stack(R, axis=-1)  # [..., K+1]

    n32 = jnp.asarray(n).astype(jnp.int32)[..., None]
    Ek4 = E[..., 4 : k_max + 5]
    totals = (
        48 * Ek4 + (ks + 1) * (n32 - Ek4) + D - R
    )  # [..., K+1] exact coded bits, int32
    key = jnp.min(totals * 32 + ks, axis=-1)
    return (key & 31).astype(jnp.int32), key >> 5


def codewords(z: jnp.ndarray, k: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(code_lo u32, code_hi u32, length i32) per sample; 32-bit ops only.

    The codeword integer (bit 0 = first stream bit) split into low/high words:
      normal: ((1<<q)-1) | (low_k(z) << (q+1)),  len = q+1+k  (q < 16)
      escape: 0xFFFF | (z << 16),                len = 48
    """
    ku = k.astype(jnp.uint32)
    q = z >> ku
    esc = q >= ESCAPE_Q
    qe = jnp.minimum(q, jnp.uint32(ESCAPE_Q - 1))  # clamp for shift safety
    ones = (jnp.uint32(1) << qe) - jnp.uint32(1)
    lowk = z & ((jnp.uint32(1) << ku) - jnp.uint32(1))
    lo_n = ones | (lowk << (qe + jnp.uint32(1)))          # u32 wrap keeps low bits
    hi_n = lowk >> (jnp.uint32(31) - qe)                   # bits 32.. of the code
    lo_e = jnp.uint32(0xFFFF) | (z << jnp.uint32(16))
    hi_e = z >> jnp.uint32(16)
    code_lo = jnp.where(esc, lo_e, lo_n)
    code_hi = jnp.where(esc, hi_e, hi_n)
    length = jnp.where(
        esc, MAX_CODE_BITS, q.astype(jnp.int32) + 1 + k.astype(jnp.int32)
    )
    return code_lo, code_hi, length
