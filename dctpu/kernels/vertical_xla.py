"""VERTICAL coder kernels (docs/FORMAT.md §2.2): dense vector ops end to end.

The throughput coder. Unlike Rice pack/unpack — whose per-sample variable
bit offsets need scans, scatters or gathers — every step here is a
fixed-shape elementwise op, reduction, or static-strided reshape:

  encode: width sweep (33 masked reductions) -> 32 bit-plane transposes
          (shift+sum over static lanes) -> EXC_CAP=16 dense rank-match passes
          for exception extraction. No scatter.
  decode: 32 plane accumulations + 16 one-hot exception patches. No gather.

Device payload region layout (uniform [B, W] interface with the Rice packer):
  [sync_words | per-sub regions of REGION_WORDS each]
  region: 128 plane words (p-major, 4 words per plane) | 4 position words |
          16 exception value words.
The host (dctpu.codec.api) compacts regions to the canonical on-disk layout
(only the first PW*b plane words, ceil(n_exc/4) position words, n_exc values)
and stages them back for decode — ragged work stays on the host, the device
sees only fixed shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dctpu.constants import (
    EXC_CAP,
    SUB_BLOCK,
    sub_caps,
    subs_per_block,
    sync_words,
)

PLANE_REGION = 4 * 32          # 32 planes x 4 words
POS_REGION = EXC_CAP // 4      # 4 words of packed u8 positions
VAL_REGION = EXC_CAP           # 16 exception value words
REGION_WORDS = PLANE_REGION + POS_REGION + VAL_REGION  # 148
# Device payload rows carry each sub's live prefix (the EXACT disk words:
# pw*b plane words, ceil(n_exc/4) pos words, vw value words — FORMAT §2.2)
# in a REGION_PAD-word slot. REGION_PAD = REGION_WORDS padded to a multiple
# of the VERT_TILE compaction lattice (kernels/ragged.py). The encoder emits
# the packed layout directly and the decoder consumes it, so compaction is
# a pure segment gather and decode staging a pure window gather. The value
# is device-only (the disk format does not depend on it) and has not been
# tuned on the H100.
REGION_PAD = 192


def padded_words_vertical(block_len: int) -> int:
    return sync_words(block_len) + subs_per_block(block_len) * REGION_PAD


# ---- packed-layout helpers (shared with kernels/ragged.py) --------------
# The packed region is the live prefix [pw*b plane words | ceil(n_exc/4)
# pos | vw vals] in a REGION_PAD slot. Conversions to/from the fixed
# per-plane layout are pure reshapes, pads, and b-indexed barrel rolls —
# no gathers, so XLA fuses them into the adjacent encode/decode passes.


def _plane_pack(region: jnp.ndarray, pwv: int) -> jnp.ndarray:
    """[..., 128] plane slots (stride 4) -> [..., 128] live-packed (stride pwv)."""
    if pwv == 4:
        return region
    lead = region.shape[:-1]
    packed = region.reshape(lead + (32, 4))[..., :pwv].reshape(lead + (32 * pwv,))
    return jnp.pad(packed, [(0, 0)] * len(lead) + [(0, 128 - 32 * pwv)])


def _plane_unpack(packed: jnp.ndarray, pwv: int) -> jnp.ndarray:
    """Inverse of _plane_pack."""
    if pwv == 4:
        return packed
    lead = packed.shape[:-1]
    v = packed[..., : 32 * pwv].reshape(lead + (32, pwv))
    v = jnp.pad(v, [(0, 0)] * len(lead) + [(0, 0), (0, 4 - pwv)])
    return v.reshape(lead + (128,))


def _roll_up_by(x: jnp.ndarray, amt: jnp.ndarray, step: int) -> jnp.ndarray:
    """Shift x right (toward higher slots) by amt*step along the last axis.

    amt: broadcastable integer array with values in [0, 32]; barrel of
    masked static shifts (step * 2^j). Zero fill."""
    for j in range(6):  # amt <= 32 -> bits 0..5
        sh = step << j
        if sh >= x.shape[-1]:
            break
        shifted = jnp.pad(x[..., :-sh], [(0, 0)] * (x.ndim - 1) + [(sh, 0)])
        x = jnp.where((amt >> j) & 1 == 1, shifted, x)
    return x


def _roll_down_by(x: jnp.ndarray, amt: jnp.ndarray, step: int) -> jnp.ndarray:
    """Shift x left (toward lower slots) by amt*step; zero fill."""
    for j in range(6):
        sh = step << j
        if sh >= x.shape[-1]:
            break
        shifted = jnp.pad(x[..., sh:], [(0, 0)] * (x.ndim - 1) + [(0, sh)])
        x = jnp.where((amt >> j) & 1 == 1, shifted, x)
    return x


def _pw_groups(block_len: int):
    """Static sub-index groups by plane word count pw (usually just {4})."""
    import numpy as np

    caps = sub_caps(block_len)
    pws = [(c + 31) // 32 for c in caps]
    groups = {}
    for s, pw in enumerate(pws):
        groups.setdefault(pw, []).append(s)
    return groups, np.asarray(pws, np.int32)


def _sub_shape(z: jnp.ndarray, n: jnp.ndarray, block_len: int):
    """[B, L] -> z_sub [B, S, 128] (zero past n), valid [B, S, 128]."""
    B, L = z.shape
    subs = subs_per_block(block_len)
    pad = subs * SUB_BLOCK - L
    idx = jnp.arange(L, dtype=jnp.int32)
    valid = idx[None, :] < n[:, None]
    z = jnp.where(valid, z, jnp.uint32(0))
    if pad:
        z = jnp.pad(z, ((0, 0), (0, pad)))
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    return (
        z.reshape(B, subs, SUB_BLOCK),
        valid.reshape(B, subs, SUB_BLOCK),
    )


def _plane_word_counts(block_len: int) -> jnp.ndarray:
    """Static per-sub-index plane word counts PW_s, shape [SUBS]."""
    return jnp.array([(c + 31) // 32 for c in sub_caps(block_len)], jnp.int32)


def bit_transpose32(x: jnp.ndarray) -> jnp.ndarray:
    """32x32 bit-matrix transpose along the last axis (length 32, u32).

    out[..., a] bit c == x[..., c] bit a. Self-inverse. 5 butterfly stages of
    masked shifts/xors — ~4x fewer ops than a 32-pass bit-plane loop; this is
    both the encode plane emission and the decode plane reconstruction.
    """
    x = x[..., ::-1]
    masks = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)
    lane = jnp.arange(32)
    j = 16
    for m in masks:
        mu = jnp.uint32(m)
        upper = (lane & j) == 0
        pd = jnp.roll(x, -j, axis=-1)
        pu = jnp.roll(x, j, axis=-1)
        t_up = (x ^ (pd >> j)) & mu
        t_low = (pu ^ (x >> j)) & mu
        x = jnp.where(upper, x ^ t_up, x ^ (t_low << j))
        j >>= 1
    return x[..., ::-1]


def _smear(z: jnp.ndarray) -> jnp.ndarray:
    """Bits [0, bitlen(z)) set: OR-smear of each value down from its MSB."""
    z = z | (z >> jnp.uint32(1))
    z = z | (z >> jnp.uint32(2))
    z = z | (z >> jnp.uint32(4))
    z = z | (z >> jnp.uint32(8))
    return z | (z >> jnp.uint32(16))


def exceed_counts(zs: jnp.ndarray) -> jnp.ndarray:
    """n_exc table: [..., S, 128] u32 (zeros where invalid) -> [..., S, 33] i32.

    out[..., b] = count of samples with bitlen > b. One smear + one 32x32
    bit-matrix transpose + popcount instead of 33 masked reductions over the
    sample axis: bit p of smear(z) says bitlen(z) > p, the transpose turns
    plane p into a per-plane bitmask over 32 samples, and popcount counts it.

    Callers that already hold the transposed plane words should use
    exceed_from_planes instead (saves this second transpose).
    """
    m = _smear(zs)
    mg = m.reshape(m.shape[:-1] + (4, 32))
    mt = bit_transpose32(mg)  # [..., S, 4, 32]: word p bit c = bitlen>p
    cnt = jnp.sum(
        jax.lax.population_count(mt).astype(jnp.int32), axis=-2
    )  # [..., S, 32]
    zero = jnp.zeros(cnt.shape[:-1] + (1,), jnp.int32)
    return jnp.concatenate([cnt, zero], axis=-1)


def exceed_from_planes(pw_by_group: jnp.ndarray) -> jnp.ndarray:
    """exceed_counts from transposed plane words [..., S, 4w, 32p].

    Plane word (w, p) bit c = sample (32w+c) bit p, so a sample exceeds
    width b iff any of its bits >= b is set: suffix-OR the plane words
    along p (5 doubling shifts), popcount, sum over the 4 word groups.
    Bit-identical to exceed_counts (tests).
    """
    y = pw_by_group
    for j in (1, 2, 4, 8, 16):  # y[..., p] |= y[..., p+j]
        pad = [(0, 0)] * (y.ndim - 1) + [(0, j)]
        y = y | jnp.pad(y[..., j:], pad)
    cnt = jnp.sum(
        jax.lax.population_count(y).astype(jnp.int32), axis=-2
    )  # [..., S, 32]
    zero = jnp.zeros(cnt.shape[:-1] + (1,), jnp.int32)
    return jnp.concatenate([cnt, zero], axis=-1)


def _select_width(
    n_exc_all: jnp.ndarray,  # [..., S, 33] i32
    pw: jnp.ndarray,         # broadcastable [..., S] i32 plane word counts
):
    """argmin_b words(b) s.t. n_exc(b) <= EXC_CAP; ties -> smallest b.

    words(b) = pw*b + ceil(n_exc/4) + ceil(e/2) with e = blmax - b when
    n_exc > 0 (FORMAT §2.2: exception values are bit-planed). Returns
    (best_b, best_words, best_exc, best_e), each [..., S] i32. b=32 is
    always legal (n_exc(32) == 0), so the argmin domain is never empty.
    """
    # blmax = number of planes with any exceeding sample (n_exc(b) > 0 for
    # exactly the b < blmax)
    blmax = jnp.sum((n_exc_all > 0).astype(jnp.int32), axis=-1)
    # Real word counts are <= PW*32 + 4 + 16 = 148 << 2^24, so the sentinel
    # dominates every legal width and the packed key below stays in int31
    # (words*64 + b < 2^31 requires words < 2^25; the sentinel is 2^24).
    assert PLANE_REGION + POS_REGION + VAL_REGION < (1 << 24)
    # Unrolled min over b on [..., S] slices, so no op carries a 33-wide
    # minor axis. Packed (words, b) key: ties pick the smallest b.
    best_key = None
    for b in range(33):
        n_exc_b = n_exc_all[..., b]
        e_b = jnp.maximum(blmax - b, 0)
        # cheaper of raw (n_exc words) and bit-planed (ceil(e/2)) layouts
        vw = jnp.where(n_exc_b > 0, jnp.minimum(n_exc_b, (e_b + 1) // 2), 0)
        words = pw * b + (n_exc_b + 3) // 4 + vw
        words = jnp.where(n_exc_b <= EXC_CAP, words, jnp.int32(1 << 24))
        key = words * 64 + b
        best_key = key if best_key is None else jnp.minimum(best_key, key)
    best_b = (best_key & 63).astype(jnp.int32)
    best_words = best_key >> 6
    b_axis = jnp.arange(33, dtype=jnp.int32)
    onehot = b_axis == best_b[..., None]
    best_exc = jnp.sum(jnp.where(onehot, n_exc_all, 0), axis=-1)
    best_e = jnp.where(best_exc > 0, blmax - best_b, 0)
    return best_b, best_words, best_exc, best_e


def vertical_selection_cost(
    z: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Predictor-selection proxy (FORMAT §2.2): sum of bitlengths of valid z.

    z: [..., L] u32, valid broadcastable -> [...] i32. One dense pass.
    """
    valid = jnp.broadcast_to(valid, z.shape)
    bl = (32 - jax.lax.clz(z.astype(jnp.int32)).astype(jnp.int32)) * (z != 0)
    return jnp.sum(jnp.where(valid, bl, 0), axis=-1)


def vertical_total_words(
    z: jnp.ndarray, valid: jnp.ndarray, block_len: int
) -> jnp.ndarray:
    """Exact per-block coded word count (diagnostics; not the selection rule).

    z: [..., B, L] u32, valid: [..., B, L] bool -> [..., B] i32.
    Mirrors the width rule (n_exc <= EXC_CAP, argmin words, tie smallest b).
    """
    subs = subs_per_block(block_len)
    L = z.shape[-1]
    pad = subs * SUB_BLOCK - L
    valid = jnp.broadcast_to(valid, z.shape)
    zm = jnp.where(valid, z, jnp.uint32(0))
    vm = valid
    if pad:
        widths = [(0, 0)] * (z.ndim - 1) + [(0, pad)]
        zm = jnp.pad(zm, widths)
        vm = jnp.pad(vm, widths)
    zs = zm.reshape(z.shape[:-1] + (subs, SUB_BLOCK))
    pw = _plane_word_counts(block_len)
    pw = pw.reshape((1,) * (z.ndim - 1) + (subs,))
    _, best_words, _, _ = _select_width(exceed_counts(zs), pw)
    return jnp.sum(best_words, axis=-1)


def exc_extract_xla(
    zs: jnp.ndarray,      # [B, S, 128] u32, zeroed past each sub-block's count
    best_b: jnp.ndarray,  # [B, S] i32 selected widths
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(pos_words [B, S, 4], vals [B, S, 16]) — pure-XLA rank-match passes.

    is_exc == (bitlen > b) & (b < 32) == (zs >> b) != 0, since zs is zeroed on
    invalid lanes. Values: EXC_CAP reduction passes. Positions: only 4 passes — each position is <= 7 bits and
    the output packs 4 per word, so a sample's position is shifted straight
    into its output byte (idx << 8*(rank&3)) and summed into word rank>>2.
    No masking past n_exc is needed anywhere: ranks only count exceptions, so
    no sample holds rank >= n_exc and the unmatched sums are exactly zero.
    """
    bb = best_b[:, :, None].astype(jnp.uint32)
    high = jnp.where(
        bb >= 32, jnp.uint32(0), zs >> jnp.minimum(bb, jnp.uint32(31))
    )
    is_exc = high != jnp.uint32(0)
    rank = jnp.cumsum(is_exc.astype(jnp.int32), axis=2) - 1
    rank8 = jnp.where(is_exc, rank, 255).astype(jnp.uint8)
    idx = jnp.arange(SUB_BLOCK, dtype=jnp.uint32)[None, None, :]

    val_list = []
    for j in range(EXC_CAP):
        m = rank8 == jnp.uint8(j)
        val_list.append(
            jnp.sum(jnp.where(m, high, jnp.uint32(0)), axis=2, dtype=jnp.uint32)
        )
    vals = jnp.stack(val_list, axis=2)  # [B, S, 16]

    byte_sh = (rank8.astype(jnp.uint32) & jnp.uint32(3)) << jnp.uint32(3)
    pos_contrib = jnp.where(is_exc, idx << byte_sh, jnp.uint32(0))
    word_id = rank8 >> 2  # u8; 63 for non-exceptions (rank8 == 255)
    pos_words = jnp.stack(
        [
            jnp.sum(
                jnp.where(word_id == jnp.uint8(m), pos_contrib, jnp.uint32(0)),
                axis=2,
                dtype=jnp.uint32,
            )
            for m in range(POS_REGION)
        ],
        axis=2,
    )  # [B, S, 4]
    return pos_words, vals


def encode_vertical(
    z: jnp.ndarray,  # [B, L] u32 zigzag values
    n: jnp.ndarray,  # [B] i32
    block_len: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (payload [B, W] u32, bit_len [B] i32). Dense ops only."""
    B, L = z.shape
    subs = subs_per_block(block_len)

    zs, valid = _sub_shape(z, n, block_len)  # [B, S, 128]
    pw = _plane_word_counts(block_len)[None, :]  # [1, S]

    # ---- bit planes first: 32x32 bit-matrix transpose per group ----
    zg = zs.reshape(B, subs, 4, 32)  # word groups of 32 samples
    pw_by_group = bit_transpose32(zg)  # [B, S, 4w, 32p]
    plane_words = jnp.swapaxes(pw_by_group, 2, 3)  # [B, S, 32p, 4w]
    plane_region = plane_words.reshape(B, subs, PLANE_REGION)

    # ---- width selection: argmin words over b, n_exc <= EXC_CAP ----
    # zs is zeroed outside `valid`, so zero samples never count as
    # exceeding any plane. The exceed table comes from the plane words
    # above (suffix-OR + popcount), so the 32x32 transpose runs once.
    best_b, best_words, best_exc, best_e = _select_width(
        exceed_from_planes(pw_by_group), pw
    )
    bit_len = 32 * jnp.sum(best_words, axis=1)

    # ---- exceptions: rank-match extraction ----
    pos_words, vals = exc_extract_xla(zs, best_b)

    # ---- exception values (FORMAT §2.2): raw layout when n_exc <= ceil(e/2),
    # else bit-planed — value-plane p holds bit p of every value on its 16
    # low bits, 2 planes per word. The same 32x32 bit transpose does the
    # value transposition (vals j >= 16 are zero, so planes fit 16 bits).
    vals32 = jnp.concatenate(
        [vals, jnp.zeros((B, subs, 32 - EXC_CAP), jnp.uint32)], axis=2
    )
    vplanes = bit_transpose32(vals32)  # [B, S, 32]: word p bit j = val_j bit p
    planed = vplanes[:, :, 0::2] | (vplanes[:, :, 1::2] << jnp.uint32(16))
    raw_layout = best_exc <= (best_e + 1) // 2  # [B, S]
    val_words = jnp.where(raw_layout[:, :, None], vals, planed)

    # ---- sync table ----
    e_field = jnp.where(best_exc > 0, best_e - 1, 0)
    entry = (best_b | (best_exc << 6) | (e_field << 11)).astype(jnp.uint32)
    if subs % 2:
        entry = jnp.pad(entry, ((0, 0), (0, 1)))
    ep = entry.reshape(B, -1, 2)
    sync = ep[:, :, 0] | (ep[:, :, 1] << jnp.uint32(16))  # [B, SW]

    # ---- packed region emission (round 4): each sub's REGION_PAD slot
    # holds its live prefix — the exact disk words. The pack (plane group
    # reshape + pos-gap close + b-indexed roll) fuses into the producers
    # above, so compaction needs no separate repack pass.
    import numpy as np

    groups, pws = _pw_groups(block_len)
    pw_d = jnp.asarray(pws)
    b3 = best_b[:, :, None]
    if set(groups) == {4}:
        packed_planes = plane_region
    else:
        packed_planes = jnp.zeros_like(plane_region)
        for pwv, subs_list in groups.items():
            mask = np.zeros(subs, bool)
            mask[subs_list] = True
            m = jnp.asarray(mask)[None, :, None]
            packed_planes = jnp.where(
                m, _plane_pack(plane_region, pwv), packed_planes
            )
    slot = jnp.arange(PLANE_REGION, dtype=jnp.int32)[None, None, :]
    live_planes = slot < (pw_d[None, :, None] * b3)
    packed_planes = jnp.where(live_planes, packed_planes, jnp.uint32(0))

    # tail: [posw pos words | vw value words], vals first moved down to
    # close the (POS_REGION - posw) gap, then the whole tail rolled up to
    # start at pw*b. Words beyond vw are zero by construction (raw vals
    # j >= n_exc are zero; planes >= e are zero), so no extra masking.
    posw = ((best_exc + 3) // 4)[:, :, None]
    tail20 = jnp.concatenate([pos_words, val_words], axis=2)  # [B, S, 20]
    tslot = jnp.arange(
        REGION_WORDS - PLANE_REGION, dtype=jnp.int32
    )[None, None, :]
    vals_dn = _roll_down_by(tail20, POS_REGION - posw, 1)
    tail20p = jnp.where(tslot < posw, tail20, vals_dn)
    packed = jnp.pad(
        packed_planes, ((0, 0), (0, 0), (0, REGION_PAD - PLANE_REGION))
    )
    # place the 20-word tail at word pw*b: a 33-way chain of static pads
    # selected by b — XLA fuses it into ONE output pass, vs the 6
    # masked-shift barrel passes over the full [B, S, REGION_PAD] row
    rolled = jnp.zeros_like(packed)
    TW = REGION_WORDS - PLANE_REGION
    for pwv, subs_list in groups.items():
        mask = np.zeros(subs, bool)
        mask[subs_list] = True
        m = jnp.asarray(mask)[None, :, None]
        placed = jnp.zeros_like(packed)
        for b in range(33):
            off = pwv * b
            seg = jnp.pad(
                tail20p, ((0, 0), (0, 0), (off, REGION_PAD - TW - off))
            )
            placed = jnp.where(b3 == b, seg, placed)
        rolled = jnp.where(m, placed, rolled)
    packed = packed | rolled  # [B, S, REGION_PAD] live prefix per sub

    payload = jnp.concatenate(
        [sync, packed.reshape(B, subs * REGION_PAD)], axis=1
    )
    return payload, bit_len.astype(jnp.int32)


PLANE_BUCKETS = (8, 12, 16, 24, 32)


def plane_bucket(max_b: int) -> int:
    """Smallest static plane count covering max_b (bounds recompiles)."""
    for b in PLANE_BUCKETS:
        if max_b <= b:
            return b
    return 32


def decode_vertical(
    payload: jnp.ndarray,  # [B, SW + SUBS*REGION_PAD] staged PACKED rows
    n: jnp.ndarray,        # [B] i32
    block_len: int,
    max_planes: int = 32,
) -> jnp.ndarray:
    """Returns z [B, L] u32 (zeros past n). Dense ops only.

    Consumes the packed live-prefix layout (staging is a pure window
    gather; see the REGION_PAD note at the top). Words at/after each sub's
    live count must be zero-staged. The un-pack (b-indexed roll-down +
    plane regroup) fuses into the plane transpose below.

    max_planes: static upper bound on any sub-block's width b in this batch
    (planes >= b are zero-staged, so skipping them is exact). The host reads
    it off the sync tables before launch.
    """
    import numpy as np

    B = payload.shape[0]
    subs = subs_per_block(block_len)
    SW = sync_words(block_len)
    L = block_len

    sync = payload[:, :SW]
    lo = (sync & jnp.uint32(0xFFFF)).astype(jnp.int32)
    hi = (sync >> jnp.uint32(16)).astype(jnp.int32)
    entries = jnp.stack([lo, hi], axis=2).reshape(B, -1)[:, :subs]
    b = (entries & 0x3F).astype(jnp.uint32)       # [B, S]
    n_exc = (entries >> 6) & 0x1F                 # [B, S]

    span = payload[:, SW:].reshape(B, subs, REGION_PAD)
    groups, pws = _pw_groups(block_len)
    b_i = b.astype(jnp.int32)[:, :, None]
    TW = REGION_WORDS - PLANE_REGION
    # tail extraction: 20 words starting at pw*b — a 33-way chain of
    # static slices selected by b (one fused output pass instead of the 6
    # masked-shift barrel passes over the whole row)
    if set(groups) == {4}:
        planes = span[:, :, :PLANE_REGION]
        tail20 = jnp.zeros((B, subs, TW), jnp.uint32)
        for bv in range(33):
            tail20 = jnp.where(
                b_i == bv, span[:, :, 4 * bv : 4 * bv + TW], tail20
            )
    else:
        planes = jnp.zeros((B, subs, PLANE_REGION), jnp.uint32)
        tail20 = jnp.zeros((B, subs, TW), jnp.uint32)
        for pwv, subs_list in groups.items():
            mask = np.zeros(subs, bool)
            mask[subs_list] = True
            m = jnp.asarray(mask)[None, :, None]
            planes = jnp.where(
                m, _plane_unpack(span[:, :, :PLANE_REGION], pwv), planes
            )
            t_g = jnp.zeros((B, subs, TW), jnp.uint32)
            for bv in range(33):
                off = pwv * bv
                t_g = jnp.where(
                    b_i == bv, span[:, :, off : off + TW], t_g
                )
            tail20 = jnp.where(m, t_g, tail20)
    # zero plane slots of planes >= b (those words belong to the tail)
    slotp = jnp.arange(PLANE_REGION, dtype=jnp.int32)[None, None, :]
    planes = jnp.where(
        (slotp >> 2) < b_i, planes, jnp.uint32(0)
    )
    plane_words = planes.reshape(B, subs, 32, 4)

    # tail: [posw pos | vw vals] -> fixed pos/val slots
    posw = ((n_exc + 3) // 4).astype(jnp.int32)[:, :, None]
    tslot = jnp.arange(
        REGION_WORDS - PLANE_REGION, dtype=jnp.int32
    )[None, None, :]
    vals_up = _roll_up_by(tail20, POS_REGION - posw, 1)
    pos_words = jnp.where(
        tslot < posw, tail20, jnp.uint32(0)
    )[:, :, :POS_REGION]
    val_words = jnp.where(
        tslot >= POS_REGION, vals_up, jnp.uint32(0)
    )[:, :, POS_REGION:]

    # exception values (FORMAT §2.2): raw layout when n_exc <= ceil(e/2),
    # else bit-planed — unpack the 16-bit halves into 32 planes, transpose
    # back to values. Planes past e are zero-staged; no masking on e needed.
    e = jnp.where(n_exc > 0, ((entries >> 11) & 0x1F) + 1, 0)
    vplanes = jnp.stack(
        [val_words & jnp.uint32(0xFFFF), val_words >> jnp.uint32(16)], axis=3
    ).reshape(B, subs, 32)
    planed_vals = bit_transpose32(vplanes)[:, :, :EXC_CAP]
    raw_layout = n_exc <= (e + 1) // 2
    vals = jnp.where(raw_layout[:, :, None], val_words, planed_vals)

    # planes -> z: the same 32x32 bit transpose (self-inverse); zero-staged
    # planes (p >= b) contribute zero bits, so no masking is needed and
    # max_planes no longer affects the cost (kept for interface stability).
    del max_planes
    pw_by_group = jnp.swapaxes(plane_words, 2, 3)  # [B, S, 4w, 32p]
    z = bit_transpose32(pw_by_group).reshape(B, subs, SUB_BLOCK)

    # exception patch: one reduction over the (minor) exception axis — live
    # positions within a sub-block are distinct, so at most one j matches any
    # sample and the sum equals the OR. XLA fuses the broadcast compare into
    # the reduce, so traffic is ~one pass over z plus the tiny pos/val arrays.
    idx = jnp.arange(SUB_BLOCK, dtype=jnp.uint32)[None, None, :]
    shifts = (jnp.arange(4, dtype=jnp.uint32) * 8)[None, None, None, :]
    pos = ((pos_words[:, :, :, None] >> shifts) & jnp.uint32(0xFF)).reshape(
        B, subs, EXC_CAP
    )
    bb = b[:, :, None]
    jj = jnp.arange(EXC_CAP, dtype=jnp.int32)[None, None, :]
    live = jj < n_exc[:, :, None]
    patch_vals = jnp.where(
        live & (bb < 32),
        vals << jnp.minimum(bb, jnp.uint32(31)),
        jnp.uint32(0),
    )  # [B, S, EXC]
    onehot = idx[:, :, :, None] == pos[:, :, None, :]  # [B, S, 128, EXC]
    z = z | jnp.sum(
        jnp.where(onehot, patch_vals[:, :, None, :], jnp.uint32(0)),
        axis=3,
        dtype=jnp.uint32,
    )

    z = z.reshape(B, subs * SUB_BLOCK)[:, :L]
    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < n[:, None]
    return jnp.where(valid, z, jnp.uint32(0))
