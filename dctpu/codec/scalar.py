"""Scalar reference codec — the executable specification of docs/FORMAT.md.

Deliberately simple (Python bigints for bit I/O, per-sample loops for LPC): this
is the clarity-first arbiter that the C++ oracle and the XLA codec are both
tested against byte-for-byte. It is NOT a performance path.

Mirrors the reference C codec's serial encode/decode call stack (SURVEY.md §3)
in structure: select_predictor → residuals → zigzag → choose k → rice emit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dctpu.config import CodecConfig, LpcTable
from dctpu.constants import (
    CODER_RICE,
    CODER_VERTICAL,
    EXC_CAP,
    DELTA,
    DOUBLE_DELTA,
    ESCAPE_Q,
    HISTORY_LEN,
    LPC,
    LPC_SHIFT,
    MAX_CODE_BITS,
    SUB_BLOCK,
    sub_caps,
    subs_per_block,
    sync_words,
)
from dctpu.format.frame import BlockHeaders, Frame, StreamMeta, plan_blocks

_M32 = (1 << 32) - 1
_M64 = (1 << 64) - 1


def _wrap_i32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def _wrap_i64(v: int) -> int:
    v &= _M64
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------- zigzag


def zigzag(r: np.ndarray) -> np.ndarray:
    """int32 residual -> uint32, small magnitudes first (FORMAT.md §2)."""
    r = r.astype(np.int32)
    return ((r.astype(np.uint32) << np.uint32(1)) ^ (r >> 31).astype(np.uint32)).astype(
        np.uint32
    )


def unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    return ((z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))).astype(np.int32)


# ---------------------------------------------------------------- predictors


def lpc_predict_one(hist: Sequence[int], table: LpcTable) -> int:
    """P = int32(wrap64(sum c_j * x_{t-j}) >> 16). hist[0] = x_{t-1}."""
    s = 0
    for j in range(table.order):
        s += int(table.coeffs[j]) * int(hist[j])
    s = _wrap_i64(s)
    return _wrap_i32(s >> LPC_SHIFT)  # Python >> on negative int is arithmetic


def residuals(x: np.ndarray, history: np.ndarray, predictor: int, table: LpcTable | None) -> np.ndarray:
    """Forward prediction; wrapping int32. history[j] = x_{-1-j}."""
    x = x.astype(np.int32)
    h = history.astype(np.int32)
    n = x.size
    if predictor == DELTA:
        prev = np.concatenate([h[:1], x[:-1]])
        return (x.astype(np.int64) - prev.astype(np.int64)).astype(np.int32)
    if predictor == DOUBLE_DELTA:
        x1 = np.concatenate([h[:1], x[:-1]])   # x_{t-1}
        x2 = np.concatenate([h[1:2], x1[:-1]]) # x_{t-2}
        acc = (
            x.astype(np.int64)
            - 2 * x1.astype(np.int64)
            + x2.astype(np.int64)
        )
        return acc.astype(np.int32)  # two's-complement truncation == wrapping
    if predictor == LPC:
        assert table is not None
        r = np.empty(n, dtype=np.int32)
        hist = [int(h[0]), int(h[1]), int(h[2]), int(h[3])]
        for t in range(n):
            p = lpc_predict_one(hist, table)
            r[t] = _wrap_i32(int(x[t]) - p)
            hist = [int(x[t])] + hist[:3]
        return r
    raise ValueError(f"unknown predictor {predictor}")


def reconstruct(r: np.ndarray, history: np.ndarray, predictor: int, table: LpcTable | None) -> np.ndarray:
    """Inverse prediction; wrapping int32."""
    r = r.astype(np.int32)
    h = history.astype(np.int32)
    n = r.size
    if predictor == DELTA:
        # x = h0 + inclusive_cumsum(r), wrapping
        return (np.cumsum(r.astype(np.int64)) + int(h[0])).astype(np.int32)
    if predictor == DOUBLE_DELTA:
        d0 = int(h[0]) - int(h[1])  # d_{-1}
        d = (np.cumsum(r.astype(np.int64)) + d0).astype(np.int32)  # d_t = x_t - x_{t-1}
        return (np.cumsum(d.astype(np.int64)) + int(h[0])).astype(np.int32)
    if predictor == LPC:
        assert table is not None
        x = np.empty(n, dtype=np.int32)
        hist = [int(h[0]), int(h[1]), int(h[2]), int(h[3])]
        for t in range(n):
            p = lpc_predict_one(hist, table)
            xt = _wrap_i32(int(r[t]) + p)
            x[t] = xt
            hist = [xt] + hist[:3]
        return x
    raise ValueError(f"unknown predictor {predictor}")


# ---------------------------------------------------------------- rice coding


def rice_code_lengths(z: np.ndarray, k: int) -> np.ndarray:
    q = (z >> np.uint32(k)).astype(np.int64)
    return np.where(q < ESCAPE_Q, q + 1 + k, MAX_CODE_BITS)


def choose_k(z: np.ndarray, k_max: int) -> Tuple[int, int]:
    """Exact argmin_k of total coded bits; ties -> smallest k (FORMAT.md §4)."""
    best_k, best_bits = 0, int(rice_code_lengths(z, 0).sum())
    for k in range(1, k_max + 1):
        bits = int(rice_code_lengths(z, k).sum())
        if bits < best_bits:
            best_k, best_bits = k, bits
    return best_k, best_bits


def rice_codeword(z: int, k: int) -> Tuple[int, int]:
    """(code, len). Bit 0 of `code` is the first emitted stream bit."""
    q = z >> k
    if q < ESCAPE_Q:
        low = z & ((1 << k) - 1)
        return ((1 << q) - 1) | (low << (q + 1)), q + 1 + k
    return 0xFFFF | (z << ESCAPE_Q), MAX_CODE_BITS


# ---------------------------------------------------------------- block codec


def pack_bits(codes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, int]:
    """Pack (code, len) pairs LSB-first into little-endian u32 words."""
    acc = 0
    off = 0
    for code, ln in codes:
        acc |= code << off
        off += ln
    nwords = (off + 31) // 32
    data = acc.to_bytes(nwords * 4, "little") if nwords else b""
    return np.frombuffer(data, dtype="<u4").copy(), off


def sync_table(code_lens: Sequence[int], block_len: int) -> np.ndarray:
    """Per-sub-block bit lengths (u16) -> packed u32 sync words (FORMAT §2.1)."""
    subs = subs_per_block(block_len)
    lens16 = np.zeros(subs, dtype=np.uint16)
    for s in range(subs):
        seg = code_lens[s * SUB_BLOCK : (s + 1) * SUB_BLOCK]
        lens16[s] = sum(seg)
    padded = np.zeros(2 * sync_words(block_len), dtype=np.uint16)
    padded[:subs] = lens16
    return padded.view("<u4").copy()


def scalar_encode_block(
    x: np.ndarray, history: np.ndarray, cfg: CodecConfig
) -> Tuple[int, int, int, int, int, np.ndarray]:
    """Encode one block -> (predictor, k, table_idx, coder, bit_len, payload).

    payload = sync table words + coded body words (docs/FORMAT.md §2.1/§2.2).
    bit_len counts body bits only (excludes the sync table).
    """
    if cfg.coder == "vertical":
        best = None  # (words, predictor, table_idx, z)
        for ci, (pred, ti) in enumerate(cfg.candidates()):
            table = cfg.lpc_tables[ti] if pred == LPC else None
            z = zigzag(residuals(x, history, pred, table))
            cost = vertical_block_cost(z, x.size, cfg.block_len)
            if best is None or cost < best[0]:
                best = (cost, pred, ti if pred == LPC else 0, z)
        _cost, pred, ti, z = best
        bit_len, payload = vertical_encode_block(z, cfg.block_len)
        return pred, 0, ti, CODER_VERTICAL, bit_len, payload

    if cfg.coder == "adaptive":
        # FORMAT §4.1: exact word count over (candidate, coder) pairs in
        # c0-RICE, c0-VERTICAL, c1-RICE, ... order; first minimum wins.
        best = None  # (words, predictor, table_idx, coder, k, z)
        for ci, (pred, ti) in enumerate(cfg.candidates()):
            table = cfg.lpc_tables[ti] if pred == LPC else None
            z = zigzag(residuals(x, history, pred, table))
            ti_eff = ti if pred == LPC else 0
            k, bits = choose_k(z, cfg.k_max)
            rw = (bits + 31) // 32
            if best is None or rw < best[0]:
                best = (rw, pred, ti_eff, CODER_RICE, k, z)
            vw = vertical_block_words(z, x.size, cfg.block_len)
            if vw < best[0]:
                best = (vw, pred, ti_eff, CODER_VERTICAL, 0, z)
        _w, pred, ti, cd, k, z = best
        if cd == CODER_VERTICAL:
            bit_len, payload = vertical_encode_block(z, cfg.block_len)
            return pred, 0, ti, CODER_VERTICAL, bit_len, payload
        codes = [rice_codeword(int(zv), k) for zv in z]
        words, bit_len = pack_bits(codes)
        sync = sync_table([ln for _, ln in codes], cfg.block_len)
        return pred, k, ti, CODER_RICE, bit_len, np.concatenate([sync, words])

    best = None  # (bits, cand_idx, predictor, table_idx, k, z)
    for ci, (pred, ti) in enumerate(cfg.candidates()):
        table = cfg.lpc_tables[ti] if pred == LPC else None
        z = zigzag(residuals(x, history, pred, table))
        k, bits = choose_k(z, cfg.k_max)
        if best is None or bits < best[0]:
            best = (bits, ci, pred, ti if pred == LPC else 0, k, z)
    bits, _ci, pred, ti, k, z = best
    codes = [rice_codeword(int(zv), k) for zv in z]
    words, bit_len = pack_bits(codes)
    assert bit_len == bits
    sync = sync_table([ln for _, ln in codes], cfg.block_len)
    return pred, k, ti, CODER_RICE, bit_len, np.concatenate([sync, words])


def scalar_decode_block(
    payload_words: np.ndarray,
    n: int,
    predictor: int,
    k: int,
    history: np.ndarray,
    table: LpcTable | None,
    block_len: int,
) -> np.ndarray:
    """Decode one block's payload back to n int32 samples.

    Sequential reference decode; cross-checks the sync table (FORMAT §2.1)
    against actual code lengths as it goes.
    """
    sw = sync_words(block_len)
    sync = np.ascontiguousarray(payload_words[:sw], dtype="<u4").view("<u2")
    words = payload_words[sw:]
    acc = int.from_bytes(np.ascontiguousarray(words, dtype="<u4").tobytes(), "little")
    z = np.empty(n, dtype=np.uint32)
    p = 0
    sub_start = 0
    for t in range(n):
        if t % SUB_BLOCK == 0 and t > 0:
            s = t // SUB_BLOCK
            assert p - sub_start == int(sync[s - 1]), "sync table mismatch"
            sub_start = p
        ones = 0
        while ones < ESCAPE_Q and (acc >> (p + ones)) & 1:
            ones += 1
        if ones >= ESCAPE_Q:
            zv = (acc >> (p + ESCAPE_Q)) & _M32
            p += MAX_CODE_BITS
        else:
            q = ones
            v = (acc >> (p + q + 1)) & ((1 << k) - 1)
            zv = (q << k) | v
            p += q + 1 + k
        z[t] = zv
    r = unzigzag(z)
    return reconstruct(r, history, predictor, table)


# ---------------------------------------------------------------- vertical coder


def vertical_sub_cost_words(z: np.ndarray, cap: int) -> Tuple[int, int]:
    """Exact (b*, words) for one sub-block; ties -> smallest b (FORMAT §2.2).

    Only widths with n_exc <= EXC_CAP are legal. Exception values are
    bit-planed (FORMAT §2.2): ceil(e/2) words with e = blmax - b.
    """
    pw = (cap + 31) // 32
    blmax = int(z.max()).bit_length() if z.size else 0
    best = None
    for b in range(33):
        n_exc = int(np.count_nonzero(z >> b)) if b < 32 else 0
        if n_exc > EXC_CAP:
            continue
        vw = min(n_exc, (blmax - b + 1) // 2) if n_exc else 0
        words = pw * b + (n_exc + 3) // 4 + vw
        if best is None or words < best[1]:
            best = (b, words)
    return best


def vertical_encode_sub(z: np.ndarray, cap: int) -> Tuple[int, int, int, List[int]]:
    """One sub-block -> (b, n_exc, e, payload words)."""
    b, _words = vertical_sub_cost_words(z, cap)
    pw = (cap + 31) // 32
    words: List[int] = []
    for p in range(b):
        for w in range(pw):
            word = 0
            for i in range(32 * w, min(32 * w + 32, z.size)):
                word |= ((int(z[i]) >> p) & 1) << (i - 32 * w)
            words.append(word)
    exc_pos = [i for i in range(z.size) if (int(z[i]) >> b) != 0] if b < 32 else []
    n_exc = len(exc_pos)
    for w in range((n_exc + 3) // 4):
        word = 0
        for j in range(4 * w, min(4 * w + 4, n_exc)):
            word |= exc_pos[j] << (8 * (j - 4 * w))
        words.append(word)
    # exception values: the cheaper of raw (n_exc words) and bit-planed
    # (ceil(e/2) words); e = blmax - b == bitlen of the largest value
    # (FORMAT §2.2 — layout chosen deterministically, no flag bit)
    e = 0
    if n_exc:
        e = max((int(z[i]) >> b).bit_length() for i in exc_pos)
        if n_exc <= (e + 1) // 2:  # raw layout
            for i in exc_pos:
                words.append((int(z[i]) >> b) & _M32)
        else:  # bit-planed layout
            planes = [0] * (2 * ((e + 1) // 2))
            for p in range(e):
                for j, i in enumerate(exc_pos):
                    planes[p] |= (((int(z[i]) >> b) >> p) & 1) << j
            for w in range((e + 1) // 2):
                words.append(planes[2 * w] | (planes[2 * w + 1] << 16))
    return b, n_exc, e, words


def vertical_decode_sub(
    words: np.ndarray, b: int, n_exc: int, e: int, cap: int, count: int
) -> np.ndarray:
    """Inverse of vertical_encode_sub -> `count` z values."""
    pw = (cap + 31) // 32
    z = np.zeros(count, dtype=np.uint32)
    for p in range(b):
        for w in range(pw):
            word = int(words[p * pw + w])
            for i in range(32 * w, min(32 * w + 32, count)):
                z[i] |= np.uint32(((word >> (i - 32 * w)) & 1) << p)
    base = b * pw
    pos_words = (n_exc + 3) // 4
    if n_exc <= (e + 1) // 2:  # raw layout
        vals = [int(words[base + pos_words + j]) for j in range(n_exc)]
    else:  # bit-planed layout
        vals = [0] * n_exc
        for p in range(e):
            plane = (int(words[base + pos_words + p // 2]) >> (16 * (p % 2))) & 0xFFFF
            for j in range(n_exc):
                vals[j] |= ((plane >> j) & 1) << p
    for j in range(n_exc):
        pos = (int(words[base + j // 4]) >> (8 * (j % 4))) & 0xFF
        z[pos] |= np.uint32((vals[j] << b) & _M32)
    return z


def vertical_encode_block(
    z: np.ndarray, block_len: int
) -> Tuple[int, np.ndarray]:
    """All subs of one block -> (bit_len, payload words incl. sync table)."""
    caps = sub_caps(block_len)
    sync = np.zeros(2 * sync_words(block_len), dtype=np.uint16)
    body: List[int] = []
    for s, cap in enumerate(caps):
        zz = z[s * SUB_BLOCK : s * SUB_BLOCK + cap]
        if zz.size == 0:
            continue
        b, n_exc, e, words = vertical_encode_sub(zz, cap)
        sync[s] = b | (n_exc << 6) | (((e - 1) << 11) if n_exc else 0)
        body.extend(words)
    payload = np.concatenate(
        [sync.view("<u4"), np.array(body, dtype=np.uint32)]
    )
    return 32 * len(body), payload


def bitlength(z: np.ndarray) -> np.ndarray:
    """Bit length of each uint32 (0 for 0). Exact via float64 log2."""
    z64 = z.astype(np.float64)
    return np.ceil(np.log2(z64 + 1.0)).astype(np.int64)


def vertical_block_cost(z: np.ndarray, n: int, block_len: int) -> int:
    """Predictor-selection proxy cost under VERTICAL (FORMAT §2.2):
    sum of bitlengths of the valid zigzag values."""
    return int(bitlength(z[:n]).sum())


def vertical_block_words(z: np.ndarray, n: int, block_len: int) -> int:
    """Exact VERTICAL coded word count for one block (FORMAT §4.1 VW)."""
    total = 0
    for s, cap in enumerate(sub_caps(block_len)):
        count = min(cap, max(0, n - s * SUB_BLOCK))
        if count == 0:
            break
        zz = np.zeros(cap, dtype=np.uint32)
        zz[:count] = z[s * SUB_BLOCK : s * SUB_BLOCK + count]
        _b, words = vertical_sub_cost_words(zz, cap)
        total += words
    return total


def vertical_decode_block(
    payload_words: np.ndarray, n: int, block_len: int
) -> np.ndarray:
    sw = sync_words(block_len)
    sync = np.ascontiguousarray(payload_words[:sw], dtype="<u4").view("<u2")
    words = payload_words[sw:]
    caps = sub_caps(block_len)
    z = np.zeros(n, dtype=np.uint32)
    off = 0
    for s, cap in enumerate(caps):
        count = min(cap, max(0, n - s * SUB_BLOCK))
        if count == 0:
            break
        b, n_exc = int(sync[s]) & 0x3F, (int(sync[s]) >> 6) & 0x1F
        e = (((int(sync[s]) >> 11) & 0x1F) + 1) if n_exc else 0
        pw = (cap + 31) // 32
        nwords = pw * b + (n_exc + 3) // 4 + min(n_exc, (e + 1) // 2)
        z[s * SUB_BLOCK : s * SUB_BLOCK + count] = vertical_decode_sub(
            words[off : off + nwords], b, n_exc, e, cap, count
        )
        off += nwords
    return z


# ---------------------------------------------------------------- full frames


def _history_for(x: np.ndarray, start: int) -> np.ndarray:
    h = np.zeros(HISTORY_LEN, dtype=np.int32)
    for j in range(HISTORY_LEN):
        idx = start - 1 - j
        if idx >= 0:
            h[j] = x[idx]
    return h


def scalar_compress(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
) -> Frame:
    cfg = cfg or CodecConfig()
    L = cfg.block_len
    lens = [int(np.asarray(s).size) for s in streams]
    nblocks, first = plan_blocks(lens, L)
    B = int(nblocks.sum())

    predictor = np.zeros(B, dtype=np.uint8)
    kk = np.zeros(B, dtype=np.uint8)
    nn = np.zeros(B, dtype=np.uint16)
    bit_len = np.zeros(B, dtype=np.uint32)
    table_idx = np.zeros(B, dtype=np.uint8)
    coder = np.zeros(B, dtype=np.uint8)
    history = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    payloads: List[np.ndarray] = []

    metas = []
    b = 0
    for si, s in enumerate(streams):
        x = np.asarray(s, dtype=np.int32)
        metas.append(
            StreamMeta(
                stream_id=int(stream_ids[si]) if stream_ids is not None else si,
                cadence_s=int(cadences[si]) if cadences is not None else 900,
                num_samples=x.size,
                num_blocks=int(nblocks[si]),
                first_block=int(first[si]),
            )
        )
        for start in range(0, x.size, L):
            xb = x[start : start + L]
            h = _history_for(x, start)
            pred, k, ti, cd, bl, words = scalar_encode_block(xb, h, cfg)
            predictor[b], kk[b], nn[b] = pred, k, xb.size
            bit_len[b], table_idx[b], history[b] = bl, ti, h
            coder[b] = cd
            payloads.append(words)
            b += 1

    payload_words = (
        np.concatenate(payloads) if payloads else np.zeros(0, dtype=np.uint32)
    )
    blocks = BlockHeaders(
        predictor=predictor, k=kk, n=nn, bit_len=bit_len,
        table_idx=table_idx, history=history, coder=coder,
    )
    return Frame(
        block_len=L,
        streams=metas,
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=payload_words,
    )


def scalar_decompress(frame: Frame) -> List[np.ndarray]:
    off = frame.blocks.word_offsets(frame.block_len)
    out: List[np.ndarray] = []
    for s in frame.streams:
        parts = []
        coders = frame.blocks.coder_arr()
        for bi in range(s.first_block, s.first_block + s.num_blocks):
            words = frame.payload_words[off[bi] : off[bi + 1]]
            pred = int(frame.blocks.predictor[bi])
            table = (
                frame.tables[int(frame.blocks.table_idx[bi])] if pred == LPC else None
            )
            n_bi = int(frame.blocks.n[bi])
            if int(coders[bi]) == CODER_VERTICAL:
                z = vertical_decode_block(words, n_bi, frame.block_len)
                parts.append(
                    reconstruct(unzigzag(z), frame.blocks.history[bi], pred, table)
                )
            else:
                parts.append(
                    scalar_decode_block(
                        words,
                        n_bi,
                        pred,
                        int(frame.blocks.k[bi]),
                        frame.blocks.history[bi],
                        table,
                        frame.block_len,
                    )
                )
        out.append(
            np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
        )
    return out
