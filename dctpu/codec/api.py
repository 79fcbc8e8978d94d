"""Host orchestration: numpy streams <-> jitted device codec <-> DCF1 frames.

This is the single-host entry point (SURVEY.md §3 E1/E2): block planning and
frame assembly happen on the host in vectorized numpy; all per-sample work runs
on device in fixed-size chunks of blocks (static shapes -> one compile per
chunk geometry). The distributed variants wrap the same device functions
(dctpu.dist).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dctpu.codec.decode import decode_blocks
from dctpu.codec.encode import encode_blocks
from dctpu.config import CodecConfig
from dctpu.constants import HISTORY_LEN, LPC
from dctpu.format.frame import (
    BlockHeaders,
    Frame,
    StreamMeta,
    payload_word_counts,
    plan_blocks,
)
from dctpu.kernels.pack_xla import padded_words

DEFAULT_CHUNK_BLOCKS = 2048


# ------------------------------------------------------------ block building


_FLAT_PATH_MIN_STREAMS = 256  # below this the per-stream memcpy loop wins


def build_blocks(
    streams: Sequence[np.ndarray], block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack streams into [B, L] padded blocks + lengths + histories.

    Two host paths (round-3 VERDICT missing #3: config 5 feeds 10M streams
    per pod, so the host feed must not be a per-stream Python loop):
      few streams  — per-stream memcpy + reshape (fastest when each stream
                     spans many blocks);
      many streams — one concatenate, then build_blocks_flat's fully
                     vectorized block/history gather (measured >=10x the
                     loop at 1M small streams; bench/host_feed.py).
    """
    L = block_len
    if len(streams) >= _FLAT_PATH_MIN_STREAMS:
        lens = np.fromiter(
            (np.asarray(s).size for s in streams), np.int64, len(streams)
        )
        flat = (
            np.concatenate([np.asarray(s, np.int32).ravel() for s in streams])
            if len(streams)
            else np.zeros(0, np.int32)
        )
        return build_blocks_flat(flat, lens, L)
    lens = [int(np.asarray(s).size) for s in streams]
    nb, first = plan_blocks(lens, L)
    B = int(nb.sum())
    x = np.zeros((B, L), dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    hist = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    for si, s in enumerate(streams):
        s = np.asarray(s, dtype=np.int32)
        ns, k, f = s.size, int(nb[si]), int(first[si])
        if k == 0:
            continue
        buf = np.zeros(k * L, dtype=np.int32)
        buf[:ns] = s
        x[f : f + k] = buf.reshape(k, L)
        n[f : f + k] = L
        n[f + k - 1] = ns - (k - 1) * L
        starts = np.arange(k, dtype=np.int64) * L
        for j in range(HISTORY_LEN):
            idx = starts - 1 - j
            hist[f : f + k, j] = np.where(idx >= 0, s[np.maximum(idx, 0)], 0)
    return x, n, hist, nb, first


def build_blocks_flat(
    flat: np.ndarray, lens: np.ndarray, block_len: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized build_blocks over concatenated samples (config-5 path).

    flat: all streams' samples concatenated (int32), lens: per-stream sample
    counts. No per-stream Python work: block->stream mapping via repeat,
    sample moves via one chunked fancy gather, histories via HISTORY_LEN
    whole-column gathers. Byte-identical to the loop path (tests).
    """
    L = block_len
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    lens = np.asarray(lens, dtype=np.int64)
    nb, first = plan_blocks(lens, L)
    B = int(nb.sum())
    x = np.zeros((B, L), dtype=np.int32)
    n = np.zeros(B, dtype=np.int32)
    hist = np.zeros((B, HISTORY_LEN), dtype=np.int32)
    if B == 0:
        return x, n, hist, nb, first
    sstart = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=sstart[1:])
    assert flat.size == sstart[-1], "flat/lens mismatch"

    from dctpu import native

    if HISTORY_LEN == 4:
        fast = native.build_blocks(flat, sstart, first, L, B)
        if fast is not None:
            x, n, hist = fast
            return x, n, hist, nb, first

    sid = np.repeat(np.arange(lens.size, dtype=np.int64), nb)   # [B]
    local = np.arange(B, dtype=np.int64) - first[sid]           # [B]
    base = sstart[sid] + local * L                               # [B]
    end = sstart[sid] + lens[sid]                                # [B]
    n[:] = np.minimum(end - base, L)

    # Sample moves: a stream's blocks are consecutive and fully packed
    # except its tail, so sample p of stream s lands at flat destination
    # first[s]*L + p — ONE scatter pass (dst indices are unique), no
    # window gather, no where. Chunked over streams to bound the
    # per-sample index transients.
    xf = x.reshape(-1)
    S_n = lens.size
    chunk_samples = 16 << 20
    a = 0
    while a < S_n:
        b = a
        while b < S_n and (sstart[b + 1] - sstart[a]) <= chunk_samples:
            b += 1
        b = max(b, a + 1)  # always advance (a single huge stream)
        seg = slice(sstart[a], sstart[b])
        cnt = int(sstart[b] - sstart[a])
        sid_s = np.repeat(np.arange(a, b, dtype=np.int64), lens[a:b])
        within = np.arange(cnt, dtype=np.int64)
        within -= sstart[sid_s] - sstart[a]
        dst = first[sid_s] * L + within
        xf[dst] = flat[seg]
        a = b

    for j in range(HISTORY_LEN):
        hidx = base - 1 - j
        ok = hidx >= sstart[sid]
        hist[:, j] = np.where(ok, flat[np.maximum(hidx, 0)], 0)
    return x, n, hist, nb, first


def compact_payload(payload: np.ndarray, bit_len: np.ndarray, block_len: int) -> np.ndarray:
    """[B, W] padded payloads -> concatenated exact-size words (frame layout)."""
    wc = payload_word_counts(bit_len, block_len)
    total = int(wc.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint32)
    off = np.zeros(wc.size + 1, dtype=np.int64)
    np.cumsum(wc, out=off[1:])

    from dctpu import native

    fast = native.segment_gather(payload, off)
    if fast is not None:
        return fast

    block_id = np.repeat(np.arange(payload.shape[0], dtype=np.int64), wc)
    within = np.arange(total, dtype=np.int64) - off[block_id]
    return payload[block_id, within]


def pad_payload(
    compact: np.ndarray, word_off: np.ndarray, num_blocks: int, width: int
) -> np.ndarray:
    """Inverse of compact_payload: [total] -> [B, width] rows (zero padded)."""
    from dctpu import native

    fast = native.segment_scatter(compact, word_off, width)
    if fast is not None and fast.shape[0] == num_blocks:
        return fast

    out = np.zeros((num_blocks, width), dtype=np.uint32)
    wc = np.diff(word_off)
    total = int(word_off[-1])
    if total:
        block_id = np.repeat(np.arange(num_blocks, dtype=np.int64), wc)
        within = np.arange(total, dtype=np.int64) - word_off[block_id]
        out[block_id, within] = compact
    return out


def compact_enc_payload(
    payload: np.ndarray, bit_len: np.ndarray, cfg: CodecConfig
) -> np.ndarray:
    """Coder-dispatched payload compaction (device rows -> disk words)."""
    if cfg.coder == "vertical":
        from dctpu.codec.vertical_host import compact_vertical

        words, _wc = compact_vertical(payload, cfg.block_len)
        return words
    return compact_payload(payload, bit_len, cfg.block_len)


def stage_frame_payload(frame) -> Tuple[np.ndarray, str]:
    """Frame -> (padded device rows, coder name). Uniform-coder frames only;
    mixed frames go through decompress(), which groups blocks per coder."""
    from dctpu.constants import CODER_VERTICAL

    L = frame.block_len
    B = frame.blocks.num_blocks
    word_off = frame.blocks.word_offsets(L)
    coders = frame.blocks.coder_arr()
    vertical = bool(B) and bool(np.all(coders == CODER_VERTICAL))
    if not vertical and B and np.any(coders == CODER_VERTICAL):
        raise NotImplementedError("mixed-coder frames: decode per coder group")
    if vertical:
        from dctpu.codec.vertical_host import stage_vertical

        return stage_vertical(frame.payload_words, word_off, L), "vertical"
    Wp = padded_words(L) + 2
    return pad_payload(frame.payload_words, word_off, B, Wp), "rice"


def _subset_disk_words(frame, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gather a block subset's disk words into a compact (words, offsets)."""
    from dctpu.format.frame import payload_word_counts

    L = frame.block_len
    word_off = frame.blocks.word_offsets(L)
    wc = payload_word_counts(frame.blocks.bit_len[idx], L)
    sub_off = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(wc, out=sub_off[1:])
    sub_words = np.zeros(int(sub_off[-1]), dtype=np.uint32)
    for j, bi in enumerate(idx):  # few groups; per-block memcpy
        sub_words[sub_off[j] : sub_off[j + 1]] = frame.payload_words[
            word_off[bi] : word_off[bi + 1]
        ]
    return sub_words, sub_off


def _stage_block_subset(frame, idx: np.ndarray, coder_id: int) -> np.ndarray:
    """Stage a subset of blocks (mixed-coder frames) per the subset's coder."""
    from dctpu.constants import CODER_VERTICAL

    L = frame.block_len
    sub_words, sub_off = _subset_disk_words(frame, idx)
    if coder_id == CODER_VERTICAL:
        from dctpu.codec.vertical_host import stage_vertical

        return stage_vertical(sub_words, sub_off, L)
    return pad_payload(sub_words, sub_off, idx.size, padded_words(L) + 2)


def _pad_chunk(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = [(0, size - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    if isinstance(arr, np.ndarray):
        return np.pad(arr, pad)
    import jax.numpy as jnp

    return jnp.pad(arr, pad)


def semi_plan(
    shape: Tuple[int, int], bit_len: np.ndarray, block_len: int, coder: str
) -> Tuple[int, np.ndarray | None]:
    """(total_tiles, rice tile counts) for the device semi compaction.

    shape: the [B, W] device payload rows; bit_len: host array for the REAL
    blocks only. total_tiles is a static bucketed capacity (the gather
    never pays for dead capacity: the full uncompressed cap holds ~4x the
    live tiles at typical ratios). The rice tile counts are exact and
    host-known ([B] i64, zero on padding rows); vertical has none.
    """
    from dctpu.constants import subs_per_block, sync_words
    from dctpu.kernels import ragged

    B, W = shape
    L = block_len
    nb = int(np.asarray(bit_len).size)  # real blocks
    if coder == "vertical":
        S = subs_per_block(L)
        SWT = -(-sync_words(L) // ragged.VERT_TILE)
        RPT = ragged.REGION_PAD // ragged.VERT_TILE
        # host upper bound on live tiles from bit_len: per block SWT sync
        # tiles + ceil-per-sub body tiles <= ceil(body_words/TILE) + S - 1.
        body_words = int(np.asarray(bit_len, dtype=np.int64).sum()) // 32
        ub = B * SWT + nb * S + -(-body_words // ragged.VERT_TILE)
        return min(ragged.tile_bucket(ub), B * (SWT + S * RPT)), None
    tc_h = np.zeros(B, np.int64)
    tc_h[:nb] = -(-payload_word_counts(bit_len, L) // ragged.RICE_TILE)
    total_tiles = min(
        ragged.tile_bucket(int(tc_h.sum())),
        B * (-(-W // ragged.RICE_TILE)),
    )
    return total_tiles, tc_h


def compact_enc_payload_device(
    payload_dev, bit_len: np.ndarray, block_len: int, coder: str
) -> np.ndarray:
    """Device-side payload compaction: fetch ~compressed-size bytes only.

    payload_dev: the [B, W] device rows straight from encode (NOT fetched).
    bit_len: host array for the REAL blocks only (padding rows, which sort
    after all real blocks, are excluded by slicing the semi prefix).

    The device emits a tile-aligned semi-compact stream (kernels/ragged.py);
    the host fetches the exact semi prefix (<= a few % over compressed
    size) and squeezes the alignment gaps while assembling the frame.
    Replaces the round-1 padded-row fetch, several times the compressed
    size (VERDICT item 2).
    """
    import jax.numpy as jnp

    from dctpu.constants import sync_words
    from dctpu.kernels import ragged

    L = block_len
    nb = int(np.asarray(bit_len).size)  # real blocks
    if nb == 0:
        return np.zeros(0, np.uint32)
    total_tiles, tc_h = semi_plan(payload_dev.shape, bit_len, L, coder)
    if coder == "vertical":
        SW = sync_words(L)
        semi_d, wc_sub_d = ragged.compact_vertical_semi(
            payload_dev, L, total_tiles
        )
        wc_sub = np.asarray(wc_sub_d[:nb]).astype(np.int64)  # [nb, S]
        # segment lens per block: [SW, wc_sub...]; semi offsets are the
        # VERT_TILE-ceiled cumsum in the same order
        lens = np.concatenate(
            [np.full((nb, 1), SW, np.int64), wc_sub], axis=1
        ).reshape(-1)
        tc = -(-lens // ragged.VERT_TILE)
        src_off = np.zeros(lens.size + 1, np.int64)
        np.cumsum(tc * ragged.VERT_TILE, out=src_off[1:])
        semi = np.asarray(semi_d[: int(src_off[-1])])
        return ragged.squeeze_host(semi, src_off[:-1], lens)
    semi_d = ragged.compact_rice_semi(
        payload_dev, jnp.asarray(tc_h.astype(np.int32)), total_tiles
    )
    semi = np.asarray(semi_d[: int(tc_h.sum()) * ragged.RICE_TILE])
    src_off = np.zeros(nb, np.int64)
    np.cumsum(tc_h[: nb - 1] * ragged.RICE_TILE, out=src_off[1:])
    return ragged.squeeze_host(semi, src_off, payload_word_counts(bit_len, L))


# ------------------------------------------------------------ public API


def _stream_metas(streams, stream_ids, cadences, nb, first):
    """Vectorized StreamDir (list-compatible; no per-stream objects)."""
    from dctpu.format.frame import StreamDir

    S = len(streams)
    lens = np.fromiter(
        (np.asarray(s).size for s in streams), np.int64, S
    )
    return StreamDir(
        stream_id=(
            np.asarray(stream_ids, np.uint64)
            if stream_ids is not None
            else np.arange(S, dtype=np.uint64)
        ),
        cadence_s=(
            np.asarray(cadences, np.uint32)
            if cadences is not None
            else np.full(S, 900, np.uint32)
        ),
        num_samples=lens,
        num_blocks=nb,
        first_block=first,
    )


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _compress_adaptive(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig,
    stream_ids,
    cadences,
    chunk_blocks: int,
    backend: str | None,
    select_fn=None,
    emit_fn=None,
    round_to: int = 1,
) -> Frame:
    """Adaptive per-block coder (FORMAT §4.1): select on device, group by
    coder on the host, emit each group with static shapes, interleave the
    compact payloads back into block-table order.

    select_fn/emit_fn default to the single-device jits; dist.sharded passes
    shard_map-wrapped ones (round_to pads batches to the mesh size).
    """
    from dctpu.codec.encode import adaptive_select, emit_blocks
    from dctpu.constants import CODER_VERTICAL, LPC as _LPC

    select_fn = select_fn or (
        lambda x, n, h: adaptive_select(x, n, h, cfg, backend or "auto")
    )
    emit_fn = emit_fn or (
        lambda x, n, h, ch, k, coder: emit_blocks(
            x, n, h, ch, k, cfg, coder, backend or "auto"
        )
    )
    chunk_blocks = _round_up(chunk_blocks, round_to)

    L = cfg.block_len
    x, n, hist, nb, first = build_blocks(streams, L)
    B = x.shape[0]

    choice = np.zeros(B, np.int32)
    coder = np.zeros(B, np.int32)
    kk = np.zeros(B, np.int32)
    for c0 in range(0, B, chunk_blocks):
        c1 = min(c0 + chunk_blocks, B)
        size = chunk_blocks if B > chunk_blocks else _round_up(B, round_to)
        ch, cd, kv = select_fn(
            _pad_chunk(x[c0:c1], size),
            _pad_chunk(n[c0:c1], size),
            _pad_chunk(hist[c0:c1], size),
        )
        m = c1 - c0
        choice[c0:c1] = np.asarray(ch[:m])
        coder[c0:c1] = np.asarray(cd[:m])
        kk[c0:c1] = np.asarray(kv[:m])

    bit_len = np.zeros(B, np.uint32)
    wc = np.zeros(B, np.int64)  # compact payload words per block
    group_payloads = {}  # gid -> concatenated compact words, idx order
    for gid, gname in ((0, "rice"), (1, "vertical")):
        idx = np.nonzero(coder == gid)[0]
        if idx.size == 0:
            continue
        parts = []
        G = idx.size
        for c0 in range(0, G, chunk_blocks):
            sel = idx[c0 : min(c0 + chunk_blocks, G)]
            size = chunk_blocks if G > chunk_blocks else _round_up(G, round_to)
            enc = emit_fn(
                _pad_chunk(x[sel], size),
                _pad_chunk(n[sel], size),
                _pad_chunk(hist[sel], size),
                _pad_chunk(choice[sel], size),
                _pad_chunk(kk[sel], size),
                gname,
            )
            m = sel.size
            bl = np.asarray(enc.bit_len[:m])
            bit_len[sel] = bl
            words = compact_enc_payload_device(enc.payload, bl, L, gname)
            if gname == "vertical":
                from dctpu.constants import sync_words

                wc[sel] = sync_words(L) + bl.astype(np.int64) // 32
            else:
                wc[sel] = payload_word_counts(bl, L)
            parts.append(words)
        group_payloads[gid] = np.concatenate(parts)

    # Interleave group payloads into block-table order (vectorized scatter).
    off = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(wc, out=off[1:])
    out = np.zeros(int(off[-1]), dtype=np.uint32)
    for gid, words in group_payloads.items():
        idx = np.nonzero(coder == gid)[0]
        wcg = wc[idx]
        src_off = np.zeros(idx.size + 1, dtype=np.int64)
        np.cumsum(wcg, out=src_off[1:])
        blk = np.repeat(np.arange(idx.size, dtype=np.int64), wcg)
        pos = np.arange(int(src_off[-1]), dtype=np.int64) - src_off[blk]
        out[off[idx[blk]] + pos] = words

    cands = cfg.candidates()
    pred_map = np.array([p for p, _ in cands], dtype=np.uint8)
    ti_map = np.array(
        [ti if p == _LPC else 0 for p, ti in cands], dtype=np.uint8
    )
    blocks = BlockHeaders(
        predictor=pred_map[choice],
        k=kk.astype(np.uint8),
        n=n.astype(np.uint16),
        bit_len=bit_len,
        table_idx=ti_map[choice],
        history=hist,
        coder=coder.astype(np.uint8),
    )
    return Frame(
        block_len=L,
        streams=_stream_metas(streams, stream_ids, cadences, nb, first),
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=out,
    )


def compress(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
) -> Frame:
    cfg = cfg or CodecConfig()
    if cfg.coder == "adaptive":
        return _compress_adaptive(
            streams, cfg, stream_ids, cadences, chunk_blocks, backend
        )
    L = cfg.block_len
    x, n, hist, nb, first = build_blocks(streams, L)
    B = x.shape[0]

    preds, ks, tis, bls, payloads = [], [], [], [], []
    for c0 in range(0, B, chunk_blocks):
        c1 = min(c0 + chunk_blocks, B)
        size = chunk_blocks if B > chunk_blocks else B  # single small batch ok
        enc = encode_blocks(
            _pad_chunk(x[c0:c1], size),
            _pad_chunk(n[c0:c1], size),
            _pad_chunk(hist[c0:c1], size),
            cfg,
            backend or "auto",
        )
        m = c1 - c0
        preds.append(np.asarray(enc.predictor[:m]))
        ks.append(np.asarray(enc.k[:m]))
        tis.append(np.asarray(enc.table_idx[:m]))
        bls.append(np.asarray(enc.bit_len[:m]))
        payloads.append(
            compact_enc_payload_device(
                enc.payload, bls[-1], cfg.block_len, cfg.coder
            )
        )

    def cat(parts, dtype):
        return (
            np.concatenate(parts).astype(dtype)
            if parts
            else np.zeros(0, dtype=dtype)
        )

    from dctpu.constants import CODER_RICE, CODER_VERTICAL

    coder_id = CODER_VERTICAL if cfg.coder == "vertical" else CODER_RICE
    blocks = BlockHeaders(
        predictor=cat(preds, np.uint8),
        k=cat(ks, np.uint8),
        n=n.astype(np.uint16),
        bit_len=cat(bls, np.uint32),
        table_idx=cat(tis, np.uint8),
        history=hist,
        coder=np.full(B, coder_id, dtype=np.uint8),
    )
    metas = _stream_metas(streams, stream_ids, cadences, nb, first)
    payload_words = cat(payloads, np.uint32)
    return Frame(
        block_len=L,
        streams=metas,
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=payload_words,
    )


def decompress(
    frame: Frame,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
    decode_fn=None,
    round_to: int = 1,
) -> List[np.ndarray]:
    """Frame -> streams. Default path (backend=None): upload the compact
    disk words once and run ALL ragged staging on device (kernels/ragged.py)
    — only compressed bytes plus the decoded output cross the host link.
    Explicit backends ("scan"/"scan_xla"/"xla") keep the host staging paths.

    decode_fn/round_to let dist.sharded reuse this exact staging logic with
    the shard_map decoder and mesh-divisible chunk sizes (so the sharded
    path gets device staging too — VERDICT r2 missing #4).
    """
    xs = _decode_blocks_array(frame, chunk_blocks, backend, decode_fn, round_to)
    streams = []
    for s in frame.streams:
        flat = xs[s.first_block : s.first_block + s.num_blocks].reshape(-1)
        streams.append(flat[: s.num_samples].copy())
    return streams


def _decode_blocks_array(
    frame: Frame,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
    decode_fn=None,
    round_to: int = 1,
) -> np.ndarray:
    """Core of decompress: frame -> [B, L] decoded blocks (zeros past n)."""
    from dctpu.constants import CODER_VERTICAL

    decode_fn = decode_fn or decode_blocks
    chunk_blocks = _round_up(chunk_blocks, round_to)

    L = frame.block_len
    B = frame.blocks.num_blocks
    coders = frame.blocks.coder_arr()
    coeffs = np.array(
        [t.coeffs for t in frame.tables], dtype=np.int64
    ).reshape(len(frame.tables), 4) if frame.tables else np.zeros((1, 4), np.int64)

    xs = np.zeros((B, L), dtype=np.int32)
    # shift-buffer decode family: all of these consume stage_rice_scan rows
    # plus buf_words. Staging them with the dense padded payload was ADVICE
    # r2 medium #1.
    use_scan = backend in (None, "scan", "scan_xla")
    device_stage = backend is None
    flat_d = off_d = None
    off_host = frame.blocks.word_offsets(L)
    for coder_id in np.unique(coders) if B else []:
        idx = np.nonzero(coders == coder_id)[0]
        coder = "vertical" if coder_id == CODER_VERTICAL else "rice"
        buf_words = 0
        grp_backend = backend or "auto"
        if device_stage:
            import jax.numpy as jnp

            from dctpu.kernels import ragged
            from dctpu.kernels.unpack_scan import (
                _sync_sub_lens_host,
                buf_bucket,
            )

            assert off_host[-1] < 2**31, "frame too large for i32 staging"
            if flat_d is None:
                flat_d = jnp.asarray(frame.payload_words)
                off_d = jnp.asarray(off_host.astype(np.int32))
            if idx.size == B:
                words_d, goff_d = flat_d, off_d
            else:
                # semi-aligned subset: each selected block's words start on
                # a VERT_TILE boundary; staging only needs intra-block
                # contiguity, so the aligned offsets are handed over as-is
                wch = np.diff(off_host)[idx]
                tc = -(-wch // ragged.VERT_TILE)
                goff8 = np.zeros(idx.size + 1, np.int64)
                np.cumsum(tc * ragged.VERT_TILE, out=goff8[1:])
                words_d = ragged.subset_semi(
                    flat_d,
                    jnp.asarray(off_host[idx].astype(np.int32)),
                    jnp.asarray(wch.astype(np.int32)),
                    int(tc.sum()),
                )
                goff_d = jnp.asarray(goff8.astype(np.int32))
            # buckets come from a cheap host parse of the sync tables
            # (payload bytes are already in host memory)
            if coder == "rice":
                lens = _sync_sub_lens_host(frame.payload_words, off_host, L)
                buf_words = buf_bucket(int(lens[idx].max()) if idx.size else 0)
                padded = ragged.stage_rice_scan_device(
                    words_d, goff_d, L, buf_words
                )
                grp_backend = "auto"
            else:
                # bucketed gather width from the host sync parse (the same
                # parse also feeds max_planes below)
                from dctpu.codec.vertical_host import _parse_sync_rows
                from dctpu.constants import subs_per_block, sync_words

                SW = sync_words(L)
                sync_rows = frame.payload_words[
                    off_host[idx, None]
                    + np.arange(SW, dtype=np.int64)[None, :]
                ]
                bw, _, _ = _parse_sync_rows(sync_rows, subs_per_block(L))
                max_b_stage = int(bw.max()) if bw.size else 0
                padded = ragged.stage_vertical_device(
                    words_d, goff_d, L, ragged.span_bucket(max_b_stage)
                )
                grp_backend = "auto"
        elif coder == "rice" and use_scan:
            from dctpu.kernels.unpack_scan import (
                buf_bucket,
                max_sub_bits_host,
                stage_rice_scan,
            )

            if idx.size == B:
                words = frame.payload_words
                off = frame.blocks.word_offsets(L)
            else:
                words, off = _subset_disk_words(frame, idx)
            buf_words = buf_bucket(max_sub_bits_host(words, off, L))
            padded = stage_rice_scan(words, off, L, buf_words)
            grp_backend = backend or "auto"
        elif idx.size == B:
            padded, coder = stage_frame_payload(frame)
        else:  # mixed-coder frame: stage this coder's subset
            padded = _stage_block_subset(frame, idx, int(coder_id))
        max_planes = 32
        if coder == "vertical":
            from dctpu.kernels.vertical_xla import plane_bucket

            if device_stage:
                from dctpu.codec.vertical_host import _parse_sync_rows
                from dctpu.constants import subs_per_block, sync_words

                SW = sync_words(L)
                sync_rows = frame.payload_words[
                    off_host[idx, None] + np.arange(SW, dtype=np.int64)[None, :]
                ]
                bwidths, _, _ = _parse_sync_rows(sync_rows, subs_per_block(L))
                max_b = int(bwidths.max()) if bwidths.size else 0
            else:
                from dctpu.codec.vertical_host import max_plane_width

                max_b = max_plane_width(padded, L)
            max_planes = plane_bucket(max_b)
        G = idx.size
        for c0 in range(0, G, chunk_blocks):
            c1 = min(c0 + chunk_blocks, G)
            sel = idx[c0:c1]
            size = (
                chunk_blocks if G > chunk_blocks
                else _round_up(max(G, 1), round_to)
            )
            has_lpc = bool(np.any(frame.blocks.predictor[sel] == LPC))
            out = decode_fn(
                _pad_chunk(padded[c0:c1], size),
                _pad_chunk(frame.blocks.k[sel].astype(np.int32), size),
                _pad_chunk(frame.blocks.n[sel].astype(np.int32), size),
                _pad_chunk(frame.blocks.predictor[sel].astype(np.int32), size),
                _pad_chunk(frame.blocks.table_idx[sel].astype(np.int32), size),
                _pad_chunk(frame.blocks.history[sel], size),
                coeffs,
                L,
                has_lpc,
                grp_backend,
                coder,
                max_planes,
                buf_words,
            )
            xs[sel] = np.asarray(out[: c1 - c0])
    return xs


def decompress_flat(
    frame: Frame,
    chunk_blocks: int = DEFAULT_CHUNK_BLOCKS,
    backend: str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """decompress, returning (flat_samples, per_stream_lens) — config-5 path.

    Splitting a million-stream result into a Python list costs a slice +
    copy per stream; the flat form is one vectorized masked flatten (blocks
    are stream-ordered and every non-tail block is full, so the valid-prefix
    concat IS the streams' concat). bench/host_feed.py measures both.
    """
    from dctpu.codec.decode import decode_blocks  # noqa: F401 (same path)

    L = frame.block_len
    # reuse the grouped device decode by calling decompress's core via a
    # temporary list-free path: decode into [B, L] then flatten valid lanes
    xs = _decode_blocks_array(frame, chunk_blocks, backend)
    n = frame.blocks.n.astype(np.int64)
    mask = np.arange(L, dtype=np.int64)[None, :] < n[:, None]
    flat = xs.reshape(-1)[mask.reshape(-1)]
    if isinstance(frame.streams, list):
        lens = np.array([s.num_samples for s in frame.streams], np.int64)
    else:
        lens = frame.streams.num_samples.astype(np.int64)
    return flat, lens
