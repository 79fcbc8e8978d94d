"""shard_map data-parallel encode/decode over the `streams` mesh axis.

Design (SURVEY.md §2.2, §3 E3): blocks are embarrassingly parallel, so each
device runs the identical jitted codec body on its shard of the [B, L] block
batch. Small shared state (LPC coefficient tables) is passed replicated —
XLA broadcasts it to every device once. Results come back as global arrays in
block-table order, which IS the ordered gather: the frame assembler reads
global arrays index-ordered, so no reordering collective is needed; only the
host-side compaction walks the (sharded) payload in order.

Every function here also runs unmodified on a multi-host global mesh: inputs
are passed as per-host shards via make_array_from_process_local_data and
outputs are fetched with process_allgather (dctpu.dist.multihost).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from dctpu.codec.decode import decode_blocks_body
from dctpu.codec.encode import EncodedBlocks, encode_blocks_body
from dctpu.config import CodecConfig
from dctpu.dist.mesh import STREAMS_AXIS


@functools.partial(
    jax.jit, static_argnames=("cfg", "mesh", "backend")
)
def encode_blocks_sharded(
    x: jnp.ndarray,        # [B, L] int32, B divisible by mesh size
    n: jnp.ndarray,        # [B]
    history: jnp.ndarray,  # [B, 4]
    cfg: CodecConfig,
    mesh: Mesh,
    backend: str = "auto",
) -> EncodedBlocks:
    body = functools.partial(encode_blocks_body, cfg=cfg, backend=backend)
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(STREAMS_AXIS, None), P(STREAMS_AXIS), P(STREAMS_AXIS, None)),
        out_specs=EncodedBlocks(
            P(STREAMS_AXIS), P(STREAMS_AXIS), P(STREAMS_AXIS),
            P(STREAMS_AXIS), P(STREAMS_AXIS, None),
        ),
        check_vma=False,
    )
    return sharded(x, n, history)


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_len", "has_lpc", "mesh", "backend", "coder", "max_planes",
        "buf_words",
    ),
)
def decode_blocks_sharded(
    payload: jnp.ndarray,       # [B, Wp] u32
    k: jnp.ndarray,
    n: jnp.ndarray,
    predictor: jnp.ndarray,
    table_idx: jnp.ndarray,
    history: jnp.ndarray,
    table_coeffs: jnp.ndarray,  # [T, 4] i64 — replicated
    block_len: int,
    has_lpc: bool,
    mesh: Mesh,
    backend: str = "auto",
    coder: str = "rice",
    max_planes: int = 32,
    buf_words: int = 0,
) -> jnp.ndarray:
    body = functools.partial(
        decode_blocks_body,
        block_len=block_len,
        has_lpc=has_lpc,
        backend=backend,
        coder=coder,
        max_planes=max_planes,
        buf_words=buf_words,
    )
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(STREAMS_AXIS, None), P(STREAMS_AXIS), P(STREAMS_AXIS),
            P(STREAMS_AXIS), P(STREAMS_AXIS), P(STREAMS_AXIS, None),
            P(),  # tables replicated
        ),
        out_specs=P(STREAMS_AXIS, None),
        check_vma=False,
    )
    return sharded(payload, k, n, predictor, table_idx, history, table_coeffs)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "backend"))
def adaptive_select_sharded(
    x: jnp.ndarray, n: jnp.ndarray, history: jnp.ndarray,
    cfg: CodecConfig, mesh: Mesh, backend: str = "auto",
):
    """shard_map wrapper of the FORMAT §4.1 (candidate, coder) selection.

    backend plumbs through to adaptive_select_body, which checks it.
    """
    from dctpu.codec.encode import adaptive_select_body

    body = functools.partial(adaptive_select_body, cfg=cfg, backend=backend)
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(STREAMS_AXIS, None), P(STREAMS_AXIS), P(STREAMS_AXIS, None)),
        out_specs=(P(STREAMS_AXIS), P(STREAMS_AXIS), P(STREAMS_AXIS)),
        check_vma=False,
    )
    return sharded(x, n, history)


@functools.partial(
    jax.jit, static_argnames=("cfg", "coder", "mesh", "backend")
)
def emit_blocks_sharded(
    x: jnp.ndarray, n: jnp.ndarray, history: jnp.ndarray,
    choice: jnp.ndarray, k: jnp.ndarray,
    cfg: CodecConfig, coder: str, mesh: Mesh, backend: str = "auto",
) -> EncodedBlocks:
    """shard_map wrapper of the forced-selection group emission (§4.1)."""
    from dctpu.codec.encode import emit_blocks_body

    body = functools.partial(
        emit_blocks_body, cfg=cfg, coder=coder, backend=backend
    )
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(STREAMS_AXIS, None), P(STREAMS_AXIS), P(STREAMS_AXIS, None),
            P(STREAMS_AXIS), P(STREAMS_AXIS),
        ),
        out_specs=EncodedBlocks(
            P(STREAMS_AXIS), P(STREAMS_AXIS), P(STREAMS_AXIS),
            P(STREAMS_AXIS), P(STREAMS_AXIS, None),
        ),
        check_vma=False,
    )
    return sharded(x, n, history, choice, k)


# ------------------------------------------------------------ host wrappers


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def compress_sharded(
    streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    mesh: Mesh | None = None,
    stream_ids: Sequence[int] | None = None,
    cadences: Sequence[int] | None = None,
    chunk_blocks: int = 2048,
    backend: str | None = None,
):
    """Single-process sharded compress: same Frame as dctpu.codec.compress."""
    from dctpu.codec import api as capi
    from dctpu.dist.mesh import make_mesh
    from dctpu.format.frame import BlockHeaders, Frame, StreamMeta

    cfg = cfg or CodecConfig()
    mesh = mesh or make_mesh()
    ndev = mesh.devices.size
    if cfg.coder == "adaptive":
        return capi._compress_adaptive(
            streams, cfg, stream_ids, cadences, chunk_blocks, backend,
            select_fn=lambda x, n, h: adaptive_select_sharded(
                jnp.asarray(x), jnp.asarray(n), jnp.asarray(h), cfg, mesh,
                backend or "auto",
            ),
            emit_fn=lambda x, n, h, ch, k, coder: emit_blocks_sharded(
                jnp.asarray(x), jnp.asarray(n), jnp.asarray(h),
                jnp.asarray(ch), jnp.asarray(k),
                cfg, coder, mesh, backend or "auto",
            ),
            round_to=ndev,
        )
    L = cfg.block_len
    x, n, hist, nb, first = capi.build_blocks(streams, L)
    B = x.shape[0]
    chunk = _round_up(chunk_blocks, ndev)

    preds, ks, tis, bls, payloads = [], [], [], [], []
    for c0 in range(0, B, chunk):
        c1 = min(c0 + chunk, B)
        size = chunk if B > chunk else _round_up(max(B, 1), ndev)
        enc = encode_blocks_sharded(
            capi._pad_chunk(x[c0:c1], size),
            capi._pad_chunk(n[c0:c1], size),
            capi._pad_chunk(hist[c0:c1], size),
            cfg,
            mesh,
            backend or "auto",
        )
        m = c1 - c0
        preds.append(np.asarray(enc.predictor[:m]))
        ks.append(np.asarray(enc.k[:m]))
        tis.append(np.asarray(enc.table_idx[:m]))
        bls.append(np.asarray(enc.bit_len[:m]))
        payloads.append(
            capi.compact_enc_payload(np.asarray(enc.payload[:m]), bls[-1], cfg)
        )

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype=dtype)

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
    metas = [
        StreamMeta(
            stream_id=int(stream_ids[si]) if stream_ids is not None else si,
            cadence_s=int(cadences[si]) if cadences is not None else 900,
            num_samples=int(np.asarray(streams[si]).size),
            num_blocks=int(nb[si]),
            first_block=int(first[si]),
        )
        for si in range(len(streams))
    ]
    return Frame(
        block_len=L,
        streams=metas,
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=cat(payloads, np.uint32),
    )


def decompress_sharded(
    frame,
    mesh: Mesh | None = None,
    chunk_blocks: int = 2048,
    backend: str | None = None,
) -> List[np.ndarray]:
    """Sharded decompress: codec.api.decompress staging (incl. the default
    device-resident ragged staging — only compressed bytes cross the host
    link) with the shard_map decoder; byte-identical to the serial path."""
    from dctpu.codec import api as capi
    from dctpu.dist.mesh import make_mesh

    mesh = mesh or make_mesh()

    def decode_fn(
        payload, k, n, predictor, table_idx, history, coeffs,
        block_len, has_lpc, grp_backend, coder, max_planes, buf_words,
    ):
        return decode_blocks_sharded(
            payload, k, n, predictor, table_idx, history, coeffs,
            block_len, has_lpc, mesh, grp_backend, coder, max_planes,
            buf_words,
        )

    return capi.decompress(
        frame,
        chunk_blocks=chunk_blocks,
        backend=backend,
        decode_fn=decode_fn,
        round_to=mesh.devices.size,
    )
