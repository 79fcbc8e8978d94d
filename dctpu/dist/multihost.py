"""Multi-host data-parallel encode: global mesh over all processes' chips.

SURVEY.md §3 E3 / §2.2 "Multi-host DP": each host feeds its local shard of the
block batch into a global-mesh jit; XLA handles the collectives implied by
the shardings. The compressed-size gather is the one genuinely multi-host step:

  1. all processes allgather per-block bit lengths (small, over the network),
  2. every process computes the global frame layout with the same exclusive
     scan (deterministic -> no coordination needed),
  3. payload words are gathered with a padded allgather over per-process
     compacted shards, then sliced into place on the assembling host.

The frame produced on host 0 is byte-identical to a single-process run — the
ordered gather preserves block-table order by construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

from dctpu.config import CodecConfig
from dctpu.dist.mesh import STREAMS_AXIS, make_mesh
from dctpu.dist.sharded import _round_up, encode_blocks_sharded


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """jax.distributed.initialize wrapper (no-op if already initialized).

    local_device_ids: the local GPUs this process opens. Without it every
    process of a multi-process run on one host opens every visible GPU and
    reserves most of each card's memory, so one process per card needs
    e.g. local_device_ids=[process_id].
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e):
            raise


def compress_multihost(
    local_streams: Sequence[np.ndarray],
    cfg: CodecConfig | None = None,
    local_stream_ids: Sequence[int] | None = None,
    local_cadences: Sequence[int] | None = None,
    backend: str = "xla",
    gather: str = "auto",
    parts_dir: str | None = None,
):
    """Each process passes ITS OWN streams; returns (frame_or_None, stats).

    Host 0 returns the assembled Frame (global stream order = process order,
    then per-process stream order); other hosts return None.

    Payload gather modes (round-1 VERDICT item 6 — the padded allgather
    ships every host's payload to every host, O(P^2) bytes on the network):

      "allgather"  padded process_allgather (in-memory; fine for few hosts)
      "files"      each host writes its ordered compact shard to parts_dir
                   (shared filesystem) with an atomic rename; host 0 reads
                   them after a barrier. Bytes moved: O(total compressed)
                   to storage, only small metadata on the network.
      "auto"       "files" when parts_dir is given, else "allgather".
    """
    from dctpu.codec import api as capi
    from dctpu.format.frame import BlockHeaders, Frame, StreamMeta

    cfg = cfg or CodecConfig()
    if cfg.coder == "adaptive":
        raise NotImplementedError(
            "compress_multihost encodes one coder per frame (rice or "
            "vertical); the adaptive coder is single-process only"
        )
    mesh = make_mesh()
    nproc = jax.process_count()
    pid = jax.process_index()
    ndev = mesh.devices.size

    L = cfg.block_len
    x, n, hist, nb, first = capi.build_blocks(local_streams, L)
    B_local = x.shape[0]

    # Global geometry: every process must call with the same padded local size,
    # divisible by its local device count so the global batch divides the mesh.
    B_local_max = int(
        multihost_utils.process_allgather(np.array([B_local]))[:, 0].max()
    )
    per_proc = _round_up(max(B_local_max, 1), ndev // nproc)

    xg = capi._pad_chunk(x, per_proc)
    ng = capi._pad_chunk(n, per_proc)
    hg = capi._pad_chunk(hist, per_proc)

    sharding = NamedSharding(mesh, P(STREAMS_AXIS))
    sharding2 = NamedSharding(mesh, P(STREAMS_AXIS, None))
    gx = jax.make_array_from_process_local_data(sharding2, xg)
    gn = jax.make_array_from_process_local_data(sharding, ng)
    gh = jax.make_array_from_process_local_data(sharding2, hg)

    enc = encode_blocks_sharded(gx, gn, gh, cfg, mesh, backend)

    def _local_rows(garr) -> np.ndarray:
        """This process's rows of a global array, in global index order."""
        shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    # Small metadata: allgather global copies (network).
    def _gather_rows(garr) -> np.ndarray:
        local = _local_rows(garr)
        return np.asarray(multihost_utils.process_allgather(local)).reshape(
            (-1,) + local.shape[1:]
        )

    pred_g = _gather_rows(enc.predictor)
    k_g = _gather_rows(enc.k)
    ti_g = _gather_rows(enc.table_idx)
    bl_g = _gather_rows(enc.bit_len)

    # Payload: compact local shard, then gather in the selected mode.
    if gather == "auto":
        gather = "files" if parts_dir is not None else "allgather"
    local_rows = _local_rows(enc.payload)
    local_bl = bl_g[pid * per_proc : (pid + 1) * per_proc]
    local_compact = capi.compact_enc_payload(local_rows, local_bl, cfg)
    sizes = multihost_utils.process_allgather(
        np.array([local_compact.size], dtype=np.int64)
    ).reshape(-1)
    if gather == "files":
        # O(total) bytes: every host writes ONLY its own ordered shard;
        # atomic rename + a global barrier make the reads race-free.
        import os
        from pathlib import Path

        pdir = Path(parts_dir)
        pdir.mkdir(parents=True, exist_ok=True)
        part = pdir / f"payload-{pid:05d}.u32"
        tmp = part.with_suffix(".tmp")
        tmp.write_bytes(np.ascontiguousarray(local_compact, "<u4").tobytes())
        os.replace(tmp, part)
        multihost_utils.sync_global_devices("dctpu_payload_parts")

        def _proc_payload(p: int) -> np.ndarray:
            data = (pdir / f"payload-{p:05d}.u32").read_bytes()
            return np.frombuffer(data, dtype="<u4")
    elif gather == "allgather":
        max_words = int(sizes.max()) if sizes.size else 0
        padded = np.zeros(max_words, dtype=np.uint32)
        padded[: local_compact.size] = local_compact
        gathered = np.asarray(
            multihost_utils.process_allgather(padded)
        )  # [nproc, max] — O(P^2) bytes; use gather="files" at scale

        def _proc_payload(p: int) -> np.ndarray:
            return gathered[p]
    else:
        raise ValueError(f"unknown gather mode {gather!r}")

    # Per-process stream metadata to host 0.
    local_meta = np.array(
        [
            [
                int(local_stream_ids[si]) if local_stream_ids is not None else si,
                int(local_cadences[si]) if local_cadences is not None else 900,
                int(np.asarray(local_streams[si]).size),
                int(nb[si]),
                int(first[si]),
            ]
            for si in range(len(local_streams))
        ],
        dtype=np.int64,
    ).reshape(len(local_streams), 5)
    nstreams = multihost_utils.process_allgather(
        np.array([local_meta.shape[0]], dtype=np.int64)
    ).reshape(-1)
    max_streams = int(nstreams.max()) if nstreams.size else 0
    meta_pad = np.zeros((max_streams, 5), dtype=np.int64)
    meta_pad[: local_meta.shape[0]] = local_meta
    metas_g = np.asarray(multihost_utils.process_allgather(meta_pad))  # [nproc, max, 5]

    # n and history per block, gathered the same way. NOTE: every collective
    # must run on ALL processes — nothing below this point may be skipped by
    # non-assembling hosts, or host 0 deadlocks waiting on the allgather.
    n_g = np.asarray(multihost_utils.process_allgather(capi._pad_chunk(n, per_proc)))
    h_g = np.asarray(multihost_utils.process_allgather(capi._pad_chunk(hist, per_proc)))

    stats = {
        "global_blocks": int(nproc * per_proc),
        "local_blocks": B_local,
        "compressed_words": int(sizes.sum()),
    }
    if pid != 0:
        return None, stats

    # ---- host 0: ordered assembly ----
    # Valid blocks per process = those with n > 0 among its first B_local rows;
    # we detect them via the allgathered per-process stream metadata.
    frames_blocks = []
    metas: List[StreamMeta] = []
    payload_parts = []
    hist_parts = []
    n_parts = []
    global_first = 0
    for p in range(nproc):
        p_nstreams = int(nstreams[p])
        p_nb = metas_g[p, :p_nstreams, 3]
        p_blocks = int(p_nb.sum())
        base = p * per_proc
        sl = slice(base, base + p_blocks)
        frames_blocks.append((pred_g[sl], k_g[sl], ti_g[sl], bl_g[sl]))
        from dctpu.format.frame import payload_word_counts
        # valid for both coders: words = sync_words + ceil(bit_len/32)
        wc = payload_word_counts(bl_g[sl], L)
        off = np.zeros(wc.size + 1, dtype=np.int64)
        np.cumsum(wc, out=off[1:])
        payload_parts.append(_proc_payload(p)[: int(off[-1])])
        for si in range(p_nstreams):
            sid, cad, ns, nblk, fb = metas_g[p, si]
            metas.append(
                StreamMeta(
                    stream_id=int(sid),
                    cadence_s=int(cad),
                    num_samples=int(ns),
                    num_blocks=int(nblk),
                    first_block=global_first + int(fb),
                )
            )
        global_first += p_blocks

    pred = np.concatenate([f[0] for f in frames_blocks]) if frames_blocks else np.zeros(0)
    kk = np.concatenate([f[1] for f in frames_blocks])
    ti = np.concatenate([f[2] for f in frames_blocks])
    bl = np.concatenate([f[3] for f in frames_blocks])

    for p in range(nproc):
        p_blocks = int(metas_g[p, : int(nstreams[p]), 3].sum())
        n_parts.append(n_g[p, :p_blocks])
        hist_parts.append(h_g[p, :p_blocks])

    from dctpu.constants import CODER_RICE, CODER_VERTICAL

    coder_id = CODER_VERTICAL if cfg.coder == "vertical" else CODER_RICE
    blocks = BlockHeaders(
        coder=np.full(pred.size, coder_id, dtype=np.uint8),
        predictor=pred.astype(np.uint8),
        k=kk.astype(np.uint8),
        n=np.concatenate(n_parts).astype(np.uint16),
        bit_len=bl.astype(np.uint32),
        table_idx=ti.astype(np.uint8),
        history=np.concatenate(hist_parts).astype(np.int32).reshape(-1, 4),
    )
    frame = Frame(
        block_len=L,
        streams=metas,
        blocks=blocks,
        tables=cfg.lpc_tables,
        payload_words=np.concatenate(payload_parts).astype(np.uint32)
        if payload_parts
        else np.zeros(0, np.uint32),
    )
    return frame, stats
