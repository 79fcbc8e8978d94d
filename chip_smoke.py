"""Smoke run of the dctpu codec on NVIDIA GPUs, through its public entry points.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # four GPUs: the sharded and multi-process paths

One GPU, one process, in phases on a deployment-sized corpus (1,000 meters
x one year of 15-minute readings, mixed cadences, a quarter cumulative
registers; BASELINE.json configs 2 and 4):

  a. preflight: device check, versions, compile cache, host library,
     C++ oracle built from source, the card's name and power limit;
  b. every production entry point compiled at [2048, 4096] (compile
     seconds, memory_analysis(), scatter combiners), each run once;
  c. compress -> write_frame -> read_frame -> decompress for the rice,
     vertical and adaptive coders: frame bytes equal the oracle's on the
     whole corpus and scalar_compress's on the first 16 streams, and the
     decode is bit-exact;
  d. the CLI's `verify` command, in-process;
  e. warm times of every stage of (b) and of compress/decompress, with
     peak device memory.

--four runs only the multi-device paths and what they are compared with:
compress_sharded/decompress_sharded over a 4-GPU mesh for all three coders,
and the 4-process multihost encode (one GPU each), all against the oracle.

The last line of standard output is one JSON object naming the device; it
is printed only when every phase passed. Without a GPU the script exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CODERS = ("rice", "vertical", "adaptive")
N_METERS, N_SAMPLES, SEED = 1000, 35040, 123
BLOCK_LEN = 4096
SCALAR_STREAMS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ preflight


def card_lines() -> list:
    """`name, power.limit` of every GPU, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpus(count: int, platform: str = "gpu"):
    """jax.devices() if it holds `count` devices of `platform`, else exit 2."""
    import jax

    devs = jax.devices()
    if devs[0].platform != platform or len(devs) < count:
        print(
            f"chip_smoke: needs {count} {platform} device(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return devs


def build_oracle() -> str:
    subprocess.run(
        ["make", "-s", "-C", str(REPO / "oracle")],
        check=True, capture_output=True, timeout=300,
    )
    return str(REPO / "oracle" / "dcomp_oracle")


def preflight() -> str:
    """Print the run's environment; build the oracle. Returns its path."""
    import jax

    from dctpu import native

    log(f"jax {jax.__version__}, python {sys.version.split()[0]}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    log("host library: "
        + ("native (native/libdctpu_host.so)" if native.available()
           else f"numpy fallback ({native.load_error})"))
    oracle = build_oracle()
    log(f"oracle: {oracle}")
    for line in card_lines():
        log(f"card: {line}")
    return oracle


# ------------------------------------------------------------ corpus + refs


def make_corpus(n_meters=N_METERS, n_samples=N_SAMPLES, seed=SEED):
    from dctpu.corpus import synth_corpus

    return synth_corpus(n_meters, n_samples, seed=seed, mixed_cadence=True,
                        cumulative_frac=0.25)


def oracle_frames(oracle, dcr: Path, block_len=BLOCK_LEN, coders=CODERS):
    """{coder: oracle frame bytes} for the DCR1 file `dcr`."""
    out = {}
    for coder in coders:
        dcf = dcr.with_suffix(f".{coder}.dcf")
        subprocess.run(
            [oracle, "encode", str(dcr), str(dcf), "--coder", coder,
             "--block-len", str(block_len)],
            check=True, capture_output=True, timeout=600,
        )
        out[coder] = dcf.read_bytes()
    return out


def frame_prefix(frame, n_streams: int):
    """The frame of the first `n_streams` streams, cut out of `frame`.

    Blocks are independent and stream-ordered, so those streams' blocks,
    headers and payload words are exactly what compressing them alone
    gives.
    """
    from dctpu.format.frame import BlockHeaders, Frame

    metas = frame.streams[:n_streams]
    nb = sum(m.num_blocks for m in metas)
    b = frame.blocks
    nw = int(b.word_offsets(frame.block_len)[nb])
    return Frame(
        block_len=frame.block_len,
        streams=metas,
        blocks=BlockHeaders(
            predictor=b.predictor[:nb], k=b.k[:nb], n=b.n[:nb],
            bit_len=b.bit_len[:nb], table_idx=b.table_idx[:nb],
            history=b.history[:nb], coder=b.coder_arr()[:nb],
        ),
        tables=frame.tables,
        payload_words=frame.payload_words[:nw],
    )


# ------------------------------------------------------------ phase b


def scatter_combiners(hlo_text: str) -> list:
    """Root opcode of each scatter's combiner in an HLO module's text.

    "add"/"maximum" are order-independent on integers; "parameter" would
    be a scatter that sets values, whose result with duplicate indices
    depends on the order GPU atomics happen to run in.
    """
    roots, cur = {}, None
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+) \(.*\{\s*$", line)
        if m:
            cur = m.group(1)
        m = re.match(r"\s*ROOT\s+%?[\w.\-]+\s*=\s*\S+\s+([\w\-]+)\(", line)
        if m and cur:
            roots[cur] = m.group(1)
    names = re.findall(r"\bscatter\(.*?to_apply=%?([\w.\-]+)", hlo_text)
    return [roots.get(name, "?") for name in names]


def phase_compile(x, n, hist, block_len=BLOCK_LEN):
    """Compile every production entry point at the chunk's [B, L].

    Each is compiled ahead of time, reported, checked for set-scatters and
    run once on the chunk, feeding the next. Returns [(name, compiled,
    args)] for phase e; raises if a decode is not bit-exact.
    """
    import jax
    import jax.numpy as jnp

    from dctpu.codec import api as capi
    from dctpu.codec.decode import decode_blocks
    from dctpu.codec.encode import adaptive_select, emit_blocks, encode_blocks
    from dctpu.codec.vertical_host import _parse_sync_rows
    from dctpu.config import CodecConfig
    from dctpu.constants import LPC, subs_per_block, sync_words
    from dctpu.format.frame import payload_word_counts
    from dctpu.kernels import ragged
    from dctpu.kernels.unpack_scan import _sync_sub_lens_host, buf_bucket
    from dctpu.kernels.vertical_xla import plane_bucket

    L = block_len
    B = x.shape[0]
    stages = []

    def build(name, fn, args, **static):
        t0 = time.perf_counter()
        compiled = fn.lower(*args, **static).compile()
        dt = time.perf_counter() - t0
        combiners = scatter_combiners(compiled.as_text())
        log(f"compile {name} [{B}, {L}]: {dt:.3f} s; scatters {combiners}")
        log(f"  memory_analysis {name}: {compiled.memory_analysis()}")
        bad = [c for c in combiners if c not in ("add", "maximum")]
        if bad:
            raise AssertionError(f"{name}: scatter combiners {bad}")
        out = jax.block_until_ready(compiled(*args))
        stages.append((name, compiled, args))
        return out

    xd, nd, hd = jnp.asarray(x), jnp.asarray(n), jnp.asarray(hist)
    for coder in ("rice", "vertical"):
        build(f"encode_blocks[{coder}]", encode_blocks, (xd, nd, hd),
              cfg=CodecConfig(block_len=L, coder=coder), backend="auto")

    cfg = CodecConfig(block_len=L, coder="adaptive")
    choice, coder_d, k = build("adaptive_select", adaptive_select,
                               (xd, nd, hd), cfg=cfg, backend="auto")
    choice_h, coder_h, k_h = (np.asarray(a) for a in (choice, coder_d, k))
    cands = cfg.candidates()
    pred_map = np.array([p for p, _ in cands], np.int32)
    ti_map = np.array([ti if p == LPC else 0 for p, ti in cands], np.int32)
    coeffs = np.array([t.coeffs for t in cfg.lpc_tables], np.int64)
    real = np.nonzero(n > 0)[0]

    for gid, gname in ((0, "rice"), (1, "vertical")):
        idx = np.nonzero((coder_h == gid) & (n > 0))[0]
        if idx.size == 0:  # a chunk with no such block: emit every block
            idx = real
        G = idx.size

        def rows(a, idx=idx):
            return capi._pad_chunk(a[idx], B)

        enc = build(f"emit_blocks[{gname}]", emit_blocks,
                    tuple(jnp.asarray(rows(a)) for a in
                          (x, n, hist, choice_h, k_h)),
                    cfg=cfg, coder=gname, backend="auto")
        bl = np.asarray(enc.bit_len[:G])
        total_tiles, tc_h = capi.semi_plan(enc.payload.shape, bl, L, gname)
        if gname == "rice":
            build("compact_rice_semi", ragged.compact_rice_semi,
                  (enc.payload, jnp.asarray(tc_h.astype(np.int32))),
                  total_tiles=total_tiles)
        else:
            build("compact_vertical_semi", ragged.compact_vertical_semi,
                  (enc.payload,), block_len=L, total_tiles=total_tiles)

        words = capi.compact_enc_payload_device(enc.payload, bl, L, gname)
        off = np.zeros(G + 1, np.int64)
        np.cumsum(payload_word_counts(bl, L), out=off[1:])
        flat_d, off_d = jnp.asarray(words), jnp.asarray(off.astype(np.int32))
        SW = sync_words(L)
        if gname == "rice":
            lens = _sync_sub_lens_host(words, off, L)
            buf, max_planes = buf_bucket(int(lens.max())), 32
            staged = build("stage_rice_scan_device",
                           ragged.stage_rice_scan_device, (flat_d, off_d),
                           block_len=L, buf_words=buf)
        else:
            sync_rows = words[off[:-1, None] + np.arange(SW)[None, :]]
            bw, _, _ = _parse_sync_rows(sync_rows, subs_per_block(L))
            buf, max_planes = 0, plane_bucket(int(bw.max()))
            staged = build("stage_vertical_device",
                           ragged.stage_vertical_device, (flat_d, off_d),
                           block_len=L,
                           span_words=ragged.span_bucket(int(bw.max())))
        pred = pred_map[choice_h[idx]]
        args = (capi._pad_chunk(staged, B),) + tuple(
            jnp.asarray(capi._pad_chunk(a, B)) for a in
            (k_h[idx] if gname == "rice" else np.zeros(G, np.int32),
             n[idx], pred, ti_map[choice_h[idx]], hist[idx])
        ) + (jnp.asarray(coeffs),)
        out = build(f"decode_blocks[{gname}]", decode_blocks, args,
                    block_len=L, has_lpc=bool(np.any(pred == LPC)),
                    backend="auto", coder=gname, max_planes=max_planes,
                    buf_words=buf)
        want = np.where(np.arange(L)[None, :] < n[idx][:, None], x[idx], 0)
        if not np.array_equal(np.asarray(out[:G]), want):
            raise AssertionError(f"decode_blocks[{gname}] not bit-exact")
        log(f"  decode_blocks[{gname}] bit-exact on {G} blocks")
    return stages


# ------------------------------------------------------------ phase c, d


def phase_round_trips(streams, ids, cads, oracle_bytes, block_len=BLOCK_LEN,
                      n_scalar=SCALAR_STREAMS, compress=None, decompress=None):
    """compress/write/read/decompress per coder against the references.

    compress/decompress default to dctpu.codec's; --four passes the
    sharded ones. Returns {coder: frame bytes}.
    """
    from dctpu.codec import api as capi
    from dctpu.codec import scalar_compress
    from dctpu.config import CodecConfig
    from dctpu.format import read_frame, write_frame

    compress = compress or capi.compress
    decompress = decompress or capi.decompress
    n_scalar = min(n_scalar, len(streams))
    raw = sum(s.nbytes for s in streams)
    frames = {}
    for coder in oracle_bytes:
        cfg = CodecConfig(block_len=block_len, coder=coder)
        t0 = time.perf_counter()
        frame = compress(streams, cfg, stream_ids=ids, cadences=cads)
        data = write_frame(frame)
        t_enc = time.perf_counter() - t0
        if data != oracle_bytes[coder]:
            raise AssertionError(f"{coder}: frame bytes differ from oracle")
        ref = write_frame(scalar_compress(
            streams[:n_scalar], cfg, stream_ids=ids[:n_scalar],
            cadences=cads[:n_scalar]))
        if write_frame(frame_prefix(frame, n_scalar)) != ref:
            raise AssertionError(
                f"{coder}: first {n_scalar} streams differ from scalar")
        t0 = time.perf_counter()
        out = decompress(read_frame(data))
        t_dec = time.perf_counter() - t0
        if len(out) != len(streams) or not all(
                np.array_equal(a, b) for a, b in zip(streams, out)):
            raise AssertionError(f"{coder}: decode not bit-exact")
        log(f"round trip {coder}: {frame.blocks.num_blocks} blocks, "
            f"{raw} -> {len(data)} bytes (ratio {raw / len(data):.4f}); "
            f"== oracle bytes, first {n_scalar} streams == scalar_compress, "
            f"decode bit-exact (cold: encode {t_enc:.3f} s, decode "
            f"{t_dec:.3f} s)")
        frames[coder] = data
    return frames


def phase_cli_verify(dcr: Path, block_len=BLOCK_LEN) -> None:
    """`dcomp verify` on the corpus, in this process (one process per card)."""
    from dctpu.cli.main import main as cli_main

    rc = cli_main(["verify", str(dcr), "--block-len", str(block_len)])
    if rc != 0:
        raise AssertionError(f"CLI verify returned {rc}")
    log("CLI verify: OK (rc 0)")


# ------------------------------------------------------------ phase e


def phase_stage_times(stages, streams, ids, cads, tag: str,
                      block_len=BLOCK_LEN, reps=5):
    """Warm host-clock times around block_until_ready, one line each."""
    import jax

    from dctpu.codec import api as capi
    from dctpu.config import CodecConfig
    from dctpu.utils.timing import device_time

    for name, compiled, args in stages:
        t, _ = device_time(lambda: compiled(*args), reps=reps, warmup=1)
        log(f"stage {name}: {t * 1e3:.3f} ms (median of {reps}) [{tag}]")
    raw = sum(s.nbytes for s in streams)
    for coder in CODERS:
        cfg = CodecConfig(block_len=block_len, coder=coder)
        t0 = time.perf_counter()
        frame = capi.compress(streams, cfg, stream_ids=ids, cadences=cads)
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        capi.decompress(frame)
        t_dec = time.perf_counter() - t0
        log(f"end-to-end {coder}: compress {t_enc:.3f} s "
            f"({raw / t_enc / 1e9:.4f} GB/s), decompress {t_dec:.3f} s "
            f"({raw / t_dec / 1e9:.4f} GB/s), {raw} bytes [{tag}]")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}"
        f" [{tag}]")


# ------------------------------------------------------------ --four


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_worker(coord, nproc, pid, dcr, out, coder, platform) -> int:
    """One process of the multihost encode: its contiguous share of `dcr`."""
    if platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    from dctpu.config import CodecConfig
    from dctpu.dist import multihost
    from dctpu.format import read_raw, write_frame

    multihost.initialize(
        coord, nproc, pid,
        local_device_ids=[pid] if platform == "gpu" else None,
    )
    dev = jax.local_devices()[0]
    if dev.platform != platform:
        raise SystemExit(f"worker {pid}: {dev.platform}, not {platform}")
    streams, ids, cads = read_raw(Path(dcr).read_bytes())
    per = -(-len(streams) // nproc)
    lo, hi = pid * per, min((pid + 1) * per, len(streams))
    frame, stats = multihost.compress_multihost(
        streams[lo:hi], CodecConfig(block_len=BLOCK_LEN, coder=coder),
        local_stream_ids=ids[lo:hi], local_cadences=cads[lo:hi],
    )
    if pid == 0:
        Path(out).write_bytes(write_frame(frame))
    print(f"worker {pid} on {dev.device_kind}: {stats}", flush=True)
    jax.effects_barrier()
    return 0


def phase_multihost(dcr: Path, oracle_bytes, nproc=4, platform="gpu",
                    timeout=900) -> None:
    """nproc worker processes, one device each; host 0's frame == oracle.

    The caller must not hold a device while this runs."""
    for coder in oracle_bytes:
        out = dcr.with_suffix(f".mh.{coder}.dcf")
        coord = f"localhost:{_free_port()}"
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--multihost-worker", coord, str(nproc), str(pid),
                 str(dcr), str(out), coder, platform],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for pid in range(nproc)
        ]
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for pid, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(
                    f"multihost {coder} worker {pid} rc {p.returncode}:\n"
                    f"{text[-4000:]}")
        if out.read_bytes() != oracle_bytes[coder]:
            raise AssertionError(f"multihost {coder}: host 0 frame != oracle")
        log(f"multihost {coder}: {nproc} processes, host 0 frame == oracle "
            f"bytes ({time.perf_counter() - t0:.3f} s incl. start-up)")


def phase_sharded(streams, ids, cads, oracle_bytes, devices,
                  block_len=BLOCK_LEN) -> None:
    """compress_sharded/decompress_sharded over a mesh of `devices`."""
    from dctpu.dist import compress_sharded, decompress_sharded
    from dctpu.dist.mesh import make_mesh

    mesh = make_mesh(devices)

    def comp(streams, cfg, stream_ids, cadences):
        return compress_sharded(streams, cfg, mesh, stream_ids=stream_ids,
                                cadences=cadences)

    phase_round_trips(streams, ids, cads, oracle_bytes, block_len,
                      compress=comp,
                      decompress=lambda f: decompress_sharded(f, mesh))
    log(f"sharded over {len(devices)} devices: all coders == oracle bytes, "
        f"decode bit-exact")


# ------------------------------------------------------------ main


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="four GPUs: the sharded and multihost paths only")
    p.add_argument("--multihost-worker", nargs=7, metavar="ARG",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.multihost_worker:
        coord, nproc, pid, dcr, out, coder, platform = args.multihost_worker
        return multihost_worker(coord, int(nproc), int(pid), dcr, out,
                                coder, platform)

    from dctpu.format import write_raw

    if args.four:
        # no JAX device in this process until the workers have exited
        try:
            cards = card_lines()
        except (OSError, subprocess.SubprocessError) as e:
            print(f"chip_smoke: no GPU ({e})", file=sys.stderr)
            raise SystemExit(2)
        if len(cards) < 4:
            print(f"chip_smoke: --four needs 4 GPUs, found {cards}",
                  file=sys.stderr)
            raise SystemExit(2)
    else:
        require_gpus(1)
        cards = card_lines()

    with tempfile.TemporaryDirectory() as tmp:
        oracle = build_oracle() if args.four else preflight()
        streams, ids, cads = make_corpus()
        dcr = Path(tmp) / "corpus.dcr"
        dcr.write_bytes(write_raw(streams, ids, cads))
        t0 = time.perf_counter()
        refs = oracle_frames(oracle, dcr)
        log(f"corpus: {len(streams)} streams, "
            f"{sum(s.size for s in streams)} samples, "
            f"{sum(s.nbytes for s in streams)} bytes; oracle frames in "
            f"{time.perf_counter() - t0:.3f} s")

        if args.four:
            phase_multihost(dcr, {c: refs[c] for c in ("rice", "vertical")})
            devices = require_gpus(4)
            phase_sharded(streams, ids, cads, refs, devices[:4])
            devices = devices[:4]
        else:
            from dctpu.codec.api import build_blocks

            devices = require_gpus(1)[:1]
            x, n, hist, _, _ = build_blocks(streams, BLOCK_LEN)
            B = 2048
            stages = phase_compile(x[:B], n[:B], hist[:B])
            phase_round_trips(streams, ids, cads, refs)
            phase_cli_verify(dcr)
            phase_stage_times(stages, streams, ids, cads, cards[0])
    for line in cards:
        log(f"card: {line}")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
