"""Benchmark harness for one GPU: end-to-end throughput of the served path.

    python bench.py

Prints ONE JSON line on stdout: the adaptive coder's (the CLI default) warm
end-to-end compress throughput — int32 streams in, frame bytes out, with
the host block building, both transfers, the device work, compaction and
the frame write included — tagged with the device as JAX reports it and
the card's name and power limit as nvidia-smi gives them. Detail goes to
stderr: every coder's compress/decompress throughput, ratio and
bit-exactness, and the warm time of each device stage at the chunk
geometry (the stages of chip_smoke.py's phase b).

Timing is the host clock around work that ends in jax.block_until_ready
or in host arrays (dctpu.utils.timing). The run refuses to start without a
GPU: a CPU number is never reported under a device metric. The corpus is
16 mixed-cadence streams, 128 MiB of int32 (8192 blocks of 4096 samples).
Any failure raises: no number is printed for a run that was not bit-exact.
"""

import contextlib
import json
import statistics
import sys
import time

import numpy as np

CODERS = ("rice", "vertical", "adaptive")
BLOCK_LEN, BLOCKS, STREAMS = 4096, 8192, 16


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def end_to_end(streams, coder, reps=3):
    """Warm median wall seconds of compress+write and read+decompress."""
    from dctpu.codec import api as capi
    from dctpu.config import CodecConfig
    from dctpu.format import read_frame, write_frame

    cfg = CodecConfig(block_len=BLOCK_LEN, coder=coder)
    data = write_frame(capi.compress(streams, cfg))  # compiles every shape
    out = capi.decompress(read_frame(data))
    if not all(np.array_equal(a, b) for a, b in zip(streams, out)):
        raise AssertionError(f"{coder}: round trip not bit-exact")
    t_enc, t_dec = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        data = write_frame(capi.compress(streams, cfg))
        t_enc.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        capi.decompress(read_frame(data))
        t_dec.append(time.perf_counter() - t0)
    raw = sum(s.nbytes for s in streams)
    res = {
        "encode_gbps": raw / statistics.median(t_enc) / 1e9,
        "decode_gbps": raw / statistics.median(t_dec) / 1e9,
        "ratio": raw / len(data),
        "bit_exact": True,
    }
    log(f"[{coder}] end-to-end: {res}")
    return res


def main():
    import chip_smoke
    from dctpu.codec.api import DEFAULT_CHUNK_BLOCKS, build_blocks
    from dctpu.corpus import synth_corpus
    from dctpu.utils.timing import device_time

    devices = chip_smoke.require_gpus(1)
    card = chip_smoke.card_lines()[0]
    log(f"device: {devices[0].device_kind} x{len(devices)}; card: {card}")
    streams, _, _ = synth_corpus(
        STREAMS, BLOCKS * BLOCK_LEN // STREAMS, seed=123,
        mixed_cadence=True, cumulative_frac=0.25,
    )
    results = {c: end_to_end(streams, c) for c in CODERS}

    x, n, hist, _, _ = build_blocks(streams, BLOCK_LEN)
    B = DEFAULT_CHUNK_BLOCKS
    with contextlib.redirect_stdout(sys.stderr):
        stages = chip_smoke.phase_compile(x[:B], n[:B], hist[:B])
    results["stage_ms"] = {}
    for name, compiled, args in stages:
        t, _ = device_time(lambda: compiled(*args), reps=5)
        results["stage_ms"][name] = t * 1e3
        log(f"stage {name} [{B}, {BLOCK_LEN}]: {t * 1e3:.3f} ms [{card}]")

    d = devices[0]
    line = {
        "metric": "adaptive_e2e_encode_gbps",
        "value": results["adaptive"]["encode_gbps"],
        "unit": "GB/s",
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
        "card": card,
        "detail": results,
    }
    print(json.dumps(line))


if __name__ == "__main__":
    main()
