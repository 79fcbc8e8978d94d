"""Adaptive per-block coder selection (docs/FORMAT.md §4.1).

Byte-equality across scalar / XLA / sharded / C++ oracle, dominance of the
adaptive ratio over both pure coders, and genuinely mixed frames.
"""

import subprocess

import numpy as np
import pytest

from dctpu.codec import api as xcodec
from dctpu.codec import scalar
from dctpu.config import CodecConfig
from dctpu.corpus import synth_corpus
from dctpu.format import read_frame, write_frame, write_raw
from tests.conftest import stream_cases
from tests.test_oracle import ORACLE, oracle_bin  # noqa: F401 (fixture)


def _mixed_streams(rng):
    """Streams engineered so neither coder wins globally."""
    return [
        np.full(3000, 123, np.int32),                                # constant
        (np.arange(3000) // 7).astype(np.int32),                     # slow ramp
        rng.integers(-(2**20), 2**20, 3000, np.int64).astype(np.int32),
        (500 + 30 * np.sin(np.arange(3000) / 96)).astype(np.int32),  # smooth
    ]


CFG = CodecConfig(block_len=512, coder="adaptive")


def test_adaptive_scalar_vs_xla_byte_equal(rng):
    streams = _mixed_streams(rng)
    bs = write_frame(scalar.scalar_compress(streams, CFG))
    bx = write_frame(xcodec.compress(streams, CFG))
    assert bs == bx


def test_adaptive_produces_mixed_frames(rng):
    frame = xcodec.compress(_mixed_streams(rng), CFG)
    hist = np.bincount(frame.blocks.coder_arr(), minlength=2)
    assert hist[0] > 0 and hist[1] > 0, f"expected both coders, got {hist}"


def test_adaptive_round_trip_all_decoders(rng):
    streams = _mixed_streams(rng)
    data = write_frame(xcodec.compress(streams, CFG))
    for decode in (xcodec.decompress, scalar.scalar_decompress):
        out = decode(read_frame(data))
        for a, b in zip(streams, out):
            assert np.array_equal(a, b)


def test_adaptive_dominates_both_coders(rng):
    # Per-block argmin-words implies the adaptive payload is never larger
    # than either pure mode's payload (§4.1).
    streams, ids, cads = synth_corpus(
        4, 2500, seed=77, mixed_cadence=True, cumulative_frac=0.25
    )
    streams = streams + _mixed_streams(rng)
    sizes = {}
    for coder in ("rice", "vertical", "adaptive"):
        cfg = CodecConfig(block_len=512, coder=coder)
        sizes[coder] = xcodec.compress(streams, cfg).payload_words.size
    assert sizes["adaptive"] <= sizes["rice"]
    assert sizes["adaptive"] <= sizes["vertical"]


def test_adaptive_adversarial_cases(rng):
    streams = stream_cases(rng)
    cfg = CodecConfig(coder="adaptive")
    bs = write_frame(scalar.scalar_compress(streams, cfg))
    bx = write_frame(xcodec.compress(streams, cfg))
    assert bs == bx
    out = xcodec.decompress(read_frame(bx))
    for a, b in zip(streams, out):
        assert np.array_equal(a, b)


def test_adaptive_sharded_matches_single_device(rng):
    from dctpu.dist.sharded import compress_sharded

    streams = _mixed_streams(rng)
    bx = write_frame(xcodec.compress(streams, CFG))
    bsh = write_frame(compress_sharded(streams, CFG))
    assert bx == bsh


def test_oracle_adaptive_matches(tmp_path, oracle_bin, rng):  # noqa: F811
    streams = _mixed_streams(rng)
    ids, cads = list(range(len(streams))), [900] * len(streams)
    dcr = tmp_path / "in.dcr"
    dcr.write_bytes(write_raw(streams, ids, cads))
    dcf = tmp_path / "oracle.dcf"
    subprocess.run(
        [oracle_bin, "encode", str(dcr), str(dcf),
         "--coder", "adaptive", "--block-len", "512"],
        check=True, capture_output=True,
    )
    py_bytes = write_frame(
        scalar.scalar_compress(streams, CFG, stream_ids=ids, cadences=cads)
    )
    assert py_bytes == dcf.read_bytes()
    # oracle decodes the adaptive (mixed) frame back to the input
    out_dcr = tmp_path / "out.dcr"
    subprocess.run(
        [oracle_bin, "decode", str(dcf), str(out_dcr)],
        check=True, capture_output=True,
    )
    from dctpu.format import read_raw

    out, _, _ = read_raw(out_dcr.read_bytes())
    for a, b in zip(streams, out):
        assert np.array_equal(a, b)

