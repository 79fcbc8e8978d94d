"""Perf-regression floors — the checking half (round-2 VERDICT missing #5).

Compression ratio is a pure function of the bitstream spec, so its floors run
in CI on any backend. This file also keeps bench/floors.json well-formed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from dctpu.codec import api as capi
from dctpu.config import CodecConfig
from dctpu.corpus import synth_corpus
from dctpu.format.frame import write_frame

FLOORS = json.loads(
    (Path(__file__).parent.parent / "bench" / "floors.json").read_text()
)


@pytest.fixture(scope="module")
def corpus():
    g = FLOORS["ratio_corpus"]
    streams, _, _ = synth_corpus(
        g["streams"], g["samples"], seed=g["seed"],
        mixed_cadence=g["mixed_cadence"], cumulative_frac=g["cumulative_frac"],
    )
    return streams, sum(s.nbytes for s in streams)


@pytest.mark.parametrize("coder", ["rice", "vertical", "adaptive"])
def test_frame_ratio_floor(corpus, coder):
    streams, raw = corpus
    frame = capi.compress(streams, CodecConfig(coder=coder))
    ratio = raw / len(write_frame(frame))
    floor = FLOORS["frame_ratio_floor"][coder]
    assert ratio >= floor, f"{coder} ratio {ratio:.3f} < floor {floor}"


def test_adaptive_dominates(corpus):
    """FORMAT §4.1: adaptive picks the cheaper coder per block, so its
    payload can never exceed either uniform coder's payload."""
    streams, raw = corpus
    sizes = {}
    for coder in ("rice", "vertical", "adaptive"):
        fr = capi.compress(streams, CodecConfig(coder=coder))
        sizes[coder] = fr.payload_words.nbytes
    assert sizes["adaptive"] <= sizes["rice"]
    assert sizes["adaptive"] <= sizes["vertical"]


def test_floors_file_covers_bench_keys():
    assert set(FLOORS["frame_ratio_floor"]) == {"rice", "vertical", "adaptive"}
    assert all(v > 1 for v in FLOORS["frame_ratio_floor"].values())
