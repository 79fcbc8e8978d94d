"""Card-only checks: chip_smoke.py's phases at the deployment size, on a GPU.

Run on the card (one process holds it):

    DCTPU_TESTS_ON_GPU=1 python -m pytest -m gpu tests/test_chip.py

Elsewhere every test here skips with a reason; whether a GPU is present is
decided inside a fixture, never at import.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform} here "
                    "(on a card: DCTPU_TESTS_ON_GPU=1 pytest -m gpu)")
    return dev


@pytest.fixture(scope="module")
def corpus(gpu, tmp_path_factory):
    from dctpu.format import write_raw

    streams, ids, cads = chip_smoke.make_corpus()
    dcr = tmp_path_factory.mktemp("corpus") / "corpus.dcr"
    dcr.write_bytes(write_raw(streams, ids, cads))
    refs = chip_smoke.oracle_frames(chip_smoke.build_oracle(), dcr)
    return streams, ids, cads, dcr, refs


def test_entry_points_compile_at_real_width(corpus):
    from dctpu.codec.api import build_blocks

    x, n, hist, _, _ = build_blocks(corpus[0], chip_smoke.BLOCK_LEN)
    stages = chip_smoke.phase_compile(x[:2048], n[:2048], hist[:2048])
    assert len(stages) == 11


@pytest.mark.parametrize("coder", chip_smoke.CODERS)
def test_round_trip_matches_oracle(corpus, coder):
    streams, ids, cads, _, refs = corpus
    chip_smoke.phase_round_trips(streams, ids, cads, {coder: refs[coder]})


def test_cli_verify(corpus):
    chip_smoke.phase_cli_verify(corpus[3])
