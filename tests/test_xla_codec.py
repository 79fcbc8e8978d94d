"""XLA codec vs scalar reference: byte-identical frames, bit-exact decode.

SURVEY.md §4 "Oracle"/"Property" tiers for the device path (CPU backend here;
the same jitted functions run on the GPU unchanged).
"""

import numpy as np
import pytest

from dctpu.codec import api as xcodec
from dctpu.codec import scalar
from dctpu.config import CodecConfig
from dctpu.constants import DELTA, DOUBLE_DELTA, LPC
from dctpu.corpus import synth_corpus
from dctpu.format import read_frame, write_frame
from tests.conftest import stream_cases


def _assert_frames_equal(streams, cfg, **kw):
    py = write_frame(scalar.scalar_compress(streams, cfg))
    xf = xcodec.compress(streams, cfg, **kw)
    xb = write_frame(xf)
    assert xb == py, "XLA frame differs from scalar reference frame"
    out = xcodec.decompress(read_frame(xb))
    for a, b in zip(streams, out):
        assert np.array_equal(np.asarray(a, dtype=np.int32), b)


def test_xla_matches_scalar_adversarial(rng):
    _assert_frames_equal(stream_cases(rng), CodecConfig(block_len=256))


def test_xla_matches_scalar_corpus():
    streams, _, _ = synth_corpus(4, 2000, seed=3, mixed_cadence=True, cumulative_frac=0.5)
    _assert_frames_equal(streams, CodecConfig(block_len=512))


def test_xla_chunking_invariance(rng):
    streams, _, _ = synth_corpus(3, 3000, seed=5)
    cfg = CodecConfig(block_len=256)
    a = write_frame(xcodec.compress(streams, cfg, chunk_blocks=4))
    b = write_frame(xcodec.compress(streams, cfg, chunk_blocks=64))
    assert a == b


def test_xla_delta_only_config(rng):
    cfg = CodecConfig(block_len=512, predictors=(DELTA,))
    streams = stream_cases(rng)[:5]
    _assert_frames_equal(streams, cfg)


def test_xla_escape_heavy(rng):
    # full-range random -> mostly escape codes; stresses 3-word straddles
    x = rng.integers(-(2**31), 2**31, size=5000, dtype=np.int64).astype(np.int32)
    _assert_frames_equal([x], CodecConfig(block_len=1024))


def test_xla_empty_and_tiny():
    streams = [np.zeros(0, np.int32), np.array([42], np.int32), np.arange(3, dtype=np.int32)]
    _assert_frames_equal(streams, CodecConfig())


def test_choose_k_packed_key_bounds():
    # The packed-key idiom in rice.choose_k is only valid while
    # L * MAX_CODE_BITS < 2^26 and k_max < 32; both must be enforced.
    import jax.numpy as jnp
    import pytest

    from dctpu.codec import rice

    z = jnp.zeros((1, 4096), jnp.uint32)
    valid = jnp.ones((1, 4096), bool)
    rice.choose_k(z, valid, 24)  # largest supported default geometry: fine
    with pytest.raises(AssertionError):
        rice.choose_k(z, valid, 32)
    zbig = jnp.zeros((1, 2**26 // 48 + 64), jnp.uint32)
    with pytest.raises(AssertionError):
        rice.choose_k(zbig, jnp.ones(zbig.shape, bool), 24)


def test_choose_k_planes_matches_choose_k(rng):
    # bit-plane k selection (2 passes) must equal the 33-pass sweep exactly
    import jax.numpy as jnp

    from dctpu.codec import rice

    for L in (512, 4096, 384):
        mag = rng.integers(0, 33, (12, 1)).astype(np.uint64)
        z = (rng.integers(0, 2**32, (12, L), dtype=np.uint64)
             >> (np.uint64(32) - mag)).astype(np.uint32)
        z[rng.random((12, L)) < 0.3] = 0
        n = rng.integers(1, L + 1, 12).astype(np.int32)
        valid = np.arange(L)[None, :] < n[:, None]
        k1, b1 = rice.choose_k(jnp.asarray(z), jnp.asarray(valid))
        k2, b2 = rice.choose_k_planes(jnp.asarray(z), jnp.asarray(n), L)
        assert np.array_equal(np.asarray(k1), np.asarray(k2))
        assert np.array_equal(np.asarray(b1), np.asarray(b2))

