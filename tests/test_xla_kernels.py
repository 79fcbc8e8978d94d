"""The XLA kernels that stay, against their specs and the scalar reference.

Kernel tier (SURVEY.md §4): the production packer/unpacker (pack_scan,
unpack_scan) against the scatter/gather spec (pack_xla, unpack_xla) and the
input; the vertical coder against the scalar vertical encoder; the adaptive
selection against scalar.choose_k / scalar.vertical_block_words; and the
backend-name table. Inputs cover escapes, empty and 3-sample blocks, a
200-sample block length and cuts at sub-block boundaries.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dctpu.codec import api as capi
from dctpu.codec import rice, scalar
from dctpu.codec.encode import adaptive_select, emit_blocks, encode_blocks
from dctpu.codec.decode import decode_blocks
from dctpu.codec.vertical_host import compact_vertical, stage_vertical
from dctpu.config import CodecConfig
from dctpu.constants import LPC
from dctpu.corpus import synth_corpus
from dctpu.kernels.pack_scan import pack_scan
from dctpu.kernels.pack_xla import pack_xla, padded_words
from dctpu.kernels.unpack_scan import (
    buf_bucket,
    max_sub_bits_host,
    stage_rice_scan,
    unpack_scan,
)
from dctpu.kernels.unpack_xla import unpack_xla
from dctpu.kernels.vertical_xla import (
    decode_vertical,
    encode_vertical,
    vertical_total_words,
)

from conftest import stream_cases

B = 6


def _lengths(L):
    """Valid counts per block: full, empty, 3, sub-block cuts, ragged."""
    n = np.array([L, 0, 3, min(128, L), min(129, L), L - L // 3], np.int32)
    return n[:B]


def _z_cases(L, source):
    """[B, L] u32 zigzag values (zero past n) and [B] i32 valid counts."""
    rng = np.random.default_rng(1000 + L + (source == "corpus"))
    if source == "corpus":
        streams, _, _ = synth_corpus(1, B * L + 1, seed=L,
                                     cumulative_frac=0.5)
        x = streams[0].astype(np.int64)
        r = (np.diff(x) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        z = scalar.zigzag(r).reshape(B, L)
    else:
        z = (rng.geometric(0.02, size=(B, L)) - 1).astype(np.uint32)
        z[rng.random((B, L)) < 0.03] = np.uint32(0xFFFFFFF0)  # escapes
    n = _lengths(L)
    z = np.where(np.arange(L)[None, :] < n[:, None], z, 0).astype(np.uint32)
    return z, n


def _packed(L, source):
    """(z, n, k, pack_xla output, pack_scan output) for one case."""
    z, n = _z_cases(L, source)
    k, _ = rice.choose_k_planes(jnp.asarray(z), jnp.asarray(n), L)
    k = np.asarray(k)
    valid = jnp.asarray(np.arange(L)[None, :] < n[:, None])
    lo, hi, ln = rice.codewords(jnp.asarray(z), jnp.asarray(k)[:, None])
    return z, n, k, pack_xla(lo, hi, ln, valid, L), pack_scan(
        lo, hi, ln, valid, L)


@pytest.mark.parametrize("source", ["corpus", "random"])
@pytest.mark.parametrize("L", [128, 256, 4096])
def test_pack_scan_matches_pack_xla(L, source):
    _, _, _, (p_xla, b_xla), (p_scan, b_scan) = _packed(L, source)
    assert np.array_equal(np.asarray(b_scan), np.asarray(b_xla))
    assert np.array_equal(np.asarray(p_scan), np.asarray(p_xla))


@pytest.mark.parametrize("source", ["corpus", "random"])
@pytest.mark.parametrize("L", [128, 256, 4096])
def test_unpack_scan_matches_unpack_xla(L, source):
    z, n, k, _, (p_scan, b_scan) = _packed(L, source)
    bl = np.asarray(b_scan)
    words = capi.compact_payload(np.asarray(p_scan), bl, L)
    off = np.zeros(B + 1, np.int64)
    np.cumsum(capi.payload_word_counts(bl, L), out=off[1:])
    buf = buf_bucket(max_sub_bits_host(words, off, L))
    staged = jnp.asarray(stage_rice_scan(words, off, L, buf))
    padded = jnp.asarray(capi.pad_payload(words, off, B, padded_words(L) + 2))
    kd, nd = jnp.asarray(k), jnp.asarray(n)
    z_scan = np.asarray(unpack_scan(staged, kd, nd, L, buf))
    z_xla = np.asarray(unpack_xla(padded, kd, nd, L))
    assert np.array_equal(z_xla, z)
    assert np.array_equal(z_scan, z)


@pytest.mark.parametrize("L", [200, 256, 4096])
def test_encode_vertical_matches_scalar(L):
    z, n = _z_cases(L, "random")
    payload, bit_len = encode_vertical(jnp.asarray(z), jnp.asarray(n), L)
    words, wc = compact_vertical(np.asarray(payload), L)
    off = np.zeros(B + 1, np.int64)
    np.cumsum(wc, out=off[1:])
    for b in range(B):
        ref_bits, ref_words = scalar.vertical_encode_block(z[b, : n[b]], L)
        assert int(bit_len[b]) == ref_bits
        assert np.array_equal(words[off[b] : off[b + 1]], ref_words)

    staged = jnp.asarray(stage_vertical(words, off, L))
    z_dec = np.asarray(decode_vertical(staged, jnp.asarray(n), L))
    assert np.array_equal(z_dec, z)


@pytest.mark.parametrize("L", [200, 256, 4096])
def test_adaptive_select_matches_scalar(L, rng):
    cfg = CodecConfig(block_len=L, coder="adaptive")
    streams = stream_cases(rng, max_len=2 * L + 7)
    streams += synth_corpus(2, 2 * L + 130, seed=L, cumulative_frac=1.0)[0]
    x, n, hist, _, _ = capi.build_blocks(streams, L)
    choice, coder, k = (
        np.asarray(a) for a in adaptive_select(
            jnp.asarray(x), jnp.asarray(n), jnp.asarray(hist), cfg, "auto")
    )
    valid = np.arange(L)[None, :] < n[:, None]
    for ci, (pred, ti) in enumerate(cfg.candidates()):
        table = cfg.lpc_tables[ti] if pred == LPC else None
        zc = np.stack([
            np.pad(scalar.zigzag(scalar.residuals(
                x[b, : n[b]], hist[b], pred, table)), (0, L - n[b]))
            for b in range(x.shape[0])
        ]).astype(np.uint32)
        k_d, bits_d = rice.choose_k_planes(jnp.asarray(zc), jnp.asarray(n), L)
        vw_d = vertical_total_words(jnp.asarray(zc), jnp.asarray(valid), L)
        for b in range(x.shape[0]):
            kb, bits = scalar.choose_k(zc[b, : n[b]], cfg.k_max)
            assert (int(k_d[b]), int(bits_d[b])) == (kb, bits)
            assert int(vw_d[b]) == scalar.vertical_block_words(zc[b], n[b], L)

    for b in range(x.shape[0]):
        pred, kb, ti, cd, _, _ = scalar.scalar_encode_block(
            x[b, : n[b]], hist[b], cfg)
        p, t = cfg.candidates()[choice[b]]
        assert (p, t if p == LPC else 0) == (pred, ti)
        assert (int(coder[b]), int(k[b])) == (cd, kb)


REMOVED = ["pallas", "mega", "reduce", "bp"]


@pytest.mark.parametrize("name", REMOVED)
@pytest.mark.parametrize("entry", ["encode", "select", "emit", "decode"])
def test_removed_backend_names_raise(entry, name):
    L = 128
    x = jnp.zeros((2, L), jnp.int32)
    n = jnp.full((2,), L, jnp.int32)
    h = jnp.zeros((2, 4), jnp.int32)
    z = jnp.zeros((2,), jnp.int32)
    cfg = CodecConfig(block_len=L)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        if entry == "encode":
            encode_blocks(x, n, h, cfg, name)
        elif entry == "select":
            adaptive_select(x, n, h, cfg, name)
        elif entry == "emit":
            emit_blocks(x, n, h, z, z, cfg, "vertical", name)
        else:
            coeffs = jnp.zeros((1, 4), jnp.int64)
            decode_blocks(jnp.zeros((2, 64), jnp.uint32), z, n, z, z, h,
                          coeffs, L, False, name, "vertical", 32, 4)
