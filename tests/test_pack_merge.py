"""pack_merge (dense hierarchical-merge packer) == pack_xla, bit for bit.

Kernel-tier cross-test (SURVEY.md §4): the scatter-OR packer is the spec;
the merge packer must reproduce its payload words exactly, including sync
table, zero padding, escapes, and partial blocks.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dctpu.codec import rice
from dctpu.kernels.pack_merge import pack_merge
from dctpu.kernels.pack_xla import pack_xla
from dctpu.kernels.unpack_xla import unpack_xla


def _pack_both(z, k, n, L):
    valid = jnp.asarray(np.arange(L)[None, :] < n[:, None])
    lo, hi, ln = rice.codewords(jnp.asarray(z), jnp.asarray(k))
    ref = pack_xla(lo, hi, ln, valid, L)
    got = pack_merge(lo, hi, ln, valid, L)
    return ref, got


@pytest.mark.parametrize("L", [1, 7, 128, 256, 1000, 4096])
def test_merge_matches_scatter(L):
    rng = np.random.default_rng(42 + L)
    B = 16
    z = rng.integers(0, 50, size=(B, L)).astype(np.uint32)
    z[rng.random((B, L)) < 0.05] = 0xFFFFFFF0  # escapes
    k = rng.integers(0, 8, size=(B, 1)).astype(np.int32)
    n = rng.integers(0, L + 1, size=(B,)).astype(np.int32)
    n[0], n[1 % B] = L, 0
    (p1, b1), (p2, b2) = _pack_both(z, k, n, L)
    assert np.array_equal(np.asarray(b1), np.asarray(b2))
    assert np.array_equal(np.asarray(p1), np.asarray(p2))


@pytest.mark.parametrize("L", [1, 7, 128, 256, 1000, 4096])
def test_scan_matches_scatter(L):
    from dctpu.kernels.pack_scan import pack_scan

    rng = np.random.default_rng(142 + L)
    B = 16
    z = rng.integers(0, 50, size=(B, L)).astype(np.uint32)
    z[rng.random((B, L)) < 0.05] = 0xFFFFFFF0  # escapes
    k = rng.integers(0, 8, size=(B, 1)).astype(np.int32)
    n = rng.integers(0, L + 1, size=(B,)).astype(np.int32)
    n[0], n[1 % B] = L, 0
    valid = jnp.asarray(np.arange(L)[None, :] < n[:, None])
    lo, hi, ln = rice.codewords(jnp.asarray(z), jnp.asarray(k))
    p1, b1 = pack_xla(lo, hi, ln, valid, L)
    p2, b2 = pack_scan(lo, hi, ln, valid, L)
    assert np.array_equal(np.asarray(b1), np.asarray(b2))
    assert np.array_equal(np.asarray(p1), np.asarray(p2))


def test_merge_roundtrip_through_unpack():
    rng = np.random.default_rng(7)
    B, L = 8, 512
    z = rng.integers(0, 1 << 20, size=(B, L)).astype(np.uint32)
    k = np.full((B, 1), 9, np.int32)
    n = np.full((B,), L, np.int32)
    (_, _), (p2, _) = _pack_both(z, k, n, L)
    pad = jnp.pad(p2, ((0, 0), (0, 2)))
    out = unpack_xla(pad, jnp.asarray(k[:, 0]), jnp.asarray(n), L)
    assert np.array_equal(np.asarray(out), z)


def test_scan_batch_mapping(monkeypatch):
    """lax.map chunking (BATCH_ROWS) is bit-identical to the direct path."""
    from dctpu.kernels import pack_scan as ps

    rng = np.random.default_rng(9)
    B, L = 20, 256
    z = rng.integers(0, 500, size=(B, L)).astype(np.uint32)
    k = rng.integers(0, 6, size=(B, 1)).astype(np.int32)
    valid = jnp.ones((B, L), bool)
    lo, hi, ln = rice.codewords(jnp.asarray(z), jnp.asarray(k))
    p1, b1 = ps.pack_scan(lo, hi, ln, valid, L)  # direct (B < BATCH_ROWS)
    monkeypatch.setattr(ps, "BATCH_ROWS", 8)
    p2, b2 = ps.pack_scan(lo, hi, ln, valid, L)  # mapped, 3 chunks
    assert np.array_equal(np.asarray(p1), np.asarray(p2))
    assert np.array_equal(np.asarray(b1), np.asarray(b2))

