"""Vectorized predictor stage over [num_blocks, block_len] arrays.

Array design (SURVEY.md §2.1): the reference's per-sample C loops become
whole-array shift/subtract ops for the forward pass (all predictors — including
LPC — are vectorizable at encode time because the true history is available),
and scan-based reconstruction for decode:

  - DELTA / DOUBLE_DELTA decode = wrapping-int32 prefix sums (associative, so
    XLA parallelizes them; the codec's analog of sequence parallelism).
  - LPC decode is a true recurrence (fixed-point shift is not associative); it
    runs as one lax.scan over the block axis — sequential within a block,
    parallel across all blocks [B:5 "delta→scan-based parallel prediction"].

All arithmetic wraps in int32 (int64 for the LPC accumulator) per
docs/FORMAT.md §3, keeping every predictor exactly invertible. A GPU
emulates int64 on its 32-bit integer units; the results stay exact.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from dctpu.config import CodecConfig
from dctpu.constants import DELTA, DOUBLE_DELTA, LPC, LPC_SHIFT


def _shift_right_one(x: jnp.ndarray, fill: jnp.ndarray) -> jnp.ndarray:
    """[B, L] -> [B, L] with column t holding input column t-1; col 0 = fill."""
    return jnp.concatenate([fill[:, None], x[:, :-1]], axis=1)


def _lagged(x: jnp.ndarray, history: jnp.ndarray, lags: int):
    """Returns [x_{t-1}, ..., x_{t-lags}] views, each [B, L]."""
    outs = []
    prev = x
    for j in range(lags):
        prev = _shift_right_one(prev, history[:, j])
        outs.append(prev)
    return outs


def lpc_predict_encode(x: jnp.ndarray, history: jnp.ndarray, coeffs) -> jnp.ndarray:
    """Vectorized LPC prediction from true samples (encode side). int32 out."""
    lagged = _lagged(x, history, 4)
    acc = jnp.zeros(x.shape, dtype=jnp.int64)
    for j, c in enumerate(coeffs):
        if int(c) != 0:
            acc = acc + jnp.int64(int(c)) * lagged[j].astype(jnp.int64)
    return (acc >> LPC_SHIFT).astype(jnp.int32)


def residuals_for_candidate(
    x: jnp.ndarray, history: jnp.ndarray, predictor: int, coeffs
) -> jnp.ndarray:
    """Forward residuals [B, L] for one (predictor, table) candidate."""
    if predictor == DELTA:
        return x - _shift_right_one(x, history[:, 0])
    if predictor == DOUBLE_DELTA:
        x1 = _shift_right_one(x, history[:, 0])
        x2 = _shift_right_one(x1, history[:, 1])
        return x - x1 - x1 + x2
    if predictor == LPC:
        return x - lpc_predict_encode(x, history, coeffs)
    raise ValueError(f"unknown predictor {predictor}")


def all_candidate_residuals(
    x: jnp.ndarray, history: jnp.ndarray, cfg: CodecConfig
) -> jnp.ndarray:
    """[C, B, L] residuals for every candidate in normative order."""
    outs = []
    for pred, ti in cfg.candidates():
        coeffs = cfg.lpc_tables[ti].coeffs if pred == LPC else None
        outs.append(residuals_for_candidate(x, history, pred, coeffs))
    return jnp.stack(outs, axis=0)


# ------------------------------------------------------------------ decode


def reconstruct_delta(r: jnp.ndarray, history: jnp.ndarray) -> jnp.ndarray:
    return jnp.cumsum(r, axis=1) + history[:, 0:1]


def reconstruct_double_delta(r: jnp.ndarray, history: jnp.ndarray) -> jnp.ndarray:
    d0 = history[:, 0:1] - history[:, 1:2]
    d = jnp.cumsum(r, axis=1) + d0
    return jnp.cumsum(d, axis=1) + history[:, 0:1]


def reconstruct_lpc(
    r: jnp.ndarray, history: jnp.ndarray, coeffs_per_block: jnp.ndarray
) -> jnp.ndarray:
    """LPC recurrence: chunked scan over the sample axis, vectorized over blocks.

    r: [B, L] int32; history: [B, 4] int32; coeffs_per_block: [B, 4] int64
    (already gathered from the table via each block's table_idx).

    The recurrence is sequential (the Q16 floor shift is not associative), but
    scan-step overhead dominates at one sample per step, so each step advances
    CHUNK samples with an unrolled body (identical wrapping-i64 arithmetic, so
    the result is bit-identical to the one-sample scan). History rides as four
    separate [B] lanes to avoid per-step concat materialization.
    """
    B, L = r.shape
    chunk = 32
    while L % chunk:
        chunk //= 2
    c0, c1, c2, c3 = (coeffs_per_block[:, j] for j in range(4))

    def step(hist, r_c):
        h0, h1, h2, h3 = hist
        outs = []
        for t in range(r_c.shape[0]):
            acc = (
                c0 * h0.astype(jnp.int64)
                + c1 * h1.astype(jnp.int64)
                + c2 * h2.astype(jnp.int64)
                + c3 * h3.astype(jnp.int64)
            )
            x_t = r_c[t] + (acc >> LPC_SHIFT).astype(jnp.int32)
            h0, h1, h2, h3 = x_t, h0, h1, h2
            outs.append(x_t)
        return (h0, h1, h2, h3), jnp.stack(outs)

    hist0 = tuple(history[:, j] for j in range(4))
    rT = r.T.reshape(L // chunk, chunk, B)
    _, xs = jax.lax.scan(step, hist0, rT)  # [L/chunk, chunk, B]
    return xs.reshape(L, B).T


def reconstruct_all(
    r: jnp.ndarray,
    history: jnp.ndarray,
    predictor: jnp.ndarray,
    table_coeffs: jnp.ndarray,
    table_idx: jnp.ndarray,
    has_lpc: bool,
) -> jnp.ndarray:
    """Per-block predictor dispatch (decode). table_coeffs: [T, 4] int64."""
    x_delta = reconstruct_delta(r, history)
    x_dd = reconstruct_double_delta(r, history)
    x = jnp.where((predictor == DELTA)[:, None], x_delta, x_dd)
    if has_lpc:
        coeffs = table_coeffs[table_idx]  # [B, 4]
        x_lpc = reconstruct_lpc(r, history, coeffs)
        x = jnp.where((predictor == LPC)[:, None], x_lpc, x)
    return x
