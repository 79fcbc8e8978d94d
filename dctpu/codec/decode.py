"""Jitted block-batch decoder: packed payloads + headers -> [B, L] samples.

Fully parallel across blocks (SURVEY.md §3 E2): the frame's per-block headers
and the word-offset prefix sum let every block start decoding independently —
the property the whole format is designed around.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dctpu.codec import predict, rice
from dctpu.kernels import api as kernels


def decode_blocks_body(
    payload: jnp.ndarray,       # [B, Wp] u32 (>=2 words zero padding per row)
    k: jnp.ndarray,             # [B] i32
    n: jnp.ndarray,             # [B] i32
    predictor: jnp.ndarray,     # [B] i32
    table_idx: jnp.ndarray,     # [B] i32
    history: jnp.ndarray,       # [B, 4] i32
    table_coeffs: jnp.ndarray,  # [T, 4] i64
    block_len: int,
    has_lpc: bool,
    backend: str = "xla",
    coder: str = "rice",
    max_planes: int = 32,
    buf_words: int = 0,
) -> jnp.ndarray:
    kernels.check_backend(backend, kernels.UNPACK_BACKENDS)
    if coder == "vertical":
        from dctpu.kernels.vertical_xla import decode_vertical

        z = decode_vertical(payload, n, block_len, max_planes)
    else:
        z = kernels.unpack(
            payload, k, n, block_len, backend, buf_words
        )  # [B, L] u32
    r = rice.unzigzag(z)
    x = predict.reconstruct_all(
        r, history, predictor, table_coeffs, table_idx, has_lpc
    )
    valid = jnp.arange(block_len, dtype=jnp.int32)[None, :] < n[:, None]
    return jnp.where(valid, x, 0)


decode_blocks = jax.jit(
    decode_blocks_body,
    static_argnames=(
        "block_len",
        "has_lpc",
        "backend",
        "coder",
        "max_planes",
        "buf_words",
    ),
)
