"""Kernel backend dispatch: the one table of backend names.

Backends implement the identical interface and are cross-tested for
bit-identical output (SURVEY.md §4 "Kernel" tier). Selection: explicit
argument or the DCTPU_KERNEL_BACKEND env var. Every stage is plain XLA;
the names choose between formulations of the Rice pack and unpack only.
The encode-side names are accepted by every encode entry point (select,
emit, encode) and the decode-side names by decode; any other name raises
ValueError.
"""

from __future__ import annotations

import os

from dctpu.kernels.pack_xla import pack_xla
from dctpu.kernels.unpack_xla import unpack_xla

# "auto" and "xla" resolve to the chunked-scan packer / shift-buffer scan.
PACK_BACKENDS = ("auto", "xla", "scan", "merge", "scatter")
UNPACK_BACKENDS = ("auto", "scan", "scan_xla", "xla")


def default_backend() -> str:
    return os.environ.get("DCTPU_KERNEL_BACKEND", "auto")


def check_backend(backend: str, names=PACK_BACKENDS) -> str:
    """Return `backend` if it is one of `names`, else raise ValueError."""
    if backend not in names:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {names}"
        )
    return backend


def pack(code_lo, code_hi, length, valid, block_len: int, backend: str | None = None):
    backend = check_backend(backend or default_backend(), PACK_BACKENDS)
    if backend in ("auto", "xla", "scan"):
        # chunked-scan packer: bit-identical to pack_xla/pack_merge, same
        # dense-funnel math, but the bottom 4 merge levels are a lax.scan so
        # HLO size (and compile time) no longer grows with B — pack_merge
        # compiled for minutes at B=8192 (round-1 VERDICT weak #3).
        from dctpu.kernels.pack_scan import pack_scan

        return pack_scan(code_lo, code_hi, length, valid, block_len)
    if backend == "merge":
        from dctpu.kernels.pack_merge import pack_merge

        return pack_merge(code_lo, code_hi, length, valid, block_len)
    return pack_xla(code_lo, code_hi, length, valid, block_len)


def unpack(
    payload,
    k,
    n,
    block_len: int,
    backend: str | None = None,
    buf_words: int = 0,
):
    backend = check_backend(backend or default_backend(), UNPACK_BACKENDS)
    if backend == "xla":
        return unpack_xla(payload, k, n, block_len)
    # gather-free shift-buffer decode; expects stage_rice_scan rows and a
    # static per-batch buffer bucket (host-derived from the sync tables).
    from dctpu.kernels.unpack_scan import unpack_scan

    return unpack_scan(payload, k, n, block_len, buf_words)
