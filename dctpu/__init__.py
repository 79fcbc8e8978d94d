"""dctpu — lossless codec for smart-meter load-profile time series, in JAX.

A from-scratch JAX/XLA re-design of the capability set of
CenterForSecureEnergyInformatics/data-compressor (serial C reference; see
SURVEY.md): delta / double-delta / linear-predictive residual coding, zigzag
mapping, Golomb-Rice entropy coding with escape codes, and a block-parallel
frame format (docs/FORMAT.md) designed for data-parallel encode/decode across
accelerators. Its device is an NVIDIA GPU (H100); the tests run on the CPU.

Layers (SURVEY.md §1):
  format/  — canonical DCF1 frame serializer (host, numpy)
  codec/   — scalar reference codec + jitted XLA encode/decode
  kernels/ — bit pack/unpack, vertical coder, ragged compaction (plain XLA)
  dist/    — mesh setup, shard_map data parallelism, multi-host gather
  corpus/  — synthetic load-profile generator
  cli/     — `dcomp` command line driver
"""

import jax

# The codec needs explicit 64-bit integers (LPC accumulates in wrapping int64).
# All arrays in this package carry explicit dtypes, so enabling x64 does not
# change any computation — it only unlocks the int64/uint64 dtypes.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: a process that meets a program geometry
# already compiled loads it. Opt out with DCTPU_NO_COMPILE_CACHE=1 (see
# dctpu/utils/compile_cache.py).
from dctpu.utils.compile_cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from dctpu.constants import (  # noqa: E402,F401
    BLOCK_LEN_DEFAULT,
    DELTA,
    DOUBLE_DELTA,
    ESCAPE_Q,
    K_MAX,
    LPC,
    MAX_CODE_BITS,
    RAW_BITS,
)
from dctpu.config import CodecConfig, DEFAULT_LPC_TABLES, LpcTable  # noqa: E402,F401

__version__ = "0.1.0"
