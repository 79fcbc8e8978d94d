"""Persistent XLA compilation cache.

Enabled from dctpu/__init__ for every consumer (CLI, bench, chip_smoke.py,
tests), so a process that compiles a program geometry the cache already
holds loads it instead. Controls:

  DCTPU_NO_COMPILE_CACHE=1      opt out entirely
  JAX_COMPILATION_CACHE_DIR     when set, JAX reads it itself and this
                                module sets no directory

Otherwise the cache lives at the fixed in-checkout path <repo>/.jax_cache
(listed in .gitignore). The path is part of what makes a cache hit
possible, so it never moves with HOME or the working directory.

The cache is keyed by HLO + compile options + backend, so CPU test
processes and GPU runs coexist in one directory, and concurrent writers
(pytest-xdist) are safe: entries are written atomically.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str | None:
    """Point JAX at the persistent cache dir. Returns the dir (None if off)."""
    if os.environ.get("DCTPU_NO_COMPILE_CACHE"):
        return None
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything: the default thresholds skip small/fast programs,
    # and the codec compiles many small geometry variants.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
