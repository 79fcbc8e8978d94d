"""Compile-cache placement, the multihost initializer's device choice, and
host-clock timing."""

from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from dctpu.utils import compile_cache
from dctpu.utils.timing import device_time

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_config():
    """Restore the process-wide cache settings the test changes."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_defaults_to_repo_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("DCTPU_NO_COMPILE_CACHE", raising=False)
    path = compile_cache.enable_compilation_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_env_dir_is_left_to_jax(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("DCTPU_NO_COMPILE_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    # no directory set in code: whatever JAX holds is untouched
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_opt_out(monkeypatch, cache_config):
    monkeypatch.setenv("DCTPU_NO_COMPILE_CACHE", "1")
    assert compile_cache.enable_compilation_cache() is None


@pytest.mark.parametrize("ids", [None, [2]])
def test_initialize_passes_local_device_ids(monkeypatch, ids):
    from dctpu.dist import multihost

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    multihost.initialize("localhost:1234", 4, 2, local_device_ids=ids)
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": ids}


def test_initialize_tolerates_repeat(monkeypatch):
    from dctpu.dist import multihost

    def again(**kw):
        raise RuntimeError("distributed.initialize should only be called "
                           "once; already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", again)
    multihost.initialize("localhost:1234", 2, 0)


def test_device_time_waits_for_every_leaf():
    calls = []

    def f():
        calls.append(1)
        return {"a": jnp.ones(4) * 2, "b": [jnp.arange(3)]}

    t, out = device_time(f, reps=3, warmup=2)
    assert len(calls) == 5 and t >= 0
    assert float(out["a"][0]) == 2.0
