"""Test configuration: CPU backend with 8 fake devices (SURVEY.md §4).

Must set env vars BEFORE jax initializes a backend in the test process.
"""

import os

# Force CPU with 8 fake devices, before any backend is initialized, so it
# holds even where a GPU is visible. DCTPU_TESTS_ON_GPU=1 leaves the platform
# to JAX, for the gpu-marked tests (tests/test_chip.py) on a card.
ON_GPU = bool(os.environ.get("DCTPU_TESTS_ON_GPU"))
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def stream_cases(rng, max_len=9000):
    """Adversarial stream shapes shared across round-trip tests."""
    cases = [
        np.zeros(1, dtype=np.int32),
        np.zeros(5, dtype=np.int32),
        np.arange(100, dtype=np.int32),
        np.full(4096, 7, dtype=np.int32),
        np.arange(4097, dtype=np.int32) * 3 - 5000,
        rng.integers(-(2**31), 2**31, size=300, dtype=np.int64).astype(np.int32),
        np.array([2**31 - 1, -(2**31), 0, -1, 1] * 50, dtype=np.int32),
        (rng.normal(0, 3, size=max_len)).astype(np.int32),
    ]
    # spiky load-profile-like
    base = (500 + 200 * np.sin(np.arange(5000) / 96 * 2 * np.pi)).astype(np.int32)
    spikes = (rng.random(5000) < 0.01) * rng.integers(0, 3000, size=5000)
    cases.append((base + spikes).astype(np.int32))
    return cases
