"""Device timing: host clock around work that ends in block_until_ready.

JAX dispatches asynchronously, so a timing that does not wait for the
outputs measures only the enqueue. Every helper here waits on all leaves of
the result before reading the clock.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax


def device_time(
    f: Callable, reps: int = 3, warmup: int = 1
) -> Tuple[float, object]:
    """(median wall seconds per call of f(), last output).

    Warm-up calls absorb compilation; each timed call ends in
    jax.block_until_ready on every leaf of the output.
    """
    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(f())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def trace(path: str):
    """Context manager: jax.profiler trace into `path` (view in TensorBoard)."""
    return jax.profiler.trace(path)
