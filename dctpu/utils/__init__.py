"""Utilities: device timing, run metrics, tracing."""

from dctpu.utils.timing import device_time  # noqa: F401
from dctpu.utils.metrics import RunMetrics  # noqa: F401
