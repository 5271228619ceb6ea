"""Shared latency math (``repro/observe/metrics.py``)."""
from repro_torch.observe.metrics import (  # noqa: F401
    latency_percentile,
    summarize_latencies,
)
