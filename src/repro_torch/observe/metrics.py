"""Latency percentiles, copied from ``repro/observe/metrics.py`` so every
p50/p99 figure of the port is computed as the reference's are."""
from __future__ import annotations

from typing import Dict, Iterable, Sequence


def latency_percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ASCENDING sample; NaN on empty
    input."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize_latencies(latencies: Iterable[float]) -> Dict[str, float]:
    """``{count, p50, p99, max, mean}`` of any iterable of numbers
    (milliseconds by convention); NaN statistics on empty input."""
    vals = sorted(float(v) for v in latencies)
    if not vals:
        nan = float("nan")
        return {"count": 0, "p50": nan, "p99": nan, "max": nan, "mean": nan}
    return {
        "count": len(vals),
        "p50": latency_percentile(vals, 0.50),
        "p99": latency_percentile(vals, 0.99),
        "max": vals[-1],
        "mean": float(sum(vals) / len(vals)),
    }
