"""Observability (``repro/observe``): measure, never act.

A counter/gauge/histogram registry with monotonic-clock span timers and a
strict-JSON JSONL sink (``metrics``), plus two emitters:

* ``TrainTelemetry`` (``train_hooks``): one ``train_iter`` record per
  ``TrainSession`` iteration — tokens/sec, per-row non-zeros of the live
  counts (counted on the card), the padded-row widths and the eval
  metrics of that iteration;
* ``ServeTelemetry`` (``serve_hooks``): windowed ``serve_window`` records
  of an ``LDAEngine``'s arrivals, queueing and latencies.

While a torch profiler records, the training step's spans and kernels'
work counters gather by name, and ``trace_totals()`` reads them (``span``,
``tracing``; ``metrics``).

The deciding half is ``repro_torch.autotune``.
"""
from repro_torch.observe.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    JsonlSink,
    MetricsRegistry,
    SpanTimer,
    latency_percentile,
    nnz_row_stats,
    span,
    summarize_latencies,
    trace_totals,
    tracing,
)
from repro_torch.observe.serve_hooks import ServeTelemetry  # noqa: F401
from repro_torch.observe.train_hooks import TrainTelemetry  # noqa: F401
