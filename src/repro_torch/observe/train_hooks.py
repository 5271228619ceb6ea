"""TrainSession telemetry: the per-iteration ``train_iter`` emitter
(``repro/observe/train_hooks.py``).

``TrainTelemetry.record_iteration`` is called by the session's
``telemetry`` schedule action (registered only when
``RunConfig.metrics_out``/``autopilot`` is set) and turns one finished
iteration into one JSONL record:

* throughput — tokens/sec from monotonic-clock deltas between records,
  stamped after a ``torch.cuda.synchronize`` on the plan's device, so the
  delta covers the work the card did and not only its launch queue;
* sparsity — row-nnz summaries of the LIVE counts (``nnz_row_stats`` of
  N_w|k and N_k|d), counted on the card: only the per-row counts (one
  int32 per word and per document) cross to the host;
* capacity — the padded-row widths in effect;
* quality — whatever the eval action already computed this iteration
  (llh / perplexity / change_rate), merged without a second pass.

A bounded deque of recent records is the window the
``repro_torch.autotune.TrainAutopilot`` consumes; this module never
decides.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional

import torch

from repro_torch.observe.metrics import MetricsRegistry, nnz_row_stats


class TrainTelemetry:
    """Per-iteration measurement hook for a ``TrainSession``.

    Args:
        registry: the metrics registry (its sink receives the JSONL).
        window: how many recent iteration records to retain for the
            autopilot's decision window.
        nnz_every: compute the row-nnz summaries every N records; other
            records carry the last-known stats.
    """

    def __init__(self, registry: MetricsRegistry, window: int = 32,
                 nnz_every: int = 1):
        self.registry = registry
        self.records: Deque[Dict[str, Any]] = collections.deque(maxlen=window)
        self.nnz_every = max(1, int(nnz_every))
        self._n_records = 0
        self._t_last: Optional[float] = None
        self._last_nnz: Dict[str, Dict[str, float]] = {}

    # -- the hook ------------------------------------------------------------
    def record_iteration(self, plan, state, iteration: int,
                         metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Measure one finished iteration; emit and retain the record.

        ``plan`` is the session's ``SingleBoxPlan`` (``num_tokens``,
        ``row_pads``, ``backend``, ``device``); ``metrics`` is the
        schedule's per-iteration dict (holding the eval results when the
        eval action fired)."""
        self._n_records += 1
        if self._n_records % self.nnz_every == 0 or not self._last_nnz:
            self._last_nnz = {
                "word_rows": nnz_row_stats(state.n_wk),
                "doc_rows": nnz_row_stats(state.n_kd),
            }
        if plan.device.type == "cuda":
            torch.cuda.synchronize(plan.device)
        t_now = time.monotonic()
        dt = None if self._t_last is None else t_now - self._t_last
        self._t_last = t_now
        kw, kd = plan.row_pads
        rec: Dict[str, Any] = {
            "kind": "train_iter",
            "iteration": int(iteration),
            "backend": plan.backend.name,
            "dt_s": dt,
            "tokens_per_s": (plan.num_tokens / dt) if dt else None,
            "row_pads": {"max_kw": int(kw), "max_kd": int(kd)},
            "word_rows": self._last_nnz["word_rows"],
            "doc_rows": self._last_nnz["doc_rows"],
        }
        for k in ("llh", "perplexity", "change_rate"):
            if k in metrics:
                rec[k] = float(metrics[k])
        self.records.append(rec)
        self.registry.gauge("train.tokens_per_s").set(rec["tokens_per_s"])
        self.registry.counter("train.iterations").inc()
        self.registry.emit(rec)
        return rec

    # -- the autopilot's view --------------------------------------------------
    def window(self) -> List[Dict[str, Any]]:
        return list(self.records)

    def emit_decision(self, record: Dict[str, Any]) -> None:
        """Log one applied (or rejected) autopilot decision."""
        self.registry.counter("train.decisions").inc()
        self.registry.emit(record)
