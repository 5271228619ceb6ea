"""LDAEngine telemetry: the per-tick ``serve_window`` emitter
(``repro/observe/serve_hooks.py``).

The engine stamps every request (``t_submit``/``t_done`` monotonic stamps,
``ticks_waited``); this hook aggregates those stamps and the per-tick
queue/bucket state into *windowed* summary records — one JSONL line per
window, not per tick. A window closes after ``window_ticks`` admission
ticks or ``window_arrivals`` arrivals, whichever first.

Every ``serve_window`` record carries the measured arrival process
(inter-arrival times), queueing state (depth, slot occupancy, spills,
ticks waited), the end-to-end latency summary of the requests that
finished inside the window, and the knob values in effect — the inputs
``repro_torch.autotune.ServeAutopilot`` derives ``tick_period`` /
``max_slot_wait`` / bucket widths from. All entry points are called by
the engine UNDER its lock; no locking here. The summaries are host
arithmetic on host stamps, equal to the reference's on the same ticks.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.observe.metrics import (
    MetricsRegistry,
    latency_percentile,
    summarize_latencies,
)


class ServeTelemetry:
    """Windowed measurement hook for an ``LDAEngine``.

    Args:
        registry: the metrics registry (its sink receives the JSONL).
        window_ticks: close a window after this many admission ticks.
        window_arrivals: ... or after this many arrivals, whichever first.
    """

    def __init__(self, registry: MetricsRegistry, window_ticks: int = 256,
                 window_arrivals: int = 64):
        self.registry = registry
        self.window_ticks = max(1, int(window_ticks))
        self.window_arrivals = max(1, int(window_arrivals))
        self.last_window: Optional[Dict[str, Any]] = None
        self._reset_window()
        self._prev_arrival_t: Optional[float] = None
        self._windows_emitted = 0

    def _reset_window(self) -> None:
        self._ticks = 0
        self._interarrivals_ms: List[float] = []
        self._doc_lens: List[int] = []
        self._latencies_ms: List[float] = []
        self._wait_ticks: List[int] = []
        self._queue_depths: List[int] = []
        self._occupancies: List[int] = []
        self._spills_at_open: Optional[int] = None

    # -- submit-side --------------------------------------------------------
    def record_submit(self, t_submit: float, doc_len: int) -> None:
        """One arrival (engine ``_submit``, under the engine lock)."""
        if self._prev_arrival_t is not None:
            self._interarrivals_ms.append(
                (t_submit - self._prev_arrival_t) * 1e3)
        self._prev_arrival_t = t_submit
        self._doc_lens.append(int(doc_len))
        self.registry.counter("serve.arrivals").inc()

    # -- tick-side ----------------------------------------------------------
    def record_tick(
        self,
        *,
        queue_depth: int,
        occupancy: int,
        finished: Sequence,
        spills_total: int,
        tick_period: float,
        max_slot_wait: int,
        bucket_widths: Sequence[int],
        model_version: int,
    ) -> Optional[Dict[str, Any]]:
        """One admission tick (engine ``step``, under the engine lock).

        ``finished`` are the ``InferRequest``s this tick completed
        (``t_submit``/``t_done``/``ticks_waited`` are read off them);
        ``spills_total`` is the engine's cumulative spill counter — the
        window reports the delta. Returns the closed window's summary
        record when this tick closed one, else None.
        """
        self._ticks += 1
        if self._spills_at_open is None:
            self._spills_at_open = int(spills_total)
        self._queue_depths.append(int(queue_depth))
        self._occupancies.append(int(occupancy))
        for req in finished:
            if req.t_done and req.t_submit:
                self._latencies_ms.append((req.t_done - req.t_submit) * 1e3)
            self._wait_ticks.append(int(req.ticks_waited))
        self.registry.gauge("serve.queue_depth").set(queue_depth)
        self.registry.gauge("serve.occupancy").set(occupancy)
        if (self._ticks < self.window_ticks
                and len(self._doc_lens) < self.window_arrivals):
            return None
        return self._close_window(
            spills_total=int(spills_total),
            tick_period=tick_period,
            max_slot_wait=max_slot_wait,
            bucket_widths=bucket_widths,
            model_version=model_version,
        )

    def _close_window(self, *, spills_total: int, tick_period: float,
                      max_slot_wait: int, bucket_widths: Sequence[int],
                      model_version: int) -> Dict[str, Any]:
        inter = sorted(self._interarrivals_ms)
        waits = sorted(self._wait_ticks)
        depths = self._queue_depths
        occ = self._occupancies
        self._windows_emitted += 1
        rec: Dict[str, Any] = {
            "kind": "serve_window",
            "window": self._windows_emitted,
            "ticks": self._ticks,
            "arrivals": len(self._doc_lens),
            "finished": len(self._wait_ticks),
            "interarrival_ms": summarize_latencies(inter),
            "latency_ms": summarize_latencies(self._latencies_ms),
            "doc_len": summarize_latencies(self._doc_lens),
            "queue_depth": {
                "mean": float(np.mean(depths)) if depths else 0.0,
                "max": int(max(depths)) if depths else 0,
            },
            "occupancy": {
                "mean": float(np.mean(occ)) if occ else 0.0,
                "max": int(max(occ)) if occ else 0,
            },
            "wait_ticks_p90": (latency_percentile(waits, 0.90)
                               if waits else 0.0),
            "wait_ticks_max": int(max(waits)) if waits else 0,
            "spills": spills_total - (self._spills_at_open or 0),
            "knobs": {
                "tick_period": tick_period,
                "max_slot_wait": int(max_slot_wait),
                "buckets": [int(b) for b in bucket_widths],
            },
            "model_version": int(model_version),
        }
        self.registry.counter("serve.windows").inc()
        self.registry.emit(rec)
        self.last_window = rec
        self._reset_window()
        return rec

    # -- decisions ------------------------------------------------------------
    def emit_decision(self, record: Dict[str, Any]) -> None:
        """Log one applied (or rejected) autopilot decision."""
        self.registry.counter("serve.decisions").inc()
        self.registry.emit(record)

    def emit_router_loads(self, loads: Sequence[int]) -> None:
        """Per-replica load snapshot (``LDARouter`` admission balance)."""
        self.registry.emit({
            "kind": "router_load",
            "loads": [int(x) for x in loads],
            "total": int(sum(loads)),
        })
