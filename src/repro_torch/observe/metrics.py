"""Counter/gauge/histogram registry, span timers and the JSONL sink
(``repro/observe/metrics.py``; the port keeps its own copy).

Everything is in-process and serializable as one JSON object per line, so
a run's telemetry is a file you can grep. Every record is one flat JSON
object with

* ``t``    — wall-clock seconds (``time.time()``; durations use the
  monotonic clock),
* ``kind`` — the record type (``train_iter`` | ``serve_window`` |
  ``decision`` | ``span`` | ``snapshot``),
* kind-specific payload fields (the emitters in
  ``repro_torch.observe.train_hooks`` / ``repro_torch.observe.serve_hooks``
  and the decision records of ``repro_torch.autotune.policy``).

``latency_percentile`` is the nearest-rank percentile every p50/p99 figure
of the port comes through, and ``summarize_latencies`` the shared
p50/p99/max/mean summary. ``nnz_row_stats`` also takes a tensor: the
per-row non-zeros are counted on its device and only they (one int32 per
row) cross to the host.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# shared latency math
# ---------------------------------------------------------------------------

def latency_percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ASCENDING sample.

    THE percentile definition for latency reporting — every p50/p99
    figure in the repo comes through here, so numbers from the serving
    CLI, the benchmarks, and the telemetry windows are comparable.
    Returns NaN on empty input.
    """
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def summarize_latencies(latencies: Iterable[float]) -> Dict[str, float]:
    """The one shared latency summary: ``{count, p50, p99, max, mean}``.

    Accepts any iterable of numbers in any order (callers pass
    milliseconds by convention); sorts once and applies the nearest-rank
    ``latency_percentile``. Empty input yields ``count=0`` and NaN
    statistics; a single element is its own p50/p99/max/mean — the edge
    cases ``tests/test_observe.py`` pins with known answers.
    """
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


def nnz_row_stats(counts) -> Dict[str, float]:
    """Row-sparsity summary of a (R, K) count matrix: per-row nnz
    mean/p50/p99/max plus K — the measured ``K_w``/``K_d`` the hybrid
    decomposition argument (paper §3.2) and the autopilot's backend
    re-pick run on. A tensor is counted on its own device; the host then
    applies the reference's numpy statistics to the per-row counts, so
    the dict equals the reference's on the same counts."""
    if isinstance(counts, torch.Tensor):
        num_topics = int(counts.shape[-1])
        nnz = (counts > 0).sum(-1, dtype=torch.int32).cpu().numpy()
        nnz = nnz.astype(np.int64)
    else:
        counts = np.asarray(counts)
        num_topics = int(counts.shape[-1])
        nnz = np.count_nonzero(counts > 0, axis=-1)
    if nnz.size == 0:
        nan = float("nan")
        return {"mean": nan, "p50": nan, "p99": nan, "max": 0,
                "num_topics": num_topics}
    return {
        "mean": float(nnz.mean()),
        "p50": float(np.percentile(nnz, 50)),
        "p99": float(np.percentile(nnz, 99)),
        "max": int(nnz.max()),
        "num_topics": num_topics,
    }


# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count (events, spills, decisions)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "counter", "name": self.name, "value": self.value}


class Gauge:
    """Last-written value (queue depth, row pads, tick period)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": "gauge", "name": self.name, "value": self.value}


class Histogram:
    """Fixed-bound histogram plus running count/sum/min/max.

    ``bounds`` are the inclusive upper edges of each bucket; values above
    the last bound land in a final overflow bucket, so ``counts`` has
    ``len(bounds) + 1`` entries. ``observe_array`` bulk-bins a numpy
    array (the row-nnz path) without a Python loop.
    """

    def __init__(self, name: str, bounds: Sequence[float]):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name!r}: bounds must be "
                             f"non-empty ascending, got {bounds!r}")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float, n: int = 1) -> None:
        i = int(np.searchsorted(self.bounds, v, side="left"))
        self.counts[i] += n
        self.count += n
        self.sum += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def observe_array(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(self.bounds, arr, side="left")
        binned = np.bincount(idx, minlength=len(self.counts))
        for i, n in enumerate(binned):
            self.counts[i] += int(n)
        self.count += int(arr.size)
        self.sum += float(arr.sum())
        lo, hi = float(arr.min()), float(arr.max())
        self.min = lo if self.min is None else min(self.min, lo)
        self.max = hi if self.max is None else max(self.max, hi)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "kind": "histogram", "name": self.name,
            "bounds": list(self.bounds), "counts": list(self.counts),
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
        }


class SpanTimer:
    """Monotonic-clock span: ``with registry.timer("jit_rebuild"): ...``
    records the wall duration (seconds) into a histogram and, when the
    registry has a sink, emits one ``kind="span"`` record per exit."""

    def __init__(self, hist: Histogram, emit=None):
        self._hist = hist
        self._emit = emit
        self._t0: Optional[float] = None
        self.last: Optional[float] = None

    def __enter__(self) -> "SpanTimer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.last = time.monotonic() - self._t0
        self._hist.observe(self.last)
        if self._emit is not None:
            self._emit({"kind": "span", "name": self._hist.name,
                        "seconds": self.last})


# default span-duration bounds: 100us .. ~2min, roughly x4 apart
_SPAN_BOUNDS = (1e-4, 4e-4, 1.6e-3, 6.4e-3, 2.56e-2, 0.1, 0.4, 1.6, 6.4,
                25.6, 102.4)


class MetricsRegistry:
    """Name-unique metric store + optional sink. Thread-safe: the engine
    and its background ticker share one registry."""

    def __init__(self, sink: Optional["JsonlSink"] = None):
        self.sink = sink
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        m = self._get(name, lambda: Counter(name))
        if not isinstance(m, Counter):
            raise TypeError(f"metric {name!r} is {type(m).__name__}")
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._get(name, lambda: Gauge(name))
        if not isinstance(m, Gauge):
            raise TypeError(f"metric {name!r} is {type(m).__name__}")
        return m

    def histogram(self, name: str,
                  bounds: Sequence[float] = _SPAN_BOUNDS) -> Histogram:
        m = self._get(name, lambda: Histogram(name, bounds))
        if not isinstance(m, Histogram):
            raise TypeError(f"metric {name!r} is {type(m).__name__}")
        return m

    def timer(self, name: str) -> SpanTimer:
        return SpanTimer(self.histogram(name), emit=self.emit)

    def emit(self, record: Dict[str, Any]) -> None:
        """Write one timestamped record to the sink (no-op without one)."""
        if self.sink is not None:
            self.sink.write(record)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [m.snapshot() for m in self._metrics.values()]

    def emit_snapshot(self) -> None:
        self.emit({"kind": "snapshot", "metrics": self.snapshot()})


class JsonlSink:
    """Append-only JSONL file: one complete, flushed line per record.

    Writes hold a lock and flush immediately, so records from multiple
    threads (trainer loop, engine ticker, checkpoint watcher) never
    interleave mid-line and a crashed run keeps everything emitted up to
    the crash. Every record gets a wall-clock ``t`` stamp unless the
    caller provided one.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("t", time.time())
        line = json.dumps(_sanitize(record), default=_json_default)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sanitize(obj):
    """Strict-JSON payloads: non-finite floats become null (json.dumps
    would otherwise emit the nonstandard ``NaN`` token and break any
    non-Python consumer of the file)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _json_default(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        v = float(obj)
        return None if math.isnan(v) else v
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    raise TypeError(f"not JSONL-serializable: {type(obj).__name__}")


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a metrics JSONL file back into records (test/CI helper)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
