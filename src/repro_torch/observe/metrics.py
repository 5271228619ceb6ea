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

Spans and work counters inside the program exist only while a torch
profiler records (``tracing``): ``span(name, device)`` on the hot path and
``MetricsRegistry.timer`` are one class, ``SpanTimer``, whose totals by
name, with the kernels' and plain routes' counters, gather in the
process's ``TRACE`` and are read by ``trace_totals()``. With no profiler a
span is one flag check and a shared no-op context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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
    """A span, with one class for every caller: ``with
    registry.timer("jit_rebuild"): ...`` records the wall duration
    (seconds, monotonic clock) into a histogram and, when the registry has
    a sink, emits one ``kind="span"`` record per exit; ``with
    span("plan.sweep", device): ...`` (:func:`span`) is a span of the hot
    path, with no histogram, that exists only while a profiler records.

    While a torch profiler records (:func:`tracing`), a span also opens
    ``record_function("repro_torch.<name>")``, so that it sits on the
    profiler's timeline beside the device's events, and adds its count,
    host seconds and parent (the innermost span open when it opened) to
    the process's collector (:data:`TRACE`); on a CUDA ``device`` it also
    records a pair of timing events on the current stream, read only when
    the totals are (:func:`trace_totals`). A span never synchronizes and
    never reads a tensor."""

    def __init__(self, hist: Optional[Histogram] = None, emit=None, *,
                 name: Optional[str] = None, device=None):
        self.name = hist.name if name is None else name
        self._hist = hist
        self._emit = emit
        self._device = device
        self._open = None
        self._t0: Optional[float] = None
        self.last: Optional[float] = None

    def __enter__(self) -> "SpanTimer":
        if tracing():
            self._open = TRACE.enter(self.name, self._device)
        else:
            TRACE.idle = True
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.last = time.monotonic() - self._t0
        if self._open is not None:
            TRACE.exit(self._open, self.last)
            self._open = None
        if self._hist is not None:
            self._hist.observe(self.last)
        if self._emit is not None:
            self._emit({"kind": "span", "name": self.name,
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


# ---------------------------------------------------------------------------
# the profiled stretch: spans and work counters
# ---------------------------------------------------------------------------

# the prefix of every span's range on the profiler's timeline
SPAN_PREFIX = "repro_torch."
# pending event pairs above which the completed ones are resolved
PENDING_PAIRS = 4096
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch profiler records (the flag that
    ``torch.profiler.profile`` sets): spans and counters are on exactly
    then."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, device=None):
    """The hot path's span: a :class:`SpanTimer` named ``name`` (with
    timing events where ``device`` is a CUDA device) while a profiler
    records; else one shared no-op context, after noting that tracing was
    off, so that the next profiled stretch starts its totals afresh."""
    if _autograd_profiler._is_profiler_enabled:
        return SpanTimer(name=name, device=device)
    TRACE.idle = True
    return _OFF


def count(name: str, value: torch.Tensor) -> None:
    """Add ``value``, a 0-d integer tensor on any device, to counter
    ``name`` of the profiled stretch: the plain routes' work counts,
    counted with torch ops. Call it only while :func:`tracing`."""
    TRACE.add(name, value)


def trace_totals() -> Dict[str, Dict[str, Any]]:
    """The latest profiled stretch's totals: ``{"spans": {name: {"count",
    "host_s", "device_s", "parent"}}, "counters": {name: int}}``.
    ``device_s`` is None for a span with no timing events (not on a card);
    ``parent`` is the name of the span it opened inside, or None. Reading
    waits for the stretch's pending events and counters (call it after
    the caller's own synchronize, once the profiler has stopped)."""
    return TRACE.totals()


@dataclasses.dataclass
class _SpanTotal:
    parent: Optional[str]
    count: int = 0
    host_s: float = 0.0
    device_s: Optional[float] = None


@dataclasses.dataclass
class _KernelCounter:
    """A kernel's own int64 counter on the card: zero when its library
    loads, added to only by launches made while tracing. The stretch's
    count is its value less ``base``, its value when the stretch's first
    launch added to it; ``seen`` is the value last read, and ``dirty``
    says that a launch may have added to it since."""

    read: Callable[[], int]
    seen: int = 0
    dirty: bool = False
    base: Optional[int] = None


class TraceCollector:
    """The totals of the latest profiled stretch, process-wide: by span
    name the count, host seconds, device seconds and the parent's name;
    by counter name the count. A stretch starts at the first span or
    count that finds tracing on after a span that found it off, or after
    the totals were read with tracing off, and drops the last stretch's
    totals. Timing events are resolved when the totals are read and,
    while more than :data:`PENDING_PAIRS` are pending, the completed ones
    (``query()``) at each span's exit, so memory stays bounded over a long
    profiled run; resolved events are used again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.idle = True
        self._spans: Dict[str, _SpanTotal] = {}
        self._pending: List[tuple] = []  # (total, start, end, card)
        self._free: Dict[int, List[torch.cuda.Event]] = {}
        self._sums: Dict[tuple, torch.Tensor] = {}  # (name, device)
        self._kernels: Dict[tuple, _KernelCounter] = {}  # (name, key)

    def _live(self) -> None:
        """Under the lock: start a new stretch if the last one ended."""
        if self.idle:
            self.idle = False
            for _, start, end, card in self._pending:
                self._free.setdefault(card, []).extend((start, end))
            self._spans, self._pending, self._sums = {}, [], {}
            for c in self._kernels.values():
                c.base = None

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _events(self, card: int):
        with self._lock:
            free = self._free.get(card)
            if free and len(free) >= 2:
                return free.pop(), free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def enter(self, name: str, device):
        """Open span ``name`` (a :class:`SpanTimer`'s, while tracing)."""
        if self.idle:
            with self._lock:
                self._live()
        stack = self._stack()
        rng = _autograd_profiler.record_function(SPAN_PREFIX + name)
        rng.__enter__()
        timed = None
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda":
            card = (torch.cuda.current_device() if dev.index is None
                    else dev.index)
            start, end = self._events(card)
            stream = torch.cuda.current_stream(dev)
            start.record(stream)
            timed = (start, end, stream, card)
        opened = (name, stack[-1] if stack else None, rng, timed)
        stack.append(name)
        return opened

    def exit(self, opened, host_s: float) -> None:
        name, parent, rng, timed = opened
        if timed is not None:
            timed[1].record(timed[2])
        rng.__exit__(None, None, None)
        self._stack().pop()
        with self._lock:
            tot = self._spans.get(name)
            if tot is None:
                tot = self._spans[name] = _SpanTotal(parent)
            tot.count += 1
            tot.host_s += host_s
            if timed is not None:
                if tot.device_s is None:
                    tot.device_s = 0.0
                self._pending.append((tot, timed[0], timed[1], timed[3]))
                if len(self._pending) > PENDING_PAIRS:
                    self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Under the lock: add the pending pairs' device seconds to their
        spans, waiting for each (``wait``) or only those completed."""
        keep = []
        for item in self._pending:
            tot, start, end, card = item
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append(item)
                continue
            tot.device_s += start.elapsed_time(end) / 1e3
            self._free.setdefault(card, []).extend((start, end))
        self._pending = keep

    def add(self, name: str, value: torch.Tensor) -> None:
        """Add a 0-d count tensor to counter ``name`` (:func:`count`)."""
        with self._lock:
            self._live()
            key = (name, value.device)
            prev = self._sums.get(key)
            self._sums[key] = value if prev is None else prev + value

    def kernel_counter(self, name: str, key, read: Callable[[], int]
                       ) -> None:
        """Note that a launch made now adds to a kernel's own counter on
        the card (``key`` tells it from others of the same ``name``;
        ``read()`` returns its value), for counter ``name``."""
        with self._lock:
            self._live()
            c = self._kernels.get((name, key))
            if c is None:
                c = self._kernels[(name, key)] = _KernelCounter(read)
            if c.base is None:
                if c.dirty:  # the last stretch's launches, never read
                    c.seen, c.dirty = c.read(), False
                c.base = c.seen
            c.dirty = True

    def totals(self) -> Dict[str, Dict[str, Any]]:
        """:func:`trace_totals`."""
        with self._lock:
            self._resolve(wait=True)
            if not tracing():  # the stretch is over
                self.idle = True
            counters: Dict[str, int] = {}
            for (name, _), v in self._sums.items():
                counters[name] = counters.get(name, 0) + int(v)
            for (name, _), c in self._kernels.items():
                if c.base is None:
                    continue
                if c.dirty:
                    c.seen, c.dirty = c.read(), False
                counters[name] = counters.get(name, 0) + c.seen - c.base
            spans = {n: dataclasses.asdict(t)
                     for n, t in self._spans.items()}
        return {"spans": spans, "counters": counters}


# the process's collector: every span and counter adds to it
TRACE = TraceCollector()


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
