"""The port's observability layer (``repro_torch.observe``) against the
JAX package's (``repro.observe``), on the CPU.

* ``nnz_row_stats``: the port's dict equals the reference's, bit for bit,
  on numpy counts and on tensors (counted on the tensor's device, only the
  per-row counts moved to the host); empty and all-zero rows included.
* Metric primitives, the registry, span timers and the strict-JSON sink
  behave as the reference's on the same calls (snapshots equal).
* ``ServeTelemetry``: the window summaries equal the reference's on the
  same stamped tick sequence (seeded random sequences and a hand case).
* ``TrainTelemetry``: one ``train_iter`` record per iteration with the
  reference's fields; its row statistics are those of the live counts.
"""
import json
import math
import threading
import types

import numpy as np
import pytest
import torch

from repro import observe as jobs
from repro.observe import metrics as jmetrics
from repro_torch import observe as tobs
from repro_torch.observe import metrics as tmetrics


def _same(a, b) -> bool:
    """Equality with NaN equal to NaN, through nested dicts and lists."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


# -- nnz_row_stats ---------------------------------------------------------------

@pytest.mark.parametrize("shape,density", [
    ((50, 12), 0.3), ((7, 1000), 0.05), ((300, 5), 0.9), ((0, 8), 0.5),
    ((4, 6), 0.0), ((1, 3), 1.0)],
    ids=["rows", "wide", "dense", "empty", "zeros", "one_row"])
def test_nnz_row_stats_bit_equal(shape, density):
    rng = np.random.default_rng(shape[0] + shape[1])
    counts = (rng.random(shape) < density) * rng.integers(1, 9, shape)
    counts = counts.astype(np.int32)
    ref = jmetrics.nnz_row_stats(counts)
    assert _same(tmetrics.nnz_row_stats(counts), ref)
    assert _same(tmetrics.nnz_row_stats(torch.from_numpy(counts)), ref)


def test_nnz_row_stats_hand_counted():
    counts = np.array([[0, 3, 0, 1], [5, 0, 0, 0], [2, 2, 2, 2]], np.int32)
    got = tmetrics.nnz_row_stats(torch.from_numpy(counts))
    assert got == {"mean": 7 / 3, "p50": 2.0, "p99": pytest.approx(3.96),
                   "max": 4, "num_topics": 4}


# -- primitives, registry, sink -------------------------------------------------

def test_latency_math_equals_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 17, 200):
        vals = list(rng.exponential(5.0, n))
        assert _same(tmetrics.summarize_latencies(vals),
                     jmetrics.summarize_latencies(vals))
        s = sorted(vals)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert _same(tmetrics.latency_percentile(s, q),
                         jmetrics.latency_percentile(s, q))


def test_histograms_and_counters_equal_reference():
    rng = np.random.default_rng(1)
    vals = rng.exponential(1.0, 300)
    snaps = []
    for mod in (jmetrics, tmetrics):
        h = mod.Histogram("h", bounds=(0.1, 1.0, 4.0))
        for v in vals[:100]:
            h.observe(float(v))
        h.observe_array(vals[100:])
        c = mod.Counter("c")
        c.inc(3)
        g = mod.Gauge("g")
        g.set(1.5)
        snaps.append([h.snapshot(), c.snapshot(), g.snapshot()])
    assert _same(snaps[0], snaps[1])
    with pytest.raises(ValueError, match="ascending"):
        tmetrics.Histogram("bad", bounds=(5.0, 1.0))


def test_registry_type_conflicts_and_thread_safety():
    reg = tmetrics.MetricsRegistry()
    reg.counter("n").inc()
    with pytest.raises(TypeError):
        reg.gauge("n")

    def bump():
        for _ in range(500):
            reg.counter("n").inc()

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("n").value == 1 + 4 * 500


def test_jsonl_sink_strict_json_equals_reference(tmp_path):
    out = []
    for mod, name in ((jmetrics, "ref"), (tmetrics, "port")):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.JsonlSink(path) as sink:
            reg = mod.MetricsRegistry(sink)
            reg.counter("events").inc(2)
            reg.emit({"kind": "train_iter", "t": 1.0, "nnz": np.int64(7),
                      "rate": np.float32(1.5), "pads": np.array([8, 16]),
                      "ppl": float("nan"), "inf": float("inf"),
                      "nested": {"x": [float("-inf"), 2.0]}})
            reg.emit({"kind": "snapshot", "t": 2.0,
                      "metrics": reg.snapshot()})
        with open(path) as fh:
            for line in fh:
                json.loads(line, parse_constant=pytest.fail)
        out.append(mod.read_jsonl(path))
    assert out[0] == out[1]
    assert out[1][0]["ppl"] is None and out[1][0]["inf"] is None
    assert out[1][0]["nested"] == {"x": [None, 2.0]}


def test_span_timer_records_and_emits(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with tmetrics.JsonlSink(path) as sink:
        reg = tmetrics.MetricsRegistry(sink)
        with reg.timer("rebuild") as span:
            pass
        reg.emit_snapshot()
    recs = tmetrics.read_jsonl(path)
    assert [r["kind"] for r in recs] == ["span", "snapshot"]
    assert recs[0]["seconds"] == span.last >= 0
    snap = {m["name"]: m for m in recs[1]["metrics"]}
    assert snap["rebuild"]["count"] == 1


def test_exports_equal_reference():
    for name in ("Counter", "Gauge", "Histogram", "JsonlSink",
                 "MetricsRegistry", "SpanTimer", "ServeTelemetry",
                 "TrainTelemetry", "latency_percentile", "nnz_row_stats",
                 "summarize_latencies"):
        assert hasattr(jobs, name) and hasattr(tobs, name), name


# -- ServeTelemetry -------------------------------------------------------------

def _ticks(seed, n_events=400):
    """A seeded stamped sequence: arrivals (time, length) and ticks (queue
    depth, occupancy, finished requests' stamps, spills, knobs)."""
    rng = np.random.default_rng(seed)
    t = 1000.0
    events = []
    spills = 0
    for _ in range(n_events):
        t += float(rng.exponential(0.004))
        if rng.random() < 0.4:
            events.append(("submit", t, int(rng.integers(0, 400))))
        else:
            fin = [types.SimpleNamespace(
                t_submit=t - float(rng.exponential(0.05)), t_done=t,
                ticks_waited=int(rng.integers(0, 6)))
                for _ in range(int(rng.integers(0, 4)))]
            spills += int(rng.integers(0, 2))
            events.append(("tick", dict(
                queue_depth=int(rng.integers(0, 20)),
                occupancy=int(rng.integers(0, 64)), finished=fin,
                spills_total=spills, tick_period=0.001 * (1 + seed),
                max_slot_wait=int(seed), bucket_widths=(128, 256, 512),
                model_version=seed)))
    return events


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ticks,arrivals", [(256, 64), (8, 4), (40, 1000)])
def test_serve_telemetry_windows_equal_reference(seed, ticks, arrivals):
    ref = jobs.ServeTelemetry(jmetrics.MetricsRegistry(), window_ticks=ticks,
                              window_arrivals=arrivals)
    got = tobs.ServeTelemetry(tmetrics.MetricsRegistry(), window_ticks=ticks,
                              window_arrivals=arrivals)
    closed = 0
    for ev in _ticks(seed):
        if ev[0] == "submit":
            ref.record_submit(ev[1], ev[2])
            got.record_submit(ev[1], ev[2])
        else:
            a, b = ref.record_tick(**ev[1]), got.record_tick(**ev[1])
            assert _same(b, a)
            closed += a is not None
    assert closed > 0
    assert _same(got.last_window, ref.last_window)
    assert got.registry.snapshot() == ref.registry.snapshot()


def test_serve_telemetry_window_closes_on_arrival_budget(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    tel = tobs.ServeTelemetry(tmetrics.MetricsRegistry(
        tmetrics.JsonlSink(path)), window_ticks=10_000, window_arrivals=4)
    for i in range(4):
        tel.record_submit(100.0 + 0.010 * i, doc_len=32)
    summary = None
    for _ in range(5):
        summary = tel.record_tick(
            queue_depth=1, occupancy=2, finished=[], spills_total=0,
            tick_period=0.001, max_slot_wait=0, bucket_widths=(32, 64),
            model_version=1) or summary
    assert summary["arrivals"] == 4
    assert summary["interarrival_ms"]["count"] == 3
    assert summary["interarrival_ms"]["p50"] == pytest.approx(10.0, rel=1e-6)
    assert any(r["kind"] == "serve_window"
               for r in tmetrics.read_jsonl(path))


# -- TrainTelemetry -------------------------------------------------------------

def test_train_telemetry_records_live_counts():
    rng = np.random.default_rng(3)
    n_wk = rng.integers(0, 3, (20, 6)).astype(np.int32)
    n_kd = rng.integers(0, 2, (9, 6)).astype(np.int32)
    plan = types.SimpleNamespace(
        device=torch.device("cpu"), num_tokens=1234, row_pads=(0, 8),
        backend=types.SimpleNamespace(name="zen"))
    state = types.SimpleNamespace(n_wk=torch.from_numpy(n_wk),
                                  n_kd=torch.from_numpy(n_kd))
    tel = tobs.TrainTelemetry(tmetrics.MetricsRegistry(), window=2)
    first = tel.record_iteration(plan, state, 1, {"llh": -5.0})
    second = tel.record_iteration(plan, state, 2, {})
    tel.record_iteration(plan, state, 3, {"perplexity": 9.0})
    assert first["dt_s"] is None and first["tokens_per_s"] is None
    assert second["dt_s"] >= 0 and first["llh"] == -5.0
    assert first["word_rows"] == jmetrics.nnz_row_stats(n_wk)
    assert first["doc_rows"] == jmetrics.nnz_row_stats(n_kd)
    assert first["row_pads"] == {"max_kw": 0, "max_kd": 8}
    assert [r["iteration"] for r in tel.window()] == [2, 3]
    assert set(first) == {"kind", "iteration", "backend", "dt_s",
                          "tokens_per_s", "row_pads", "word_rows",
                          "doc_rows", "llh"}
