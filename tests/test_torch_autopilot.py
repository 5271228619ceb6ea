"""The port's autopilot (``repro_torch.autotune``) and its wiring into
``TrainSession``, ``LDAEngine`` and ``serve_lda``, against the JAX
package's, on the CPU.

* Both policies decide as the reference's on the same windows: seeded
  random sequences of windows (the training policy's dwell state
  included) and the reference's hand cases (``tests/test_autopilot.py``).
* Training: a mis-picked word-side backend is switched to the doc-side
  one and logged, mis-sized explicit row widths shrink, and with the
  autopilot and telemetry off nothing is built and the run is bit-equal
  to a metered one.
* Serving: under a paced load the autopilot pulls ``tick_period`` down;
  without it the configured knobs stay. A pending bucket grid is swapped
  in only when every bucket has drained — in lockstep with the
  reference's engine on the same submissions, a reload in flight — and
  every request keeps the model version it was admitted under.
* ``LDAServeConfig`` JSON with the new fields loads in both packages, and
  ``serve_lda --autopilot --metrics-out`` prints the reference's lines.
"""
import dataclasses
import json
import math
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.autotune import ServeAutopilot as JServePilot
from repro.autotune import TrainAutopilot as JTrainPilot
from repro.autotune.policy import backend_cost as j_backend_cost
from repro.core.types import LDAHyperParams as JHyper
from repro.serving import FrozenLDAModel as JModel
from repro.serving import LDAEngine as JEngine
from repro.serving import LDAServeConfig as JConfig
from repro_torch.autotune import (
    BackendSwitch,
    RowRepad,
    ServeAutopilot,
    ServeRetune,
    TrainAutopilot,
)
from repro_torch.autotune.policy import backend_cost
from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.observe.metrics import read_jsonl
from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig
from repro_torch.train.session import RunConfig, TrainSession

CPU = "cpu"


def _records(decisions):
    return [d.to_record() for d in decisions]


# -- training policy --------------------------------------------------------------

def _train_window(mean_kw, mean_kd, k, max_kw=None, max_kd=None, p99=None):
    row = lambda mean, mx: {  # noqa: E731
        "mean": mean, "p50": mean, "p99": mean if p99 is None else p99,
        "max": mean if mx is None else mx, "num_topics": k}
    return [{"kind": "train_iter", "word_rows": row(mean_kw, max_kw),
             "doc_rows": row(mean_kd, max_kd)}]


def test_backend_cost_equals_reference():
    for name in ("zen", "zen_pallas", "std", "zen_cdf", "zen_sparse",
                 "sparselda", "zen_hybrid", "lightlda", "unknown"):
        for kw, kd in ((30.0, 5.0), (2.0, 9.5), (7.0, 7.0)):
            assert backend_cost(name, kw, kd, 64) == \
                j_backend_cost(name, kw, kd, 64)
    assert backend_cost("zen_hybrid", 30.0, 5.0, 64) == 5.0


@pytest.mark.parametrize("quantile", ["max", "p99"])
@pytest.mark.parametrize("seed", range(6))
def test_train_decisions_equal_reference_on_random_windows(seed, quantile):
    rng = np.random.default_rng(seed)
    cands = ("zen", "zen_sparse", "sparselda", "zen_hybrid")
    kw = dict(switch_ratio=float(rng.uniform(0.5, 0.95)),
              dwell=int(rng.integers(0, 3)), pad_quantile=quantile,
              pad_slack=int(rng.integers(0, 12)))
    ref, got = JTrainPilot(cands, **kw), TrainAutopilot(cands, **kw)
    backend, pads = "zen", (0, 0)
    for _ in range(40):
        k = int(rng.choice([16, 64, 1000]))
        mean_kw, mean_kd = (float(x) for x in rng.uniform(1, k, 2))
        window = _train_window(
            mean_kw, mean_kd, k, max_kw=int(rng.integers(1, k + 1)),
            max_kd=int(rng.integers(1, k + 1)),
            p99=float(rng.integers(1, k + 1)))
        if rng.random() < 0.1:
            window = [{"kind": "decision"}]
        args = dict(current_backend=backend, current_pads=pads,
                    num_topics=k, pads_tunable=bool(rng.random() < 0.7))
        a, b = ref.decide(window, **args), got.decide(window, **args)
        assert _records(b) == _records(a)
        for d in b:
            if isinstance(d, BackendSwitch):
                backend = d.backend
            elif isinstance(d, RowRepad):
                pads = (d.max_kw, d.max_kd)


def test_switch_fires_only_past_ratio_with_dwell():
    pilot = TrainAutopilot(("sparselda", "zen_sparse"), switch_ratio=0.8,
                           dwell=2)
    ref = JTrainPilot(("sparselda", "zen_sparse"), switch_ratio=0.8, dwell=2)
    window = _train_window(mean_kw=34.0, mean_kd=6.6, k=64)
    args = dict(current_pads=(0, 0), num_topics=64, pads_tunable=False)
    decisions = pilot.decide(window, current_backend="sparselda", **args)
    assert _records(decisions) == _records(
        ref.decide(window, current_backend="sparselda", **args))
    assert [type(d) for d in decisions] == [BackendSwitch]
    assert decisions[0].backend == "zen_sparse"
    for _ in range(3):  # two cooldown ticks, then nothing left to do
        assert pilot.decide(window, current_backend="zen_sparse",
                            **args) == []


@pytest.mark.parametrize("case", ["margin", "repad", "clamp", "no_op",
                                  "untunable", "empty", "padless"])
def test_train_hand_cases_equal_reference(case):
    """The reference's unit cases, decided by both policies."""
    if case == "margin":
        cands, window = ("sparselda", "zen_sparse"), _train_window(10.0, 9.0,
                                                                  64)
        args = dict(current_backend="sparselda", current_pads=(0, 0),
                    num_topics=64, pads_tunable=False)
        want = []
    else:
        cands = ("zen_sparse",)
        window = _train_window(20.0, 5.0, 128, max_kw=50, max_kd=11)
        args = dict(current_backend="zen_sparse", current_pads=(128, 128),
                    num_topics=128)
        want = [(64, 24)]
        if case == "clamp":
            window = _train_window(120.0, 5.0, 128, max_kw=128, max_kd=11)
            args["current_pads"] = (64, 24)
            want = [(128, 24)]
        elif case == "no_op":
            args["current_pads"] = (64, 24)
            want = []
        elif case == "untunable":
            args["pads_tunable"] = False
            want = []
        elif case == "empty":
            window, want = [], []
        elif case == "padless":
            window, want = [{"kind": "decision"}], []
    got = TrainAutopilot(cands, pad_quantile="max", pad_slack=8).decide(
        window, **args)
    ref = JTrainPilot(cands, pad_quantile="max", pad_slack=8).decide(
        window, **args)
    assert _records(got) == _records(ref)
    assert [(d.max_kw, d.max_kd) for d in got
            if isinstance(d, RowRepad)] == want


# -- serving policy -------------------------------------------------------------

def _serve_summary(inter_p50_ms, count=16, wait_p90=0.0,
                   doc_len=(24.0, 50.0, 60)):
    p50, p99, mx = doc_len
    return {"kind": "serve_window",
            "interarrival_ms": {"count": count, "p50": inter_p50_ms},
            "wait_ticks_p90": wait_p90,
            "doc_len": {"count": count, "p50": p50, "p99": p99, "max": mx}}


@pytest.mark.parametrize("seed", range(6))
def test_serve_decisions_equal_reference_on_random_windows(seed):
    rng = np.random.default_rng(seed)
    kw = dict(period_fraction=float(rng.uniform(0.2, 1.0)),
              hysteresis=float(rng.uniform(0.05, 0.5)),
              retune_buckets=bool(seed % 3))
    ref, got = JServePilot(**kw), ServeAutopilot(**kw)
    period, wait, buckets = 0.001, 0, (32, 64)
    for _ in range(60):
        p50 = float(rng.uniform(2, 300))
        summary = _serve_summary(
            float(rng.exponential(5.0)), count=int(rng.integers(0, 30)),
            wait_p90=float(rng.integers(0, 6)),
            doc_len=(p50, p50 * float(rng.uniform(1, 2)),
                     int(p50 * rng.uniform(2, 3))))
        if rng.random() < 0.05:
            summary = {"kind": "train_iter"}
        args = dict(tick_period=period, max_slot_wait=wait, buckets=buckets)
        a, b = ref.decide(summary, **args), got.decide(summary, **args)
        assert (b is None) == (a is None)
        if b is None:
            continue
        assert b.to_record() == a.to_record()
        period = b.tick_period or period
        wait = b.max_slot_wait if b.max_slot_wait is not None else wait
        buckets = b.buckets or buckets


@pytest.mark.parametrize("case", [
    ("period", 10.0, {}, 0.05), ("hysteresis", 10.0, {}, 0.0045),
    ("floor", 0.1, {}, 0.05), ("cap", 5000.0, {}, 0.001),
    ("few", 10.0, {"count": 3}, 0.05),
    ("wait", 10.0, {"wait_p90": 4.0}, 0.005),
    ("truncating", 10.0, {"doc_len": (24.0, 90.0, 120)}, 0.005),
    ("wasteful", 10.0, {"doc_len": (8.0, 30.0, 31)}, 0.005)],
    ids=lambda c: c[0])
def test_serve_hand_cases_equal_reference(case):
    _, p50, extra, period = case
    buckets = (64, 256) if case[0] == "wasteful" else (32, 64)
    summary = _serve_summary(p50, **extra)
    for kw in ({}, {"retune_buckets": False}):
        a = JServePilot(**kw).decide(summary, tick_period=period,
                                     max_slot_wait=0, buckets=buckets)
        b = ServeAutopilot(**kw).decide(summary, tick_period=period,
                                        max_slot_wait=0, buckets=buckets)
        assert (None if b is None else b.to_record()) == \
            (None if a is None else a.to_record())
    d = ServeAutopilot().decide(_serve_summary(10.0), tick_period=0.05,
                                max_slot_wait=0, buckets=(32, 64))
    assert isinstance(d, ServeRetune)
    assert d.tick_period == pytest.approx(0.005)


# -- training integration ---------------------------------------------------------

def _hot_vocab():
    # word rows touch ~K/2 topics while doc rows stay short: the
    # doc-side decomposition wins by > 2x (the reference's corpus)
    return synthetic_corpus(0, num_docs=120, num_words=24, avg_doc_len=8,
                            zipf_a=0.8)


def test_autopilot_switches_backend_and_logs(tmp_path):
    path = str(tmp_path / "train.jsonl")
    cfg = RunConfig(algorithm="sparselda", num_iterations=6, eval_every=0,
                    autopilot=True, autopilot_every=2, metrics_out=path)
    session = TrainSession(_hot_vocab(), LDAHyperParams(num_topics=64), cfg,
                           device=CPU)
    assert session.schedule.names() == ("autopilot", "telemetry")
    fired = []
    final = session.run(0, callback=lambda st, m: fired.extend(
        m.get("autopilot", ())))
    final.check_invariants(session.corpus)
    assert session.backend.name == "zen_sparse"
    assert session.plan.backend.name == "zen_sparse"
    applied = [r for r in fired
               if r["decision"] == "BackendSwitch" and r["applied"]]
    assert applied and applied[0]["backend"] == "zen_sparse"
    records = read_jsonl(path)
    assert any(r["kind"] == "decision" and r["decision"] == "BackendSwitch"
               and r["applied"] for r in records)
    iters = [r for r in records if r["kind"] == "train_iter"]
    assert [r["iteration"] for r in iters] == list(range(1, 7))
    assert iters[-1]["backend"] == "zen_sparse"
    assert all(r["tokens_per_s"] is None or math.isfinite(r["tokens_per_s"])
               for r in iters)
    assert any(r["tokens_per_s"] for r in iters[1:])


def test_autopilot_shrinks_mis_sized_pads():
    k = 64
    cfg = RunConfig(algorithm="zen_sparse", num_iterations=4, eval_every=0,
                    max_kw=k, max_kd=k, autopilot=True, autopilot_every=2)
    session = TrainSession(_hot_vocab(), LDAHyperParams(num_topics=k), cfg,
                           device=CPU)
    fired = []
    session.run(0, callback=lambda st, m: fired.extend(
        m.get("autopilot", ())))
    repads = [r for r in fired if r["decision"] == "RowRepad"]
    assert repads and repads[0]["applied"]
    assert session.plan.row_pads[1] < k
    assert session.plan.row_pads == (repads[-1]["max_kw"],
                                     repads[-1]["max_kd"])


def test_autopilot_off_is_bit_identical_and_structure_free(tmp_path):
    corpus = synthetic_corpus(1, num_docs=40, num_words=60, avg_doc_len=30)
    hyper = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)
    base = dict(algorithm="zen_sparse", num_iterations=5, rebuild_every=2)
    plain = TrainSession(corpus, hyper, RunConfig(**base), device=CPU)
    assert plain.telemetry is None and plain._autopilot_policy is None
    assert plain.schedule.names() == ("rebuild", "repad")
    metered = TrainSession(corpus, hyper, RunConfig(
        **base, metrics_out=str(tmp_path / "m.jsonl")), device=CPU)
    assert metered.schedule.names() == ("rebuild", "repad", "telemetry")
    a, b = plain.run(3), metered.run(3)
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_set_backend_keeps_the_row_orders():
    session = TrainSession(_hot_vocab(), LDAHyperParams(num_topics=16),
                           RunConfig(algorithm="zen", kernels="on"),
                           device=CPU)
    st = session.init(0)
    orders = session.plan.row_orders()
    assert not session.plan.set_backend("zen", st)
    assert session.plan.set_backend("zen_hybrid", st)
    assert session.plan.row_orders() is orders
    st = session.step(st)
    st.check_invariants(session.corpus)
    np.testing.assert_array_equal(session.plan.host_n_wk(st),
                                  st.n_wk.numpy())


# -- serving integration -----------------------------------------------------------

def _model_arrays(w=80, k=8):
    rng = np.random.default_rng(0)
    n_wk = rng.poisson(2.0, size=(w, k)).astype(np.int32)
    return n_wk, n_wk.sum(0).astype(np.int32)


def _port_model(seed=0, w=80, k=8):
    n_wk, n_k = _model_arrays(w, k)
    if seed:
        n_wk = np.roll(n_wk, seed, axis=1)
        n_k = n_wk.sum(0).astype(np.int32)
    return FrozenLDAModel.from_numpy(n_wk, n_k, {"num_topics": k},
                                     device=CPU)


def _ref_model(seed=0, w=80, k=8):
    n_wk, n_k = _model_arrays(w, k)
    if seed:
        n_wk = np.roll(n_wk, seed, axis=1)
        n_k = n_wk.sum(0).astype(np.int32)
    return JModel(n_wk=jnp.asarray(n_wk), n_k=jnp.asarray(n_k),
                  hyper=JHyper(num_topics=k))


def test_engine_autopilot_retunes_tick_period_under_paced_load(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    cfg = LDAServeConfig(buckets=(16, 32), max_batch=4, mode="latency",
                         rtlda_sweeps=1, tick_period=0.05, autopilot=True,
                         autopilot_window=12, metrics_out=path)
    engine = LDAEngine(_port_model(), cfg, seed=0)
    engine.warm()
    engine.start()
    try:
        rng = np.random.default_rng(1)
        tickets = []
        for _ in range(40):
            tickets.append(engine.submit_async(
                rng.integers(0, 80, size=12).astype(np.int32)))
            time.sleep(0.002)
        thetas = [engine.result(t, timeout=30.0) for t in tickets]
    finally:
        engine.stop()
    assert len(thetas) == 40
    assert all(th.shape == (8,) and np.isfinite(th).all() for th in thetas)
    assert engine.tick_period < cfg.tick_period
    records = read_jsonl(path)
    assert any(r["kind"] == "serve_window" for r in records)
    assert any(r["kind"] == "decision" and r["decision"] == "ServeRetune"
               and r["applied"] for r in records)


def test_engine_without_autopilot_keeps_configured_knobs():
    cfg = LDAServeConfig(buckets=(16, 32), max_batch=4, tick_period=0.01)
    engine = LDAEngine(_port_model(), cfg, seed=0)
    assert engine._telemetry is None and engine._autopilot is None
    engine.result(engine.submit_async(np.arange(10, dtype=np.int32)))
    assert engine.tick_period == 0.01
    assert engine.max_slot_wait == 0
    assert engine.bucket_widths == (16, 32)


def _drive(engine, model_b, docs, new_grid):
    """Submit ``docs``, take one tick, ask for ``new_grid`` and reload
    ``model_b``, then tick to the end; per tick, the grid, the per-bucket
    occupancy before the tick and each finished request's (uid, version,
    version current at its admission)."""
    uids = [engine.submit(d) for d in docs]
    trace, admitted_under = [], {}

    def tick():
        before = {bl: b.num_active for bl, b in engine._buckets.items()}
        grid = engine.bucket_widths
        done = engine.step()
        for bl, b in engine._buckets.items():
            for r in b.active:
                if r is not None:
                    admitted_under.setdefault(r.uid, engine.model_version)
        trace.append((grid, before, engine.bucket_widths,
                      sorted((r.uid, r.model_version) for r in done)))
        return done

    finished = tick()
    engine._pending_buckets = tuple(new_grid)
    engine.reload(model_b)
    for _ in range(50):
        finished += tick()
        if len(finished) == len(uids):
            break
    return trace, finished, admitted_under


def test_bucket_swap_waits_for_drain_in_lockstep_with_reference():
    rng = np.random.default_rng(4)
    docs = [rng.integers(0, 80, int(n)).astype(np.int32)
            for n in rng.integers(1, 30, 9)]
    kw = dict(buckets=(16, 32), max_batch=2, num_sweeps=3)
    t_trace, t_done, t_adm = _drive(
        LDAEngine(_port_model(), LDAServeConfig(**kw), seed=0),
        _port_model(3), docs, (8, 64))
    j_trace, j_done, _ = _drive(
        JEngine(_ref_model(), JConfig(**kw), seed=0), _ref_model(3), docs,
        (8, 64))
    assert t_trace == j_trace
    swaps = [i for i, (g0, _, g1, _) in enumerate(t_trace) if g0 != g1]
    assert len(swaps) == 1
    _, before, _, _ = t_trace[swaps[0]]
    assert not any(before.values())  # drained before the new grid
    assert all(t_trace[i][0] == (16, 32) for i in range(swaps[0] + 1))
    assert len(t_done) == len(docs)
    for r in t_done:
        assert np.isfinite(r.theta).all()
        assert r.model_version == t_adm.get(r.uid, r.model_version)
    assert {r.model_version for r in t_done} == {0, 1}


def test_autopilot_recuts_a_truncating_grid_only_when_drained(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    # a submission is cut to the widest bucket before telemetry sees it,
    # so the grid the policy can recut is a wasteful one: short documents
    # on wide buckets
    cfg = LDAServeConfig(buckets=(128, 256), max_batch=3, num_sweeps=2,
                         autopilot=True, autopilot_window=8,
                         metrics_out=path)
    engine = LDAEngine(_port_model(), cfg, seed=0)
    swaps = []
    apply = engine._apply_pending_buckets

    def watched():
        drained = all(b.num_active == 0 for b in engine._buckets.values())
        grid = engine.bucket_widths
        apply()
        if engine.bucket_widths != grid:
            swaps.append((grid, engine.bucket_widths, drained))

    engine._apply_pending_buckets = watched
    rng = np.random.default_rng(2)
    docs = [rng.integers(0, 80, int(n)).astype(np.int32)
            for n in rng.integers(4, 20, 40)]
    thetas = engine.infer_batch(docs)
    assert np.isfinite(thetas).all() and np.allclose(thetas.sum(1), 1,
                                                     atol=1e-5)
    assert swaps and all(drained for _, _, drained in swaps)
    assert swaps[0][0] == (128, 256) and swaps[0][1][-1] <= 24
    decisions = [r for r in read_jsonl(path) if r["kind"] == "decision"]
    assert any(r["buckets"] and r["applied"] for r in decisions)


@pytest.mark.parametrize("max_batch", [8, 32],
                         ids=["one_queued_before", "all_admitted"])
def test_bucket_swap_under_traffic_decodes_each_request_as_alone(max_batch):
    """``chip_smoke.py``'s ``swap_across_traffic`` on a CPU model: the
    grid holds while any request is in flight, requests queued at the swap
    are cut to the new widest bucket, and every theta equals its
    document's decode alone, with the same key, on the grid it finished
    on (a failed check raises SystemExit)."""
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.default_rng(7)
    docs = [rng.integers(0, 80, int(n)).astype(np.int32)
            for n in rng.integers(5, 120, 40)]
    base = dict(buckets=(32, 64, 128), max_batch=max_batch, num_sweeps=5,
                algorithm="zen_pallas")
    out = chip_smoke.swap_across_traffic(_port_model(), base, docs, (16,), 0)
    assert out["to"] == [16] and out["steps_held"] >= 4
    assert out["queued_across"] >= 16 and out["truncated"] >= 1
    assert out["thetas_equal_alone"] == 32


def test_serve_config_json_with_observability_fields_in_both_packages():
    cfg = LDAServeConfig(buckets=(16, 64), max_batch=12, num_sweeps=7,
                         burn_in=2, thin=2, mode="latency", rtlda_sweeps=3,
                         tick_period=0.004, max_slot_wait=3,
                         metrics_out="serve.jsonl", autopilot=True,
                         autopilot_window=32)
    ref = JConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(ref) == {**dataclasses.asdict(cfg),
                                       "buckets": (16, 64)}
    assert LDAServeConfig.from_json(ref.to_json()) == cfg
    assert json.loads(cfg.to_json()) == json.loads(ref.to_json())


def test_serve_cli_autopilot_lines_equal_reference(tmp_path, monkeypatch,
                                                   capsys):
    from repro.launch import serve_lda as jserve
    from repro_torch.launch import serve_lda as tserve
    from repro_torch.train.checkpoint import save_lda_model

    ckpt = str(tmp_path / "ckpt")
    n_wk, n_k = _model_arrays()
    save_lda_model(ckpt, n_wk, n_k, LDAHyperParams(num_topics=8), step=1)
    path = tmp_path / "serve.jsonl"
    args = ["--checkpoint-dir", ckpt, "--synthetic-docs", "24",
            "--synthetic-len", "12", "--mode", "latency", "--buckets",
            "16,32", "--autopilot", "--autopilot-window", "8",
            "--metrics-out", str(path), "--pace", "0.001",
            "--tick-period", "0.02", "--show", "0"]
    monkeypatch.setattr(sys, "argv", ["serve_lda"] + args)
    jserve.main()
    ref = capsys.readouterr().out.splitlines()
    path.unlink()
    assert tserve.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()

    def shapes(lines):
        keep = [ln for ln in lines
                if ln.startswith(("autopilot:", "telemetry:"))]
        return [re.sub(r"-?\d+(\.\d+)?", "#", re.sub(r"\(.*\)", "()", ln))
                for ln in keep]

    assert shapes(got) == shapes(ref) and len(shapes(got)) == 2
    assert any(r["kind"] == "serve_window" for r in read_jsonl(str(path)))
    # replicas (item 7) serve behind the router, with the reference's
    # lines; the router's fleet records ride on replica 0's telemetry
    path.unlink()
    monkeypatch.setattr(sys, "argv", ["serve_lda"] + args
                        + ["--replicas", "2"])
    jserve.main()
    ref = capsys.readouterr().out.splitlines()
    path.unlink()
    assert tserve.main(args + ["--device", "cpu", "--replicas", "2"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert shapes(got) == shapes(ref) and len(shapes(got)) == 2
    assert any(r["kind"] == "router_load" for r in read_jsonl(str(path)))
    # sharded serving does not run in latency mode, in either package;
    # in throughput mode it serves and prints its layout
    monkeypatch.setattr(sys, "argv", ["serve_lda"] + args
                        + ["--mesh-shape", "1,2"])
    with pytest.raises(ValueError, match="latency mode"):
        jserve.main()
    with pytest.raises(ValueError, match="latency mode"):
        tserve.main(args + ["--device", "cpu", "--mesh-shape", "1,2"])
    capsys.readouterr()
    assert tserve.main(args[:args.index("--mode")] + args[
        args.index("--mode") + 2:] + ["--device", "cpu", "--mesh-shape",
                                      "1,2"]) == 0
    assert "sharded: 2 word shards" in capsys.readouterr().out

