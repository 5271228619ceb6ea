"""Spans and work counters inside the port's training step
(``repro_torch.observe.metrics``: ``span``, ``count``, ``trace_totals``),
on the CPU at the benchmark's tiny size (``portbench/tests/tiny.py``).

With no profiler recording a step is the parent's path, bit for bit, and
leaves nothing behind: no record_function range, no CUDA event, nothing
in the collector. Under ``torch.profiler.profile`` every span is a user
annotation nested as the step nests it, both counters equal a recount of
their predicate after every step, the readers of device milliseconds
find nothing on the CPU, and two profiled windows each see only their
own totals. ``zen_cdf``'s counters count on both of its routes by one
rule (``kernels="on"`` here runs the kernel route's plain versions).
"""
import hashlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import registry
from portbench.tests import tiny
from repro_torch.algorithms import zen_cdf
from repro_torch.kernels import ops
from repro_torch.kernels.cdf_tokens import cdf_remedy_plain
from repro_torch.observe import metrics, trace_totals

DENSE, CDF = tiny.CELLS
PLAN_SPANS = {"plan.sweep", "plan.merge", "plan.update"}
CDF_SPANS = {"zen_cdf.tables", "zen_cdf.doc_rows", "zen_cdf.draws",
             "zen_cdf.remedy"}
# SHA-256 (first 16 hex digits) of topic, n_wk, n_kd and n_k after 3
# steps of each tiny cell from tiny.SEED, as the step was before it had
# spans or counters
PARENT_DIGEST = {DENSE: "2f1c2bd6cd6d487d", CDF: "df5cd3af6e73e60e"}
MS_METRICS = ("plan_sweep_ms", "plan_merge_ms", "plan_update_ms",
              "cdf_tables_ms", "cdf_doc_rows_ms", "cdf_draws_ms",
              "cdf_remedy_ms")


def runner(name):
    cell, config, traffic = tiny.spec(name)
    run = registry.runner(config["runner"]).Runner(
        config, traffic, cell, tiny.SEED, torch.device("cpu"))
    run.build({})
    return run


def digest(state):
    h = hashlib.sha256()
    for k in ("topic", "n_wk", "n_kd", "n_k"):
        h.update(getattr(state, k).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture()
def collector(monkeypatch):
    """A fresh process collector for the test."""
    fresh = metrics.TraceCollector()
    monkeypatch.setattr(metrics, "TRACE", fresh)
    return fresh


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("name", tiny.CELLS)
def test_untraced_step_is_the_parents_path(name, collector, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("traced work with no profiler recording")

    monkeypatch.setattr(metrics._autograd_profiler, "record_function",
                        refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(metrics, "count", refuse)
    run = runner(name)
    for _ in range(3):
        run.step()
    assert digest(run.state) == PARENT_DIGEST[name]
    assert trace_totals() == {"spans": {}, "counters": {}}
    assert not collector._pending and not collector._kernels


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_step_changes_no_draw(name, collector):
    run = runner(name)
    with cpu_profile():
        for _ in range(3):
            run.step()
    assert digest(run.state) == PARENT_DIGEST[name]


def test_spans_are_user_annotations_nested_as_the_step(collector):
    run = runner(CDF)
    with cpu_profile() as prof:
        run.step()
    found = {}
    for ev in prof.events():
        if ev.name.startswith(metrics.SPAN_PREFIX):
            assert ev.is_user_annotation, ev.name
            outer = []
            parent = ev.cpu_parent
            while parent is not None:
                outer.append(parent.name)
                parent = parent.cpu_parent
            found.setdefault(ev.name[len(metrics.SPAN_PREFIX):], outer)
    assert set(found) == PLAN_SPANS | CDF_SPANS
    for name in CDF_SPANS:
        assert "repro_torch.plan.sweep" in found[name], found[name]
    for name in PLAN_SPANS:
        assert not any(n.startswith(metrics.SPAN_PREFIX)
                       for n in found[name])
    spans = trace_totals()["spans"]
    assert {n: s["parent"] for n, s in spans.items()} == dict(
        {n: None for n in PLAN_SPANS}, **{n: "plan.sweep" for n in CDF_SPANS})
    counts = {n: s["count"] for n, s in spans.items()}
    assert counts["plan.sweep"] == counts["plan.merge"] == 1
    assert counts["plan.update"] == 2
    assert counts["zen_cdf.tables"] == 1
    assert counts["zen_cdf.draws"] == 2 * counts["zen_cdf.doc_rows"]
    assert counts["zen_cdf.remedy"] == counts["zen_cdf.doc_rows"] >= 1
    assert all(s["device_s"] is None and s["host_s"] > 0
               for s in spans.values())
    assert spans["plan.sweep"]["host_s"] >= sum(
        spans[n]["host_s"] for n in CDF_SPANS)


@pytest.mark.parametrize("kernels", ["off", "on"])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_counters_equal_a_recount_step_by_step(name, kernels, collector,
                                               monkeypatch):
    """``on`` takes the kernels' routes, whose ops run their plain
    versions on the CPU; ``off`` the plain routes. ``zen_cdf``'s counters
    equal a recount at its route's term-3, term-2 and remedy steps."""
    monkeypatch.setenv("REPRO_KERNELS", kernels)
    searches, entries, seconds, routes = [], [], [], set()
    runs = []

    def spied(which, route):
        def term3(tables, word, doc, *args):
            routes.add(which)
            entries.append(int((tables.kd_cnt[doc.long()] > 0).sum()))
            walk = args[-1]
            if walk is not None:  # the chunk's word order: its words' runs
                w = word[walk[0].long()]
                runs.append(int((w[1:] != w[:-1]).sum()) + 1)
            return route.term3(tables, word, doc, *args)

        def term2(tables, n_wk, word, targets, count):
            searches.append(int((targets > 0).sum()))
            return route.term2(tables, n_wk, word, targets, count)

        def remedy(*args, **kwargs):
            seconds.append(int(cdf_remedy_plain(*args)[1].sum()))
            return route.remedy(*args, **kwargs)

        return route._replace(term3=term3, term2=term2, remedy=remedy)

    for which in ("KERNEL_ROUTE", "PLAIN_ROUTE"):
        monkeypatch.setattr(zen_cdf, which,
                            spied(which, getattr(zen_cdf, which)))
    run = runner(name)
    changed = 0
    with cpu_profile():
        for _ in range(3):
            before = run.state.topic
            run.step()
            changed += int((run.state.topic != before).sum())
            counters = trace_totals()["counters"]
            assert counters["counts.changed_tokens"] == changed
            if name == CDF:
                assert routes == {
                    "KERNEL_ROUTE" if kernels == "on" else "PLAIN_ROUTE"}
                assert searches and counters[
                    "zen_cdf.search_tokens"] == sum(searches)
                assert entries and counters[
                    "zen_cdf.row_entries"] == sum(entries)
                assert sum(seconds) > 0 and counters[
                    "zen_cdf.remedy_second"] == sum(seconds)
                # the kernel route walks the session's word orders (one
                # tile a chunk at this size), the plain route none
                assert bool(runs) == (kernels == "on")
                assert counters.get("zen_cdf.word_runs", 0) == sum(runs)
            else:
                assert not (routes or searches or entries or seconds)
                for counter in ("search_tokens", "row_entries",
                                "remedy_second", "word_runs"):
                    assert f"zen_cdf.{counter}" not in counters


def test_ops_count_their_predicates_on_the_plain_route(collector):
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, 7, (500,), generator=g, dtype=torch.int32)
    z_old = torch.randint(0, 4, (500,), generator=g, dtype=torch.int32)
    z_new = torch.randint(0, 4, (500,), generator=g, dtype=torch.int32)
    inc = torch.randint(0, 2, (500,), generator=g, dtype=torch.int32)
    targets = torch.rand(500, generator=g) - 0.5
    counts = torch.randint(0, 9, (7, 4), generator=g, dtype=torch.int32)
    term = torch.rand(4, generator=g)
    kd_cnt = torch.randint(0, 3, (7, 5), generator=g, dtype=torch.int32)
    kd_idx = torch.randint(0, 4, (7, 5), generator=g, dtype=torch.int32)
    words = torch.randint(0, 7, (500,), generator=g, dtype=torch.int32)
    search = (counts, words, rows, kd_cnt, kd_idx, term, torch.rand(
        7, generator=g), torch.cumsum(term, 0), targets.abs(), targets + 0.5)
    with cpu_profile():
        out = ops.topic_histogram(rows, z_old, z_new, inc, 7, 4, count=True)
        ops.topic_histogram(rows, z_old, z_new, None, 7, 4, count=True)
        hits = ops.cdf_row_search(counts, rows, term, targets, count=True)
        found = ops.doc_row_search(*search, beta=0.1, count=True)
    assert torch.equal(out, ops.topic_histogram(rows, z_old, z_new, inc,
                                                7, 4))
    assert torch.equal(hits, ops.cdf_row_search(counts, rows, term, targets))
    for a, b in zip(found, ops.doc_row_search(*search, beta=0.1)):
        assert torch.equal(a, b)
    changed = z_old != z_new
    assert trace_totals()["counters"] == {
        "counts.changed_tokens": int((changed & (inc != 0)).sum())
        + int(changed.sum()),
        "zen_cdf.search_tokens": int((targets > 0).sum()),
        "zen_cdf.row_entries": int((kd_cnt[rows.long()] > 0).sum())}


def test_remedy_counts_the_second_draws_on_the_plain_route(collector):
    """``ops.cdf_remedy(count=True)`` on the CPU adds the tokens that take
    draw b to ``zen_cdf.remedy_second``, and counting changes no output."""
    g = torch.Generator().manual_seed(7)
    t, k, i32 = 2000, 6, torch.int32
    z_old = torch.randint(0, k, (t,), generator=g, dtype=i32)
    # draw a's codes: term 1 (a topic), term 2 (-1), term 3 (-2 - topic)
    z_a = torch.randint(0, k, (t,), generator=g, dtype=i32)
    z_a[::2] = z_old[::2]
    kind = torch.randint(0, 3, (t,), generator=g)
    code = torch.stack([
        torch.where(kind == 0, z_a, torch.where(kind == 1, -1, -2 - z_a)),
        torch.randint(0, k, (t,), generator=g, dtype=i32)]).to(i32)
    args = (code, z_a, z_old, z_old,
            torch.randint(0, 9, (t,), generator=g, dtype=i32),
            torch.randint(0, 5, (t,), generator=g, dtype=i32),
            torch.randint(0, 4, (9, k), generator=g, dtype=i32),
            torch.randint(0, 4, (5, k), generator=g, dtype=i32),
            torch.rand(t, generator=g))
    with cpu_profile():
        got = ops.cdf_remedy(*args, count=True)
    want, second = cdf_remedy_plain(*args)
    assert torch.equal(got, want) and torch.equal(got, ops.cdf_remedy(*args))
    assert 0 < int(second.sum()) < t
    assert trace_totals()["counters"] == {
        "zen_cdf.remedy_second": int(second.sum())}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_readers_of_a_traced_run_on_the_cpu(name):
    result, lines = tiny.run(name, traced=1)
    assert result["correct"] is True, lines
    record = {"sweeps": result["attempted"]}
    for m in MS_METRICS:
        assert registry.metric_reader(m)(record) is None, m
        assert m not in result["metrics"]
    wanted = {"merge_changed_tokens_per_step"}
    if name == CDF:
        wanted.add("cdf_search_tokens_per_step")
    new = {m["name"] for m in registry.per_layer_for(
        registry.benchmark(), name) if m["source"].startswith("program_")}
    assert set(result["metrics"]) & new == wanted
    counters = trace_totals()["counters"]
    assert result["metrics"]["merge_changed_tokens_per_step"]["value"] == (
        counters["counts.changed_tokens"] / record["sweeps"]) > 0


def test_readers_of_a_program_without_spans(monkeypatch):
    import repro_torch.observe as observe

    monkeypatch.delattr(observe, "trace_totals")
    for m in MS_METRICS + ("merge_changed_tokens_per_step",
                           "cdf_search_tokens_per_step"):
        assert registry.metric_reader(m)({"sweeps": 3}) is None, m


@pytest.mark.parametrize("between", ["read", "untraced step"])
def test_two_profiled_windows_see_their_own_totals(between, collector):
    """Between the windows the totals are read, or a step runs with no
    profiler and nothing is read."""
    run = runner(CDF)
    for steps in (2, 1):
        changed = 0
        with cpu_profile():
            for _ in range(steps):
                before = run.state.topic
                run.step()
                changed += int((run.state.topic != before).sum())
        if between == "untraced step" and steps == 2:
            run.step()
            continue
        totals = trace_totals()
        assert totals["counters"]["counts.changed_tokens"] == changed
        spans = totals["spans"]
        assert spans["plan.sweep"]["count"] == steps
        assert spans["plan.update"]["count"] == 2 * steps
        assert spans["zen_cdf.tables"]["count"] == steps


def test_registry_timer_is_the_hot_paths_span(collector):
    reg = metrics.MetricsRegistry()
    with reg.timer("rebuild") as quiet:
        pass
    with cpu_profile() as prof:
        with reg.timer("rebuild") as traced:
            with metrics.span("inner"):
                pass
    assert type(quiet) is type(traced) is metrics.SpanTimer
    assert reg.histogram("rebuild").count == 2
    names = [e.name for e in prof.events()]
    assert "repro_torch.rebuild" in names and "repro_torch.inner" in names
    spans = trace_totals()["spans"]
    assert spans["rebuild"]["count"] == 1
    assert spans["inner"]["parent"] == "rebuild"
    assert metrics.span("off") is metrics.span("also off")


def test_kernel_counter_bookkeeping(collector, monkeypatch):
    """``_build.work_counter`` on a stand-in for a library's counter (an
    int64 the kernel only ever adds to): each profiled stretch reads its
    own launches' work, read or not before the next one starts, and the
    counter's address is asked for once."""
    import contextlib
    import ctypes
    import types

    from repro_torch.kernels import _build

    card = {"value": 0, "asked": 0}

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    def counter(at, value):
        ctypes.c_void_p.from_address(at).value = 4096
        if value is None:
            card["asked"] += 1
        else:
            ctypes.c_ulonglong.from_address(value).value = card["value"]
        return 0

    monkeypatch.setattr(_build, "_COUNTERS", {})
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        topic_histogram_changed=counter))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cuda = torch.device("cuda", 0)

    def launch(work):
        assert _build.work_counter("topic_histogram_changed", "k5",
                                   cuda) == 4096
        card["value"] += work

    def window(works, read=True):
        with cpu_profile():
            with metrics.span("step"):
                for w in works:
                    launch(w)
        return trace_totals()["counters"] if read else None

    assert window([10, 15]) == {"k5": 25}
    assert window([5]) == {"k5": 5}
    window([7], read=False)
    with metrics.span("untraced"):
        pass
    assert window([3, 4]) == {"k5": 7}
    assert card["asked"] == 1
