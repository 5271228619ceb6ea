"""The training step's spans and the work counters of kernels 5 and 7, of
the doc-row search and of ``zen_cdf``'s remedy on the card (marker
``gpu``; they skip without one). Run them where a card is:

    PYTHONPATH=src:. python -m pytest -m gpu --noconftest \
        tests/test_torch_trace_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.tests import tiny
from repro_torch.algorithms import zen_cdf
from repro_torch.kernels.cdf_search import (cdf_row_search_cuda,
                                            doc_row_search_cuda,
                                            doc_row_search_plain)
from repro_torch.kernels.cdf_tokens import cdf_remedy_cuda, cdf_remedy_plain
from repro_torch.kernels.topic_histogram import topic_histogram_cuda
from repro_torch.observe import trace_totals

pytestmark = pytest.mark.gpu
SIZES = dict(num_words=5000, num_docs=2000, mean_doc_len=100,
             num_topics=256)
CDF_SPANS = ("zen_cdf.tables", "zen_cdf.doc_rows", "zen_cdf.draws",
             "zen_cdf.remedy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def card_profile():
    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_spans_take_device_time(cuda, cell):
    result, lines = tiny.run(cell, seconds=0.5, traced=1, device=cuda,
                             **SIZES)
    assert result["correct"] is True, lines
    spans = trace_totals()["spans"]
    assert {"plan.sweep", "plan.merge", "plan.update"} <= set(spans)
    assert all(s["device_s"] > 0 for s in spans.values()), spans
    children = [n for n, s in spans.items() if s["parent"] == "plan.sweep"]
    if cell == "nytimes-cdf-sweeps":
        assert sorted(children) == sorted(CDF_SPANS)
    assert sum(spans[n]["device_s"] for n in children) <= (
        spans["plan.sweep"]["device_s"])
    for m in ("plan_sweep_ms", "plan_merge_ms", "plan_update_ms",
              "merge_changed_tokens_per_step"):
        assert result["metrics"][m]["value"] > 0, m


@pytest.mark.parametrize("t,r,k", [(100_000, 300, 1000), (20_000, 40, 70_000),
                                   (5, 3, 7)])
def test_kernel_5_same_with_its_counter(cuda, t, r, k):
    g = torch.Generator(device=cuda).manual_seed(t + k)
    i32 = torch.int32
    rows = torch.randint(0, r, (t,), generator=g, device=cuda, dtype=i32)
    z_old = torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    z_new = torch.where(
        torch.rand(t, generator=g, device=cuda) < 0.5, z_old,
        torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32))
    inc = torch.randint(0, 2, (t,), generator=g, device=cuda, dtype=i32)
    changed = z_old != z_new
    for weights, want in ((inc, changed & (inc != 0)), (None, changed)):
        plain = topic_histogram_cuda(rows, z_old, z_new, weights, r, k)
        with card_profile():
            counted = topic_histogram_cuda(rows, z_old, z_new, weights, r, k,
                                           count=True)
        assert torch.equal(plain, counted)
        assert trace_totals()["counters"] == {
            "counts.changed_tokens": int(want.sum())}


@pytest.mark.parametrize("t,k", [(300_000, 1000), (1000, 37), (3, 5)])
def test_kernel_7_same_with_its_counter(cuda, t, k):
    g = torch.Generator(device=cuda).manual_seed(t + k)
    r = 64
    counts = torch.randint(0, 20, (r, k), generator=g, device=cuda,
                           dtype=torch.int32)
    rows = torch.randint(0, r, (t,), generator=g, device=cuda,
                         dtype=torch.int32)
    term = torch.rand(k, generator=g, device=cuda)
    # a third of the targets search: the others are 0, negative or NaN
    u = torch.rand(t, generator=g, device=cuda)
    targets = torch.where(u < 1 / 3, u * 30.0, torch.where(
        u < 0.8, 0.0, torch.where(u < 0.9, -1.0, float("nan"))))
    plain = cdf_row_search_cuda(counts, rows, term, targets)
    with card_profile():
        counted = cdf_row_search_cuda(counts, rows, term, targets, count=True)
        again = cdf_row_search_cuda(counts, rows, term, targets, count=True)
    assert torch.equal(plain, counted) and torch.equal(plain, again)
    assert trace_totals()["counters"] == {
        "zen_cdf.search_tokens": 2 * int((targets > 0).sum())}


@pytest.mark.parametrize("t,k,j", [(300_000, 1000, 128), (1000, 300, 200),
                                   (3, 5, 1)])
def test_doc_row_search_same_with_its_counter(cuda, t, k, j):
    """The counter of live row entries on the card equals the plain
    version's count (``ops.doc_row_search`` on the CPU), and counting
    changes no output."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(t + j)
    i32 = torch.int32
    w, d = 500, max(2, t // 300)
    kd_cnt = torch.randint(0, 4, (d, j), generator=g, device=cuda, dtype=i32)
    kd_cnt = torch.sort(kd_cnt, dim=1, descending=True).values.contiguous()
    args = (
        torch.randint(0, 9, (w, k), generator=g, device=cuda, dtype=i32),
        torch.randint(0, w, (t,), generator=g, device=cuda, dtype=i32),
        torch.randint(0, d, (t,), generator=g, device=cuda, dtype=i32),
        kd_cnt,
        torch.randint(0, k, (d, j), generator=g, device=cuda, dtype=i32),
        torch.rand(k, generator=g, device=cuda),
        torch.rand(w, generator=g, device=cuda),
        torch.rand(k, generator=g, device=cuda).cumsum(0),
        torch.rand(t, generator=g, device=cuda),
        torch.rand(t, generator=g, device=cuda))
    plain = doc_row_search_cuda(*args, 0.01)
    with card_profile():
        counted = doc_row_search_cuda(*args, 0.01, count=True)
        again = doc_row_search_cuda(*args, 0.01, count=True)
    card = trace_totals()["counters"]
    for a, b, c, p in zip(plain, counted, again,
                          doc_row_search_plain(*args, 0.01)):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, p)
    with profile(activities=[ProfilerActivity.CPU]):
        ops.doc_row_search(*(x.cpu() for x in args), beta=0.01, count=True)
    assert card == {"zen_cdf.row_entries": 2 * trace_totals()["counters"][
        "zen_cdf.row_entries"]}
    assert card["zen_cdf.row_entries"] == 2 * int(
        (kd_cnt[args[2].long()] > 0).sum())


@pytest.mark.parametrize("t", [1 << 20, 4099, 3])
def test_remedy_same_with_its_counter(cuda, t):
    """The counter of tokens that take draw b on the card equals the plain
    version's count, and counting changes no output."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(t)
    i32, k, w, d = torch.int32, 300, 500, max(2, t // 300)
    z1 = torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    kind = torch.randint(0, 3, (t,), generator=g, device=cuda)
    code = torch.stack([
        torch.where(kind == 0, z1, torch.where(kind == 1, -1, -2 - z1)),
        torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    ]).to(i32)
    z_old = torch.where(kind < 2, z1, torch.randint(
        0, k, (t,), generator=g, device=cuda, dtype=i32))
    args = (code, z1, z1, z_old,
            torch.randint(0, w, (t,), generator=g, device=cuda, dtype=i32),
            torch.randint(0, d, (t,), generator=g, device=cuda, dtype=i32),
            torch.randint(0, 4, (w, k), generator=g, device=cuda, dtype=i32),
            torch.randint(0, 3, (d, k), generator=g, device=cuda, dtype=i32),
            torch.rand(t, generator=g, device=cuda))
    plain = cdf_remedy_cuda(*args)
    with card_profile():
        counted = cdf_remedy_cuda(*args, count=True)
        again = cdf_remedy_cuda(*args, count=True)
    card = trace_totals()["counters"]
    want, second = cdf_remedy_plain(*args)
    for x in (plain, counted, again):
        assert torch.equal(x, want)
    assert card == {"zen_cdf.remedy_second": 2 * int(second.sum())}
    with profile(activities=[ProfilerActivity.CPU]):
        ops.cdf_remedy(*(x.cpu() for x in args), count=True)
    assert trace_totals()["counters"] == {
        "zen_cdf.remedy_second": int(second.sum())}


def test_counters_of_a_session_equal_a_recount(cuda, monkeypatch):
    from portbench import registry

    searches, entries, seconds, runs = [], [], [], []
    route = zen_cdf.KERNEL_ROUTE

    def spy(tables, n_wk, word, targets, count):
        searches.append((targets > 0).sum())
        return route.term2(tables, n_wk, word, targets, count)

    def spy_doc(tables, word, doc, *args):
        entries.append((tables.kd_cnt[doc.long()] > 0).sum())
        # the session's word order of the chunk: its runs of equal words
        # within each tile, recounted
        order, tile = args[-1][0].long(), zen_cdf.CDF_ORDER_TILE_TOKENS
        key = (torch.arange(order.shape[0], device=order.device) // tile
               << 32) + word[order].long()
        runs.append((key[1:] != key[:-1]).sum() + 1)
        return route.term3(tables, word, doc, *args)

    def spy_remedy(*args, **kwargs):
        seconds.append(cdf_remedy_plain(*args)[1].sum())
        return route.remedy(*args, **kwargs)

    monkeypatch.setattr(zen_cdf, "KERNEL_ROUTE", route._replace(
        term2=spy, term3=spy_doc, remedy=spy_remedy))
    cell, config, traffic = tiny.spec("nytimes-cdf-sweeps", **SIZES)
    run = registry.runner(config["runner"]).Runner(
        config, traffic, cell, tiny.SEED, cuda)
    run.build({})
    run.step()
    for spied in (searches, entries, seconds, runs):
        spied.clear()
    changed = 0
    with card_profile():
        for _ in range(3):
            before = run.state.topic
            run.step()
            changed += int((run.state.topic != before).sum())
    assert trace_totals()["counters"] == {
        "counts.changed_tokens": changed,
        "zen_cdf.search_tokens": int(sum(searches)),
        "zen_cdf.row_entries": int(sum(entries)),
        "zen_cdf.remedy_second": int(sum(seconds)),
        "zen_cdf.word_runs": int(sum(runs))}
    assert sum(seconds) > 0 and sum(runs) > 0
