"""``zen_cdf``'s word order of a chunk's tokens (``cdf_token_order``) and
the doc-row search that walks it, on the CPU: the order is a permutation
of each chunk, word-major within its tiles with positions ascending among
equal words, and its runs of equal words are counted once; walking it
changes no output of ``ops.doc_row_search`` (its plain version here) and
no topic of a session's sweep. This file imports no JAX.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.algorithms import zen_cdf as zc
from repro_torch.core.types import Corpus, LDAHyperParams
from repro_torch.kernels import ops
from repro_torch.kernels.cdf_search import doc_row_search_plain
from repro_torch.observe import metrics, trace_totals
from repro_torch.train.session import RunConfig, TrainSession


def _words(case, t, g):
    if case == "one_word":
        return torch.full((t,), 7, dtype=torch.int32)
    if case == "all_distinct":
        return torch.randperm(t, generator=g).to(torch.int32)
    if case == "skewed":  # a few words take most tokens
        return (torch.rand(t, generator=g) ** 4 * 60).to(torch.int32)
    return torch.randint(0, 50, (t,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("case,t,chunk,tile", [
    ("random", 1000, 300, 128),  # the chunk does not divide T
    ("random", 200, 1024, 64),  # T below one chunk
    ("one_word", 500, 128, 32),
    ("all_distinct", 777, 256, 100),
    ("skewed", 1000, 256, 1 << 22),  # whole-chunk tiles
    ("random", 1000, 250, 250),  # a tile a chunk
    ("skewed", 513, 512, 7),  # a last chunk of one token
])
def test_order_is_word_major_within_tiles(case, t, chunk, tile):
    g = torch.Generator().manual_seed(t + chunk + tile)
    word = _words(case, t, g)
    got = zc.cdf_token_order(word, chunk, tile)
    assert got.chunk == chunk and got.order.dtype == torch.int32
    assert got.order.shape == (t,)
    assert len(got.runs) == -(-t // chunk)
    for c, s in enumerate(range(0, t, chunk)):
        pos = got.order[s:s + chunk].long()
        w = word[s:s + chunk].long()
        n = w.shape[0]
        assert torch.equal(torch.sort(pos).values, torch.arange(n))
        runs = 0
        for a in range(0, n, tile):
            # each tile's stretch of the order holds that tile's positions
            at = pos[a:a + tile]
            assert bool(((at >= a) & (at < a + tile)).all())
            key = w[at] * n + at  # words ascend, then positions
            assert bool((key[1:] > key[:-1]).all())
            runs += int(torch.unique(w[at]).numel())
        assert got.runs[c].dim() == 0 and int(got.runs[c]) == runs
    if case == "one_word":
        assert [int(r) for r in got.runs] == [
            -(-min(chunk, t - s) // tile) for s in range(0, t, chunk)]
    if case == "all_distinct":
        assert sum(int(r) for r in got.runs) == t


def test_order_of_no_token():
    got = zc.cdf_token_order(torch.zeros(0, dtype=torch.int32), 16, 4)
    assert got.order.shape == (0,) and got.runs == ()


def _search_args(t, k, j, w, d, seed):
    g = torch.Generator().manual_seed(seed)
    i32 = torch.int32
    kd_cnt = torch.sort(torch.randint(0, 4, (d, j), generator=g, dtype=i32),
                        1, descending=True).values.contiguous()
    return (torch.randint(0, 9, (w, k), generator=g, dtype=i32),
            torch.randint(0, w, (t,), generator=g, dtype=i32),
            torch.sort(torch.randint(0, d, (t,), generator=g)).values.to(i32),
            kd_cnt, torch.randint(0, k, (d, j), generator=g, dtype=i32),
            torch.rand(k, generator=g), torch.rand(w, generator=g),
            torch.rand(k, generator=g).cumsum(0), torch.rand(t, generator=g),
            torch.rand(t, generator=g))


@pytest.mark.parametrize("t,k,j,w,tile", [(4099, 64, 64, 30, 1 << 22),
                                          (4099, 300, 160, 4099, 512),
                                          (1000, 20, 7, 5, 100),
                                          (33, 5, 1, 3, 8)])
def test_doc_row_search_in_word_order_is_bit_equal(t, k, j, w, tile,
                                                   monkeypatch):
    """``ops.doc_row_search`` with the word order, and with a random
    permutation, equals it without one, bit for bit, and counts the same
    live row entries."""
    monkeypatch.setattr(metrics, "TRACE", metrics.TraceCollector())
    args = _search_args(t, k, j, w, max(2, t // 50), t + j)
    want = ops.doc_row_search(*args, beta=0.01)
    perm = torch.randperm(t, generator=torch.Generator().manual_seed(j))
    for order in (zc.cdf_token_order(args[1], t, tile).order,
                  perm.to(torch.int32)):
        with profile(activities=[ProfilerActivity.CPU]):
            got = ops.doc_row_search(*args, beta=0.01, order=order,
                                     count=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        live = int((args[3][args[2].long()] > 0).sum())
        assert trace_totals()["counters"] == {"zen_cdf.row_entries": live}
        for a, b in zip(doc_row_search_plain(*args, 0.01, order=order), want):
            assert torch.equal(a, b)


def test_doc_row_search_refuses_an_order_out_of_range():
    args = _search_args(50, 8, 4, 6, 3, 0)
    for bad in (50, -1):
        order = torch.arange(50, dtype=torch.int32)
        order[9] = bad
        with pytest.raises(IndexError, match="order outside"):
            ops.doc_row_search(*args, beta=0.01, order=order)


def _corpus(t=600, w=40, d=12, seed=3):
    g = torch.Generator().manual_seed(seed)
    word = torch.randint(0, w, (t,), generator=g, dtype=torch.int32)
    doc = torch.sort(torch.randint(0, d, (t,), generator=g)).values
    return Corpus(word=word, doc=doc.to(torch.int32), num_words=w,
                  num_docs=d)


def _session(corpus, kernels, token_chunk=0):
    return TrainSession(corpus, LDAHyperParams(num_topics=16), RunConfig(
        algorithm="zen_cdf", max_kd=8, kernels=kernels,
        token_chunk=token_chunk), device="cpu")


@pytest.mark.parametrize("forced", ["constant", "token_chunk"])
def test_session_sweeps_same_with_and_without_the_order(forced, monkeypatch):
    """On the kernel route (``kernels="on"``, its plain versions here) the
    session prepares each chunk's word order once, the doc-row search is
    handed each chunk's slice of it, and the topics after two steps equal
    those of the same session walking token order."""
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    if forced == "constant":
        monkeypatch.setattr(zc, "CDF_KERNEL_CHUNK_TOKENS", 97)  # ragged
        monkeypatch.setattr(zc, "CDF_ORDER_TILE_TOKENS", 40)
        chunk, token_chunk = 97, 0
    else:
        chunk = token_chunk = 150
    corpus = _corpus()
    walks = []

    def spy(*args, order=None, **kwargs):
        walks.append(None if order is None else order.clone())
        return ops.doc_row_search(*args, order=order, **kwargs)

    monkeypatch.setattr(zc, "doc_row_search", spy)
    topics = []
    for walk in (True, False):
        sess = _session(corpus, "on", token_chunk)
        aux = sess.plan._aux
        assert isinstance(aux, zc.CdfOrder) and aux.chunk == chunk
        if not walk:
            sess.plan._aux = None
        st = sess.init(5)
        walks.clear()
        for _ in range(2):
            st = sess.step(st)
        chunks = -(-corpus.num_tokens // chunk)
        assert len(walks) == 2 * chunks
        if walk:
            for i, o in enumerate(walks):
                s = (i % chunks) * chunk
                assert torch.equal(o, aux.order[s:s + chunk])
        else:
            assert walks == [None] * (2 * chunks)
        topics.append(st.topic)
    assert torch.equal(*topics)


def test_no_order_off_the_kernel_route(monkeypatch):
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    assert _session(_corpus(), "off").plan._aux is None
    assert _session(_corpus(), "auto").plan._aux is None  # the CPU


def test_cell_refuses_an_order_of_other_chunks(monkeypatch):
    corpus = _corpus()
    sess = _session(corpus, "on")
    st = sess.init(1)
    other = zc.cdf_token_order(corpus.word, 50, 8)
    with pytest.raises(ValueError, match="chunks of 50"):
        zc.zen_cdf_cell(7, corpus.word, corpus.doc, st.topic, None, st.n_wk,
                        st.n_kd, st.n_k, sess.hyper, corpus.num_words, 8,
                        use_kernel=True, order=other)
    # the plain route walks its tokens all at once: an order changes nothing
    want = zc.zen_cdf_cell(7, corpus.word, corpus.doc, st.topic, None,
                           st.n_wk, st.n_kd, st.n_k, sess.hyper,
                           corpus.num_words, 8)
    got = zc.zen_cdf_cell(7, corpus.word, corpus.doc, st.topic, None,
                          st.n_wk, st.n_kd, st.n_k, sess.hyper,
                          corpus.num_words, 8, order=other)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernels", ["on", "off"])
def test_word_runs_counted_while_tracing(kernels, monkeypatch):
    """A traced step adds the runs of the orders its doc-row search walked
    (each chunk's, computed once in set-up), and nothing where it walks
    token order; an untraced step counts nothing."""
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    monkeypatch.setattr(metrics, "TRACE", metrics.TraceCollector())
    monkeypatch.setattr(zc, "CDF_KERNEL_CHUNK_TOKENS", 128)
    monkeypatch.setattr(zc, "CDF_ORDER_TILE_TOKENS", 50)
    corpus = _corpus()
    sess = _session(corpus, kernels)
    st = sess.step(sess.init(2))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            st = sess.step(st)
    counters = trace_totals()["counters"]
    if kernels == "on":
        # the distinct words of each 50-token tile of each 128-token chunk
        runs = sum(int(torch.unique(corpus.word[c + a:c + min(
            a + 50, 128)]).numel()) for c in range(0, 600, 128)
            for a in range(0, min(128, 600 - c), 50))
        assert sum(int(r) for r in sess.plan._aux.runs) == runs
        assert counters[zc.WORD_RUNS] == 2 * runs
    else:
        assert zc.WORD_RUNS not in counters
