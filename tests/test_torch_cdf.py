"""The zen_cdf slice (kernel 7, ``zen_cdf`` train and native serve, the
``std`` backend, ``cgs_sweep_serial``) against the JAX package, on the CPU.

* Kernel 7: the port's ``ops.cdf_row_search`` (its plain version here) and
  its oracle ``ref.cdf_row_search_ref`` add the prefix sums in the CUDA
  kernel's order and are bit-equal. The reference's ``ops.cdf_row_search``
  (Pallas, interpret mode) and ``ref.cdf_row_search_ref`` add per K tile
  with ``jnp.cumsum``: a result may differ from the port's only where the
  target lies within 1e-5 of the row's mass from a float64 prefix sum
  between the two answers (a near-tie). Mismatches are counted; the grid
  puts targets exactly on the reference's prefix sums so that they occur.
* ``zen_cdf`` draws, fed the reference's own ``jax.random`` uniforms (split
  as the reference splits its key), equal the reference's except where a
  token's scaled uniform lies within 1e-5 of its total mass from a
  boundary it is compared with (branch masses, a CDF prefix of its term).
  The frozen serving tables agree within float32 round-off (rtol 1e-5:
  cumulative sums over K in another order), the served topics up to
  counted near-ties.
* The doc top-k keeps ``jax.lax.top_k``'s tie order; no chunking changes a
  draw; ``kernels="on"`` and ``"off"`` differ at near-ties only.
* Whole runs are statistical: from the reference's initial topics, the
  per-token llh of ``zen_cdf`` and ``std`` after 4 iterations lies within 8%
  of the reference run's, the count invariants exact after every step.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.algorithms import zen_cdf as jzc
from repro.algorithms.zen_dense import _searchsorted_rows as j_ssr
from repro.core import decompositions as jdec
from repro.core import sampler as jsampler
from repro.core.likelihood import predictive_llh as j_predictive_llh
from repro.core.types import CGSState as JState
from repro.core.types import LDAHyperParams as JHyper
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.train.session import RunConfig as JRunConfig
from repro.train.session import TrainSession as JSession
from repro_torch import algorithms as talg
from repro_torch.algorithms import zen_cdf as tzc
from repro_torch.algorithms.zen_dense import _searchsorted_rows
from repro_torch.core import sampler as tsampler
from repro_torch.core.init import make_state, random_init
from repro_torch.core.keys import as_key, fold_in, key_seed, stream_uniforms
from repro_torch.core.likelihood import predictive_llh
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.data.corpus import synthetic_lda_corpus
from repro_torch.kernels import cdf_search, cdf_tokens, ops, ref
from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig
from repro_torch.train.session import RunConfig, TrainSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 1e-5  # of the row's (or the token's total) mass


def t_(a):
    return torch.from_numpy(np.array(a))


def _route(use_kernel):
    return tzc.KERNEL_ROUTE if use_kernel else tzc.PLAIN_ROUTE


def _chunk_tokens(use_kernel, num_tokens, max_kd, token_chunk=0):
    """Tokens a chunk of ``zen_cdf_cell`` on the route, by its chunk rule."""
    width, elems = _route(use_kernel).chunk(max_kd)
    return tsampler.chunk_size(num_tokens, width, token_chunk, elems)


def _near_ties(target, vals, got, want):
    """Rows where ``got`` != ``want`` (lower-bound positions into the rows
    of ``vals``), after checking each is a near-tie: a float64 prefix sum
    between the two positions lies within NEAR_TIE of the row's mass from
    the target."""
    bad = np.flatnonzero(got != want)
    pre = np.cumsum(np.asarray(vals, np.float64), axis=1)
    for t in bad:
        lo, hi = sorted((int(got[t]), int(want[t])))
        gap = np.abs(pre[t, lo:hi + 1] - target[t]).min()
        assert gap <= NEAR_TIE * max(pre[t, -1], 1e-30), \
            (t, got[t], want[t], gap, pre[t, -1])
    return bad


# -- kernel 7 ----------------------------------------------------------------

@pytest.mark.parametrize(
    "t,k,w,bt,bk",
    [
        (64, 128, 40, 64, 128),
        (9, 33, 12, 8, 128),  # unaligned -> the reference's padding path
        (300, 700, 80, 64, 128),
        (128, 256, 64, 64, 256),
        (1, 5, 3, 8, 128),
    ],
)
def test_cdf_row_search_matches_reference_up_to_near_ties(t, k, w, bt, bk):
    """The reference's shapes (``tests/test_kernels.py``), targets past the
    row mass (the clamp to K - 1) and exactly on the reference's prefix
    sums included."""
    rng = np.random.default_rng(t + k)
    counts = rng.integers(0, 50, (w, k)).astype(np.int32)
    rows = rng.integers(0, w, t).astype(np.int32)
    term = (rng.random(k) + 1e-3).astype(np.float32)
    vals = counts[rows].astype(np.float32) * term[None, :]
    mass = vals.astype(np.float64).sum(1)
    # * 1.1: ~10% of targets overshoot the total mass -> the clamp
    tgt = rng.random(t) * mass * 1.1
    cdf = np.asarray(jnp.cumsum(jnp.asarray(vals), axis=1))
    on = rng.integers(0, k, t)
    tgt[::3] = cdf[np.arange(t), on][::3]  # exactly on a prefix sum
    tgt = tgt.astype(np.float32)
    args = [t_(a) for a in (counts, rows, term, tgt)]
    got = ops.cdf_row_search(*args).numpy()
    assert got.dtype == np.int32 and ((got >= 0) & (got < k)).all()
    np.testing.assert_array_equal(got, ref.cdf_row_search_ref(*args).numpy())
    np.testing.assert_array_equal(
        got, cdf_search.cdf_row_search_plain(*args).numpy())
    jargs = [jnp.asarray(a) for a in (counts, rows, term, tgt)]
    for want in (np.asarray(jops.cdf_row_search(*jargs, bt=bt, bk=bk)),
                 np.asarray(jref.cdf_row_search_ref(*jargs, bk=bk))):
        bad = _near_ties(tgt, vals, got, want)
        # targets placed on a prefix sum (every third row) make the ties;
        # elsewhere at most one row in 300 may
        assert bad[bad % 3 != 0].size <= max(1, t // 300), bad


def test_cdf_row_search_walk_stops_at_the_target():
    """The kernel's walk stops once the carry reaches the target; for the
    non-negative terms its callers pass, the count equals the whole-row
    oracle's, clamped to K - 1 past the row mass."""
    counts = t_(np.ones((1, 64), np.int32))
    term = torch.ones(64)
    tgt = torch.tensor([0.0, 0.5, 10.0, 64.0, 100.0])
    rows = torch.zeros(5, dtype=torch.int32)
    got = ops.cdf_row_search(counts, rows, term, tgt)
    assert got.tolist() == [0, 0, 9, 63, 63]
    assert torch.equal(got, ref.cdf_row_search_ref(counts, rows, term, tgt))


def test_cdf_row_search_refuses_rows_out_of_range_and_counts_no_cpu_launch():
    counts = t_(np.ones((4, 8), np.int32))
    term, tgt = torch.ones(8), torch.full((3,), 2.0)
    ops.reset_launch_counts()
    base = ops.cdf_row_search(counts, torch.tensor([0, 1, 3],
                                                   dtype=torch.int32),
                              term, tgt)
    assert base.tolist() == [1, 1, 1]
    assert ops.cdf_row_search(counts, torch.tensor([0, 1, 3],
                                                   dtype=torch.int32),
                              term, tgt, bt=8, bk=1024).tolist() == [1, 1, 1]
    assert ops.launch_counts()["cdf_row_search"] == 0
    for bad in ([0, 4, 1], [0, -1, 1]):
        with pytest.raises(IndexError, match="outside"):
            ops.cdf_row_search(counts, torch.tensor(bad, dtype=torch.int32),
                               term, tgt)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cdf_search.cdf_row_search_cuda(
            counts, torch.zeros(3, dtype=torch.int32), term, tgt)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.cdf_row_search(counts.to("meta"), torch.zeros(
            3, dtype=torch.int32, device="meta"), term.to("meta"),
            tgt.to("meta"))


# -- search helpers and the doc top-k ----------------------------------------

def test_search_helpers_equal_the_references():
    rng = np.random.default_rng(4)
    mat = np.cumsum(rng.random((30, 37)).astype(np.float32), axis=1)
    mat[3] = 0.0  # a zero row
    rows = rng.integers(0, 30, 500).astype(np.int32)
    tgt = (rng.random(500) * 20 - 1).astype(np.float32)
    tgt[::4] = mat[rows[::4], rng.integers(0, 37, 125)]  # on an entry
    np.testing.assert_array_equal(
        tzc._bsearch_gather(t_(mat), t_(rows), t_(tgt)).numpy(),
        np.asarray(jzc._bsearch_gather(jnp.asarray(mat), jnp.asarray(rows),
                                       jnp.asarray(tgt))))
    got = _searchsorted_rows(t_(mat[rows]), t_(tgt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ssr(jnp.asarray(mat[rows]),
                                      jnp.asarray(tgt))))
    for k in (1, 2, 5):  # tiny rows: the halving walk's edge
        m = np.cumsum(np.ones((2, k), np.float32), axis=1)
        r = np.array([0, 1, 1, 0], np.int32)
        x = np.array([0.0, 1.0, 1.5, 9.0], np.float32)
        np.testing.assert_array_equal(
            tzc._bsearch_gather(t_(m), t_(r), t_(x)).numpy(),
            np.asarray(jzc._bsearch_gather(jnp.asarray(m), jnp.asarray(r),
                                           jnp.asarray(x))))


@pytest.mark.parametrize("kd", [1, 2, 7, 49, 50])
def test_doc_topk_keeps_the_reference_tie_order(kd):
    """Equal counts: the lower topic id first, as ``jax.lax.top_k`` (the
    reference's serving rows) orders them. The reference's training rows
    come from ``approx_max_k``, which on the CPU orders ties the same way
    for 1 < kd < K; at kd == 1 and kd == K it returns another member of
    the tie first (a reference property: its rows are still a valid top-k,
    so the sampler is the same, but draws may differ there)."""
    n = np.random.default_rng(kd).integers(0, 4, (300, 50)).astype(np.int32)
    cnt, idx = tzc.doc_topk(t_(n), kd)
    jv, ji = jax.lax.top_k(jnp.asarray(n), kd)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    av, ai = jax.lax.approx_max_k(jnp.asarray(n, jnp.float32), kd,
                                  recall_target=0.95)
    ai = np.asarray(ai)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(av, np.int32))
    np.testing.assert_array_equal(np.take_along_axis(n, ai, 1), cnt.numpy())
    if 1 < kd < 50:
        np.testing.assert_array_equal(idx.numpy(), ai)


def test_doc_topk_in_blocks(monkeypatch):
    n = np.random.default_rng(2).integers(0, 6, (97, 20)).astype(np.int32)
    whole = tzc.doc_topk(t_(n), 8)
    monkeypatch.setattr(tzc, "_TOPK_ELEMS", 60)  # 3 rows per block
    for a, b in zip(whole, tzc.doc_topk(t_(n), 8)):
        assert torch.equal(a, b)


# -- zen_cdf training draws ----------------------------------------------------

def _setup(seed, e=600, w=40, d=12, k=20):
    rng = np.random.default_rng(seed)
    word = rng.integers(0, w, e).astype(np.int32)
    doc = np.sort(rng.integers(0, d, e)).astype(np.int32)
    topic = ((word * 7 + doc * 3 + rng.integers(0, 6, e)) % k).astype(
        np.int32)
    n_wk = np.zeros((w, k), np.int32)
    n_kd = np.zeros((d, k), np.int32)
    np.add.at(n_wk, (word, topic), 1)
    np.add.at(n_kd, (doc, topic), 1)
    return dict(word=word, doc=doc, topic=topic, n_wk=n_wk, n_kd=n_kd,
                n_k=n_wk.sum(0).astype(np.int32), w=w, d=d, k=k, e=e)


def _hypers(k):
    kw = dict(num_topics=k, alpha=0.1, beta=0.05)
    return JHyper(**kw), LDAHyperParams(**kw)


def _reference_uniforms(key, e):
    """The three uniform streams the reference's zen_cdf_cell draws."""
    key_a, key_b, key_r = jax.random.split(key, 3)
    return [np.asarray(jax.random.uniform(jax.random.split(kk)[0], (e,)))
            for kk in (key_a, key_b)] \
        + [np.asarray(jax.random.uniform(key_r, (e,)))]


def _cell_near_ties(s, jh, kd, u):
    """Per token: does draw a's or draw b's scaled uniform lie within
    NEAR_TIE of the token's total mass from a boundary it is compared with
    (the branch masses, or a float64 prefix sum of term 1, of the word's
    term-2 row or of the doc's top-kd term-3 row)?"""
    terms = jdec.precompute_zen_terms(jnp.asarray(s["n_k"]), jh, s["w"])
    t1, t4, g = (np.asarray(x, np.float64) for x in (terms.t1, terms.t4,
                                                    terms.g_dense))
    word, doc = s["word"], s["doc"]
    idx = np.argsort(-s["n_kd"], axis=1, kind="stable")[:, :kd][doc]
    cnt = np.take_along_axis(s["n_kd"][doc], idx, 1).astype(np.float64)
    d_vals = np.where(cnt > 0, cnt * (s["n_wk"][word[:, None], idx] + jh.beta)
                      * t1[idx], 0.0)
    g_pre = np.broadcast_to(np.cumsum(g), (s["e"], s["k"]))
    m1 = g_pre[:, -1:]
    w_pre = m1 + np.cumsum(s["n_wk"][word] * t4[None, :], axis=1)
    m12 = w_pre[:, -1:]
    d_pre = m12 + np.cumsum(d_vals, axis=1)
    bounds = np.concatenate([g_pre, w_pre, d_pre], axis=1)
    total = d_pre[:, -1]
    near = np.zeros(s["e"], bool)
    for u01 in u[:2]:
        gap = np.abs(bounds - (u01 * total)[:, None]).min(1)
        near |= gap <= NEAR_TIE * total
    return near


@pytest.mark.parametrize("seed,kd,use_kernel", [(1, 4, False), (2, 16, False),
                                                (3, 8, True)])
def test_zen_cdf_draws_fed_reference_uniforms(seed, kd, use_kernel):
    s = _setup(seed)
    jh, th = _hypers(s["k"])
    key = jax.random.key(seed)
    names = ("word", "doc", "topic")
    want = np.asarray(jzc.zen_cdf_cell(
        key, *(jnp.asarray(s[n]) for n in names), None,
        jnp.asarray(s["n_wk"]), jnp.asarray(s["n_kd"]),
        jnp.asarray(s["n_k"]), jh, s["w"], kd, use_kernel=use_kernel))
    u = _reference_uniforms(key, s["e"])
    tables = tzc.build_cdf_tables(t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]),
                                  th, s["w"], kd, _route(use_kernel))
    got = tzc.zen_cdf_tokens(tables, *(t_(s[n]) for n in names),
                             t_(s["n_wk"]), t_(s["n_kd"]), th,
                             t_(np.stack(u))).numpy()
    assert got.dtype == np.int32 and ((got >= 0) & (got < s["k"])).all()
    bad = np.flatnonzero(got != want)
    near = _cell_near_ties(s, jh, kd, u)
    assert near[bad].all(), (bad, bad[~near[bad]])
    assert bad.size <= 2, bad.size  # counted: near-ties only, and rare


@pytest.mark.parametrize("use_kernel", [False, True])
def test_chunking_changes_no_draw(use_kernel, monkeypatch):
    s = _setup(5, e=480)
    _, th = _hypers(s["k"])
    args = [t_(s[n]) for n in ("word", "doc", "topic")] + [None] + \
        [t_(s[n]) for n in ("n_wk", "n_kd", "n_k")]
    whole = tzc.zen_cdf_cell(1234, *args, th, s["w"], 8,
                             use_kernel=use_kernel)
    fourths = tzc.zen_cdf_cell(1234, *args, th, s["w"], 8,
                               use_kernel=use_kernel, token_chunk=120)
    # 7-token chunks on either route
    monkeypatch.setattr(tzc, "CDF_CHUNK_ELEMS", 8 * 7)
    monkeypatch.setattr(tzc, "CDF_KERNEL_CHUNK_TOKENS", 7)
    sevens = tzc.zen_cdf_cell(1234, *args, th, s["w"], 8,
                              use_kernel=use_kernel)
    assert torch.equal(whole, fourths) and torch.equal(whole, sevens)


@pytest.mark.parametrize("use_kernel,token_chunk", [
    (True, 0), (False, 0), (True, 1 << 20), (False, 1 << 20)])
def test_chunk_width_follows_the_route(use_kernel, token_chunk):
    """Tokens a chunk: ``token_chunk`` when set; else the per-token
    constant on the kernel route (6 chunks a NYTIMES sweep of 99.5M
    tokens) and CDF_CHUNK_ELEMS // max_kd off it (95); never more than
    the tokens."""
    n = 95 << 20
    got = _chunk_tokens(use_kernel, n, 128, token_chunk)
    if token_chunk:
        assert got == token_chunk
    elif use_kernel:
        assert got == tzc.CDF_KERNEL_CHUNK_TOKENS
    else:
        assert got == tzc.CDF_CHUNK_ELEMS // 128
    nyt = 99_500_000
    assert -(-nyt // _chunk_tokens(use_kernel, nyt, 128)) == (
        6 if use_kernel else 95)
    assert _chunk_tokens(use_kernel, 480, 128) == 480


@pytest.mark.parametrize("use_kernel", [False, True])
def test_cell_walks_its_routes_chunks(use_kernel, monkeypatch):
    """``zen_cdf_cell`` walks the chunks of its own route's constant (7
    tokens on the kernel route, 60 off it, each route blind to the other's
    constant), and the draws equal the whole-corpus chunk's. A chunk's
    uniforms come from its route's step, once a chunk: ``ops.cdf_uniforms``
    on the kernel route and ``stream_uniforms`` off it."""
    assert tzc.KERNEL_ROUTE.uniforms is ops.cdf_uniforms
    assert tzc.PLAIN_ROUTE.uniforms is stream_uniforms
    s = _setup(5, e=480)
    _, th = _hypers(s["k"])
    args = [t_(s[n]) for n in ("word", "doc", "topic")] + [None] + \
        [t_(s[n]) for n in ("n_wk", "n_kd", "n_k")]
    whole = tzc.zen_cdf_cell(1234, *args, th, s["w"], 8,
                             use_kernel=use_kernel)
    monkeypatch.setattr(tzc, "CDF_KERNEL_CHUNK_TOKENS", 7)
    monkeypatch.setattr(tzc, "CDF_CHUNK_ELEMS", 8 * 60)
    route, other = (("KERNEL_ROUTE", "PLAIN_ROUTE") if use_kernel
                    else ("PLAIN_ROUTE", "KERNEL_ROUTE"))
    chunks, uniforms = [], getattr(tzc, route).uniforms

    def counted(seed, start, n, *rest, **kw):
        chunks.append((start, n))
        return uniforms(seed, start, n, *rest, **kw)

    def refused(*args, **kwargs):
        raise AssertionError("the other route's uniforms")

    monkeypatch.setattr(tzc, route,
                        getattr(tzc, route)._replace(uniforms=counted))
    monkeypatch.setattr(tzc, other,
                        getattr(tzc, other)._replace(uniforms=refused))
    got = tzc.zen_cdf_cell(1234, *args, th, s["w"], 8,
                           use_kernel=use_kernel)
    size = 7 if use_kernel else 60
    assert chunks == [(a, min(size, s["e"] - a))
                      for a in range(0, s["e"], size)]
    assert torch.equal(whole, got)


def test_kernel_and_plain_routes_differ_at_near_ties_only(monkeypatch):
    """``kernels="on"`` (kernel 7's plain version here) against ``"off"``
    (the float CDF matrix): in range, mostly agreeing (the reference's own
    test allows 80% disagreement), and on the CPU, fed the same uniforms,
    differing only at near-ties of term 2."""
    monkeypatch.delenv("REPRO_KERNELS", raising=False)
    s = _setup(6, e=800)
    jh, th = _hypers(s["k"])
    corpus = Corpus(word=t_(s["word"]), doc=t_(s["doc"]), num_words=s["w"],
                    num_docs=s["d"])
    state = CGSState(topic=t_(s["topic"]), prev_topic=t_(s["topic"]),
                     n_wk=t_(s["n_wk"]), n_kd=t_(s["n_kd"]),
                     n_k=t_(s["n_k"]), rng=as_key(3), iteration=2)
    be = talg.get("zen_cdf")
    outs = {}
    for mode in ("off", "on"):
        knobs = be.resolve_cell_knobs(talg.SamplerKnobs(kernels=mode), th)
        assert knobs.max_kd == s["k"]  # the default 64, clamped to K
        outs[mode] = be.sweep(state, corpus, th, knobs).numpy()
    for z in outs.values():
        assert z.dtype == np.int32 and ((z >= 0) & (z < s["k"])).all()
    bad = np.flatnonzero(outs["on"] != outs["off"])
    assert bad.size / s["e"] < 0.8
    u = stream_uniforms(key_seed(fold_in(state.rng, state.iteration)), 0,
                        s["e"], tzc.CDF_STREAMS).numpy()
    near = _cell_near_ties(s, jh, s["k"], u)
    assert near[bad].all(), bad[~near[bad]]


# -- term 3's doc-row search (kernels.ops.doc_row_search) --------------------

def _row_search_args(s, th, kd, u):
    """The op's arguments on the kernel route's tables (int32 ``kd_idx``)
    for draws a and b of ``u``, and the tables."""
    tables = tzc.build_cdf_tables(t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]),
                                  th, s["w"], kd, tzc.KERNEL_ROUTE)
    args = (t_(s["n_wk"]), t_(s["word"]), t_(s["doc"]), tables.kd_cnt,
            tables.kd_idx, tables.terms.t1, tables.m2_all, tables.g_cdf,
            t_(u[0]), t_(u[1]))
    return args, tables


def _off_route_term3(s, th, kd, u):
    """Today's ``kernels="off"`` term 3: :func:`doc_rows`, the token's
    total, and each draw's ``_searchsorted_rows`` position and topic."""
    tables = tzc.build_cdf_tables(t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]),
                                  th, s["w"], kd, tzc.PLAIN_ROUTE)
    word, doc = t_(s["word"]), t_(s["doc"])
    rows_idx, d_cdf = tzc.doc_rows(tables, word, doc, t_(s["n_wk"]), th)
    m1, m2 = tables.g_cdf[-1], tables.m2_all[word.long()]
    total = m1 + m2 + d_cdf[:, -1]
    pos = [_searchsorted_rows(d_cdf, torch.clamp_min(
        t_(u01) * total - m1 - m2, 0.0)).long() for u01 in u[:2]]
    z = [rows_idx.gather(1, p[:, None])[:, 0] for p in pos]
    d_vals = torch.diff(d_cdf, dim=1, prepend=torch.zeros_like(d_cdf[:, :1]))
    return total, pos, z, rows_idx, d_vals


@pytest.mark.parametrize("seed,kd,k", [(0, 1, 20), (1, 7, 20), (2, 20, 20),
                                       (3, 32, 64), (4, 49, 64),
                                       (5, 50, 64), (6, 64, 64)])
def test_doc_row_search_matches_doc_rows_up_to_near_ties(seed, kd, k):
    """The plain version against ``doc_rows`` plus ``_searchsorted_rows``
    fed the same uniforms, at J of 1, 7, 32, 49, 50 and J == K: rows with
    zero-count tails (a doc holds ~50 tokens of a few topics), one doc row
    all zero. Totals agree to float32 round-off; topics are equal except
    at counted near-ties of the term-3 target."""
    s = _setup(seed, k=k)
    s["n_kd"][5] = 0  # a zero-mass doc row: every target clamps to J - 1
    _, th = _hypers(k)
    rng = np.random.default_rng(seed)
    u = rng.random((2, s["e"])).astype(np.float32)
    args, tables = _row_search_args(s, th, kd, u)
    assert tables.kd_idx.dtype == torch.int32
    assert bool((tables.kd_cnt == 0).any())  # zero tails are exercised
    ops.reset_launch_counts()
    total, z = ops.doc_row_search(*args, beta=th.beta)
    assert ops.launch_counts()["doc_row_search"] == 0
    assert total.dtype == torch.float32 and z.dtype == torch.int32
    assert z.shape == (2, s["e"])
    want_total, want_pos, want_z, rows_idx, d_vals = _off_route_term3(
        s, th, kd, u)
    torch.testing.assert_close(total, want_total, rtol=1e-6, atol=0.0)
    m12 = (tables.g_cdf[-1] + tables.m2_all[args[1].long()]).double()
    mismatches = 0
    for i in range(2):
        hit = rows_idx == z[i].long()[:, None]
        assert bool(hit.any(1).all())  # a topic of the token's doc row
        got_pos = hit.int().argmax(1)
        target = np.maximum(u[i] * want_total.double().numpy()
                            - m12.numpy(), 0.0)
        bad = _near_ties(target, d_vals.numpy(), got_pos.numpy(),
                         want_pos[i].numpy())
        mismatches += bad.size
    assert mismatches <= 2, mismatches  # counted: near-ties, and rare


@pytest.mark.parametrize("kd", [1, 7, 32, 49, 50, 64])
def test_doc_row_search_on_prefix_sums_and_past_the_mass(kd):
    """Exact arithmetic (integer weights, m1 = m2 = 0, t1 a power of two):
    a target exactly on a prefix sum counts the prefixes strictly below it,
    a target on the row's mass stops at the last live entry (the zero tail's
    prefixes equal the mass), and one past it clamps to J - 1; the same
    positions as ``doc_rows`` plus ``_searchsorted_rows``."""
    k, w = 64, 3
    rng = np.random.default_rng(kd)
    live = max(1, kd - 5)  # entries with a count; the rest a zero tail
    n_kd = np.zeros((2, k), np.int32)
    n_kd[0, rng.permutation(k)[:live]] = rng.integers(1, 4, live)
    n_kd[1, :live] = 2  # ties: the lower topic first
    n_wk = rng.integers(0, 5, (w, k)).astype(np.int32)
    th = LDAHyperParams(num_topics=k, alpha=0.1, beta=0.0)
    n_k = np.full(k, 1, np.int32)
    g = tzc.build_cdf_tables(t_(n_wk), t_(n_kd), t_(n_k), th, w, kd,
                             tzc.KERNEL_ROUTE)
    # t1 = 1 / (N_k + W·beta) = 1: every weight cnt·n_wk is an integer
    assert bool((g.terms.t1 == 1.0).all())
    tables = g._replace(g_cdf=torch.zeros(k), m2_all=torch.zeros(w))
    word = torch.tensor([0, 1, 2, 0, 1, 2] * 4, dtype=torch.int32)
    doc = torch.tensor([0] * 12 + [1] * 12, dtype=torch.int32)
    cnt = tables.kd_cnt[doc.long()].double()
    idx = tables.kd_idx[doc.long()].long()
    vals = cnt * t_(n_wk)[word.long()[:, None], idx].double()
    pre = torch.cumsum(vals, 1)
    mass = pre[:, -1]
    on = torch.from_numpy(rng.integers(0, kd, word.shape[0]))
    # draw a: a float32 uniform whose float32 product with the mass is
    # exactly a prefix sum; draw b: on the mass, or past it
    on_pre = pre.gather(1, on[:, None])[:, 0].numpy().astype(np.float32)
    m32 = mass.numpy().astype(np.float32)
    u_a = np.zeros(word.shape[0], np.float32)
    for t in np.flatnonzero(m32 > 0):
        u = np.float32(on_pre[t] / m32[t])
        for _ in range(8):  # the nearest floats below, then above
            u = np.nextafter(u, np.float32(-1))
        for _ in range(17):
            if u * m32[t] == on_pre[t]:
                u_a[t] = u
                break
            u = np.nextafter(u, np.float32(2))
    exact = t_(u_a * m32 == on_pre) & (mass > 0)
    assert int(exact.sum()) >= word.shape[0] // 2, int(exact.sum())
    u_a = t_(u_a)
    u_b = torch.where(torch.arange(word.shape[0]) % 2 == 0, 1.0, 1.5).float()
    total, z = ops.doc_row_search(
        t_(n_wk), word, doc, tables.kd_cnt, tables.kd_idx, tables.terms.t1,
        tables.m2_all, tables.g_cdf, u_a, u_b, beta=0.0)
    assert torch.equal(total.double(), mass)
    want_a = torch.clamp_max((pre < (u_a * total).double()[:, None]).sum(1),
                             kd - 1)
    want_b = torch.clamp_max((pre < (u_b * total).double()[:, None]).sum(1),
                             kd - 1)
    assert torch.equal(z[0].long(), idx.gather(1, want_a[:, None])[:, 0])
    assert torch.equal(z[1].long(), idx.gather(1, want_b[:, None])[:, 0])
    past = (u_b > 1) | (mass == 0)
    assert bool((want_b[past] == kd - 1).all())
    live_row = (cnt > 0).sum(1)
    on_mass = ~past & (live_row < kd)
    # the first prefix that reaches the mass: the last entry with a weight
    last = (vals > 0).long().cumsum(1).argmax(1)
    assert bool((want_b[on_mass] == last[on_mass]).all())
    # today's route gives the same positions on this exact arithmetic
    off = tables._replace(kd_idx=tables.kd_idx.long())
    rows_idx, d_cdf = tzc.doc_rows(off, word, doc, t_(n_wk), th)
    for i, u01 in enumerate((u_a, u_b)):
        pos = _searchsorted_rows(d_cdf, torch.clamp_min(
            u01 * total, 0.0)).long()
        assert torch.equal(z[i].long(), rows_idx.gather(1, pos[:, None])[:, 0])


def test_doc_row_search_refuses_ids_out_of_range():
    s = _setup(7)
    _, th = _hypers(s["k"])
    u = np.zeros((2, s["e"]), np.float32)
    args, _ = _row_search_args(s, th, 4, u)
    for at, bound in ((1, s["w"]), (2, s["d"])):
        for bad in (bound, -1):
            broken = list(args)
            broken[at] = broken[at].clone()
            broken[at][3] = bad
            with pytest.raises(IndexError, match="outside"):
                ops.doc_row_search(*broken, beta=th.beta)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cdf_search.doc_row_search_cuda(*args, th.beta)


class _Shapes(torch.utils._python_dispatch.TorchDispatchMode):
    """The shape of every tensor an op returns, outside the calls that
    stand for kernels (``inside``)."""

    def __init__(self):
        super().__init__()
        self.shapes, self.inside = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside:
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor):
                    self.shapes.append(tuple(x.shape))
        return out


@pytest.mark.parametrize("use_kernel", [True, False])
def test_kernel_route_makes_no_chunk_by_row_tensor(use_kernel):
    """On the kernel route every tensor the token path makes outside its
    four kernel steps (term 3, the draws, term 2 and the remedy; run here
    as their plain versions) holds one value per token at most: no (chunk,
    max_kd) rows, weights or CDF. The plain route, the control, makes them
    in its term-3 step, which the watch sees there."""
    s = _setup(8, e=500)
    _, th = _hypers(s["k"])
    kd = 8
    tables = tzc.build_cdf_tables(t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]),
                                  th, s["w"], kd, _route(use_kernel))
    watch = _Shapes()

    def as_kernel(fn):
        def run(*args, **kwargs):
            watch.inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                watch.inside -= 1
        return run

    steps = ("draws", "term2", "remedy") + (("term3",) if use_kernel else ())
    tables = tables._replace(route=tables.route._replace(
        **{n: as_kernel(getattr(tables.route, n)) for n in steps}))
    u = stream_uniforms(3, 0, s["e"], tzc.CDF_STREAMS)
    args = [t_(s[n]) for n in ("word", "doc", "topic", "n_wk", "n_kd")]
    with watch:
        z = tzc.zen_cdf_tokens(tables, *args, th, u)
    assert z.shape == (s["e"],)
    widest = max(int(np.prod(x)) for x in watch.shapes)
    rows = [x for x in watch.shapes if len(x) == 2 and x[1] == kd]
    if use_kernel:
        assert widest <= s["e"] and not rows, (widest, rows)
    else:
        assert rows and widest >= s["e"] * kd


# -- the kernel route's uniforms, draws and remedy (kernels.cdf_tokens) ------

def _torch_chain(tables, word, doc, z_old, n_wk, n_kd, hyper, uniforms):
    """The kernel route's draws and remedy as a chain of torch ops around
    the doc-row search and kernel 7 (their plain versions), in the order
    the route ran them before its glue became kernels: the oracle the glue
    kernels' plain versions are held to, bit for bit. Returns (the new
    topics, draw a's branch, the tokens that take draw b)."""
    k = hyper.num_topics
    total, z_ds = cdf_search.doc_row_search_plain(
        n_wk, word, doc, tables.kd_cnt, tables.kd_idx, tables.terms.t1,
        tables.m2_all, tables.g_cdf, uniforms[0], uniforms[1], hyper.beta)
    w, d = word.long(), doc.long()
    m1 = tables.g_cdf[-1]
    m12 = m1 + tables.m2_all[w]

    def draw(i):
        u = uniforms[i] * total
        branch = torch.where(u < m1, 0, torch.where(u < m12, 1, 2))
        z_g = torch.clamp_max(torch.searchsorted(tables.g_cdf, u), k - 1)
        t2 = torch.where(branch == 1, torch.clamp_min(u - m1, 0.0), 0.0)
        z_w = cdf_search.cdf_row_search_plain(n_wk, word, tables.terms.t4, t2)
        z = torch.where(branch == 0, z_g,
                        torch.where(branch == 1, z_w.long(), z_ds[i]))
        return torch.clamp_max(z, k - 1).to(torch.int32), branch

    z1, branch = draw(0)
    z2, _ = draw(1)
    zo = z_old.long()
    nw_prev = torch.clamp_min(n_wk[w, zo].to(torch.float32), 1.0)
    nd_prev = torch.clamp_min(n_kd[d, zo].to(torch.float32), 1.0)
    p_w = 1.0 / nw_prev
    p_d = torch.clamp(1.0 / nd_prev + (nd_prev + nw_prev - 1.0)
                      / (nd_prev * nw_prev), 0.0, 1.0)
    remedy_p = torch.where(branch == 1, p_w,
                           torch.where(branch == 2, p_d, 0.0))
    take_second = (z1 == z_old) & (uniforms[2] < remedy_p)
    return torch.where(take_second, z2, z1), branch, take_second


@pytest.mark.parametrize("seed,kd,k,chunk,indexed", [
    (0, 8, 20, 0, False), (1, 64, 64, 4099, True), (2, 128, 160, 4099, False),
    (3, 128, 130, 1000, True), (4, 8, 200, 4099, True),
    (2**31 - 1, 64, 300, 0, False)])
def test_glue_plain_versions_equal_the_torch_chain(seed, kd, k, chunk,
                                                   indexed, monkeypatch):
    """``zen_cdf_cell`` on the kernel route (the uniforms, draws and remedy
    as ``ops.cdf_uniforms``/``cdf_draws``/``cdf_remedy``, run here as their
    plain versions) against :func:`_torch_chain` over the same chunks with
    ``stream_uniforms``: the topics bit-equal at J of 8, 64 and 128, chunks
    of the whole cell, 4,099 and 1,000 tokens, with and without a mesh
    cell's ``token_index``; every branch taken, the remedy engaged."""
    s = _setup(seed % 1000, e=9000, w=300, d=60, k=k)
    _, th = _hypers(k)
    word, doc, z_old = (t_(s[n]) for n in ("word", "doc", "topic"))
    n_wk, n_kd = t_(s["n_wk"]), t_(s["n_kd"])
    index = None
    if indexed:
        rng = np.random.default_rng(seed)
        index = t_(rng.integers(2**31 - 4 * s["e"], 2**31 - 1, s["e"]
                                ).astype(np.int32))
    if chunk:
        monkeypatch.setattr(tzc, "CDF_KERNEL_CHUNK_TOKENS", chunk)
    got = tzc.zen_cdf_cell(seed, word, doc, z_old, None, n_wk, n_kd,
                           t_(s["n_k"]), th, s["w"], kd, use_kernel=True,
                           token_index=index)
    tables = tzc.build_cdf_tables(n_wk, n_kd, t_(s["n_k"]), th, s["w"], kd,
                                  tzc.KERNEL_ROUTE)
    size = chunk or s["e"]
    want, branch, take = [], [], []
    for a in range(0, s["e"], size):
        sl = slice(a, a + size)
        n = word[sl].shape[0]
        u = stream_uniforms(seed, a if index is None else index[sl], n,
                            tzc.CDF_STREAMS)
        z, b, tk = _torch_chain(tables, word[sl], doc[sl], z_old[sl], n_wk,
                                n_kd, th, u)
        want.append(z), branch.append(b), take.append(tk)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cat(want))
    assert set(torch.cat(branch).tolist()) == {0, 1, 2}
    assert int(torch.cat(take).sum()) > 0


def _off_route_chain(tables, word, doc, z_old, n_wk, n_kd, hyper, uniforms):
    """The ``kernels="off"`` route's own chain of torch ops, as it ran
    before it shared the draws and the remedy with the kernel route: the
    doc rows (int64 topics) and their ``torch.cumsum``, then for each draw
    its branch, term-1 search, term-2 search in ``w_cdf`` and term-3 search
    in the doc row, then the remedy. The oracle the plain route is held to,
    bit for bit. Returns (the new topics, draw a's branch, the tokens that
    take draw b)."""
    k = hyper.num_topics
    w, d = word.long(), doc.long()
    rows_idx = tables.kd_idx.long()[d]
    rows_cnt = tables.kd_cnt[d]
    nwk_at = n_wk.reshape(-1)[w[:, None] * k + rows_idx]
    d_vals = (rows_cnt.to(torch.float32)
              * (nwk_at.to(torch.float32) + hyper.beta)
              * tables.terms.t1[rows_idx])
    d_cdf = torch.cumsum(torch.where(rows_cnt > 0, d_vals, 0.0), dim=-1)
    m1 = tables.g_cdf[-1]
    m2 = tables.m2_all[w]
    m12 = m1 + m2
    total = m12 + d_cdf[:, -1]

    def draw(i):
        u = uniforms[i] * total
        branch = torch.where(u < m1, 0, torch.where(u < m12, 1, 2))
        z_g = torch.clamp_max(torch.searchsorted(tables.g_cdf, u), k - 1)
        t2 = torch.where(branch == 1, torch.clamp_min(u - m1, 0.0), 0.0)
        z_w = tzc._bsearch_gather(tables.w_cdf, word, t2)
        pos = _searchsorted_rows(d_cdf, torch.clamp_min(u - m1 - m2, 0.0))
        z_d = rows_idx.gather(1, pos.long()[:, None])[:, 0]
        z = torch.where(branch == 0, z_g,
                        torch.where(branch == 1, z_w.long(), z_d))
        return torch.clamp_max(z, k - 1).to(torch.int32), branch

    z1, branch = draw(0)
    z2, _ = draw(1)
    zo = z_old.long()
    nw_prev = torch.clamp_min(n_wk[w, zo].to(torch.float32), 1.0)
    nd_prev = torch.clamp_min(n_kd[d, zo].to(torch.float32), 1.0)
    p_w = 1.0 / nw_prev
    p_d = torch.clamp(1.0 / nd_prev + (nd_prev + nw_prev - 1.0)
                      / (nd_prev * nw_prev), 0.0, 1.0)
    remedy_p = torch.where(branch == 1, p_w,
                           torch.where(branch == 2, p_d, 0.0))
    take_second = (z1 == z_old) & (uniforms[2] < remedy_p)
    return torch.where(take_second, z2, z1), branch, take_second


@pytest.mark.parametrize("seed,kd,k,chunk,indexed", [
    (0, 8, 20, 0, False), (1, 64, 64, 4099, True), (2, 128, 160, 4099, False),
    (3, 128, 130, 1000, True), (4, 8, 200, 4099, True),
    (2**31 - 1, 64, 300, 0, False)])
def test_plain_route_equals_the_off_route_chain(seed, kd, k, chunk, indexed,
                                                monkeypatch):
    """``zen_cdf_cell`` on the plain route (``stream_uniforms``, the doc
    rows and their row-wise search, the kernels' plain draws, the ``w_cdf``
    search and the kernels' plain remedy) against :func:`_off_route_chain`
    over the same chunks: the topics bit-equal at J of 8, 64 and 128,
    chunks of the whole cell, 4,099 and 1,000 tokens, with and without a
    mesh cell's ``token_index``; every branch taken, the remedy engaged."""
    s = _setup(seed % 1000, e=9000, w=300, d=60, k=k)
    _, th = _hypers(k)
    word, doc, z_old = (t_(s[n]) for n in ("word", "doc", "topic"))
    n_wk, n_kd = t_(s["n_wk"]), t_(s["n_kd"])
    index = None
    if indexed:
        rng = np.random.default_rng(seed)
        index = t_(rng.integers(2**31 - 4 * s["e"], 2**31 - 1, s["e"]
                                ).astype(np.int32))
    if chunk:
        monkeypatch.setattr(tzc, "CDF_CHUNK_ELEMS", chunk * kd)
    got = tzc.zen_cdf_cell(seed, word, doc, z_old, None, n_wk, n_kd,
                           t_(s["n_k"]), th, s["w"], kd, use_kernel=False,
                           token_index=index)
    tables = tzc.build_cdf_tables(n_wk, n_kd, t_(s["n_k"]), th, s["w"], kd,
                                  tzc.PLAIN_ROUTE)
    size = chunk or s["e"]
    want, branch, take = [], [], []
    for a in range(0, s["e"], size):
        sl = slice(a, a + size)
        n = word[sl].shape[0]
        u = stream_uniforms(seed, a if index is None else index[sl], n,
                            tzc.CDF_STREAMS)
        z, b, tk = _off_route_chain(tables, word[sl], doc[sl], z_old[sl],
                                    n_wk, n_kd, th, u)
        want.append(z), branch.append(b), take.append(tk)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.cat(want))
    assert set(torch.cat(branch).tolist()) == {0, 1, 2}
    assert int(torch.cat(take).sum()) > 0


@pytest.mark.parametrize("seed", [0, 977, 2**31 - 1])
@pytest.mark.parametrize("start", [0, 2**32 - 5, 3 * 2**32 + 11, "index"])
def test_plain_uniforms_equal_stream_uniforms(seed, start):
    """``ops.cdf_uniforms`` on the CPU (its plain version) equals
    ``stream_uniforms`` entry for entry, for starts past 2^32 (the hash
    takes the global index mod 2^32) and for a mesh cell's int32 corpus
    indices."""
    n = 1000
    if start == "index":
        start = torch.arange(2**31 - 600, 2**31 - 600 + 2 * n, 2,
                             dtype=torch.int64).to(torch.int32)
        start[::7] = 3
    got = ops.cdf_uniforms(seed, start, n, tzc.CDF_STREAMS, device="cpu")
    want = stream_uniforms(seed, start, n, tzc.CDF_STREAMS)
    assert got.shape == (tzc.CDF_STREAMS, n) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_glue_refuses_ids_out_of_range():
    """The plain versions refuse what the kernels trap on (a word, doc or
    previous topic out of range), and the launchers refuse CPU tensors."""
    t, k, w, d = 6, 5, 4, 3
    i32 = torch.int32
    word, doc = torch.zeros(t, dtype=i32), torch.zeros(t, dtype=i32)
    z_old, u = torch.zeros(t, dtype=i32), torch.full((t,), 0.5)
    z2 = torch.zeros((2, t), dtype=i32)
    n_wk, n_kd = torch.ones((w, k), dtype=i32), torch.ones((d, k), dtype=i32)
    draws = [word, u, u, u, torch.ones(w), torch.arange(1.0, k + 1), z2]
    remedy = [z2, z_old, z_old, z_old, word, doc, n_wk, n_kd, u]
    for args, fn, at, bound in ((draws, ops.cdf_draws, 0, w),
                                (remedy, ops.cdf_remedy, 3, k),
                                (remedy, ops.cdf_remedy, 4, w),
                                (remedy, ops.cdf_remedy, 5, d)):
        for bad in (bound, -1):
            broken = list(args)
            broken[at] = broken[at].clone()
            broken[at][2] = bad
            with pytest.raises(IndexError, match="outside"):
                fn(*broken)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cdf_tokens.cdf_draws_cuda(*draws)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cdf_tokens.cdf_remedy_cuda(*remedy)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        cdf_tokens.cdf_uniforms_cuda(0, word, t, 3, "cpu")


# -- zen_cdf serving -----------------------------------------------------------

def _serving_setup(seed, b=5, l=16, w=40, k=12):
    rng = np.random.default_rng(seed)
    n_wk = rng.integers(0, 30, (w, k)).astype(np.int32)
    n_wk[rng.random((w, k)) < 0.6] = 0
    words = rng.integers(0, w, (b, l)).astype(np.int32)
    lens = rng.integers(1, l + 1, b)
    mask = np.arange(l)[None, :] < lens[:, None]
    z = rng.integers(0, k, (b, l)).astype(np.int32)
    n_kd = np.zeros((b, k), np.int32)
    for i in range(b):
        np.add.at(n_kd[i], z[i][mask[i]], 1)
    return dict(n_wk=n_wk, n_k=n_wk.sum(0).astype(np.int32), words=words,
                mask=mask, z=z, n_kd=n_kd, w=w, k=k, b=b, l=l)


@pytest.mark.parametrize("seed,kd", [(0, 64), (1, 3)])
def test_frozen_tables_and_served_draws_match_reference(seed, kd):
    s = _serving_setup(seed)
    jh, th = _hypers(s["k"])
    jt = jzc.ZenCdf().prepare_infer(jnp.asarray(s["n_wk"]),
                                    jnp.asarray(s["n_k"]), jh, None)
    tt = talg.get("zen_cdf").prepare_infer(t_(s["n_wk"]), t_(s["n_k"]), th,
                                           talg.SamplerKnobs())
    for name in ("t1", "alpha_k"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    for name in ("a_cdf", "a_mass"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)), rtol=1e-5)
    keys = jax.random.split(jax.random.key(seed), s["b"])
    jargs = [jnp.asarray(s[n]) for n in ("words", "mask", "z", "n_kd",
                                         "n_wk", "n_k")]
    want = np.asarray(jzc.zen_cdf_infer_sweep(keys, *jargs, jh, kd, jt))
    u01 = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (s["l"],)))(
        keys))
    got = tzc.zen_cdf_infer_tokens(
        t_(u01), t_(s["words"]), t_(s["mask"]), t_(s["z"]), t_(s["n_kd"]),
        t_(s["n_wk"]), th, kd, tt).numpy()
    assert got.shape == (s["b"], s["l"]) and got.dtype == np.int32
    bad = np.argwhere(got != want)
    # a mismatch must be a near-tie of the two-branch draw, in float64
    a_pre = np.cumsum((s["n_wk"] + jh.beta) * np.asarray(jt.alpha_k * jt.t1,
                                                         np.float64), axis=1)
    for bi, li in bad:
        wi, zi = s["words"][bi, li], s["z"][bi, li]
        cnt = s["n_kd"][bi].astype(np.float64)
        if s["mask"][bi, li]:
            cnt[zi] -= 1
        order = np.argsort(-s["n_kd"][bi], kind="stable")[:min(kd, s["k"])]
        d = np.where(cnt[order] > 0, cnt[order] * (s["n_wk"][wi, order]
                                                   + jh.beta)
                     * np.asarray(jt.t1, np.float64)[order], 0.0)
        bounds = np.concatenate([a_pre[wi], a_pre[wi, -1] + np.cumsum(d)])
        x = u01[bi, li] * bounds[-1]
        assert np.abs(bounds - x).min() <= NEAR_TIE * bounds[-1], (bi, li)
    assert len(bad) <= 1


def _sharp_model(k=4, w=40, weight=100):
    n_wk = np.zeros((w, k), np.int32)
    block = w // k
    for t in range(k):
        n_wk[t * block:(t + 1) * block, t] = weight
    return FrozenLDAModel.from_numpy(
        n_wk, n_wk.sum(0), {"num_topics": k, "alpha": 0.1, "beta": 0.01},
        device="cpu")


def _serve_one(model, doc, key, *, buckets, batch_mates=()):
    eng = LDAEngine(model, LDAServeConfig(buckets=buckets, max_batch=8,
                                          num_sweeps=10,
                                          algorithm="zen_cdf"), seed=0)
    uid = eng.submit(doc, key=key)
    for mate in batch_mates:
        eng.submit(mate)
    return {r.uid: r for r in eng.run_until_done()}[uid].theta


def test_bucket_padding_and_batch_composition_change_no_theta():
    model = _sharp_model()
    rng = np.random.default_rng(2)
    doc = rng.integers(0, 40, size=10).astype(np.int32)
    thetas = [_serve_one(model, doc, 42, buckets=buckets)
              for buckets in [(16,), (32,), (64, 128)]]
    mates = [rng.integers(0, 40, size=rng.integers(1, 14)).astype(np.int32)
             for _ in range(5)]
    thetas.append(_serve_one(model, doc, 42, buckets=(16,),
                             batch_mates=mates))
    for theta in thetas[1:]:
        np.testing.assert_array_equal(thetas[0], theta)
    assert int(np.argmax(thetas[0])) == int(np.bincount(doc // 10).argmax())


def test_engine_builds_the_frozen_tables_once_and_sweeps_with_them(
        monkeypatch):
    be = talg.get("zen_cdf")
    built, seen = [], []
    prepare, sweep = type(be).prepare_infer, type(be).infer_sweep

    def spy_prepare(self, *a, **kw):
        built.append(prepare(self, *a, **kw))
        return built[-1]

    def spy_sweep(self, *a, **kw):
        seen.append(a[9] if len(a) > 9 else kw.get("aux"))
        return sweep(self, *a, **kw)

    monkeypatch.setattr(type(be), "prepare_infer", spy_prepare)
    monkeypatch.setattr(type(be), "infer_sweep", spy_sweep)
    model = _sharp_model()
    eng = LDAEngine(model, LDAServeConfig(buckets=(16,), num_sweeps=4,
                                          algorithm="zen_cdf"))
    thetas = eng.infer_batch([[0, 1, 2], [30, 31], [12, 13, 14, 15]])
    assert [int(np.argmax(th)) for th in thetas] == [0, 3, 1]
    assert len(built) == 1 and isinstance(built[0], tzc.FrozenCdfTables)
    assert len(seen) >= 4 and all(a is built[0] for a in seen)
    latency = LDAEngine(model, LDAServeConfig(buckets=(16,), mode="latency",
                                              algorithm="zen_cdf"))
    assert len(built) == 1  # latency mode builds no tables
    assert latency.infer_batch([[0, 1]]).shape == (1, 4)


# -- std and the serial sweep --------------------------------------------------

def _tiny(seed=0):
    jc, _ = j_lda_corpus(seed, 40, 60, 6, 30)
    tc, _ = synthetic_lda_corpus(seed, 40, 60, 6, 30)
    kw = dict(num_topics=6, alpha=0.1, beta=0.05)
    return jc, tc, JHyper(**kw), LDAHyperParams(**kw)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_std_conditional_matches_reference(exclude_self):
    jc, tc, jh, th = _tiny(1)
    rng = np.random.default_rng(1)
    topic = rng.integers(0, 6, tc.num_tokens).astype(np.int32)
    st = make_state(t_(topic), tc, th, as_key(0))
    js = JState(topic=jnp.asarray(topic), prev_topic=jnp.asarray(topic),
                n_wk=jnp.asarray(st.n_wk.numpy()),
                n_kd=jnp.asarray(st.n_kd.numpy()),
                n_k=jnp.asarray(st.n_k.numpy()), rng=jax.random.key(0),
                iteration=0)
    for dec in ("std", "zen"):
        want = np.asarray(jsampler.conditional_probs(
            js, jc, jh, exclude_self=exclude_self, decomposition=dec))
        got = tsampler.conditional_probs(st, tc, th, exclude_self,
                                         decomposition=dec).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown decomposition"):
        tsampler.conditional_probs(st, tc, th, decomposition="nope")


def test_std_and_zen_sweeps_draw_the_same_conditional():
    """The same uniforms through Eq. 3 as written and through the ZenLDA
    decomposition: the same topics, but for float round-off (the
    reference's own test asks > 99%)."""
    _, tc, _, th = _tiny(2)
    st = random_init(as_key(5), tc, th)
    z_zen = tsampler.cgs_sweep_stale(st, tc, th, decomposition="zen")
    z_std = tsampler.cgs_sweep_stale(st, tc, th, decomposition="std")
    assert float((z_zen == z_std).float().mean()) > 0.99
    knobs = talg.SamplerKnobs()
    assert torch.equal(talg.get("std").sweep(st, tc, th, knobs), z_std)
    assert torch.equal(tsampler.cgs_sweep_stale(st, tc, th, method="gumbel",
                                                decomposition="std",
                                                token_chunk=tc.num_tokens),
                       tsampler.cgs_sweep_stale(st, tc, th, method="gumbel",
                                                decomposition="std"))


def test_serial_sweep_invariants_and_convergence():
    _, tc, _, th = _tiny(0)
    st = random_init(as_key(0), tc, th)
    llh0 = float(predictive_llh(st, tc, th))
    first = st
    for _ in range(2):
        st = tsampler.cgs_sweep_serial(st, tc, th)
        st.check_invariants(tc)
    assert st.iteration == first.iteration + 2
    assert not torch.equal(st.topic, first.topic)
    assert float(predictive_llh(st, tc, th)) > llh0
    # the chain is counter-based: the same state draws the same sweep
    again = tsampler.cgs_sweep_serial(first, tc, th)
    assert torch.equal(again.topic,
                       tsampler.cgs_sweep_serial(first, tc, th).topic)
    assert torch.equal(again.prev_topic, first.topic)


def _serial_probs64(n_wk, n_kd, n_k, w, d, h, num_words):
    """The reference's serial conditional (Eq. 3 with the asymmetric
    alpha_k of the decremented N_k) in float64, from already-decremented
    numpy counts."""
    nk = n_k.astype(np.float64)
    k = float(h.num_topics)
    alpha_k = (k * h.alpha) * (nk + h.alpha_prime / k) / (nk.sum()
                                                          + h.alpha_prime)
    return ((n_wk[w] + h.beta) / (nk + num_words * h.beta)
            * (n_kd[d] + alpha_k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serial_sweep_fed_reference_uniforms_matches_reference(seed):
    """The port's serial chain and the reference's ``cgs_sweep_serial``,
    from one set of topics and fed the reference's per-token uniforms,
    draw the same topics. Where a draw differs, the chains part for good;
    the first such token must be a near-tie of the float64 conditional
    (target within NEAR_TIE of the mass from a prefix sum), and is
    counted."""
    jc, tc, jh, th = _tiny(seed)
    e = tc.num_tokens
    topic = np.random.default_rng(seed).integers(0, 6, e).astype(np.int32)
    st = make_state(t_(topic), tc, th, as_key(seed))
    js = JState(topic=jnp.asarray(topic), prev_topic=jnp.asarray(topic),
                n_wk=jnp.asarray(st.n_wk.numpy()),
                n_kd=jnp.asarray(st.n_kd.numpy()),
                n_k=jnp.asarray(st.n_k.numpy()), rng=jax.random.key(seed),
                iteration=0)
    want = jsampler.cgs_sweep_serial(js, jc, jh)
    keys = jax.random.split(jax.random.fold_in(js.rng, js.iteration), e)
    u = np.asarray(jax.vmap(lambda k_i: jax.random.uniform(
        k_i, (1, 1), dtype=jnp.float32)[0, 0])(keys))
    got = tsampler.cgs_sweep_serial(st, tc, th, uniforms=t_(u))
    got.check_invariants(tc)
    z_got, z_want = got.topic.numpy(), np.asarray(want.topic)
    bad = np.flatnonzero(z_got != z_want)
    if bad.size == 0:
        for name in ("n_wk", "n_kd", "n_k"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_allclose(
            float(predictive_llh(got, tc, th)),
            float(j_predictive_llh(want, jc, jh)), rtol=1e-5)
        return
    # replay the shared prefix of the chain to the first parting token
    n_wk, n_kd, n_k = (getattr(st, n).numpy().copy()
                       for n in ("n_wk", "n_kd", "n_k"))
    word, doc = tc.word.numpy(), tc.doc.numpy()
    first = int(bad[0])
    for i in range(first + 1):
        w, d = word[i], doc[i]
        for arr, row in ((n_wk, w), (n_kd, d)):
            arr[row, topic[i]] -= 1
        n_k[topic[i]] -= 1
        if i < first:
            for arr, row in ((n_wk, w), (n_kd, d)):
                arr[row, z_want[i]] += 1
            n_k[z_want[i]] += 1
    p = _serial_probs64(n_wk, n_kd, n_k, word[first], doc[first], th,
                        tc.num_words)
    _near_ties(np.array([u[first] * p.sum()]), p[None, :],
               z_got[first:first + 1], z_want[first:first + 1])
    assert first > e // 2, (first, e)  # near-ties are rare


@pytest.mark.parametrize("seed", [0, 3])
def test_serial_conditional_boundaries_match_the_reference_formula(seed):
    """One token resampled against random counts, fed uniforms just below
    and just above each float64 prefix boundary of the reference's serial
    conditional (counts decremented first, alpha_k of the decremented
    N_k): the draw lands on each side of every boundary. A small N_k total
    makes the asymmetric alpha_k sensitive to the decrement order."""
    rng = np.random.default_rng(seed)
    k, w_n, d_n = 6, 5, 4
    th = LDAHyperParams(num_topics=k, alpha=0.1, beta=0.05)
    n_wk = rng.integers(1, 6, (w_n, k)).astype(np.int32)
    n_kd = rng.integers(1, 6, (d_n, k)).astype(np.int32)
    n_k = (n_wk.sum(0) + rng.integers(0, 4, k)).astype(np.int32)
    w, d, z = 2, 1, int(rng.integers(0, k))
    tc = Corpus(word=torch.tensor([w], dtype=torch.int32),
                doc=torch.tensor([d], dtype=torch.int32),
                num_words=w_n, num_docs=d_n)
    st = CGSState(topic=torch.tensor([z], dtype=torch.int32),
                  prev_topic=torch.tensor([z], dtype=torch.int32),
                  n_wk=t_(n_wk), n_kd=t_(n_kd), n_k=t_(n_k),
                  rng=as_key(seed), iteration=0)
    dec = [a.copy() for a in (n_wk, n_kd, n_k)]
    dec[0][w, z] -= 1
    dec[1][d, z] -= 1
    dec[2][z] -= 1
    pre = np.cumsum(_serial_probs64(*dec, w, d, th, w_n))
    for j in range(k - 1):
        for side, expect in ((1 - 1e-5, j), (1 + 1e-5, j + 1)):
            u = torch.tensor([pre[j] / pre[-1] * side], dtype=torch.float32)
            out = tsampler.cgs_sweep_serial(st, tc, th, uniforms=u)
            assert int(out.topic[0]) == expect, (j, side)
            assert int(out.n_k[expect]) == int(dec[2][expect]) + 1


# -- whole runs and the CLI ------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """4 iterations of zen_cdf and std in the reference on one corpus; the
    initial topics and the final per-token llh."""
    jc, _ = j_lda_corpus(0, 80, 100, 6, 40)
    jh = JHyper(num_topics=6, alpha=0.1, beta=0.01)
    out = {}
    for name in ("zen_cdf", "std"):
        sess = JSession(jc, jh, JRunConfig(algorithm=name))
        st = sess.init(jax.random.key(0))
        topics = np.asarray(st.topic)
        for _ in range(4):
            st = sess.step(st)
        out[name] = (topics, sess.llh(st) / jc.num_tokens)
    return out


@pytest.mark.parametrize("name,kernels", [("zen_cdf", "auto"),
                                          ("zen_cdf", "on"),
                                          ("std", "auto")])
def test_whole_runs_match_reference_llh(name, kernels, reference_runs):
    tc, _ = synthetic_lda_corpus(0, 80, 100, 6, 40)
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.01)
    init_topics, ref_llh = reference_runs[name]
    sess = TrainSession(tc, th, RunConfig(algorithm=name, kernels=kernels),
                        device="cpu")
    st = sess.init(0, init_topics=init_topics)
    llh0 = sess.llh(st)
    for _ in range(4):
        st = sess.step(st)
        st.check_invariants(sess.corpus)
    llh = sess.llh(st) / tc.num_tokens
    assert sess.llh(st) > llh0
    assert abs(llh / ref_llh - 1) < 0.08, (name, llh, ref_llh)


def test_default_train_cli_then_serve_on_zen_cdf(tmp_path):
    """``launch.train --single-box --device cpu`` trains the default
    backend, ``zen_cdf``, and exits 0; ``serve_lda --algorithm zen_cdf``
    serves its checkpoint; JAX never loads."""
    ckpt = str(tmp_path / "zc")
    cmds = [
        ("repro_torch.launch.train", [
            "--single-box", "--iters", "3", "--topics", "8",
            "--synthetic-docs", "60", "--synthetic-words", "80",
            "--synthetic-len", "20", "--llh-every", "1", "--max-kd", "4",
            "--checkpoint-dir", ckpt, "--device", "cpu"]),
        ("repro_torch.launch.serve_lda", [
            "--checkpoint-dir", ckpt, "--device", "cpu", "--algorithm",
            "zen_cdf", "--synthetic-docs", "6", "--buckets", "16,32",
            "--sweeps", "3", "--show", "1"]),
    ]
    code = (
        "import runpy, sys\n"
        f"for mod, argv in {cmds!r}:\n"
        "    sys.argv = [mod] + argv\n"
        "    try:\n"
        "        runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code in (0, None), (mod, e.code)\n"
        "loaded = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(ln.startswith("single-box  algorithm=zen_cdf ")
               for ln in lines), lines[:3]
    llh = [float(ln.split()[3]) for ln in lines if ln.startswith("iter ")]
    assert len(llh) == 3 and llh[-1] > llh[0]
    final = [ln for ln in lines if ln.startswith("finished at iteration")]
    assert len(final) == 1 and final[0].startswith(
        "finished at iteration 3; final llh -"), final
    assert "algorithm=zen_cdf" in proc.stdout and "docs/sec" in proc.stdout
