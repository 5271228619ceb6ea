"""The padded-sparse slice (zen_sparse, sparselda, zen_hybrid, lightlda)
against the JAX package, on the CPU.

* Integer work is bit-equal: padded rows (``sparsify_rows``,
  ``densify_rows``, ``lookup_rows``, ``max_row_nnz``,
  ``shard_row_capacity``), row-pad resolution, the doc -> token indices,
  the hybrid's route, ``build_alias_counts`` and ``CompactVector``.
* Alias tables: the port's realise their pmf within 1e-6, and equal the
  reference's on integer pmfs (where no float sum order enters).
* ``build_tables`` masses within 1e-5 relative (float32 sums in another
  order).
* Draws, fed the reference's own ``jax.random`` uniforms (split as the
  reference splits its keys) and the reference's tables: ``zen_sample_
  tokens``, ``sparselda`` and one LightLDA MH cycle equal the reference's
  draw for draw, except where a token's scaled uniform lies within 1e-5 of
  its total mass from a boundary it is compared with (a near-tie: the two
  packages add float32 prefix sums and row sums in different orders).
  Such mismatches are counted.
* No chunking changes a draw (uniforms hash the global token index).
* Whole runs are statistical: from the reference's initial topics, each
  backend's per-token llh after 4 iterations lies within 8% of the
  reference run's (the band of ``tests/test_baselines.py``), with the
  count invariants exact after every step.
* ``launch.train --single-box --algorithm zen_sparse --device cpu`` and
  ``serve_lda`` on its checkpoint run in a process where JAX never loads.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.algorithms.base import auto_pad as j_auto_pad
from repro.algorithms.base import fill_cell_row_pads as j_fill_pads
from repro.algorithms.base import resolve_row_pads as j_resolve_pads
from repro.algorithms.base import SamplerKnobs as JKnobs
from repro.algorithms.zen_hybrid import hybrid_route_doc_side as j_route
from repro.core import alias as jalias
from repro.core import baselines as jbase
from repro.core import decompositions as jdec
from repro.core import zen_sparse as jzs
from repro.core.compactvector import CompactVector as JCompactVector
from repro.core.types import CGSState as JState
from repro.core.types import Corpus as JCorpus
from repro.core.types import LDAHyperParams as JHyper
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro.train.session import RunConfig as JRunConfig
from repro.train.session import TrainSession as JSession
from repro_torch import algorithms as talg
from repro_torch.algorithms.zen_hybrid import hybrid_route_doc_side
from repro_torch.core import alias as talias
from repro_torch.core import baselines as tbase
from repro_torch.core import decompositions as tdec
from repro_torch.core import zen_sparse as tzs
from repro_torch.core.compactvector import CompactVector
from repro_torch.core.keys import stream_uniforms
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.data.corpus import synthetic_lda_corpus
from repro_torch.train.session import RunConfig, TrainSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 1e-5  # of the token's total mass
BACKENDS = ("zen_sparse", "sparselda", "zen_hybrid", "lightlda")


def t_(a):
    return torch.from_numpy(np.array(a))


def _setup(seed, e=400, w=40, d=12, k=20, sparse=True):
    """A corpus and a state whose rows are sparse (each word and doc draws
    from a few topics), as numpy and in both packages."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, w, e).astype(np.int32)
    doc = np.sort(rng.integers(0, d, e)).astype(np.int32)
    if sparse:
        topic = ((word * 7 + doc * 3 + rng.integers(0, 4, e)) % k)
    else:
        topic = rng.integers(0, k, e)
    topic = topic.astype(np.int32)
    n_wk = np.zeros((w, k), np.int32)
    n_kd = np.zeros((d, k), np.int32)
    np.add.at(n_wk, (word, topic), 1)
    np.add.at(n_kd, (doc, topic), 1)
    n_k = n_wk.sum(0).astype(np.int32)
    return dict(word=word, doc=doc, topic=topic, n_wk=n_wk, n_kd=n_kd,
                n_k=n_k, w=w, d=d, k=k, e=e)


def _hypers(k):
    kw = dict(num_topics=k, alpha=0.1, beta=0.05)
    return JHyper(**kw), LDAHyperParams(**kw)


def _pads(s):
    kw = j_auto_pad(jzs.max_row_nnz(jnp.asarray(s["n_wk"])))
    kd = j_auto_pad(jzs.max_row_nnz(jnp.asarray(s["n_kd"])))
    return kw, kd


def _uniforms(key, n, count):
    return [np.asarray(jax.random.uniform(k_, (n,)))
            for k_ in jax.random.split(key, count)]


def _near(x, bounds, scale):
    """Per token: is any boundary within NEAR_TIE * scale of x?"""
    gaps = [np.abs(np.asarray(b, np.float64) - x) for b in bounds]
    return np.min(np.stack(gaps, 0), axis=0) <= NEAR_TIE * scale


def _near_prefix(target, vals, scale):
    """Per token: does a float64 prefix sum of ``vals`` row lie within
    NEAR_TIE * scale of ``target``?"""
    pre = np.cumsum(np.asarray(vals, np.float64), axis=1)
    return (np.abs(pre - target[:, None]).min(1) <= NEAR_TIE * scale)


# -- integer work: bit-equal ----------------------------------------------------

@pytest.mark.parametrize("max_nnz", [3, 8, 20])
def test_padded_rows_bit_equal(max_nnz):
    s = _setup(1, sparse=False)
    for name in ("n_wk", "n_kd"):
        jr = jzs.sparsify_rows(jnp.asarray(s[name]), max_nnz)
        tr = tzs.sparsify_rows(t_(s[name]), max_nnz)
        np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
        np.testing.assert_array_equal(tr.cnt.numpy(), np.asarray(jr.cnt))
        np.testing.assert_array_equal(tr.nnz.numpy(), np.asarray(jr.nnz))
        np.testing.assert_array_equal(tzs.densify_rows(tr).numpy(),
                                      np.asarray(jzs.densify_rows(jr)))
        assert int(tzs.max_row_nnz(t_(s[name]))) == \
            int(jzs.max_row_nnz(jnp.asarray(s[name])))
        for mult in (8, 128):
            assert tzs.shard_row_capacity(t_(s[name]), mult) == \
                jzs.shard_row_capacity(jnp.asarray(s[name]), mult)
    rows = np.random.default_rng(2).integers(0, s["d"], 50).astype(np.int32)
    topics = np.random.default_rng(3).integers(0, s["k"] + 1, (50, 7))
    topics = topics.astype(np.int32)
    jr = jzs.sparsify_rows(jnp.asarray(s["n_kd"]), max_nnz)
    tr = tzs.sparsify_rows(t_(s["n_kd"]), max_nnz)
    np.testing.assert_array_equal(
        tzs.lookup_rows(tr, t_(rows), t_(topics)).numpy(),
        np.asarray(jzs.lookup_rows(jr, jnp.asarray(rows),
                                   jnp.asarray(topics))))


def test_sparsify_handles_wide_rows_in_blocks(monkeypatch):
    """Rows are sparsified in blocks; the block size changes nothing."""
    s = _setup(4, sparse=False)
    whole = tzs.sparsify_rows(t_(s["n_wk"]), 12)
    monkeypatch.setattr(tzs, "_SPARSIFY_ELEMS", 3 * s["k"])
    blocks = tzs.sparsify_rows(t_(s["n_wk"]), 12)
    assert torch.equal(whole.idx, blocks.idx)
    assert torch.equal(whole.cnt, blocks.cnt)


def test_row_pad_resolution_bit_equal():
    s = _setup(5)
    jst = JState(topic=jnp.asarray(s["topic"]), prev_topic=None,
                 n_wk=jnp.asarray(s["n_wk"]), n_kd=jnp.asarray(s["n_kd"]),
                 n_k=jnp.asarray(s["n_k"]), rng=jax.random.key(0))
    tst = CGSState(topic=t_(s["topic"]), prev_topic=t_(s["topic"]),
                   n_wk=t_(s["n_wk"]), n_kd=t_(s["n_kd"]), n_k=t_(s["n_k"]),
                   rng=torch.zeros(2, dtype=torch.int64))
    for n in (0, 1, 7, 8, 9, 200):
        assert talg.auto_pad(torch.tensor(n)) == j_auto_pad(jnp.asarray(n))
    for kw, kd in ((0, 0), (24, 0), (0, 16), (40, 48)):
        jk = j_resolve_pads(jst, JKnobs(max_kw=kw, max_kd=kd))
        tk = talg.resolve_row_pads(tst, talg.SamplerKnobs(max_kw=kw,
                                                          max_kd=kd))
        assert (tk.max_kw, tk.max_kd) == (jk.max_kw, jk.max_kd)
        for k in (10, 100, 1000):
            jf, tf = j_fill_pads(jk, k), talg.fill_cell_row_pads(tk, k)
            assert (tf.max_kw, tf.max_kd) == (jf.max_kw, jf.max_kd)
            jf, tf = (j_fill_pads(JKnobs(max_kw=kw, max_kd=kd), k),
                      talg.fill_cell_row_pads(
                          talg.SamplerKnobs(max_kw=kw, max_kd=kd), k))
            assert (tf.max_kw, tf.max_kd) == (jf.max_kw, jf.max_kd)
    hyper = LDAHyperParams(num_topics=50)
    for name in BACKENDS:
        got = talg.get(name).resolve_cell_knobs(talg.SamplerKnobs(), hyper)
        assert (got.max_kw, got.max_kd) == (50, 50)
    assert talg.get("zen").resolve_cell_knobs(
        talg.SamplerKnobs(), hyper) == talg.SamplerKnobs()


def test_doc_indices_and_hybrid_route_bit_equal():
    s = _setup(6)
    jc = JCorpus(word=jnp.asarray(s["word"]), doc=jnp.asarray(s["doc"]),
                 num_words=s["w"], num_docs=s["d"])
    tc = Corpus(word=t_(s["word"]), doc=t_(s["doc"]), num_words=s["w"],
                num_docs=s["d"])
    ji, ti = jbase.build_doc_index(jc), tbase.build_doc_index(tc)
    for f in ("token_of", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(ji, f)))
    # a cell: shuffled doc ids, a third of the tokens masked out
    rng = np.random.default_rng(7)
    doc = rng.integers(0, s["d"], 90).astype(np.int32)
    mask = rng.random(90) < 0.67
    ji = jbase.build_cell_doc_index(jnp.asarray(doc), jnp.asarray(mask),
                                    s["d"])
    ti = tbase.build_cell_doc_index(t_(doc), t_(mask), s["d"])
    for f in ("token_of", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(ji, f)))
    for kw, kd in ((4, 4), (2, 8), (20, 1)):
        got = hybrid_route_doc_side(t_(s["n_wk"]), t_(s["n_kd"]),
                                    t_(s["word"]), t_(s["doc"]), kw, kd)
        want = j_route(jnp.asarray(s["n_wk"]), jnp.asarray(s["n_kd"]),
                       jnp.asarray(s["word"]), jnp.asarray(s["doc"]), kw, kd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_integer_alias_and_compact_vector_bit_equal():
    rng = np.random.default_rng(8)
    for k in (1, 2, 7, 50):
        counts = rng.integers(0, 30, k) * (rng.random(k) < 0.7)
        got, want = (talias.build_alias_counts(counts),
                     jalias.build_alias_counts(counts))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        a = talias.sample_alias_counts(*got, np.random.default_rng(k), 200)
        b = jalias.sample_alias_counts(*want, np.random.default_rng(k), 200)
        np.testing.assert_array_equal(a, b)
    for dense in ([0, 0, 3, 4, 0, 0, 0, 5, 6, 0], [1, 2, 3], [0, 0, 0],
                  rng.integers(0, 3, 40) * (rng.random(40) < 0.4)):
        got, want = CompactVector.from_dense(dense), \
            JCompactVector.from_dense(dense)
        np.testing.assert_array_equal(got.empty_starts, want.empty_starts)
        np.testing.assert_array_equal(got.nnz_before, want.nnz_before)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.to_dense(), np.asarray(dense))
        assert got.nbytes() == want.nbytes()
        if len(dense):
            ins = got.insert(0, 9)
            assert ins.get(0) == 9
            np.testing.assert_array_equal(
                ins.to_dense(), want.insert(0, 9).to_dense())


# -- float work -------------------------------------------------------------------

def test_alias_tables_realise_their_pmf_and_match_on_integer_pmfs():
    rng = np.random.default_rng(9)
    pf = (rng.random((30, 17)) * (rng.random((30, 17)) < 0.6)).astype(
        np.float32)
    pf[0] = 0.0  # an all-zero row gives the uniform
    tab = talias.build_alias(t_(pf))
    target = pf / np.maximum(pf.sum(1, keepdims=True), 1e-30)
    target[0] = 1.0 / 17
    np.testing.assert_allclose(talias.alias_pmf(tab).numpy(), target,
                               atol=1e-6)
    pi = (rng.integers(0, 20, (40, 23))
          * (rng.random((40, 23)) < 0.5)).astype(np.float32)
    want = jax.vmap(jalias.build_alias)(jnp.asarray(pi))
    got = talias.build_alias(t_(pi))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))
    one = talias.build_alias(t_(pi[3]))
    np.testing.assert_array_equal(one.prob.numpy(), got.prob[3].numpy())
    # the samplers, on the same uniforms
    u1, u2 = _uniforms(jax.random.key(1), 500, 2)
    j1 = jalias.build_alias(jnp.asarray(pi[5]))
    np.testing.assert_array_equal(
        talias.sample_alias(one._replace(prob=got.prob[5],
                                         alias=got.alias[5]),
                            t_(u1), t_(u2)).numpy(),
        np.asarray(jalias.sample_alias(j1, jnp.asarray(u1),
                                       jnp.asarray(u2))))
    np.testing.assert_array_equal(
        talias.sample_alias_reuse(
            talias.AliasTable(got.prob[5], got.alias[5]), t_(u1)).numpy(),
        np.asarray(jalias.sample_alias_reuse(j1, jnp.asarray(u1))))


def test_fplus_tree_matches_reference():
    rng = np.random.default_rng(10)
    p = rng.integers(0, 9, 13).astype(np.float32)
    jt, tt = jalias.ftree_build(jnp.asarray(p)), talias.ftree_build(t_(p))
    np.testing.assert_array_equal(tt.tree.numpy(), np.asarray(jt.tree))
    assert float(talias.ftree_total(tt)) == float(jalias.ftree_total(jt))
    u = rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(
        talias.ftree_sample(tt, t_(u)).numpy(),
        np.asarray(jalias.ftree_sample(jt, jnp.asarray(u))))
    jt, tt = jalias.ftree_update(jt, 4, 11.0), talias.ftree_update(tt, 4,
                                                                   11.0)
    np.testing.assert_array_equal(tt.tree.numpy(), np.asarray(jt.tree))


def test_decompositions_match_reference():
    rng = np.random.default_rng(11)
    k, w_total, t = 16, 50, 12
    n_wk = rng.integers(0, 30, (t, k)).astype(np.int32)
    n_kd = rng.integers(0, 10, (t, k)).astype(np.int32)
    n_k = rng.integers(20, 400, k).astype(np.int32)
    jh, th = JHyper(num_topics=k, alpha=0.05, beta=0.01), \
        LDAHyperParams(num_topics=k, alpha=0.05, beta=0.01)
    jt = jdec.precompute_zen_terms(jnp.asarray(n_k), jh, w_total)
    tt = tdec.precompute_zen_terms(t_(n_k), th, w_total)
    args = (jnp.asarray(n_wk), jnp.asarray(n_kd))
    targs = (t_(n_wk), t_(n_kd))
    np.testing.assert_allclose(tdec.zen_probs(*targs, tt, 0.01).numpy(),
                               np.asarray(jdec.zen_probs(*args, jt, 0.01)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tdec.std_probs(*targs, t_(n_k), tt.alpha_k, 0.01, w_total).numpy(),
        np.asarray(jdec.std_probs(*args, jnp.asarray(n_k), jt.alpha_k, 0.01,
                                  w_total)), rtol=1e-6)
    for got, want in zip(tdec.sparselda_buckets(*targs, tt, 0.01),
                         jdec.sparselda_buckets(*args, jt, 0.01)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert {d.value for d in tdec.Decomposition} == \
        {d.value for d in jdec.Decomposition}


def test_build_tables_masses_and_rows_match_reference():
    s = _setup(12)
    jh, th = _hypers(s["k"])
    kw, kd = _pads(s)
    jt = jzs.build_tables(jnp.asarray(s["n_wk"]), jnp.asarray(s["n_kd"]),
                          jnp.asarray(s["n_k"]), jh, s["w"], kw, kd)
    tt = tzs.build_tables(t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]), th,
                          s["w"], kw, kd)
    for rows in ("wk_rows", "kd_rows"):
        np.testing.assert_array_equal(getattr(tt, rows).idx.numpy(),
                                      np.asarray(getattr(jt, rows).idx))
        np.testing.assert_array_equal(getattr(tt, rows).cnt.numpy(),
                                      np.asarray(getattr(jt, rows).cnt))
    np.testing.assert_allclose(tt.w_mass.numpy(), np.asarray(jt.w_mass),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tt.terms.g_mass),
                               float(jt.terms.g_mass), rtol=1e-5)
    # each table realises its row's pmf
    w_vals = tt.wk_rows.cnt.float() * torch.cat(
        [tt.terms.t4, torch.zeros(1)])[tt.wk_rows.idx.long()]
    pmf = talias.alias_pmf(talias.AliasTable(tt.w_prob, tt.w_alias))
    np.testing.assert_allclose(
        pmf.numpy(), (w_vals / w_vals.sum(1, keepdim=True)).numpy(),
        atol=1e-6)
    vals, topics = tzs._d_sparse(tt, t_(s["word"]), t_(s["doc"]), 0.05)
    jv, jtop = jzs._d_sparse(jt, jnp.asarray(s["word"]),
                             jnp.asarray(s["doc"]), 0.05)
    np.testing.assert_array_equal(topics.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _port_tables(jt):
    """The reference's ZenTables as the port's, value for value."""
    terms = tdec.ZenTerms(*(t_(np.asarray(x)) for x in jt.terms))
    return tzs.ZenTables(
        terms=terms,
        g_table=talias.AliasTable(t_(np.asarray(jt.g_table.prob)),
                                  t_(np.asarray(jt.g_table.alias))),
        w_prob=t_(np.asarray(jt.w_prob)), w_alias=t_(np.asarray(jt.w_alias)),
        w_mass=t_(np.asarray(jt.w_mass)),
        wk_rows=tzs.SparseRows(t_(np.asarray(jt.wk_rows.idx)),
                               t_(np.asarray(jt.wk_rows.cnt)),
                               jt.wk_rows.num_topics),
        kd_rows=tzs.SparseRows(t_(np.asarray(jt.kd_rows.idx)),
                               t_(np.asarray(jt.kd_rows.cnt)),
                               jt.kd_rows.num_topics),
    )


@pytest.mark.parametrize("seed", [13, 14])
def test_zen_sample_tokens_fed_reference_uniforms(seed):
    s = _setup(seed, e=600)
    jh, th = _hypers(s["k"])
    kw, kd = _pads(s)
    jt = jzs.build_tables(jnp.asarray(s["n_wk"]), jnp.asarray(s["n_kd"]),
                          jnp.asarray(s["n_k"]), jh, s["w"], kw, kd)
    # previous topics: the current ones, with a fifth changed
    rng = np.random.default_rng(seed)
    prev = np.where(rng.random(s["e"]) < 0.2, rng.integers(0, s["k"],
                                                           s["e"]),
                    s["topic"]).astype(np.int32)
    key = jax.random.key(seed)
    want = np.asarray(jzs.zen_sample_tokens(
        key, jt, jnp.asarray(s["word"]), jnp.asarray(s["doc"]),
        jnp.asarray(prev), jh))
    key_a, key_b, key_r = jax.random.split(key, 3)
    u = (_uniforms(key_a, s["e"], 6)[:5] + _uniforms(key_b, s["e"], 6)[:5]
         + [np.asarray(jax.random.uniform(key_r, (s["e"],)))])
    got = tzs.zen_sample_tokens(_port_tables(jt), t_(s["word"]),
                                t_(s["doc"]), t_(prev), th,
                                t_(np.stack(u))).numpy()
    bad = np.flatnonzero(got != want)
    # the decisions of both draws, in float64 from the shared tables
    jv, _ = jzs._d_sparse(jt, jnp.asarray(s["word"]), jnp.asarray(s["doc"]),
                          jh.beta)
    jv = np.asarray(jv, np.float64)
    m1 = float(jt.terms.g_mass)
    m2 = np.asarray(jt.w_mass, np.float64)[s["word"]]
    total = m1 + m2 + jv.sum(1)
    near = np.zeros(s["e"], bool)
    for u01 in (u[0], u[5]):
        x = u01 * total
        near |= _near(x, [np.full_like(x, m1), m1 + m2], total)
        near |= _near_prefix(x - (m1 + m2), jv, total)
    assert near[bad].all(), (bad, bad[~near[bad]])
    assert bad.size <= 2, bad.size  # counted: near-ties only, and rare
    assert ((got >= 0) & (got < s["k"])).all()


def test_sparselda_fed_reference_uniforms():
    s = _setup(15, e=600)
    jh, th = _hypers(s["k"])
    kw, kd = _pads(s)
    key = jax.random.key(15)
    args = [jnp.asarray(s[n]) for n in ("word", "doc", "topic", "n_wk",
                                        "n_kd", "n_k")]
    want = np.asarray(jbase.sparselda_cell(key, *args, jh, s["w"], kw, kd))
    u01 = np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                        (s["e"],)))
    tables = tbase.sparselda_tables(t_(s["n_wk"]), t_(s["n_kd"]),
                                    t_(s["n_k"]), th, s["w"], kw, kd)
    got = tbase.sparselda_tokens(tables, t_(s["word"]), t_(s["doc"]),
                                 t_(s["topic"]), th, t_(u01)).numpy()
    bad = np.flatnonzero(got != want)
    r_vals, _, q_vals, _ = tbase.sparselda_rows(
        tables, t_(s["word"]), t_(s["doc"]), t_(s["topic"]))
    r = np.asarray(r_vals, np.float64)
    q = np.asarray(q_vals, np.float64)
    s_vals = np.asarray(tables.terms.g_dense, np.float64)
    s_mass = s_vals.sum()
    total = s_mass + r.sum(1) + q.sum(1)
    x = u01 * total
    near = _near(x, [np.full_like(x, s_mass), s_mass + r.sum(1)], total)
    near |= _near_prefix(x, np.broadcast_to(s_vals, (s["e"], s["k"])),
                         total)
    near |= _near_prefix(x - s_mass, r, total)
    near |= _near_prefix(x - s_mass - r.sum(1), q, total)
    assert near[bad].all(), (bad, bad[~near[bad]])
    assert bad.size <= 2, bad.size


def _light_tables(s, jh, kw, use_kernel):
    """The reference's LightLDA tables, built with its own functions as
    ``lightlda_cell`` builds them, handed to the port."""
    terms = jdec.precompute_zen_terms(jnp.asarray(s["n_k"]), jh, s["w"])
    wk = jzs.sparsify_rows(jnp.asarray(s["n_wk"]), kw)
    t1 = jnp.concatenate([terms.t1, jnp.zeros((1,), jnp.float32)])
    w_vals = wk.cnt.astype(jnp.float32) * t1[wk.idx]
    w_alias = None if use_kernel else jax.vmap(jalias.build_alias)(w_vals)
    dense = jalias.build_alias(terms.t5)
    corpus = Corpus(word=t_(s["word"]), doc=t_(s["doc"]), num_words=s["w"],
                    num_docs=s["d"])
    tc = lambda x: t_(np.asarray(x))  # noqa: E731
    return tbase.LightTables(
        terms=tdec.ZenTerms(*(tc(x) for x in terms)),
        alpha_k=tc(jh.alpha_k(jnp.asarray(s["n_k"]))),
        alpha_bar=tc(jnp.mean(terms.alpha_k)), n_kd_cell=t_(s["n_kd"]),
        wk_rows=tzs.SparseRows(tc(wk.idx), tc(wk.cnt), s["k"]),
        w_vals=tc(w_vals),
        w_alias=None if w_alias is None else talias.AliasTable(
            tc(w_alias.prob), tc(w_alias.alias)),
        w_sparse_mass=tc(jnp.sum(w_vals, axis=-1)),
        dense_tab=talias.AliasTable(tc(dense.prob), tc(dense.alias)),
        dense_mass=tc(jnp.sum(terms.t5)),
        n_d=tbase.build_doc_index(corpus).lengths.float(),
        doc_index=tbase.build_doc_index(corpus),
    )


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lightlda_mh_cycle_fed_reference_uniforms(use_kernel):
    """One word step and one doc step (num_mh = 2), each fed the uniforms
    the reference draws inside its loop."""
    s = _setup(16, e=500)
    jh, th = _hypers(s["k"])
    kw, _ = _pads(s)
    key = jax.random.key(16)
    jc = JCorpus(word=jnp.asarray(s["word"]), doc=jnp.asarray(s["doc"]),
                 num_words=s["w"], num_docs=s["d"])
    args = [jnp.asarray(s[n]) for n in ("word", "doc", "topic")]
    mask = jnp.ones((s["e"],), bool)
    want = np.asarray(jbase.lightlda_cell(
        key, *args, mask, jnp.asarray(s["n_wk"]), jnp.asarray(s["n_kd"]),
        jnp.asarray(s["n_k"]), jh, s["w"], jbase.build_doc_index(jc), kw,
        num_mh=2, use_kernel=use_kernel, bt=64))
    # the reference's keys: mh_step splits (key, k_prop, k_acc), then the
    # proposals split k_prop
    e = (s["e"],)
    key1, kp0, ka0 = jax.random.split(key, 3)
    k1, k2, k3, k4 = jax.random.split(kp0, 4)
    draws0 = dict(pick=jax.random.uniform(k1, e),
                  u1=jax.random.uniform(k2, e), u2=jax.random.uniform(k3, e),
                  dense_bin=jax.random.uniform(k4, e),
                  dense_split=jax.random.uniform(jax.random.fold_in(k4, 1),
                                                 e),
                  acc=jax.random.uniform(ka0, e))
    _, kp1, ka1 = jax.random.split(key1, 3)
    k1, k2, k3 = jax.random.split(kp1, 3)
    draws1 = dict(pick=jax.random.uniform(k1, e),
                  tok=jax.random.uniform(k2, e),
                  unif=jax.random.randint(k3, e, 0, s["k"], dtype=jnp.int32),
                  acc=jax.random.uniform(ka1, e))
    tab = _light_tables(s, jh, kw, use_kernel)
    w, d, z0 = t_(s["word"]), t_(s["doc"]), t_(s["topic"])
    w_rows = (tab.w_vals[w.long()], tab.wk_rows.idx[w.long()])
    z = z0
    for i, draws in enumerate((draws0, draws1)):
        draws = {n: t_(np.asarray(v)) for n, v in draws.items()}
        if "unif" in draws:
            draws["unif"] = draws["unif"].long()
        z = tbase.lightlda_mh_step(i, z, z0, w, d, z0, tab, t_(s["n_wk"]),
                                   t_(s["n_kd"]), t_(s["n_k"]), th, s["w"],
                                   draws, use_kernel, w_rows)
    got = z.numpy()
    bad = np.flatnonzero(got != want)
    if not use_kernel:
        np.testing.assert_array_equal(got, want)  # no float sum decides
    else:
        # kernel 6 over w_vals: the target u1 * m_s against the prefixes
        m_s = tab.w_sparse_mass.numpy().astype(np.float64)[s["word"]]
        x = np.asarray(draws0["u1"], np.float64) * m_s
        near = _near_prefix(x, tab.w_vals.numpy()[s["word"]],
                            np.maximum(m_s, 1e-30))
        assert near[bad].all(), (bad, bad[~near[bad]])
        assert bad.size <= 2, bad.size
    assert ((got >= 0) & (got < s["k"])).all()


# -- chunking changes no draw ---------------------------------------------------

@pytest.mark.parametrize("name", BACKENDS)
def test_chunking_changes_no_draw(name, monkeypatch):
    s = _setup(17, e=480)
    _, th = _hypers(s["k"])
    backend = talg.get(name)
    args = (t_(s["word"]), t_(s["doc"]), t_(s["topic"]), None,
            t_(s["n_wk"]), t_(s["n_kd"]), t_(s["n_k"]), th, s["w"])
    kernels = ("off", "on") if name == "lightlda" else ("auto",)
    for mode in kernels:
        knobs = talg.SamplerKnobs(max_kw=24, max_kd=16, kernels=mode)
        whole = backend.cell_sweep(99, *args, knobs)
        for chunk in (48, 160):
            part = backend.cell_sweep(
                99, *args, dataclasses.replace(knobs, token_chunk=chunk))
            assert torch.equal(whole, part), (name, mode, chunk)
        monkeypatch.setattr(tzs, "SPARSE_CHUNK_ELEMS", 7 * 24)
        monkeypatch.setattr(tbase, "SPARSE_CHUNK_ELEMS", 7 * 24)
        assert torch.equal(whole, backend.cell_sweep(99, *args, knobs))
        monkeypatch.undo()
    # a token's uniforms: its global index and the stream only
    u = stream_uniforms(5, 0, 100, 3)
    assert torch.equal(u[:, 40:60], stream_uniforms(5, 40, 20, 3))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_sweeps_are_the_backends_single_box_sweeps():
    """``zen_sparse_sweep`` / ``sparselda_sweep`` draw what the backends'
    single-box sweeps draw: the whole corpus as one cell."""
    s = _setup(18, e=300)
    _, th = _hypers(s["k"])
    corpus = Corpus(word=t_(s["word"]), doc=t_(s["doc"]), num_words=s["w"],
                    num_docs=s["d"])
    st = CGSState(topic=t_(s["topic"]), prev_topic=t_(s["topic"]),
                  n_wk=t_(s["n_wk"]), n_kd=t_(s["n_kd"]), n_k=t_(s["n_k"]),
                  rng=torch.tensor([3, 4], dtype=torch.int64), iteration=2)
    knobs = talg.SamplerKnobs(max_kw=16, max_kd=16)
    for name, fn in (("zen_sparse", tzs.zen_sparse_sweep),
                     ("sparselda", tbase.sparselda_sweep)):
        got = fn(st, corpus, th, 16, 16)
        assert torch.equal(got, talg.get(name).sweep(st, corpus, th, knobs))
    idx = tbase.build_doc_index(corpus)
    assert torch.equal(
        tbase.lightlda_sweep(st, corpus, th, idx, 16, num_mh=2),
        talg.get("lightlda").sweep(
            st, corpus, th, dataclasses.replace(knobs, num_mh=2,
                                                kernels="off"), idx))


# -- whole runs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_runs():
    """4 iterations of each backend in the reference on one corpus; the
    initial topics and the final per-token llh."""
    jc, _ = j_lda_corpus(0, 80, 100, 6, 40)
    jh = JHyper(num_topics=6, alpha=0.1, beta=0.01)
    out = {}
    for name in BACKENDS:
        sess = JSession(jc, jh, JRunConfig(algorithm=name, num_mh=4))
        st = sess.init(jax.random.key(0))
        topics = np.asarray(st.topic)
        for _ in range(4):
            st = sess.step(st)
        out[name] = (topics, sess.llh(st) / jc.num_tokens)
    return out


@pytest.mark.parametrize("name", BACKENDS)
def test_whole_runs_match_reference_llh(name, reference_runs):
    tc, _ = synthetic_lda_corpus(0, 80, 100, 6, 40)
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.01)
    init_topics, ref_llh = reference_runs[name]
    sess = TrainSession(tc, th, RunConfig(algorithm=name, num_mh=4),
                        device="cpu")
    st = sess.init(0, init_topics=init_topics)
    llh0 = sess.llh(st)
    for _ in range(4):
        st = sess.step(st)
        st.check_invariants(sess.corpus)
    llh = sess.llh(st) / tc.num_tokens
    assert sess.llh(st) > llh0
    assert abs(llh / ref_llh - 1) < 0.08, (name, llh, ref_llh)


def test_session_resolves_pads_per_sweep_and_registers_repad():
    tc, _ = synthetic_lda_corpus(0, 30, 40, 4, 20)
    th = LDAHyperParams(num_topics=4)
    sess = TrainSession(tc, th, RunConfig(algorithm="zen_sparse",
                                          rebuild_every=2), device="cpu")
    assert sess.row_pads == (0, 0)
    assert "repad" in sess.schedule.names()
    assert not sess.plan.repad(sess.init(0))
    assert sess.plan.apply_row_pads(16, 8) and sess.row_pads == (16, 8)
    assert not sess.plan.apply_row_pads(16, 8)
    fixed = TrainSession(tc, th, RunConfig(algorithm="zen_sparse",
                                           rebuild_every=2, max_kw=8,
                                           max_kd=8), device="cpu")
    assert "repad" not in fixed.schedule.names()
    st = sess.run(0)
    st.check_invariants(sess.corpus)
    # the two backends once refused here are ported: the reference's run
    # config loads in both packages and trains
    for name in ("std", "zen_cdf"):
        cfg = RunConfig.from_json(JRunConfig(
            algorithm=name, num_iterations=2).to_json())
        st = TrainSession(tc, th, cfg, device="cpu").run(0)
        st.check_invariants(sess.corpus)
        assert st.iteration == 2


def test_train_cli_and_serve_on_zen_sparse(tmp_path):
    """``launch.train --single-box --algorithm zen_sparse --device cpu``
    exits 0 with the reference's final line, then ``serve_lda`` serves the
    checkpoint, in a process where JAX never loads."""
    ckpt = str(tmp_path / "zs")
    cmds = [
        ("repro_torch.launch.train", [
            "--single-box", "--algorithm", "zen_sparse", "--iters", "4",
            "--topics", "8", "--synthetic-docs", "60", "--synthetic-words",
            "80", "--synthetic-len", "20", "--llh-every", "2",
            "--checkpoint-dir", ckpt, "--device", "cpu"]),
        ("repro_torch.launch.serve_lda", [
            "--checkpoint-dir", ckpt, "--device", "cpu", "--synthetic-docs",
            "6", "--buckets", "16,32", "--sweeps", "3", "--show", "1"]),
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
    assert any(ln.startswith("padded-row widths: max_kw=") for ln in lines)
    final = [ln for ln in lines if ln.startswith("finished at iteration")]
    assert len(final) == 1 and final[0].startswith(
        "finished at iteration 4; final llh -"), final
    assert "docs/sec" in proc.stdout
