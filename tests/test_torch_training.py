"""The port's training slice against the JAX package, on the CPU.

* Integer work is bit-equal: ``delta_counts`` and ``word_frequencies``
  (with and without mask), the exclusion statistics and resample
  probability, ``duplicate_topic_map``, ``merge_topics`` and ``rebuild``.
* Float work within float32 tolerances: ``conditional_probs`` (rtol 1e-6),
  the likelihoods (rtol 1e-5: the port sums in float64, the reference in
  float32), and the hand-computed pins of ``tests/test_likelihood.py`` at
  the tolerances the reference's own pin tests use.
* Draws: the dense ``zen`` sweep (cdf and gumbel) and ``zen_pallas``'s
  plain kernel path follow the reference's conditional (chi-square over
  many seeds and noise rows, p > 1e-3).
* Whole runs are statistical (the port's draws are counter-based, not
  threefry): from the reference's initial topics, the 3-chain mean
  perplexity at iteration 30 of the port's ``zen`` and ``zen_pallas`` is
  within 10% of the reference's ``zen`` (its own chains spread ~±7%), with
  the count invariants holding at every step.
* Config and state cross between the packages, and the quickstart pair
  runs through the port's CLIs in a process where JAX never loads.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from repro.core import counts as jcounts
from repro.core import exclusion as jexcl
from repro.core import hyper as jhyper
from repro.core import likelihood as jllh
from repro.core import sampler as jsampler
from repro.core.types import CGSState as JState
from repro.core.types import Corpus as JCorpus
from repro.core.types import LDAHyperParams as JHyper
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro.train import checkpoint as jckpt
from repro.train.session import RunConfig as JRunConfig
from repro.train.session import TrainSession as JSession
from repro_torch import algorithms as talg
from repro_torch.core import counts, exclusion, likelihood, sampler
from repro_torch.core import hyper as thyper
from repro_torch.core.keys import as_key
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.data.corpus import synthetic_lda_corpus
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.session import (
    RunConfig,
    SingleBoxPlan,
    TrainSession,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus_state(seed, e=300, w=40, d=12, k=7, hyper_kw=None):
    """One random corpus and state, as numpy and in both packages."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, w, e).astype(np.int32)
    doc = np.sort(rng.integers(0, d, e)).astype(np.int32)
    topic = rng.integers(0, k, e).astype(np.int32)
    n_wk = np.zeros((w, k), np.int32)
    n_kd = np.zeros((d, k), np.int32)
    np.add.at(n_wk, (word, topic), 1)
    np.add.at(n_kd, (doc, topic), 1)
    n_k = n_wk.sum(0).astype(np.int32)
    hk = {**dict(num_topics=k, alpha=0.1, beta=0.05), **(hyper_kw or {})}
    jc = JCorpus(word=jnp.asarray(word), doc=jnp.asarray(doc), num_words=w,
                 num_docs=d)
    js = JState(topic=jnp.asarray(topic), prev_topic=jnp.asarray(topic),
                n_wk=jnp.asarray(n_wk), n_kd=jnp.asarray(n_kd),
                n_k=jnp.asarray(n_k), rng=jax.random.key(seed))
    tc = Corpus(word=torch.from_numpy(word), doc=torch.from_numpy(doc),
                num_words=w, num_docs=d)
    ts = CGSState(topic=torch.from_numpy(topic),
                  prev_topic=torch.from_numpy(topic),
                  n_wk=torch.from_numpy(n_wk), n_kd=torch.from_numpy(n_kd),
                  n_k=torch.from_numpy(n_k), rng=as_key(seed))
    return (jc, js, JHyper(**hk)), (tc, ts, LDAHyperParams(**hk))


# -- integer work: bit-equal --------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_delta_counts_and_word_frequencies_bit_equal(masked):
    (jc, js, jh), (tc, ts, th) = _corpus_state(1)
    rng = np.random.default_rng(2)
    new = rng.integers(0, 7, tc.num_tokens).astype(np.int32)
    new[::3] = ts.topic.numpy()[::3]  # unchanged tokens add nothing
    mask = rng.random(tc.num_tokens) < 0.7 if masked else None
    j = jcounts.delta_counts(jc.word, jc.doc, js.topic, jnp.asarray(new),
                             40, 12, 7,
                             mask=None if mask is None else jnp.asarray(mask))
    t = counts.delta_counts(tc.word, tc.doc, ts.topic, torch.from_numpy(new),
                            40, 12, 7,
                            mask=None if mask is None
                            else torch.from_numpy(mask))
    for a, b in zip(j, t):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jf = jcounts.word_frequencies(
        jc.word, 40, mask=None if mask is None else jnp.asarray(mask))
    tf = counts.word_frequencies(
        tc.word, 40, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("case", ["masked", "unchanged", "hot_word"])
def test_plan_row_orders_and_kernel_route_delta_counts(case):
    """The plan's word-major and doc-major walks are the stable row-major
    orders of the corpus, and ``delta_counts`` called as the plan calls it
    where kernels are dispatched (``use_kernel``, those walks; on the CPU
    the kernel's plain version, which takes no walk) equals the
    reference's scatter-adds bit for bit: masked tokens, unchanged tokens,
    and a corpus where one word holds >= 25% of the tokens."""
    rng = np.random.default_rng(5)
    e, w, d, k = 2000, 60, 30, 9
    word = rng.integers(0, w, e).astype(np.int32)
    if case == "hot_word":
        word[rng.random(e) < 0.3] = 17
        assert (word == 17).mean() >= 0.25
    doc = np.sort(rng.integers(0, d, e)).astype(np.int32)
    old = rng.integers(0, k, e).astype(np.int32)
    new = rng.integers(0, k, e).astype(np.int32)
    keep = rng.random(e) < (0.5 if case == "unchanged" else 0.1)
    new[keep] = old[keep]  # unchanged tokens add nothing
    mask = rng.random(e) < 0.7 if case == "masked" else None
    tc = Corpus(word=torch.from_numpy(word), doc=torch.from_numpy(doc),
                num_words=w, num_docs=d)
    plan = SingleBoxPlan(tc, LDAHyperParams(num_topics=k),
                         RunConfig(algorithm="zen", kernels="on"),
                         device="cpu")
    w_order, d_order = plan.row_orders()
    assert d_order.order is None  # doc rows: the corpus order is sorted
    assert bool((w_order.rows[1:] >= w_order.rows[:-1]).all())
    assert torch.equal(tc.word[w_order.order.long()], w_order.rows)
    j = jcounts.delta_counts(jnp.asarray(word), jnp.asarray(doc),
                             jnp.asarray(old), jnp.asarray(new), w, d, k,
                             mask=None if mask is None else jnp.asarray(mask))
    t = counts.delta_counts(
        tc.word, tc.doc, torch.from_numpy(old), torch.from_numpy(new), w, d,
        k, mask=None if mask is None else torch.from_numpy(mask),
        use_kernel=True, orders=plan.row_orders())
    for a, b in zip(j, t):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas", "zen_cdf"])
def test_session_states_equal_under_every_kernel_policy_on_cpu(algorithm):
    """On the CPU "auto" dispatches no kernel and "on" takes the kernels'
    plain versions (the delta merge along the plan's row walks): after 3
    steps every state equals the "off" run's."""
    tc, _ = synthetic_lda_corpus(0, 60, 80, 6, 30)
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.01)
    states = {}
    for kernels in ("auto", "on", "off"):
        sess = TrainSession(tc, th, RunConfig(algorithm=algorithm,
                                              kernels=kernels),
                            device="cpu")
        st = sess.init(0)
        for _ in range(3):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
        states[kernels] = st
    for kernels in ("auto", "on"):
        for name in ("topic", "prev_topic", "n_wk", "n_kd", "n_k",
                     "stale_iters", "same_count"):
            assert torch.equal(getattr(states[kernels], name),
                               getattr(states["off"], name)), \
                (kernels, name)


def test_exclusion_stats_and_resample_prob_bit_equal():
    (jc, js, _), (tc, ts, _) = _corpus_state(3)
    rng = np.random.default_rng(4)
    e = tc.num_tokens
    stale = rng.integers(0, 6, e).astype(np.int32)
    same = rng.integers(0, 9, e).astype(np.int32)
    new = np.where(rng.random(e) < 0.5, ts.topic.numpy(),
                   rng.integers(0, 7, e)).astype(np.int32)
    mask = rng.random(e) < 0.6
    js = dataclasses.replace(js, stale_iters=jnp.asarray(stale),
                             same_count=jnp.asarray(same))
    ts = dataclasses.replace(ts, stale_iters=torch.from_numpy(stale),
                             same_count=torch.from_numpy(same))
    ji, jt = jexcl.update_exclusion_stats(js, jnp.asarray(new),
                                          jnp.asarray(mask))
    ti, tt = exclusion.update_exclusion_stats(ts, torch.from_numpy(new),
                                              torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for floor in (0.0, 0.05):
        # the reference's expression inside active_mask
        jp = jnp.clip(jnp.exp2(jnp.asarray(stale, jnp.float32)
                               - jnp.asarray(same, jnp.float32)), floor, 1.0)
        tp = exclusion.resample_prob(torch.from_numpy(stale),
                                     torch.from_numpy(same), floor)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    # past the start iteration the mask samples at about that probability
    cfg = exclusion.ExclusionConfig(True, 1, 0.0)
    late = dataclasses.replace(ts, iteration=5)
    m = exclusion.active_mask(late, cfg, as_key(9)).numpy()
    p = exclusion.resample_prob(late.stale_iters, late.same_count,
                                0.0).numpy()
    assert m[p == 1.0].all()
    assert abs(m.mean() - p.mean()) < 0.1
    assert exclusion.active_mask(dataclasses.replace(ts, iteration=0), cfg,
                                 as_key(9)).all()


def _duplicated_n_wk():
    rng = np.random.default_rng(5)
    n_wk = rng.integers(0, 30, (50, 8)).astype(np.int32)
    n_wk[:, 5] = n_wk[:, 1]  # exact duplicate
    n_wk[:, 6] = n_wk[:, 2] * 2  # same distribution, twice the mass
    n_wk[:3, 7] = n_wk[:3, 3] + 1  # close to topic 3 ...
    n_wk[3:, 7] = n_wk[3:, 3]  # ... but not equal
    return n_wk


@pytest.mark.parametrize("threshold,min_topics", [(0.05, 2), (0.6, 4),
                                                  (5.0, 2), (5.0, 1)])
def test_duplicate_topic_map_and_merge_bit_equal(threshold, min_topics):
    n_wk = _duplicated_n_wk()
    jm = jhyper.duplicate_topic_map(n_wk, threshold, min_topics)
    tm = thyper.duplicate_topic_map(torch.from_numpy(n_wk), threshold,
                                    min_topics)
    np.testing.assert_array_equal(tm, jm)
    (_, js, _), (_, ts, _) = _corpus_state(6, k=8)
    j_out = jhyper.merge_topics(js.topic, js.n_wk, js.n_kd, js.n_k,
                                jnp.asarray(jm))
    t_out = thyper.merge_topics(ts.topic, ts.n_wk, ts.n_kd, ts.n_k,
                                torch.from_numpy(tm))
    for a, b in zip(j_out, t_out):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_topic_distances_match_reference():
    n_wk = _duplicated_n_wk()
    np.testing.assert_allclose(
        thyper.topic_l1_distances(torch.from_numpy(n_wk)).numpy(),
        np.asarray(jhyper.topic_l1_distances(jnp.asarray(n_wk))),
        rtol=1e-6, atol=1e-6)


def test_rebuild_and_minka_step_match_reference():
    (jc, js, jh), (tc, ts, th) = _corpus_state(7)
    stale = dataclasses.replace(ts, n_wk=ts.n_wk * 0, n_kd=ts.n_kd * 0,
                                n_k=ts.n_k * 0)
    plan = SingleBoxPlan(tc, th, RunConfig(), device="cpu")
    rebuilt = plan.rebuild(stale)
    for name in ("n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(getattr(rebuilt, name).numpy(),
                                      np.asarray(getattr(js, name)))
    n_kd = np.asarray(js.n_kd)
    np.testing.assert_allclose(thyper.minka_alpha_update(n_kd, 0.1),
                               jhyper.minka_alpha_update(n_kd, 0.1),
                               rtol=1e-12)
    assert thyper.anneal_beta(0.05, 0.5, 0.01) == \
        jhyper.anneal_beta(0.05, 0.5, 0.01)


# -- float work ---------------------------------------------------------------

@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("asymmetric", [True, False])
def test_conditional_probs_match_reference(exclude_self, asymmetric):
    (jc, js, jh), (tc, ts, th) = _corpus_state(
        8, hyper_kw=dict(asymmetric_alpha=asymmetric))
    j = np.asarray(jsampler.conditional_probs(js, jc, jh, exclude_self))
    t = sampler.conditional_probs(ts, tc, th, exclude_self)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


@pytest.mark.parametrize("how", ["cdf", "gumbel", "zen_pallas",
                                 "zen_cell"])
def test_draws_follow_the_reference_conditional(how):
    """Empirical topic frequencies of each token over 8 sweep seeds x 600
    replicas (distinct noise rows) against the reference's conditional:
    pooled chi-square, p > 1e-3. ``zen_cell`` is the dense backend's
    per-cell form (``zen_dense_cell``)."""
    (jc, js, jh), (tc, ts, th) = _corpus_state(
        9, e=24, w=6, d=3, k=4, hyper_kw=dict(alpha=0.5, beta=0.1))
    probs = np.asarray(jsampler.conditional_probs(js, jc, jh), np.float64)
    probs /= probs.sum(1, keepdims=True)
    reps, seeds, e, k = 600, 8, 24, 4
    rep_corpus = Corpus(word=tc.word.repeat(reps), doc=tc.doc.repeat(reps),
                        num_words=6, num_docs=3)
    rep_state = dataclasses.replace(ts, topic=ts.topic.repeat(reps),
                                    prev_topic=ts.topic.repeat(reps))
    hist = np.zeros((e, k))
    for it in range(seeds):
        st = dataclasses.replace(rep_state, iteration=it)
        if how == "zen_pallas":
            z = talg.get("zen_pallas").sweep(st, rep_corpus, th,
                                             talg.SamplerKnobs())
        elif how == "zen_cell":
            z = talg.get("zen").cell_sweep(
                1000 + it, rep_corpus.word, rep_corpus.doc, st.topic, None,
                st.n_wk, st.n_kd, st.n_k, th, 6, talg.SamplerKnobs())
        else:
            z = sampler.cgs_sweep_stale(st, rep_corpus, th, method=how)
        z = z.numpy().reshape(reps, e)
        for i in range(e):
            hist[i] += np.bincount(z[:, i], minlength=k)
    expected = probs * reps * seeds
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    p = stats.chi2.sf(chi2, e * (k - 1))
    assert p > 1e-3, (chi2, p)


def test_token_chunk_changes_no_draw():
    (_, _, _), (tc, ts, th) = _corpus_state(10, e=300)
    whole = sampler.cgs_sweep_stale(ts, tc, th)
    for chunk in (30, 100, 300, 1000):
        np.testing.assert_array_equal(
            sampler.cgs_sweep_stale(ts, tc, th, token_chunk=chunk).numpy(),
            whole.numpy())
    with pytest.raises(ValueError, match="does not divide"):
        sampler.cgs_sweep_stale(ts, tc, th, token_chunk=7)
    knobs = talg.SamplerKnobs(token_chunk=60)
    zp = talg.get("zen_pallas")
    np.testing.assert_array_equal(
        zp.sweep(ts, tc, th, knobs).numpy(),
        zp.sweep(ts, tc, th, talg.SamplerKnobs(kernels="on")).numpy())


def test_gibbs_iteration_is_the_plan_step_without_exclusion():
    (_, _, _), (tc, ts, th) = _corpus_state(15)
    zeros = torch.zeros_like(ts.topic)
    ts = dataclasses.replace(ts, stale_iters=zeros, same_count=zeros)
    plan = SingleBoxPlan(tc, th, RunConfig(sampling_method="cdf"),
                         device="cpu")
    a, b = sampler.gibbs_iteration(ts, tc, th), plan.step(ts)
    a.check_invariants(tc)
    assert a.iteration == b.iteration == 1
    for name in ("topic", "prev_topic", "n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy())


@pytest.mark.parametrize("asymmetric", [True, False])
def test_likelihoods_match_reference(asymmetric):
    (jc, js, jh), (tc, ts, th) = _corpus_state(
        11, e=2000, w=80, d=40, k=9,
        hyper_kw=dict(asymmetric_alpha=asymmetric))
    np.testing.assert_allclose(
        float(likelihood.predictive_llh(ts, tc, th)),
        float(jllh.predictive_llh(js, jc, jh)), rtol=1e-5)
    np.testing.assert_allclose(
        float(likelihood.predictive_llh(ts, tc, th, token_chunk=500)),
        float(likelihood.predictive_llh(ts, tc, th)), rtol=1e-12)
    np.testing.assert_allclose(float(likelihood.perplexity(ts, tc, th)),
                               float(jllh.perplexity(js, jc, jh)), rtol=1e-5)
    j, t = jllh.joint_llh(js, jc, jh), likelihood.joint_llh(ts, tc, th)
    for name in ("word", "doc", "total"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), rtol=1e-5)


def _pin_values(asymmetric):
    """tests/test_likelihood.py's pure-python oracle on its 2-doc,
    3-word, 2-topic pin corpus."""
    import math

    n_wk, n_kd, n_k, n_d = [[1, 0], [0, 2], [1, 1]], [[1, 1], [1, 2]], \
        [2, 3], [2, 3]
    w, k, beta = 3, 2, 0.25
    alpha_k = ([2 * 0.5 * (n + 0.5) / 6.0 for n in n_k] if asymmetric
               else [0.5, 0.5])
    a_sum = sum(alpha_k)
    pred = sum(math.log(sum(
        (n_kd[d][t] + alpha_k[t]) / (n_d[d] + a_sum)
        * (n_wk[wd][t] + beta) / (n_k[t] + w * beta) for t in range(k)))
        for wd, d in zip([0, 1, 1, 2, 2], [0, 0, 1, 1, 1]))
    lg = math.lgamma
    word = (k * lg(w * beta) - sum(lg(n + w * beta) for n in n_k)
            + sum(lg(c + beta) for row in n_wk for c in row)
            - k * w * lg(beta))
    doc = (2 * lg(a_sum) - sum(lg(n + a_sum) for n in n_d)
           + sum(lg(n_kd[d][t] + alpha_k[t]) for d in range(2)
                 for t in range(k)) - 2 * sum(lg(a) for a in alpha_k))
    return pred, word, doc


@pytest.mark.parametrize("asymmetric", [False, True])
def test_likelihood_hand_computed_pins(asymmetric):
    corpus = Corpus(word=torch.tensor([0, 1, 1, 2, 2], dtype=torch.int32),
                    doc=torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32),
                    num_words=3, num_docs=2)
    hyper = LDAHyperParams(num_topics=2, alpha=0.5, beta=0.25,
                           alpha_prime=1.0, asymmetric_alpha=asymmetric)
    topic = torch.tensor([0, 1, 1, 0, 1], dtype=torch.int32)
    state = CGSState(topic=topic, prev_topic=topic,
                     n_wk=torch.tensor([[1, 0], [0, 2], [1, 1]],
                                       dtype=torch.int32),
                     n_kd=torch.tensor([[1, 1], [1, 2]], dtype=torch.int32),
                     n_k=torch.tensor([2, 3], dtype=torch.int32),
                     rng=as_key(0))
    state.check_invariants(corpus)
    pred, word, doc = _pin_values(asymmetric)
    literal = -5.2329003404 if asymmetric else -5.2430152746
    np.testing.assert_allclose(pred, literal, rtol=1e-9)
    np.testing.assert_allclose(
        float(likelihood.predictive_llh(state, corpus, hyper)), pred,
        rtol=1e-5)
    np.testing.assert_allclose(
        float(likelihood.perplexity(state, corpus, hyper)),
        np.exp(-pred / 5), rtol=1e-5)
    got = likelihood.joint_llh(state, corpus, hyper)
    # the reference's own pin tolerance (float32 lgamma, cancellation)
    np.testing.assert_allclose(float(got.word), word, rtol=5e-4)
    np.testing.assert_allclose(float(got.doc), doc, rtol=5e-4)
    np.testing.assert_allclose(float(got.total), word + doc, rtol=5e-4)


# -- initialisation and whole runs -------------------------------------------

@pytest.mark.parametrize("init", ["random", "sparse_word", "sparse_doc"])
def test_init_strategies_hold_invariants(init):
    corpus, _ = synthetic_lda_corpus(0, 60, 80, 10, 30)
    hyper = LDAHyperParams(num_topics=10)
    plan = SingleBoxPlan(corpus, hyper, RunConfig(init=init,
                                                  sparse_init_degree=0.3),
                         device="cpu")
    st = plan.init(3)
    st.check_invariants(plan.corpus)
    again = plan.init(3)
    np.testing.assert_array_equal(st.topic.numpy(), again.topic.numpy())
    assert not torch.equal(st.topic, plan.init(4).topic)
    assert st.iteration == 0 and not torch.equal(st.rng, as_key(3))
    if init != "random":
        group = (plan.corpus.word if init == "sparse_word"
                 else plan.corpus.doc).numpy()
        z = st.topic.numpy()
        for g in np.unique(group):
            assert len(np.unique(z[group == g])) <= 3  # round(0.3 * 10)


def _chains(corpus_t, hyper_t, init_topics, algorithm, iters=30):
    ppl = []
    for c, topics in enumerate(init_topics):
        s = TrainSession(corpus_t, hyper_t,
                         RunConfig(algorithm=algorithm), device="cpu")
        st = s.init(100 + c, init_topics=topics)
        for _ in range(iters):
            st = s.step(st)
            st.check_invariants(s.corpus)
        ppl.append(s.perplexity(st))
    return ppl


def test_whole_runs_match_reference_perplexity():
    """Quickstart corpus, K=10, alpha=0.1, beta=0.01, 30 iterations from
    the reference's initial topics: the port's 3-chain mean perplexity
    (zen and zen_pallas) within 10% of the reference zen's."""
    jc, _ = j_lda_corpus(0, 200, 300, 10, 50)
    tc, _ = synthetic_lda_corpus(0, 200, 300, 10, 50)
    np.testing.assert_array_equal(tc.word.numpy(), np.asarray(jc.word))
    jh = JHyper(num_topics=10, alpha=0.1, beta=0.01)
    th = LDAHyperParams(num_topics=10, alpha=0.1, beta=0.01)
    ref_ppl, init_topics = [], []
    for c in range(3):
        s = JSession(jc, jh, JRunConfig(algorithm="zen"))
        st = s.init(jax.random.key(c))
        init_topics.append(np.asarray(st.topic))
        for _ in range(30):
            st = s.step(st)
        ref_ppl.append(s.perplexity(st))
    ref_mean = float(np.mean(ref_ppl))
    for algorithm in ("zen", "zen_pallas"):
        port = _chains(tc, th, init_topics, algorithm)
        assert abs(np.mean(port) / ref_mean - 1) < 0.10, \
            (algorithm, port, ref_ppl)


@pytest.mark.parametrize("seed,max_kd", [
    *(pytest.param(s, 8, id=str(s)) for s in range(6)),
    *(pytest.param(s, 64, id=f"{s}-control") for s in range(6))])
def test_zen_cdf_doc_topk_truncation_tracks_the_reference(seed, max_kd):
    """``zen_cdf`` on K = 64 topics, both packages from the reference's
    initial topics, 6 iterations. With doc rows truncated to their top
    max_kd = 8 (60-token documents: most rows hold more than 8) and, as
    the control, with max_kd = K (nothing truncated, so only the two
    packages' own chains differ): the port's llh lies within 1% of the
    reference's after every iteration. Each case prints its largest gap
    (``pytest -s``): the band sits just above the controls' and far below
    a 2% gap of the truncation between the packages."""
    jc, _ = j_lda_corpus(0, 60, 150, 64, 60)
    tc, _ = synthetic_lda_corpus(0, 60, 150, 64, 60)
    jh = JHyper(num_topics=64, alpha=0.1, beta=0.01)
    th = LDAHyperParams(num_topics=64, alpha=0.1, beta=0.01)
    js = JSession(jc, jh, JRunConfig(algorithm="zen_cdf", max_kd=max_kd))
    jst = js.init(jax.random.key(seed))
    sess = TrainSession(tc, th,
                        RunConfig(algorithm="zen_cdf", max_kd=max_kd),
                        device="cpu")
    st = sess.init(seed, init_topics=np.asarray(jst.topic))
    assert float(np.asarray(jst.n_kd).astype(bool).sum(1).max()) > 8
    ref, port = [js.llh(jst)], [sess.llh(st)]
    for _ in range(6):
        jst, st = js.step(jst), sess.step(st)
        st.check_invariants(sess.corpus)
        ref.append(js.llh(jst))
        port.append(sess.llh(st))
    assert port[0] == pytest.approx(ref[0], rel=1e-6)
    assert port[-1] > port[0]
    gap = max(abs(b / a - 1) for a, b in zip(ref[1:], port[1:]))
    print(f"zen_cdf K=64 max_kd={max_kd} seed={seed}: largest llh gap "
          f"{gap:.4%}")
    assert gap < 0.01, (ref, port)


# -- config, state and checkpoints cross between the packages ---------------

def test_run_config_json_round_trips_between_packages():
    ref = JRunConfig(algorithm="zen_pallas", kernels="off", token_chunk=64,
                     exclusion_start=5, merge_every=3, hyper_every=2,
                     checkpoint_dir="/x", sampling_method="gumbel")
    port = RunConfig.from_json(ref.to_json())
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert JRunConfig.from_json(port.to_json()) == ref
    assert json.loads(RunConfig().to_json()) == \
        json.loads(JRunConfig().to_json())
    with pytest.raises(ValueError, match="unknown RunConfig fields: nope"):
        RunConfig.from_json('{"nope": 1}')


@pytest.mark.parametrize("field,value,item", [
    ("mesh_shape", (1, 1), "item 7"), ("window_docs", 64, "item 6"),
    ("stream_source", "replay", "item 6"),
    ("metrics_out", "m.jsonl", "item 5"), ("autopilot", True, "item 5"),
    ("quality_every", 2, "item 5"), ("algorithm", "zen_cdf", "item 4"),
    ("algorithm", "std", "item 1")])
def test_unported_run_config_fields_are_refused(field, value, item,
                                                tmp_path):
    """Every field that once waited for a ROADMAP item is ported. The mesh
    plan (``mesh_shape``, item 7) trains a (1, 1) mesh in this process (a
    world of one) and its checkpoint tree and model have the shapes of
    the reference's mesh plan on the same corpus. The two backends that
    once waited (``zen_cdf``, item 4; ``std``, item 1) and the streaming
    fields (``window_docs``, ``stream_source``, item 6): their reference
    RunConfig JSON loads in both packages and trains in ``TrainSession``,
    which ignores the streaming fields, as the reference's does. So are
    item 5's telemetry, autopilot and quality fields: a session takes
    them, builds the reference's schedule for them and trains with them
    on."""
    (jc, _, jh), (tc, _, th) = _corpus_state(12)
    if field == "metrics_out":
        value = str(tmp_path / value)
    cfg = RunConfig(**{field: value})
    ref = JRunConfig.from_json(cfg.to_json())  # the reference takes it
    assert getattr(ref, field) == value
    if item == "item 5":
        cfg = dataclasses.replace(cfg, num_iterations=2)
        sess = TrainSession(tc, th, cfg, device="cpu")
        assert sess.schedule.names() == JSession(
            jc, jh, dataclasses.replace(ref, num_iterations=2)
        ).schedule.names()
        assert field.split("_")[0] in " ".join(sess.schedule.names()) \
            or field == "metrics_out"
        st = sess.run(0)
        st.check_invariants(sess.corpus)
        assert int(st.iteration) == 2
        if field == "metrics_out":
            from repro_torch.observe.metrics import read_jsonl

            assert [r["iteration"] for r in read_jsonl(value)] == [1, 2]
        return
    if field == "mesh_shape":
        cfg = dataclasses.replace(cfg, num_iterations=2)
        sess = TrainSession(tc, th, cfg, device="cpu")
        jsess = JSession(jc, jh, dataclasses.replace(ref, num_iterations=2))
        assert sess.schedule.names() == jsess.schedule.names()
        assert sess.cfg.sampling_method == jsess.cfg.sampling_method
        st = sess.run(0)
        jst = jsess.run(jax.random.key(0))
        sess.plan.check_invariants(st)
        assert int(st.iteration) == int(jst.iteration) == 2
        tree, jtree = (sess.plan.checkpoint_tree(st),
                       jsess.plan.checkpoint_tree(jst))
        assert tree["topic"].shape == np.asarray(jtree["topic"]).shape
        assert [a.shape for a in sess.plan.model_arrays(st)] == \
            [a.shape for a in jsess.plan.model_arrays(jst)]
        assert sess.llh(st) < 0 and 0 < sess.metrics(st)["change_rate"] < 1
        return
    if field in ("algorithm", "window_docs", "stream_source"):
        port = RunConfig.from_json(ref.to_json())
        assert port == cfg
        sess = TrainSession(tc, th, port, device="cpu")
        st = sess.init(0)
        llh0 = sess.llh(st)
        for _ in range(2):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
        assert sess.llh(st) > llh0
        return
    with pytest.raises(ValueError, match=f"{field}=.*{item}"):
        TrainSession(tc, th, cfg, device="cpu")


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch,
                                                          capsys, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _, _), (tc, _, th) = _corpus_state(13)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainSession(tc, th, RunConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SingleBoxPlan(tc, th, RunConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--single-box", "--algorithm", "zen", "--iters", "1",
                    "--synthetic-docs", "5", "--synthetic-words", "9"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CGSState.from_numpy({"topic": np.zeros(4, np.int32),
                             "rng": np.zeros(2, np.uint32)})
    # the mesh plan is ported: without --single-box a 1x1 mesh trains in
    # this process, a 2x2 one needs 4 ranks (exit 2 without them, as a
    # mismatched mesh fails in the reference), and --single-box ignores
    # --rows
    mesh_tiny = ["--iters", "1", "--topics", "4", "--synthetic-docs", "5",
                 "--synthetic-words", "9", "--device", "cpu"]
    for argv, code, line in (
            (["--algorithm", "zen", "--rows", "1", "--cols", "1"], 0,
             "mesh 1x1  tokens="),
            (["--single-box", "--algorithm", "zen", "--rows", "2"], 0,
             "single-box  algorithm=zen "),
            (["--algorithm", "zen"], 2, None)):
        capsys.readouterr()
        assert train.main(argv + mesh_tiny) == code, argv
        if line is not None:
            assert line in capsys.readouterr().out, argv
    # item 5's flags are ported: each trains on the CPU
    tiny = ["--single-box", "--algorithm", "zen", "--iters", "2", "--topics",
            "4", "--synthetic-docs", "5", "--synthetic-words", "9",
            "--device", "cpu"]
    for argv in (["--autopilot"],
                 ["--metrics-out", str(tmp_path / "m")],
                 ["--quality-every", "1"]):
        capsys.readouterr()
        assert train.main(tiny + argv) == 0, argv
        out = capsys.readouterr().out
        assert "finished at iteration 2" in out, argv
        assert ("autopilot: final backend=" in out) == (
            argv[0] == "--autopilot")
        assert ("umass" in out) == (argv[0] == "--quality-every")
    # the default algorithm, zen_cdf, is ported: it trains on the CPU
    capsys.readouterr()
    assert train.main(["--single-box", "--iters", "2", "--topics", "6",
                       "--synthetic-docs", "5", "--synthetic-words", "9",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "single-box  algorithm=zen_cdf " in out
    assert "finished at iteration 2; final llh -" in out
    # --stream is ported: a drift stream trains on the CPU
    assert train.main(["--single-box", "--algorithm", "zen", "--stream",
                       "--iters", "2", "--topics", "4", "--window-docs",
                       "4", "--synthetic-words", "30", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "stream  source=drift  window_docs=4" in out
    assert "stream finished at window 2" in out


def test_state_crosses_between_packages():
    (jc, js, jh), (tc, _, th) = _corpus_state(14)
    leaves = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js)
              if f.name not in ("rng", "iteration")
              and getattr(js, f.name) is not None}
    leaves["rng"] = np.asarray(jax.random.key_data(js.rng))
    leaves["iteration"] = 4
    st = CGSState.from_numpy(leaves, device="cpu")
    st.check_invariants(tc)
    assert st.iteration == 4 and st.rng.tolist() == leaves["rng"].tolist()
    back = st.to_numpy()
    for name, arr in leaves.items():
        np.testing.assert_array_equal(back[name], arr)
    broken = dataclasses.replace(st, n_k=st.n_k + 1)
    with pytest.raises(AssertionError, match="sum n_k == E"):
        broken.check_invariants(tc)


def test_reference_training_checkpoint_resumes_in_port(tmp_path):
    jc, _ = j_lda_corpus(1, 30, 40, 5, 20)
    tc, _ = synthetic_lda_corpus(1, 30, 40, 5, 20)
    ckpt = str(tmp_path / "train")
    js = JSession(jc, JHyper(num_topics=5), JRunConfig(
        algorithm="zen", num_iterations=2, train_checkpoint_dir=ckpt,
        train_checkpoint_every=1))
    final = js.run(jax.random.key(0))
    port = TrainSession(tc, LDAHyperParams(num_topics=5), RunConfig(
        algorithm="zen", num_iterations=2, train_checkpoint_dir=ckpt,
        train_checkpoint_every=1), device="cpu")
    st = port.run(7)  # resumes at iteration 2: nothing left to run
    assert st.iteration == 2
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(final, name)))
    more = TrainSession(tc, LDAHyperParams(num_topics=5), RunConfig(
        algorithm="zen_pallas", num_iterations=4, train_checkpoint_dir=ckpt,
        train_checkpoint_every=1), device="cpu").run(7)
    assert more.iteration == 4
    more.check_invariants(tc)
    leaves, _, step = tckpt.CheckpointManager(ckpt).restore_latest()
    assert step == 4 and leaves["iteration"].dtype == np.int32
    np.testing.assert_array_equal(leaves["topic"], more.topic.numpy())


def test_schedule_and_model_checkpoint_match_reference(tmp_path):
    tc, _ = synthetic_lda_corpus(2, 40, 50, 6, 25)
    jc, _ = j_lda_corpus(2, 40, 50, 6, 25)
    kw = dict(algorithm="zen_pallas", num_iterations=6, eval_every=2,
              exclusion_start=2, rebuild_every=3, merge_every=3,
              merge_threshold=0.3, hyper_every=2, hyper_beta_anneal=0.9,
              checkpoint_dir=str(tmp_path / "model"), checkpoint_every=4,
              train_checkpoint_dir=str(tmp_path / "train"),
              train_checkpoint_every=5)
    jsess = JSession(jc, JHyper(num_topics=6), JRunConfig(**kw))
    sess = TrainSession(tc, LDAHyperParams(num_topics=6), RunConfig(**kw),
                        device="cpu")
    assert sess.schedule.names() == jsess.schedule.names()
    seen = []

    def cb(st, metrics):
        st.check_invariants(sess.corpus)
        seen.append((int(st.iteration), sorted(metrics)))

    final = sess.run(0, callback=cb)
    assert [i for i, _ in seen] == [1, 2, 3, 4, 5, 6]
    assert all("llh" in m for i, m in seen if i % 2 == 0)
    assert sess.hyper.beta < 0.01 * 0.9 ** 2
    n_wk, n_k, hyper, meta, step = jckpt.load_lda_model(kw["checkpoint_dir"])
    assert step == 6 and meta["algorithm"] == "zen_pallas"
    np.testing.assert_array_equal(np.asarray(n_wk), final.n_wk.numpy())
    np.testing.assert_array_equal(np.asarray(n_k), final.n_k.numpy())
    assert dataclasses.asdict(hyper) == dataclasses.asdict(sess.hyper)


def test_quickstart_pair_runs_through_the_port(tmp_path):
    """``python -m repro_torch.launch.train ... --device cpu`` then
    ``repro_torch.launch.serve_lda --mode latency`` (both backends), in a
    process where jax and the JAX package never load; the JAX package
    loads and serves the same checkpoints."""
    dirs = {alg: str(tmp_path / alg) for alg in ("zen", "zen_pallas")}
    cmds = []
    for alg, d in dirs.items():
        cmds.append(("repro_torch.launch.train", [
            "--single-box", "--algorithm", alg, "--iters", "5",
            "--topics", "8", "--synthetic-docs", "60", "--synthetic-words",
            "80", "--synthetic-len", "20", "--llh-every", "0",
            "--checkpoint-dir", d, "--device", "cpu"]))
        cmds.append(("repro_torch.launch.serve_lda", [
            "--checkpoint-dir", d, "--device", "cpu", "--mode", "latency",
            "--synthetic-docs", "6", "--buckets", "16,32", "--show", "1"]))
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
    assert proc.stdout.count("finished at iteration 5; final llh") == 2
    assert proc.stdout.count("latency ms: p50=") == 2
    for alg, d in dirs.items():
        n_wk, n_k, hyper, meta, step = jckpt.load_lda_model(d)
        t_wk, t_k, t_hyper, _, _ = tckpt.load_lda_model(d)
        np.testing.assert_array_equal(np.asarray(n_wk), t_wk)
        assert step == 5 and meta["algorithm"] == alg
        assert int(np.asarray(n_k).sum()) == int(t_wk.sum())
    serve = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve_lda", "--checkpoint-dir",
         dirs["zen_pallas"], "--synthetic-docs", "4", "--buckets", "16,32",
         "--sweeps", "3", "--show", "1"],
        cwd=ROOT, env=dict(env, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr
    assert "W=80 K=8" in serve.stdout or "docs/sec" in serve.stdout
