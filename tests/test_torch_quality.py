"""The port's quality evaluation (``repro_torch.eval``) against the JAX
package's (``repro.eval``), on the CPU.

* Bit-equal: top-word ids (tie-heavy counts included) and every coherence
  integer — D(w), D(w, w'), the window counts of words and pairs and
  ``num_windows`` — on corpora with documents shorter than, as long as and
  longer than the window, repeated words in one window and empty
  documents, in corpus order and shuffled.
* Within 1e-12 absolute: UMass and NPMI per topic and their means (the
  reference's hand cases and random corpora).
* Left-to-right: the up-front uniforms equal the reference's call-by-call
  draws; estimates within 1e-10 relative of the reference's with the same
  generator, every draw equal (0 near-ties on the CPU); pinned against the
  enumeration oracle.
* ``QualityEval.evaluate``: the same keys and values on the same
  snapshots (numpy or tensors).
* ``TrainSession``: quality on its cadence, nothing built when disabled,
  the reference's schedule names, runs bit-identical with quality and
  telemetry on or off, the JSONL records' kinds and fields as the
  reference's; and the train CLI's line shapes as the reference's.
"""
import dataclasses
import math
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.types import LDAHyperParams as JHyper
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro.eval import coherence as jcoh
from repro.eval import left_to_right as jl2r
from repro.eval import quality as jq
from repro.observe.metrics import read_jsonl as j_read_jsonl
from repro.train.session import RunConfig as JRunConfig
from repro.train.session import TrainSession as JSession
from repro_torch.core.types import Corpus, LDAHyperParams
from repro_torch.eval import (
    CoherenceStats,
    QualityConfig,
    QualityEval,
    exhaustive_llh,
    left_to_right_llh,
    left_to_right_llh_batch,
    npmi_coherence,
    top_topic_words,
    umass_coherence,
)
from repro_torch.observe.metrics import read_jsonl
from repro_torch.train.session import RunConfig, TrainSession

CPU = "cpu"


def _corpus(jc) -> Corpus:
    return Corpus(word=torch.from_numpy(np.asarray(jc.word)),
                  doc=torch.from_numpy(np.asarray(jc.doc)),
                  num_words=jc.num_words, num_docs=jc.num_docs)


def _both_stats(word, doc, num_docs, window, num_words=None):
    js = jcoh.CoherenceStats(word, doc, num_docs, window=window)
    ts = CoherenceStats(torch.tensor(word), torch.tensor(doc), num_docs,
                        window=window, num_words=num_words)
    return js, ts


def _random_corpus(seed, regime, shuffle):
    """Documents of lengths around the window (regime "short": all <= 10,
    "long": mostly > 10, "mixed"), a small vocabulary so words repeat
    within a window, and empty documents."""
    rng = np.random.default_rng(seed)
    d, w = 25, 9
    hi = {"short": 11, "long": 40, "mixed": 25}[regime]
    lo = {"short": 0, "long": 8, "mixed": 0}[regime]
    lens = rng.integers(lo, hi, d)
    lens[[0, 7]] = 0  # empty documents
    lens[3] = 10  # exactly the window
    doc = np.repeat(np.arange(d), lens).astype(np.int32)
    word = rng.integers(0, w, doc.size).astype(np.int32)
    if shuffle:
        perm = rng.permutation(doc.size)
        word, doc = word[perm], doc[perm]
    return word, doc, d, w


# -- top words ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("top_n", [1, 5, 40])
def test_top_topic_words_bit_equal_with_ties(seed, top_n):
    rng = np.random.default_rng(seed)
    # few distinct values: most columns are full of ties
    n_wk = rng.integers(0, 3 + seed, (30, 7)).astype(np.int32)
    n_wk[:, 0] = 5  # one column all tied
    ref = jcoh.top_topic_words(n_wk, top_n)
    got = top_topic_words(torch.from_numpy(n_wk), top_n)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        top_topic_words(n_wk, top_n, device=CPU).numpy(), ref)


def test_top_topic_words_reference_hand_case():
    n_wk = np.array([[5, 1], [9, 1], [5, 7], [0, 7]], np.int64)
    top = top_topic_words(n_wk, 3, device=CPU).numpy()
    np.testing.assert_array_equal(top[0], [1, 0, 2])
    np.testing.assert_array_equal(top[1], [2, 3, 0])


def test_eval_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    """Host data goes to the card unless the caller asks for the CPU, and
    raises without one; a tensor stays on its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n_wk = np.array([[5, 1], [9, 1], [5, 7]], np.int64)
    n_k = n_wk.sum(0)
    word = np.array([0, 1, 2, 1], np.int32)
    doc = np.array([0, 0, 1, 1], np.int32)
    hyper = LDAHyperParams(num_topics=2)
    no_card = pytest.raises(RuntimeError, match="no CUDA device")
    with no_card:
        top_topic_words(n_wk, 2)
    with no_card:
        CoherenceStats(word, doc, 2)
    with no_card:
        left_to_right_llh(n_wk, n_k, [0, 2], hyper,
                          rng=np.random.default_rng(0))
    with no_card:
        left_to_right_llh_batch(n_wk, n_k, [[0, 2]], hyper)
    with no_card:
        top_topic_words(torch.from_numpy(n_wk), 2, device="cuda")
    # CPU tensors, and host data with device="cpu", stay on the CPU
    assert top_topic_words(torch.from_numpy(n_wk), 2).device.type == CPU
    assert CoherenceStats(torch.from_numpy(word), torch.from_numpy(doc),
                          2).device.type == CPU
    assert CoherenceStats(word, doc, 2, device=CPU).num_windows == 2
    got, near = left_to_right_llh_batch(n_wk, n_k, [[0, 2]], hyper,
                                        rngs=[np.random.default_rng(0)],
                                        device=CPU)
    assert np.isfinite(got).all() and near.tolist() == [0]


# -- coherence integers -------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("regime", ["short", "long", "mixed"])
@pytest.mark.parametrize("window", [1, 2, 10])
def test_coherence_integers_bit_equal(window, regime, shuffle):
    word, doc, d, w = _random_corpus(window * 7 + len(regime), regime,
                                     shuffle)
    js, ts = _both_stats(word, doc, d, window)
    assert ts.num_windows == js.num_windows
    ids = np.arange(-1, w + 2)  # outside the corpus too
    assert list(ts.doc_freq(ids)) == [js.doc_freq(x) for x in ids]
    assert list(ts.window_count(ids)) == [len(js._windows_with(x))
                                          for x in ids]
    a, b = (x.ravel() for x in np.meshgrid(ids, ids))
    assert list(ts.co_doc_freq(a, b)) == [js.co_doc_freq(x, y)
                                          for x, y in zip(a, b)]
    assert list(ts.co_window_count(a, b)) == [
        len(js._windows_with(x) & js._windows_with(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(ts.window_prob(ids),
                                  [js.window_prob(x) for x in ids])
    np.testing.assert_array_equal(ts.co_window_prob(a, b),
                                  [js.co_window_prob(x, y)
                                   for x, y in zip(a, b)])
    assert len(ts.docs) == len(js.docs)
    for ref, got in zip(js.docs, ts.docs):
        np.testing.assert_array_equal(got, ref)


def test_coherence_hand_counts_and_empty_corpus():
    word = np.array([0, 1, 2, 0, 1, 2, 3], np.int32)
    doc = np.array([0, 0, 0, 1, 1, 2, 2], np.int32)
    js, ts = _both_stats(word, doc, 3, 2)
    assert ts.doc_freq([0]).tolist() == [js.doc_freq(0)] == [2]
    assert ts.co_doc_freq([2], [3]).tolist() == [js.co_doc_freq(2, 3)] == [1]
    assert ts.window_prob([1]).tolist() == [js.window_prob(1)] == [3 / 4]
    assert ts.co_window_prob([0], [1]).tolist() == \
        [js.co_window_prob(0, 1)] == [2 / 4]
    empty = np.zeros(0, np.int32)
    je, te = _both_stats(empty, empty, 4, 10, num_words=5)
    assert te.num_windows == je.num_windows == 0
    assert te.window_prob([3]).tolist() == [je.window_prob(3)] == [0.0]
    assert te.co_doc_freq([1], [2]).tolist() == [0]
    top = np.array([[0, 1], [2, 3]])
    assert umass_coherence(te, top) == (0.0, pytest.approx([0.0, 0.0]))


# -- coherence scores ------------------------------------------------------------

def _tiny(window=2):
    word = np.array([0, 1, 2, 0, 1, 2, 3], np.int32)
    doc = np.array([0, 0, 0, 1, 1, 2, 2], np.int32)
    return _both_stats(word, doc, 3, window)


@pytest.mark.parametrize("top", [[[0, 1], [2, 3]], [[7, 0]], [[0, 3]],
                                 [[3, 2, 1, 0], [1, 0, 3, 2]]],
                         ids=["hand", "absent_word", "never_together",
                              "four_words"])
def test_coherence_reference_hand_cases(top):
    """``tests/test_eval_quality.py``'s hand corpus: the reference's values
    (log(1.5)/2, log(4/3)/log 2, the skipped absent word, the -1 limit)
    within 1e-12."""
    js, ts = _tiny()
    top = np.array(top)
    for jf, tf in ((jcoh.umass_coherence, umass_coherence),
                   (jcoh.npmi_coherence, npmi_coherence)):
        jm, jp = jf(js, top)
        tm, tp = tf(ts, torch.from_numpy(top))
        assert abs(tm - jm) < 1e-12
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    _, per_topic = umass_coherence(ts, np.array([[0, 1], [2, 3]]))
    np.testing.assert_allclose(per_topic, [math.log(1.5), 0.0], rtol=1e-12)
    _, per_topic = npmi_coherence(ts, np.array([[0, 1], [2, 3]]))
    np.testing.assert_allclose(
        per_topic, [math.log(4 / 3) / math.log(2), 0.5], rtol=1e-12)


@pytest.mark.parametrize("seed", range(5))
def test_coherence_random_corpora_within_1e12(seed):
    jc, _ = j_lda_corpus(seed=seed, num_docs=40, num_words=50, num_topics=5,
                         avg_doc_len=15)
    word, doc = np.asarray(jc.word), np.asarray(jc.doc)
    rng = np.random.default_rng(seed)
    for window in (3, 10):
        js, ts = _both_stats(word, doc, jc.num_docs, window)
        n_wk = rng.integers(0, 6, (50, 5))
        top = jcoh.top_topic_words(n_wk, 8)
        for jf, tf in ((jcoh.umass_coherence, umass_coherence),
                       (jcoh.npmi_coherence, npmi_coherence)):
            jm, jp = jf(js, top)
            tm, tp = tf(ts, top)
            assert abs(tm - jm) < 1e-12, (jf.__name__, tm, jm)
            np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)


def test_chip_smoke_plain_pair_counts_equal_stats_at_wide_ids():
    """``chip_smoke.py``'s direct per-pair version against
    ``CoherenceStats`` on a top-word union spread over every frequency
    band (``planted_top_counts``, ``banded_pairs``), on a corpus whose
    word id times document count passes 2^31."""
    import pathlib

    from repro_torch.data.corpus import synthetic_corpus

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    corpus = synthetic_corpus(0, num_docs=30_000, num_words=100_000,
                              avg_doc_len=12)
    stats = CoherenceStats.from_corpus(corpus, window=10)
    top = top_topic_words(chip_smoke.planted_top_counts(
        corpus.num_words, 100, 10, 0, CPU), 10).numpy()
    pairs, bands = chip_smoke.banded_pairs(top, stats.doc_freq, 200,
                                           np.random.default_rng(0))
    assert len(bands) >= 10 and int(pairs.max()) * 30_001 > 2 ** 31
    ordered, plain, windows = chip_smoke.plain_pair_counts(corpus, pairs, 10)
    a = np.array([p[0] for p in ordered])
    b = np.array([p[1] for p in ordered])
    assert windows == stats.num_windows
    assert stats.doc_freq(a).tolist() == plain["doc_freq"]
    assert stats.window_count(a).tolist() == plain["window_count"]
    assert stats.co_doc_freq(a, b).tolist() == plain["co_doc_freq"]
    assert stats.co_window_count(a, b).tolist() == plain["co_window_count"]
    assert sum(x > 0 for x in plain["co_window_count"]) > 50


# -- left-to-right ---------------------------------------------------------------

_LLH_MODEL = dict(n_wk=np.array([[8, 1], [1, 8], [4, 4]], np.int64),
                  n_k=np.array([13, 13], np.int64))


def test_l2r_uniforms_equal_call_by_call_draws():
    """One ``random((S, R))`` up front yields the same numbers, in the same
    order, as the reference's S consecutive ``random(R)`` calls."""
    for seed in range(3):
        a = np.random.default_rng((seed, 4, 2))
        b = np.random.default_rng((seed, 4, 2))
        up_front = a.random((36, 20))
        calls = np.stack([b.random(20) for _ in range(36)])
        np.testing.assert_array_equal(up_front, calls)


@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_l2r_matches_reference(seed, asymmetric, resample):
    rng = np.random.default_rng(seed)
    w, k = 40, 9
    n_wk = rng.integers(0, 30, (w, k))
    n_k = n_wk.sum(0)
    hk = dict(num_topics=k, alpha=0.2, beta=0.05,
              asymmetric_alpha=asymmetric)
    docs = [rng.integers(0, w, n) for n in (7, 0, 16, 1, 11)]

    def gens():
        return [np.random.default_rng((seed, 3, i)) for i in range(len(docs))]

    ref = [jl2r.left_to_right_llh(n_wk, n_k, d, JHyper(**hk),
                                  num_particles=8, rng=g, resample=resample)
           for d, g in zip(docs, gens())]
    got, near = left_to_right_llh_batch(
        torch.from_numpy(n_wk), torch.from_numpy(n_k), docs,
        LDAHyperParams(**hk), num_particles=8, rngs=gens(),
        resample=resample)
    assert near.shape == (len(docs),) and not near.any()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
    one = left_to_right_llh(n_wk, n_k, docs[2], LDAHyperParams(**hk),
                            num_particles=8, rng=gens()[2],
                            resample=resample, device=CPU)
    assert abs(one - ref[2]) <= 1e-10 * abs(ref[2])


def test_l2r_single_token_exact_and_empty_doc():
    hyper = LDAHyperParams(num_topics=2, alpha=0.3, beta=0.2)
    exact = exhaustive_llh(**_LLH_MODEL, words=np.array([1]), hyper=hyper)
    est = left_to_right_llh(**_LLH_MODEL, words=np.array([1]), hyper=hyper,
                            num_particles=3, rng=np.random.default_rng(0),
                            device=CPU)
    np.testing.assert_allclose(est, exact, rtol=1e-12)
    assert left_to_right_llh(**_LLH_MODEL, words=np.array([], np.int32),
                             hyper=hyper, rng=np.random.default_rng(0),
                             device=CPU) == 0.0


@pytest.mark.parametrize("asymmetric", [False, True])
def test_l2r_matches_exhaustive_three_tokens(asymmetric):
    hk = dict(num_topics=2, alpha=0.3, beta=0.2, asymmetric_alpha=asymmetric)
    words = np.array([0, 1, 2])
    exact = exhaustive_llh(**_LLH_MODEL, words=words,
                           hyper=LDAHyperParams(**hk))
    assert exact == jl2r.exhaustive_llh(**_LLH_MODEL, words=words,
                                        hyper=JHyper(**hk))
    est = left_to_right_llh(**_LLH_MODEL, words=words,
                            hyper=LDAHyperParams(**hk), num_particles=4000,
                            rng=np.random.default_rng(0), device=CPU)
    assert abs(est - exact) < 0.05, (est, exact)


# -- QualityEval -------------------------------------------------------------

@pytest.fixture(scope="module")
def quality_corpus():
    corpus, _phi = j_lda_corpus(seed=0, num_docs=30, num_words=40,
                                num_topics=4, avg_doc_len=20)
    return corpus


_HK = dict(num_topics=4, alpha=0.1, beta=0.05)


@pytest.mark.parametrize("cfg", [
    dict(top_n=5, l2r_docs=3, l2r_particles=6),
    dict(top_n=10, npmi_window=0, l2r_docs=0),
    dict(top_n=3, npmi_window=4, l2r_docs=50, l2r_particles=5,
         l2r_max_len=6, l2r_seed=3)], ids=["l2r", "umass_only", "all_docs"])
def test_quality_eval_matches_reference(quality_corpus, cfg):
    jqe = jq.QualityEval(quality_corpus, JHyper(**_HK), jq.QualityConfig(**cfg))
    tqe = QualityEval(_corpus(quality_corpus), LDAHyperParams(**_HK),
                      QualityConfig(**cfg))
    rng = np.random.default_rng(0)
    for it in (0, 3):
        n_wk = rng.integers(0, 9, (quality_corpus.num_words, 4))
        n_k = n_wk.sum(axis=0)
        ref = jqe.evaluate(n_wk, n_k, iteration=it)
        got = tqe.evaluate(torch.from_numpy(n_wk), torch.from_numpy(n_k),
                           iteration=it)
        assert set(got) == set(ref)
        assert tqe.last_near_ties == 0
        for key in ("coherence_umass", "coherence_npmi"):
            if key in ref:
                assert abs(got[key] - ref[key]) < 1e-12
        for key in ("l2r_llh", "l2r_per_token"):
            if key in ref:
                assert abs(got[key] - ref[key]) <= 1e-10 * abs(ref[key])
        assert tqe.evaluate(n_wk, n_k, iteration=it) == got  # numpy in


# -- TrainSession ----------------------------------------------------------------

def test_quality_action_fires_on_cadence(quality_corpus):
    cfg = RunConfig(algorithm="zen", num_iterations=4, quality_every=2,
                    quality_l2r_docs=2, quality_l2r_particles=4)
    session = TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                           cfg, device=CPU)
    assert "quality" in session.schedule.names()
    ticks = []
    session.run(0, callback=lambda st, m: ticks.append(
        (int(st.iteration), m)) if m else None)
    assert [i for i, _ in ticks] == [2, 4]
    for _, m in ticks:
        for key in ("coherence_umass", "coherence_npmi", "l2r_llh",
                    "l2r_per_token"):
            assert key in m and np.isfinite(m[key]), m


def test_quality_disabled_builds_nothing(quality_corpus):
    session = TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                           RunConfig(algorithm="zen", num_iterations=1),
                           device=CPU)
    assert session._quality is None and session.telemetry is None
    assert session._autopilot_policy is None
    assert "quality" not in session.schedule.names()


@pytest.mark.parametrize("extra", [
    {}, dict(metrics_out="m.jsonl"), dict(quality_every=2),
    dict(autopilot=True), dict(autopilot=True, rebuild_every=2),
    dict(algorithm="zen_sparse", rebuild_every=2),
    dict(algorithm="zen_sparse", rebuild_every=2, autopilot=True,
         metrics_out="m.jsonl", quality_every=1, eval_every=1,
         hyper_every=2, merge_every=3)],
    ids=["off", "telemetry", "quality", "autopilot", "autopilot_rebuild",
         "repad", "everything"])
def test_schedule_names_equal_reference(quality_corpus, tmp_path, extra):
    if "metrics_out" in extra:
        extra = {**extra, "metrics_out": str(tmp_path / "m.jsonl")}
    kw = {"algorithm": "zen", "num_iterations": 2, **extra}
    ref = JSession(quality_corpus, JHyper(**_HK), JRunConfig(**kw))
    got = TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                       RunConfig(**kw), device=CPU)
    assert got.schedule.names() == ref.schedule.names()


@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas", "zen_sparse"])
def test_quality_and_telemetry_leave_the_run_bit_identical(
        quality_corpus, tmp_path, algorithm):
    base = dict(algorithm=algorithm, num_iterations=4, eval_every=2,
                rebuild_every=2)
    plain = TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                         RunConfig(**base), device=CPU)
    observed = TrainSession(
        _corpus(quality_corpus), LDAHyperParams(**_HK),
        RunConfig(**base, quality_every=1, quality_l2r_docs=3,
                  metrics_out=str(tmp_path / "m.jsonl")), device=CPU)
    a, b = [], []
    st_a = plain.run(5, callback=lambda st, m: a.append(
        m.get("llh")))
    st_b = observed.run(5, callback=lambda st, m: b.append(
        m.get("llh")))
    assert a == b
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        assert torch.equal(getattr(st_a, name), getattr(st_b, name)), name
    assert len(read_jsonl(str(tmp_path / "m.jsonl"))) == 4


_TIME_FIELDS = {"t", "dt_s", "tokens_per_s"}


def test_metrics_jsonl_kinds_and_fields_equal_reference(quality_corpus,
                                                        tmp_path):
    kw = dict(algorithm="zen", num_iterations=4, eval_every=2,
              quality_every=2)
    jp, tp = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    JSession(quality_corpus, JHyper(**_HK),
             JRunConfig(**kw, metrics_out=jp)).run(jax.random.key(0))
    TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                 RunConfig(**kw, metrics_out=tp), device=CPU).run(0)
    ref, got = j_read_jsonl(jp), read_jsonl(tp)
    assert [r["kind"] for r in got] == [r["kind"] for r in ref]
    for r, g in zip(ref, got):
        assert set(g) == set(r)
        for key in set(r) - _TIME_FIELDS - {"llh", "perplexity",
                                            "change_rate", "word_rows",
                                            "doc_rows"}:
            assert g[key] == r[key], key
        for key in ("word_rows", "doc_rows"):
            assert set(g[key]) == set(r[key])
            assert g[key]["num_topics"] == r[key]["num_topics"]
    assert all(g["tokens_per_s"] is None or g["tokens_per_s"] > 0
               for g in got)


def test_hyper_action_updates_the_quality_evaluator(quality_corpus):
    cfg = RunConfig(algorithm="zen", num_iterations=2, hyper_every=2,
                    hyper_beta_anneal=0.9, quality_every=2,
                    quality_l2r_docs=2)
    session = TrainSession(_corpus(quality_corpus), LDAHyperParams(**_HK),
                           cfg, device=CPU)
    session.run(0)
    assert session._quality.hyper is session.hyper
    assert session.hyper.beta == pytest.approx(_HK["beta"] * 0.9)


# -- the train CLI ------------------------------------------------------------

def _shape(line: str) -> str:
    """A progress line with its numbers, the port's device fields and its
    timing suffix taken out."""
    line = re.sub(r"  \([0-9.]+s on [^)]*\)", "", line)
    line = re.sub(r"  device=\S+| on cpu", "", line)
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def test_train_cli_line_shapes_equal_reference(tmp_path, monkeypatch,
                                               capsys):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    args = ["--single-box", "--algorithm", "sparselda", "--iters", "4",
            "--topics", "64", "--synthetic-docs", "120",
            "--synthetic-words", "24", "--synthetic-len", "8",
            "--llh-every", "2", "--quality-every", "2", "--l2r-docs", "3",
            "--l2r-particles", "4", "--autopilot", "--autopilot-every", "2"]
    path = tmp_path / "m.jsonl"
    args += ["--metrics-out", str(path)]
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    jtrain.main()
    ref = capsys.readouterr().out.splitlines()
    assert j_read_jsonl(str(path))
    path.unlink()
    assert ttrain.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    keep = ("iter", "  autopilot", "autopilot:", "telemetry:", "finished")

    def shapes(lines):
        return [_shape(ln) for ln in lines if ln.startswith(keep)]

    assert shapes(got) == shapes(ref)
    assert any("umass" in ln and "npmi" in ln and "l2r/tok" in ln
               for ln in got)
    assert any(ln.startswith("  autopilot BackendSwitch applied")
               for ln in got)
    assert "autopilot: final backend=zen_sparse" in "\n".join(got)
    assert read_jsonl(str(path))


def test_run_config_with_item5_fields_round_trips(tmp_path):
    cfg = RunConfig(metrics_out=str(tmp_path / "m.jsonl"), autopilot=True,
                    autopilot_every=3, quality_every=2, quality_top_n=7,
                    quality_l2r_docs=4)
    ref = JRunConfig.from_json(cfg.to_json())
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    assert RunConfig.from_json(ref.to_json()) == cfg
