"""The port's streaming slice against the JAX package, on the CPU:
corpus sources, windowed online training, stream checkpoints and hot
model reload in serving.

* The sources draw only numpy randomness: every window (words, docs,
  ``num_docs``, ``uid``, ``index``, ``token_index``) is bit-equal to the
  reference's, resumes included.
* Integer work is bit-equal: the decay (``np.rint`` against
  ``torch.round``, on counts that meet .5 ties) and the composed window
  counts, given the reference's ``z0`` (the port's ``window_topics`` is
  replaced by the reference's ``jax.random.randint`` draws).
* Stream checkpoints cross in both directions with the same cursors and
  retained assignments; kill and resume is bit-identical in the port.
* The sweeps draw from counter-based keys, not threefry: the rotation
  regime's whole-corpus perplexity is compared within a band (``pytest
  -s`` prints each seed's gap).
* Every streaming and reload behaviour of ``tests/test_streaming.py`` has
  a counterpart here, run on the port with ``device="cpu"``.
"""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import LDAHyperParams as JHyper
from repro.data import save_libsvm as j_save_libsvm
from repro.data import synthetic_corpus as j_synthetic_corpus
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro.data import stream as jstream
from repro.serving import FrozenLDAModel as JModel
from repro.serving import LDAEngine as JEngine
from repro.serving import LDAServeConfig as JServeConfig
from repro.train import online as jonline
from repro.train.checkpoint import save_lda_model as j_save_lda_model
from repro.train.session import RunConfig as JRunConfig
from repro.train.session import SingleBoxPlan as JPlan
from repro_torch.core.counts import build_counts
from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import (
    save_libsvm,
    synthetic_corpus,
    synthetic_lda_corpus,
)
from repro_torch.data.stream import (
    DriftSource,
    LibsvmStreamSource,
    ReplaySource,
    make_source,
)
from repro_torch.serving import (
    FrozenLDAModel,
    LDAEngine,
    LDARouter,
    LDAServeConfig,
    docs_from_corpus,
)
from repro_torch.train import online
from repro_torch.train.checkpoint import load_lda_model, save_lda_model
from repro_torch.train.online import StreamingSession
from repro_torch.train.session import RunConfig, SingleBoxPlan, TrainSession

CPU = "cpu"
# rotation regime, 20 epochs of the tiny corpus, same initial topics: the
# port's whole-corpus perplexity lies within this fraction of the
# reference's. The chains draw from different generators: over seeds 0-7
# the gaps were -5.7% to +3.4%, and the reference's own perplexity spans
# 11.15-12.08 across those seeds (at 6 epochs the spread is +-15%)
PPL_BAND = 0.08


def _stream_cfg(**kw):
    kw.setdefault("num_iterations", 0)
    kw.setdefault("window_docs", 10)
    kw.setdefault("window_sweeps", 1)
    return RunConfig(**kw)


def _j_cfg(cfg):
    return JRunConfig.from_json(cfg.to_json())


def _tiny():
    """The suite's tiny corpus (``conftest.tiny_corpus``) in both packages,
    and its hyper-parameters."""
    jc, _ = j_lda_corpus(0, 40, 60, 6, 30)
    tc, _ = synthetic_lda_corpus(0, 40, 60, 6, 30)
    return (jc, JHyper(num_topics=6, alpha=0.1, beta=0.05),
            tc, LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05))


def _same_window(jw, tw):
    assert (tw.index, tw.uid, tw.corpus.num_docs, tw.corpus.num_words) == \
        (jw.index, jw.uid, jw.corpus.num_docs, jw.corpus.num_words)
    for name in ("word", "doc"):
        a = getattr(tw.corpus, name)
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jw.corpus, name)))
    if jw.token_index is None:
        assert tw.token_index is None
    else:
        np.testing.assert_array_equal(tw.token_index, jw.token_index)


def _reference_topics(seed):
    """A stand-in for ``online.window_topics`` that draws the reference's
    fresh topics: ``randint(fold_in(key(seed), window.index), (T,), 0, K)``."""
    def draw(key, window, num_topics, device):
        z = jax.random.randint(
            jax.random.fold_in(jax.random.key(seed), window.index),
            (window.corpus.num_tokens,), 0, num_topics, dtype=jnp.int32)
        return torch.from_numpy(np.array(z)).to(device)
    return draw


# ---------------------------------------------------------------------------
# corpus sources: bit-equal windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_docs,epochs", [(12, 1), (15, 2), (40, 1)])
def test_replay_source_windows_equal_the_reference(window_docs, epochs):
    jc, _, tc, _ = _tiny()
    jsrc = jstream.ReplaySource(jc, window_docs, epochs=epochs)
    tsrc = ReplaySource(tc, window_docs, epochs=epochs)
    jw, tw = list(jsrc.windows()), list(tsrc.windows())
    assert len(tw) == len(jw) == tsrc.num_windows == jsrc.num_windows
    for a, b in zip(jw, tw):
        _same_window(a, b)
    # windows cover the corpus once per epoch, doc ids window-local
    seen = np.zeros(tc.num_tokens, np.int32)
    for w in tw[: tsrc.windows_per_epoch]:
        assert int(w.corpus.doc.min()) == 0
        assert int(w.corpus.doc.max()) < w.corpus.num_docs
        seen[w.token_index] += 1
        np.testing.assert_array_equal(w.corpus.word.numpy(),
                                      tc.word.numpy()[w.token_index])
    np.testing.assert_array_equal(seen, 1)
    # the resume contract: start=k yields the identical tail
    k = len(tw) - 1
    for a, b in zip(jsrc.windows(start=k), tsrc.windows(start=k)):
        _same_window(a, b)
    assert [w.uid for w in tw] == \
        [f"w{i % tsrc.windows_per_epoch}" for i in range(len(tw))]


def test_drift_source_windows_equal_the_reference():
    kw = dict(seed=7, window_docs=6, num_windows=5, num_words=30)
    jw = list(jstream.DriftSource(**kw).windows())
    tsrc = DriftSource(**kw)
    tw = list(tsrc.windows())
    assert len(tw) == len(jw) == 5
    for a, b in zip(jw, tw):
        _same_window(a, b)
    for a, b in zip(jw[3:], tsrc.windows(start=3)):  # the phi chain replays
        _same_window(a, b)
    assert not np.array_equal(tw[0].corpus.word.numpy(),
                              tw[1].corpus.word.numpy())  # it drifts
    assert list(tsrc.windows(start=5)) == []


def test_libsvm_stream_source_windows_and_resume_equal_the_reference(
        tmp_path):
    c = j_synthetic_corpus(5, num_docs=17, num_words=25, avg_doc_len=6)
    path = str(tmp_path / "c.libsvm")
    j_save_libsvm(c, path)
    jsrc = jstream.LibsvmStreamSource(path, window_docs=5, num_words=25)
    tsrc = LibsvmStreamSource(path, window_docs=5, num_words=25)
    jw, tw = list(jsrc.windows()), list(tsrc.windows())
    assert [w.corpus.num_docs for w in tw] == [5, 5, 5, 2]
    for a, b in zip(jw, tw):
        _same_window(a, b)
    for kw in (dict(start=2), dict(start=2, start_docs=7),
               dict(start=1, start_docs=3)):
        got = list(tsrc.windows(**kw))
        want = list(jsrc.windows(**kw))
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            _same_window(a, b)
    with pytest.raises(ValueError, match="num_words"):
        LibsvmStreamSource("x", window_docs=5, num_words=0)


def test_libsvm_resume_after_an_eof_truncated_window(tmp_path):
    """7 documents in windows of 5 leave a 2-document window; 4 more
    arrive. ``start_docs=7`` reads exactly the new 4 (as the reference's
    source does); the window arithmetic (10) would skip 3 of them."""
    c1 = synthetic_corpus(3, num_docs=7, num_words=25, avg_doc_len=6)
    c2 = synthetic_corpus(4, num_docs=4, num_words=25, avg_doc_len=6)
    path = str(tmp_path / "s.libsvm")
    save_libsvm(c1, path)
    tail = str(tmp_path / "tail.libsvm")
    save_libsvm(c2, tail)
    with open(tail) as f_in, open(path, "a") as f_out:
        f_out.write(f_in.read())
    tsrc = LibsvmStreamSource(path, window_docs=5, num_words=25)
    jsrc = jstream.LibsvmStreamSource(path, window_docs=5, num_words=25)
    wins = list(tsrc.windows(start=2, start_docs=7))
    assert [w.index for w in wins] == [2] and wins[0].corpus.num_docs == 4
    _same_window(list(jsrc.windows(start=2, start_docs=7))[0], wins[0])
    np.testing.assert_array_equal(
        np.bincount(wins[0].corpus.word.numpy(), minlength=25),
        np.bincount(c2.word.numpy(), minlength=25))
    assert sum(w.corpus.num_docs for w in tsrc.windows(start=2)) == 1


def test_make_source_specs_and_errors_match_the_reference():
    jc, _, tc, _ = _tiny()
    for spec, kw in (("replay", dict(epochs=2)),
                     ("drift:11", dict(num_words=50, num_windows=3)),
                     ("drift", dict(num_words=50, seed=4)),
                     ("libsvm:/tmp/x.libsvm", dict(num_words=50))):
        t = make_source(spec, 8, corpus=tc, **kw)
        j = jstream.make_source(spec, 8, corpus=jc, **kw)
        assert type(t).__name__ == type(j).__name__
        for attr in ("window_docs", "num_words", "epochs", "seed", "path",
                     "num_windows"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
    for spec, kw in (("kafka:topic", {}), ("replay", {}), ("libsvm", {}),
                     ("libsvm:/x", {}), ("drift", {})):
        with pytest.raises(ValueError) as te:
            make_source(spec, 8, **kw)
        with pytest.raises(ValueError) as je:
            jstream.make_source(spec, 8, **kw)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# windowed online training against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [0.5, 0.25, 0.75, 0.02, 0.1])
def test_decay_equals_the_reference_bit_for_bit(decay):
    """Counts chosen so that n * (1 - decay) meets .5 ties (odd counts at
    0.5, 2 mod 4 at 0.25 and 0.75) beside large random ones; both round
    half to even."""
    rng = np.random.default_rng(int(decay * 100))
    w, k = 64, 6
    n_wk = rng.integers(0, 2_000_000, (w, k)).astype(np.int32)
    n_wk[:8] = (2 * np.arange(48).reshape(8, 6) + 1)  # x.5 at decay 0.5
    n_wk[8:16] = 4 * np.arange(48).reshape(8, 6) + 2  # x.5 at 0.25 / 0.75
    src_kw = dict(seed=1, window_docs=4, num_windows=1, num_words=w)
    jsess = jonline.StreamingSession(
        jstream.DriftSource(**src_kw), JHyper(num_topics=k),
        _j_cfg(_stream_cfg(decay=decay)))
    tsess = StreamingSession(DriftSource(**src_kw),
                             LDAHyperParams(num_topics=k),
                             _stream_cfg(decay=decay), device=CPU)
    jsess.n_wk = jnp.asarray(n_wk)
    tsess.n_wk = torch.from_numpy(n_wk.copy())
    jsess._apply_decay()
    tsess._apply_decay()
    want = np.asarray(jsess.n_wk)
    assert tsess.n_wk.dtype == torch.int32 and tsess.n_k.dtype == torch.int32
    np.testing.assert_array_equal(tsess.n_wk.numpy(), want)
    np.testing.assert_array_equal(tsess.n_k.numpy(), np.asarray(jsess.n_k))
    ties = n_wk * (1.0 - decay) % 1.0 == 0.5
    if decay in (0.5, 0.25, 0.75):
        assert ties.sum() >= 40  # the .5 cases were met
    assert (want[ties] % 2 == 0).all()  # and went to even


def _first_step_states(monkeypatch, plan_cls):
    """Record a copy of the state each ``plan_cls.step`` call receives
    first in a window (iteration 0)."""
    seen = []
    real = plan_cls.step

    def spy(self, state):
        if int(state.iteration) == 0:
            seen.append({name: np.array(getattr(state, name))
                         if not isinstance(getattr(state, name),
                                           torch.Tensor)
                         else getattr(state, name).numpy().copy()
                         for name in ("topic", "n_wk", "n_kd", "n_k")})
        return real(self, state)

    monkeypatch.setattr(plan_cls, "step", spy)
    return seen


@pytest.mark.parametrize("regime", ["fresh", "resident", "revisit"])
def test_composed_window_counts_equal_the_reference(monkeypatch, regime):
    """Given the reference's z0, the state a window's first sweep receives
    (topics, its n_kd, the resident n_wk/n_k plus the window's own on a
    first visit) is bit-equal to the reference's: from an empty model
    (fresh), onto counts already resident (resident), and on a revisit
    that reuses retained topics and adds nothing (revisit)."""
    jc, jh, tc, th = _tiny()
    monkeypatch.setattr(online, "window_topics", _reference_topics(3))
    jseen = _first_step_states(monkeypatch, JPlan)
    tseen = _first_step_states(monkeypatch, SingleBoxPlan)
    cfg = _stream_cfg(algorithm="zen")
    jsess = jonline.StreamingSession(jstream.ReplaySource(jc, 10, 2), jh,
                                     _j_cfg(cfg))
    tsess = StreamingSession(ReplaySource(tc, 10, 2), th, cfg, device=CPU)
    jsess._base_key = jax.random.key(3)
    tsess._base_key = torch.tensor([0, 3])
    jwins = list(jsess.source.windows())
    twins = list(tsess.source.windows())
    index = {"fresh": 0, "resident": 1, "revisit": 4}[regime]
    if regime != "fresh":
        rng = np.random.default_rng(index)
        n_wk = rng.integers(0, 50, (60, 6)).astype(np.int32)
        jsess.n_wk, tsess.n_wk = jnp.asarray(n_wk), torch.from_numpy(n_wk)
        n_k = n_wk.sum(0).astype(np.int32)
        jsess.n_k, tsess.n_k = jnp.asarray(n_k), torch.from_numpy(n_k)
    if regime == "revisit":
        z = np.random.default_rng(9).integers(
            0, 6, twins[index].corpus.num_tokens).astype(np.int32)
        jsess._retained["w0"], tsess._retained["w0"] = z, z.copy()
    jsess.run_window(jwins[index])
    tsess.run_window(twins[index])
    assert len(jseen) == len(tseen) == 1
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(tseen[0][name], jseen[0][name], name)
    if regime == "revisit":
        np.testing.assert_array_equal(tseen[0]["n_wk"], n_wk)
    # the reference's keys of the metrics dict, nothing else
    jm = jsess.run_window(jwins[index + 1])
    tm = tsess.run_window(twins[index + 1])
    assert sorted(tm) == sorted(jm)
    assert (tm["window"], tm["uid"], tm["docs"], tm["tokens"],
            tm["resident_kd_bytes"]) == (jm["window"], jm["uid"], jm["docs"],
                                         jm["tokens"],
                                         jm["resident_kd_bytes"])


def test_stream_checkpoint_written_by_the_reference_resumes_in_the_port(
        tmp_path):
    jc, jh, tc, th = _tiny()
    ckpt = str(tmp_path / "stream")
    cfg = _stream_cfg(train_checkpoint_dir=ckpt, train_checkpoint_every=1)
    jsess = jonline.StreamingSession(jstream.ReplaySource(jc, 10, 2), jh,
                                     _j_cfg(dataclasses.replace(
                                         cfg, num_iterations=5)))
    jsess.run(jax.random.key(1))
    assert jsess.windows_done == 5
    tsess = StreamingSession(ReplaySource(tc, 10, 2), th, cfg, device=CPU)
    assert tsess._maybe_restore()
    assert (tsess.windows_done, tsess.docs_consumed) == \
        (jsess.windows_done, jsess.docs_consumed) == (5, 50)
    np.testing.assert_array_equal(tsess.n_wk.numpy(), np.asarray(jsess.n_wk))
    np.testing.assert_array_equal(tsess.n_k.numpy(), np.asarray(jsess.n_k))
    assert sorted(tsess._retained) == sorted(jsess._retained)
    for uid, z in jsess._retained.items():
        np.testing.assert_array_equal(tsess._retained[uid], z)
    # the port runs the stream to its end from there
    tsess.run(1)
    assert tsess.windows_done == 8
    st = tsess.assembled_state()
    st.check_invariants(tc)
    np.testing.assert_array_equal(st.n_wk.numpy(), tsess.n_wk.numpy())


def test_stream_checkpoint_written_by_the_port_resumes_in_the_reference(
        tmp_path):
    jc, jh, tc, th = _tiny()
    ckpt = str(tmp_path / "stream")
    cfg = _stream_cfg(train_checkpoint_dir=ckpt, train_checkpoint_every=1)
    tsess = StreamingSession(ReplaySource(tc, 10, 2), th,
                             dataclasses.replace(cfg, num_iterations=6),
                             device=CPU)
    tsess.run(2)
    jsess = jonline.StreamingSession(jstream.ReplaySource(jc, 10, 2), jh,
                                     _j_cfg(cfg))
    assert jsess._maybe_restore()
    assert (jsess.windows_done, jsess.docs_consumed) == \
        (tsess.windows_done, tsess.docs_consumed) == (6, 60)
    np.testing.assert_array_equal(np.asarray(jsess.n_wk), tsess.n_wk.numpy())
    np.testing.assert_array_equal(np.asarray(jsess.n_k), tsess.n_k.numpy())
    assert sorted(jsess._retained) == sorted(tsess._retained) == \
        ["w0", "w1", "w2", "w3"]
    for uid, z in tsess._retained.items():
        np.testing.assert_array_equal(jsess._retained[uid], z)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rotation_full_perplexity_tracks_the_reference(monkeypatch, seed):
    """decay=0 replay over the tiny corpus, 20 epochs of 4 windows, both
    packages from the reference's initial topics: the port's whole-corpus
    perplexity lies within ``PPL_BAND`` of the reference's (and both fall
    well below the initial level)."""
    jc, jh, tc, th = _tiny()
    monkeypatch.setattr(online, "window_topics", _reference_topics(seed))
    cfg = _stream_cfg(algorithm="zen")
    jsess = jonline.StreamingSession(jstream.ReplaySource(jc, 10, 20), jh,
                                     _j_cfg(cfg))
    tsess = StreamingSession(ReplaySource(tc, 10, 20), th, cfg, device=CPU)
    jsess.run(jax.random.key(seed))
    tsess.run(seed)
    ref, port = jsess.full_perplexity(), tsess.full_perplexity()
    gap = abs(port / ref - 1)
    print(f"rotation seed={seed}: full perplexity port {port:.3f} "
          f"reference {ref:.3f} gap {gap:.4%}")
    assert gap < PPL_BAND, (port, ref)
    z0 = np.asarray(jax.random.randint(jax.random.fold_in(
        jax.random.key(seed), 0), (10,), 0, 6))
    assert z0.shape == (10,)  # the stand-in draws what the reference does


# ---------------------------------------------------------------------------
# the reference's streaming behaviours, on the port
# ---------------------------------------------------------------------------

def test_windowed_replay_matches_batch_trend():
    _, _, tc, th = _tiny()
    iters = 10
    batch = TrainSession(tc, th, RunConfig(algorithm="zen",
                                           num_iterations=iters),
                         device=CPU)
    state = batch.init(0)
    ppl0 = batch.perplexity(state)
    ppl_batch = batch.perplexity(batch.run(state=state))
    assert ppl_batch < ppl0
    src = ReplaySource(tc, window_docs=10, epochs=iters)
    sess = StreamingSession(src, th, _stream_cfg(algorithm="zen"),
                            device=CPU)
    metrics = []
    sess.run(0, callback=lambda s, m: metrics.append(m))
    assert sess.windows_done == src.num_windows
    ppl_stream = sess.full_perplexity()
    assert ppl_stream < 0.6 * ppl0
    assert abs(ppl_stream - ppl_batch) / ppl_batch < 0.15
    first = np.mean([m["perplexity"] for m in metrics[:4]])
    last = np.mean([m["perplexity"] for m in metrics[-4:]])
    assert last < first


@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas", "zen_cdf"])
def test_stream_counts_stay_consistent(algorithm):
    _, _, tc, th = _tiny()
    src = ReplaySource(tc, window_docs=10, epochs=2)
    sess = StreamingSession(src, th, _stream_cfg(algorithm=algorithm),
                            device=CPU)
    tokens_seen = 0
    for w in src.windows():
        sess.run_window(w)
        if w.index < src.windows_per_epoch:
            tokens_seen += w.corpus.num_tokens
        nwk = sess.n_wk.numpy()
        np.testing.assert_array_equal(sess.n_k.numpy(), nwk.sum(0))
        assert nwk.sum() == tokens_seen and (nwk >= 0).all()
        assert np.isfinite(sess.timings["sweeps"])
    st = sess.assembled_state()
    np.testing.assert_array_equal(st.n_wk.numpy(), sess.n_wk.numpy())
    np.testing.assert_array_equal(st.n_k.numpy(), sess.n_k.numpy())


def test_decay_mode_forgets():
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)
    src = DriftSource(seed=1, window_docs=8, num_windows=4, num_words=40,
                      num_topics=6)
    sess = StreamingSession(src, th, _stream_cfg(window_docs=8, decay=0.5,
                                                 window_sweeps=2),
                            device=CPU)
    sess.run(2)
    assert not sess._retain and not sess._retained and not sess._plans
    nwk = sess.n_wk.numpy()
    np.testing.assert_array_equal(sess.n_k.numpy(), nwk.sum(0))
    assert nwk.sum() < 2.5 * src.window_docs * src.avg_doc_len


def test_streaming_session_validation(tmp_path):
    _, _, tc, th = _tiny()
    src = ReplaySource(tc, window_docs=10)
    with pytest.raises(ValueError, match="single-box"):
        StreamingSession(src, th, _stream_cfg(mesh_shape=(1, 2)), device=CPU)
    with pytest.raises(ValueError, match="decay"):
        StreamingSession(src, th, _stream_cfg(decay=1.0), device=CPU)
    with pytest.raises(ValueError, match="window_sweeps"):
        StreamingSession(src, th, _stream_cfg(window_sweeps=0), device=CPU)
    # item 5's fields are accepted and ignored, as the reference's
    # StreamingSession does: no telemetry file appears
    ignored = StreamingSession(src, th, _stream_cfg(
        metrics_out=str(tmp_path / "m.jsonl"), autopilot=True,
        quality_every=1), device=CPU)
    ignored.run(1)
    assert not (tmp_path / "m.jsonl").exists()
    sess = StreamingSession(src, th, _stream_cfg(decay=0.1), device=CPU)
    with pytest.raises(ValueError, match="rotation regime"):
        sess.assembled_state()


def _drift_run(cfg, th):
    src = DriftSource(seed=9, window_docs=8, num_windows=6, num_words=40,
                      num_topics=6)
    sess = StreamingSession(src, th, cfg, device=CPU)
    sess.run(5)
    return sess


def test_checkpoint_resume_matches_uninterrupted_drift(tmp_path):
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)
    full = _drift_run(_stream_cfg(window_docs=8, decay=0.1), th)
    assert full.windows_done == 6
    cfg = _stream_cfg(window_docs=8, decay=0.1,
                      train_checkpoint_dir=str(tmp_path),
                      train_checkpoint_every=1)
    killed = _drift_run(dataclasses.replace(cfg, num_iterations=3), th)
    assert killed.windows_done == 3
    resumed = _drift_run(cfg, th)
    assert resumed.windows_done == 6
    assert torch.equal(resumed.n_wk, full.n_wk)
    assert torch.equal(resumed.n_k, full.n_k)


def test_checkpoint_resume_restores_retained_assignments(tmp_path):
    _, _, tc, th = _tiny()

    def run(cfg, limit=None):
        src = ReplaySource(tc, window_docs=10, epochs=2)
        c = cfg if limit is None else dataclasses.replace(
            cfg, num_iterations=limit)
        sess = StreamingSession(src, th, c, device=CPU)
        sess.run(3)
        return sess

    full = run(_stream_cfg())
    assert full.windows_done == 8
    cfg = _stream_cfg(train_checkpoint_dir=str(tmp_path),
                      train_checkpoint_every=1)
    killed = run(cfg, limit=5)
    assert killed.windows_done == 5
    resumed = run(cfg)
    assert resumed.windows_done == 8 and resumed.docs_consumed == 80
    assert torch.equal(resumed.n_wk, full.n_wk)
    assert sorted(resumed._retained) == sorted(full._retained)
    for uid in full._retained:
        np.testing.assert_array_equal(resumed._retained[uid],
                                      full._retained[uid])
    assert resumed.full_perplexity() == full.full_perplexity()


def test_libsvm_eof_truncated_window_kill_and_resume(tmp_path):
    c1 = synthetic_corpus(3, num_docs=7, num_words=25, avg_doc_len=6)
    c2 = synthetic_corpus(4, num_docs=4, num_words=25, avg_doc_len=6)
    th = LDAHyperParams(num_topics=6)
    path = str(tmp_path / "stream.libsvm")
    save_libsvm(c1, path)
    cfg = _stream_cfg(window_docs=5,
                      train_checkpoint_dir=str(tmp_path / "ckpt"),
                      train_checkpoint_every=1)
    killed = StreamingSession(LibsvmStreamSource(path, 5, 25), th, cfg,
                              device=CPU)
    killed.run(2)
    assert killed.windows_done == 2 and killed.docs_consumed == 7
    tail = str(tmp_path / "append.libsvm")
    save_libsvm(c2, tail)
    with open(tail) as f_in, open(path, "a") as f_out:
        f_out.write(f_in.read())
    resumed = StreamingSession(LibsvmStreamSource(path, 5, 25), th, cfg,
                               device=CPU)
    resumed.run(2)
    assert resumed.windows_done == 3 and resumed.docs_consumed == 11
    assert int(resumed.n_wk.sum()) == c1.num_tokens + c2.num_tokens
    np.testing.assert_array_equal(resumed.n_k.numpy(),
                                  resumed.n_wk.numpy().sum(0))


@pytest.mark.parametrize("algorithm", ["zen_pallas", "zen_cdf"])
def test_zero_token_window_passes_through(tmp_path, algorithm):
    """A libsvm window can hold documents but no tokens (lines with a
    label only): it sweeps, merges and evaluates to nothing."""
    path = str(tmp_path / "empty.libsvm")
    c = synthetic_corpus(2, num_docs=3, num_words=20, avg_doc_len=5)
    save_libsvm(c, path)
    with open(path, "a") as f:
        f.write("0\n0\n0\n")
    th = LDAHyperParams(num_topics=5)
    sess = StreamingSession(LibsvmStreamSource(path, 3, 20), th,
                            _stream_cfg(window_docs=3, algorithm=algorithm,
                                        max_kd=4 if algorithm == "zen_cdf"
                                        else 0),
                            device=CPU)
    metrics = []
    sess.run(0, callback=lambda s, m: metrics.append(m))
    assert [m["tokens"] for m in metrics] == [c.num_tokens, 0]
    assert metrics[1]["docs"] == 3 and metrics[1]["llh"] == 0.0
    assert int(sess.n_wk.sum()) == c.num_tokens


# ---------------------------------------------------------------------------
# hot model reload in serving
# ---------------------------------------------------------------------------

def _two_models(seed=0, num_words=50, k=5):
    corpus, _ = synthetic_lda_corpus(seed, 30, num_words, k, 25)
    hyper = LDAHyperParams(num_topics=k)
    z = torch.from_numpy(np.random.default_rng(seed).integers(
        0, k, corpus.num_tokens).astype(np.int32))
    n_wk, _n_kd, n_k = build_counts(corpus.word, corpus.doc, z,
                                    corpus.num_words, corpus.num_docs, k)
    m0 = FrozenLDAModel(n_wk=n_wk, n_k=n_k, hyper=hyper)
    m1 = FrozenLDAModel(n_wk=n_wk * 3, n_k=n_k * 3, hyper=hyper)
    return m0, m1, corpus


def _j_model(m):
    """The reference's frozen model on the same counts as the port's."""
    return JModel(n_wk=jnp.asarray(m.n_wk.numpy()),
                  n_k=jnp.asarray(m.n_k.numpy()),
                  hyper=JHyper(**dataclasses.asdict(m.hyper)))


def _j_engine(m, cfg, **kw):
    """The reference's engine on the port model ``m`` under ``cfg``."""
    return JEngine(_j_model(m), JServeConfig(**dataclasses.asdict(cfg)),
                   **kw)


def _record_theta_rows(monkeypatch):
    """Record, per request uid, the doc-topic row the port's engine
    smooths into theta: a throughput chain draws from the port's counter
    keys, so its theta is held to the reference's smoothing of that row
    with the reference's alpha_k of the admitted model."""
    rows, real = {}, LDAEngine._theta

    def theta(self, req, n_kd_row, alpha_k):
        rows[req.uid] = np.array(n_kd_row)
        return real(self, req, n_kd_row, alpha_k)

    monkeypatch.setattr(LDAEngine, "_theta", theta)
    return rows


def _reference_theta(req, row, alpha_k):
    return JEngine._theta(None, req, row, alpha_k)


def test_reload_version_tags_and_monotonicity():
    m0, m1, _ = _two_models()
    cfg = LDAServeConfig(buckets=(32,), max_batch=4, num_sweeps=2)
    seen = []
    for eng, w0, w1 in ((LDAEngine(m0, cfg), m0, m1),
                        (_j_engine(m0, cfg), _j_model(m0), _j_model(m1))):
        tags = [(eng.model_version, eng.reloads), eng.reload(w1),
                (eng.model_version, eng.reloads)]
        assert eng.model is w1
        with pytest.raises(ValueError, match="must increase"):
            eng.reload(w0, version=1)
        tags += [eng.reload(w0, version=7), eng.reloads]
        t = eng.submit_async(np.zeros(0, np.int32))  # instant: stamped now
        tags.append(eng.request(t).model_version)
        seen.append(tags)
    # the port's tags, and the reference's for the same calls
    assert seen[0] == seen[1] == [(0, 0), 1, (1, 1), 7, 2, 7]


@pytest.mark.parametrize("mode", ["throughput", "latency"])
def test_inflight_finishes_on_admitted_model(mode, monkeypatch):
    """A request in flight across ``reload`` completes bit-identically to
    an engine that never reloaded: it decodes under the counts, tables and
    alpha_k of the model it was admitted for. The reference's engine runs
    the same calls: it stamps the same versions, and its latency thetas
    are the port's bit for bit. Throughput chains draw from other keys
    than the reference's, so there the port's theta is held to the
    reference's smoothing of the port's final row with the reference's
    alpha_k of the admitted model."""
    rows = _record_theta_rows(monkeypatch)
    m0, m1, corpus = _two_models()
    doc = docs_from_corpus(corpus)[0]
    cfg = LDAServeConfig(buckets=(64,), max_batch=2, num_sweeps=6, mode=mode)
    ref = LDAEngine(m0, cfg, seed=3)
    theta_ref = ref.result(ref.submit_async(doc))
    new = LDAEngine(m1, cfg, seed=3)
    theta_new = new.result(new.submit_async(doc))
    # the models' alpha_k differ, so a theta smoothed with the wrong one
    # would not be bit-equal
    assert not np.array_equal(ref._alpha_k, new._alpha_k)

    runs = []
    for eng, w1 in ((LDAEngine(m0, cfg, seed=3), m1),
                    (_j_engine(m0, cfg, seed=3), _j_model(m1))):
        alpha = [np.array(eng._alpha_k)]
        t0 = eng.submit_async(doc)
        if mode == "throughput":
            eng.step()  # admit + first sweep: now in flight
            assert eng.poll(t0) == "admitted"
        else:
            eng._admit()  # latency mode finishes within a tick: admit only
        eng.reload(w1)
        alpha.append(np.array(eng._alpha_k))
        t1 = eng.submit_async(doc)  # queued behind the pinned old bucket
        r0, r1 = eng.request(t0), eng.request(t1)
        runs.append(((r0, eng.result(t0)), (r1, eng.result(t1)), alpha))
    ((r0, theta0), (r1, theta1), alpha), ((j0, jt0), (j1, jt1), jalpha) = runs
    assert (r0.model_version, r1.model_version) == (0, 1)
    assert (j0.model_version, j1.model_version) == (0, 1)
    for a, b in zip(alpha, jalpha):  # each version's alpha_k, both packages
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(theta0, theta_ref)
    if mode == "latency":  # deterministic: equal to the new model's own
        np.testing.assert_array_equal(theta1, theta_new)
        np.testing.assert_array_equal(theta0, jt0)
        np.testing.assert_array_equal(theta1, jt1)
    else:
        for r, th, v in ((r0, theta0, 0), (r1, theta1, 1)):
            np.testing.assert_array_equal(
                th, _reference_theta(r, rows[r.uid], jalpha[v]))
            assert not np.array_equal(
                th, _reference_theta(r, rows[r.uid], jalpha[1 - v]))
    assert not np.array_equal(theta1, theta0)


def test_reload_to_another_topic_count_reshapes_drained_buckets():
    """A reload may change K and W: the bucket in flight finishes on the
    old model's K; once drained it pins the new model and its doc-topic
    state takes the new K. The reference's engine, given the same calls,
    stamps the same versions and shapes, and in latency mode gives the
    same thetas bit for bit."""
    m0, _, corpus = _two_models(k=5)
    m1, _, _ = _two_models(seed=1, num_words=60, k=7)
    doc = docs_from_corpus(corpus)[0]
    seen = {}
    for mode in ("throughput", "latency"):
        cfg = LDAServeConfig(buckets=(64,), max_batch=2, num_sweeps=3,
                             mode=mode)
        for name, eng, w1 in (
                ("port", LDAEngine(m0, cfg, seed=2), m1),
                ("ref", _j_engine(m0, cfg, seed=2), _j_model(m1))):
            t0 = eng.submit_async(doc)
            if mode == "throughput":
                eng.step()
            else:
                eng._admit()
            eng.reload(w1)
            t1 = eng.submit_async(doc)
            r0, r1 = eng.request(t0), eng.request(t1)
            theta0, theta1 = eng.result(t0), eng.result(t1)
            assert theta0.shape == (5,) and theta1.shape == (7,)
            assert np.isclose(theta0.sum(), 1, atol=1e-5)
            assert np.isclose(theta1.sum(), 1, atol=1e-5)
            bucket = eng._buckets[64]
            seen[mode, name] = (
                r0.model_version, r1.model_version,
                tuple(bucket.n_kd.shape), bucket.slot_model.version,
                theta0, theta1)
        port, ref = seen[mode, "port"], seen[mode, "ref"]
        assert port[:4] == ref[:4] == (0, 1, (2, 7), 1)
        if mode == "latency":
            np.testing.assert_array_equal(port[4], ref[4])
            np.testing.assert_array_equal(port[5], ref[5])


@pytest.mark.parametrize("mode", ["throughput", "latency"])
def test_reload_atomic_under_background_ticker(mode, monkeypatch):
    """Every ticket completes across a reload under the ticker, versions
    never decrease, and each theta is the reference's for the version the
    request was stamped with: in latency mode the reference engine's
    theta on that model bit for bit; in throughput mode the reference's
    smoothing of the port's final row with that model's alpha_k."""
    rows = _record_theta_rows(monkeypatch)
    m0, m1, corpus = _two_models(seed=2)
    docs = docs_from_corpus(corpus)
    cfg = LDAServeConfig(buckets=(64,), max_batch=4, num_sweeps=4,
                         mode=mode, rtlda_sweeps=2)
    eng = LDAEngine(m0, cfg, seed=1)
    eng.start(0.001)
    try:
        tickets = []
        for i, d in enumerate(docs):
            tickets.append(eng.submit_async(d))
            if i == len(docs) // 2:
                eng.reload(m1)
            time.sleep(0.0005)
        reqs = [eng.request(t) for t in tickets]
        thetas = [eng.result(t, timeout=60) for t in tickets]
    finally:
        eng.stop()
    assert len(thetas) == len(docs)
    assert all(th is not None and np.isfinite(th).all() for th in thetas)
    versions = [r.model_version for r in reqs]
    assert all(v in (0, 1) for v in versions)
    assert versions == sorted(versions)
    assert versions[0] == 0 and versions[-1] == 1
    assert eng.reloads == 1

    refs = [_j_engine(m, cfg, seed=1) for m in (m0, m1)]
    if mode == "latency":
        want = [refs[v].infer_batch([d])[0] for v, d in zip(versions, docs)]
    else:
        want = [_reference_theta(r, rows[r.uid], refs[v]._alpha_k)
                for v, r in zip(versions, reqs)]
    for th, w in zip(thetas, want):
        np.testing.assert_array_equal(th, w)


def test_watch_checkpoint_dir_hot_reloads(tmp_path):
    m0, m1, _ = _two_models(seed=4)
    td = str(tmp_path)
    save_lda_model(td, m0.n_wk.numpy(), m0.n_k.numpy(), m0.hyper, step=1)
    cfg = LDAServeConfig(buckets=(32,), max_batch=2)
    eng = LDAEngine(m0, cfg)
    jeng = _j_engine(m0, cfg)  # the reference follows the same directory
    for e in (eng, jeng):
        e.watch_checkpoint_dir(td, period=0.02, initial_step=1)
    try:
        time.sleep(0.08)
        assert eng.model_version == jeng.model_version == 0  # step 1 served
        # a checkpoint of the reference's writer is followed too
        j_save_lda_model(td, m1.n_wk.numpy(), m1.n_k.numpy(), m1.hyper,
                         step=2)
        deadline = time.monotonic() + 10.0
        while (eng.model_version == 0 or jeng.model_version == 0) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        assert eng.stop_watching() is None
        assert jeng.stop_watching() is None
    assert eng.model_version == jeng.model_version == 1
    assert eng.reloads == jeng.reloads == 1
    assert torch.equal(eng.model.n_wk, m1.n_wk)
    np.testing.assert_array_equal(np.asarray(jeng.model.n_wk),
                                  eng.model.n_wk.numpy())
    assert eng.model.device == eng.device
    assert eng.stop_watching() is None  # idempotent


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _truncate_leaf(directory, step):
    leaf = os.path.join(directory, f"step_{step:08d}", "leaf_00000.npy")
    with open(leaf, "r+b") as f:
        f.truncate(8)


def _commit_truncated(directory, model, step):
    """Commit a checkpoint whose leaf does not load, in one rename, so a
    running watcher never sees it whole."""
    staging = directory + ".staging"
    save_lda_model(staging, model.n_wk.numpy(), model.n_k.numpy(),
                   model.hyper, step=step)
    _truncate_leaf(staging, step)
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    os.replace(os.path.join(staging, name), os.path.join(directory, name))


def test_watcher_surfaces_truncated_checkpoint_error(tmp_path):
    m0, _m1, _ = _two_models(seed=6)
    td = str(tmp_path)
    save_lda_model(td, m0.n_wk.numpy(), m0.n_k.numpy(), m0.hyper, step=2)
    _truncate_leaf(td, 2)
    cfg = LDAServeConfig(buckets=(32,), max_batch=2)
    engines = (LDAEngine(m0, cfg), _j_engine(m0, cfg))
    for e in engines:
        e.watch_checkpoint_dir(td, period=0.01, max_failures=3)
    assert _wait(lambda: not any(e._watcher.is_alive() for e in engines))
    errs = []
    for e in engines:
        assert e._watcher.failures == 3
        assert e.model_version == 0 and e.reloads == 0
        err = e.watch_error
        assert isinstance(err, Exception)
        assert e.stop_watching() is err
        errs.append(err)
    # the reference gives up on the same checkpoint with the same error
    assert type(errs[0]) is type(errs[1])


def test_watcher_waits_on_an_empty_directory(tmp_path):
    m0, m1, _ = _two_models(seed=7)
    td = str(tmp_path / "later")
    cfg = LDAServeConfig(buckets=(32,), max_batch=2)
    engines = (LDAEngine(m0, cfg), _j_engine(m0, cfg))
    for e in engines:
        e.watch_checkpoint_dir(td, period=0.01, max_failures=2)
    time.sleep(0.1)
    for e in engines:
        assert e._watcher.is_alive() and e.watch_error is None
        assert e._watcher.failures == 0
    save_lda_model(td, m1.n_wk.numpy(), m1.n_k.numpy(), m1.hyper, step=3)
    assert _wait(lambda: all(e.model_version == 1 for e in engines))
    for e in engines:
        assert e.stop_watching() is None and e.model_version == 1


def test_watcher_failure_policy_equals_the_reference(tmp_path):
    """The port's ``CheckpointWatcher`` and the reference's, side by side
    on one directory: nothing committed is waited on without spending the
    retry budget; a committed step that does not load is retried with its
    error held; a good step is reloaded once and clears the error and the
    budget; a bad step above a good one falls back to the good one; and
    ``max_failures`` bad attempts in a row stop both with the same
    error."""
    from repro.serving import CheckpointWatcher as JWatcher
    from repro_torch.serving.lda_engine import CheckpointWatcher

    m0, m1, _ = _two_models(seed=8)
    td = str(tmp_path / "ckpt")
    loaded = ([], [])
    ws = [CheckpointWatcher(lambda m: loaded[0].append(m.n_wk.numpy()), td,
                            period=0.01, max_failures=400, device=CPU),
          JWatcher(lambda m: loaded[1].append(np.asarray(m.n_wk)), td,
                   period=0.01, max_failures=400)]
    try:
        for w in ws:
            w.start()
        time.sleep(0.1)  # nothing committed: benign
        assert all(w.is_alive() and w.error is None and w.failures == 0
                   for w in ws)
        _commit_truncated(td, m0, 3)  # committed, and it does not load
        assert _wait(lambda: all(w.failures >= 2 for w in ws))
        assert all(w.is_alive() and w.last_step is None for w in ws)
        assert type(ws[0].error) is type(ws[1].error)
        assert str(ws[0].error) == str(ws[1].error)
        save_lda_model(td, m1.n_wk.numpy(), m1.n_k.numpy(), m1.hyper, step=4)
        assert _wait(lambda: all(len(v) == 1 for v in loaded))
        assert _wait(lambda: all(w.error is None and w.failures == 0
                                 for w in ws))
        _commit_truncated(td, m0, 5)  # falls back to step 4: served
        time.sleep(0.1)
        assert all(w.error is None and w.failures == 0 and w.last_step == 4
                   for w in ws)
        assert [len(v) for v in loaded] == [1, 1]
    finally:
        errs = [w.stop() for w in ws]
    assert errs == [None, None]
    np.testing.assert_array_equal(loaded[0][0], loaded[1][0])
    np.testing.assert_array_equal(loaded[0][0], m1.n_wk.numpy())

    # nothing loadable, a small budget: both stop on the same error
    _truncate_leaf(td, 4)
    gave_up = [CheckpointWatcher(lambda m: None, td, period=0.01,
                                 max_failures=3, device=CPU).start(),
               JWatcher(lambda m: None, td, period=0.01,
                        max_failures=3).start()]
    assert _wait(lambda: not any(w.is_alive() for w in gave_up))
    assert [w.failures for w in gave_up] == [3, 3]
    errs = [w.stop() for w in gave_up]
    assert type(errs[0]) is type(errs[1]) and str(errs[0]) == str(errs[1])


def test_live_pipeline_stream_to_follow(tmp_path):
    th = LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)
    src = DriftSource(seed=12, window_docs=10, num_windows=3, num_words=40,
                      num_topics=6)
    td = str(tmp_path)
    cfg = _stream_cfg(window_docs=10, decay=0.05, checkpoint_dir=td,
                      checkpoint_every=1, algorithm="zen_pallas")
    sess = StreamingSession(src, th, cfg, device=CPU)
    sess.run_window(next(src.windows()))
    sess.save_model()
    eng = LDAEngine(FrozenLDAModel.from_checkpoint(td, device=CPU),
                    LDAServeConfig(buckets=(32, 64), max_batch=4,
                                   num_sweeps=3, algorithm="zen_pallas"))
    eng.start(0.001)
    eng.watch_checkpoint_dir(td, period=0.02, initial_step=1)
    stop = threading.Event()
    tickets, t_lock = [], threading.Lock()
    rng = np.random.default_rng(0)

    def client():
        while not stop.is_set():
            doc = rng.integers(0, 40, size=12).astype(np.int32)
            with t_lock:
                tickets.append(eng.submit_async(doc))
            time.sleep(0.002)

    t = threading.Thread(target=client)
    t.start()
    try:
        for w in src.windows(start=1):
            sess.run_window(w)
            sess.save_model()
        deadline = time.monotonic() + 20.0
        while eng.model_version < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        stop.set()
        t.join(timeout=30)
        with t_lock:
            reqs = [eng.request(tk) for tk in tickets]
            thetas = [eng.result(tk, timeout=60) for tk in tickets]
        eng.stop_watching()
        eng.stop()
    assert not t.is_alive()
    assert sess.windows_done == 3
    assert eng.model_version == 2
    assert len(thetas) == len(tickets) > 0
    assert all(np.isfinite(th).all() for th in thetas)
    versions = [r.model_version for r in reqs]
    assert versions == sorted(versions) and versions[-1] >= 1


# ---------------------------------------------------------------------------
# the CLIs, and no silent CPU fallback
# ---------------------------------------------------------------------------

def test_train_stream_and_serve_follow_run_on_cpu(tmp_path, capsys,
                                                  monkeypatch):
    from repro_torch.launch import serve_lda, train

    live, ckpt = str(tmp_path / "live"), str(tmp_path / "ckpt")
    argv = ["--stream", "--stream-source", "replay", "--window-docs", "8",
            "--epochs", "2", "--iters", "0", "--topics", "6",
            "--synthetic-docs", "20", "--synthetic-words", "40",
            "--synthetic-len", "12", "--algorithm", "zen_pallas",
            "--checkpoint-dir", live, "--checkpoint-every", "2",
            "--ckpt", ckpt, "--device", "cpu"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "stream  source=replay  window_docs=8  sweeps/window=2" in out
    assert "window    0 (w0)  docs     8  ppl " in out
    assert "window    5 (w2)  docs     4  ppl " in out
    assert "stream finished at window 6" in out
    # a rerun resumes from the stream checkpoint: nothing left to run
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "window " not in out.replace("finished at window", "")
    assert "stream finished at window 6" in out

    # the server follows the directory: once its watcher has polled step
    # 6, the trainer commits a newer model (step 99)
    from repro_torch.train import checkpoint as tckpt

    n_wk, n_k, hyper, _meta, step = load_lda_model(live)
    assert step == 6
    # serve_lda serves through the router (as the reference's does), whose
    # one watcher follows the directory for the fleet
    real_watch, real_load = LDARouter.watch_checkpoint_dir, \
        tckpt.load_lda_model
    polls = []

    def counted_load(*a, **kw):
        try:
            return real_load(*a, **kw)
        finally:
            if threading.current_thread().name == "lda-ckpt-watcher":
                polls.append(1)

    def watch_then_commit(self, *a, **kw):
        real_watch(self, *a, **kw)
        assert _wait(lambda: bool(polls))
        save_lda_model(live, n_wk, n_k, hyper, step=99)

    monkeypatch.setattr(tckpt, "load_lda_model", counted_load)

    monkeypatch.setattr(LDARouter, "watch_checkpoint_dir", watch_then_commit)
    assert serve_lda.main(
        ["--checkpoint-dir", live, "--device", "cpu", "--follow",
         "--watch-period", "0.05", "--rounds", "20",
         "--synthetic-docs", "4", "--synthetic-len", "10",
         "--buckets", "16,32", "--show", "1"]) == 0
    out = capsys.readouterr().out
    assert "model: W=40 K=6" in out and "step=6" in out
    assert "round 19  served 4 docs" in out
    assert "model versions [0]" in out.splitlines()[2]
    assert "model versions [1]" in out  # the step-99 model was followed


def test_stream_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from repro_torch.core.types import CGSState
    from repro_torch.launch import serve_lda, train
    from repro_torch.serving.lda_engine import CheckpointWatcher
    from repro_torch.train.checkpoint import restore_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tc, th = _tiny()
    src = ReplaySource(tc, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSession(src, th, _stream_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CGSState.from_numpy({"topic": np.zeros(3, np.int32),
                             "rng": np.zeros(2, np.uint32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointWatcher(lambda m: None, str(tmp_path))
    path = save_lda_model(str(tmp_path), np.eye(3, dtype=np.int32),
                          np.ones(3, np.int32), LDAHyperParams(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(path, {"n_k": 0, "n_wk": 0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--stream", "--iters", "1", "--synthetic-words", "9"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lda.main(["--checkpoint-dir", str(tmp_path), "--follow"])
    tree, meta = restore_checkpoint(path, {"n_k": 0, "n_wk": 0},
                                    device="cpu")
    assert meta["kind"] == "lda_model" and tree["n_wk"].dtype == torch.int32
    assert torch.equal(tree["n_wk"], torch.eye(3, dtype=torch.int32))
