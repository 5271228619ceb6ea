"""The port's deprecated single-box shims (``repro_torch.core.trainer``:
``TrainConfig`` / ``LDATrainer``) against the reference's, on the CPU.

* ``TrainConfig`` has the reference's fields and defaults, and
  ``to_run_config`` gives the reference's ``RunConfig`` field for field
  (compared through the JSON both packages read).
* ``LDATrainer.train`` is bit-equal to ``TrainSession.run`` from the same
  key (the mirror of ``tests/test_session.py``'s shim check), with the
  exclusion event too; resuming from a state ticks on the absolute
  iteration grid; a target perplexity costs one likelihood pass per tick
  (a spy on the session's ``predictive_llh``).
* Whole runs are statistical (counter-based draws, not threefry): from the
  reference's initial topics, the port's 3-chain mean perplexity after 30
  iterations is within 10% of the reference ``LDATrainer``'s, the band of
  ``test_torch_training.py::test_whole_runs_match_reference_perplexity``;
  ``llh_split`` equals the reference's ``joint_llh`` parts (rtol 1e-5,
  the band of the likelihood tests there: float64 against float32 sums).
* The default device is the card: without one the shim raises.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import LDATrainer as JTrainer
from repro.core import TrainConfig as JTrainConfig
from repro.core.exclusion import ExclusionConfig as JExcl
from repro.core.types import LDAHyperParams as JHyper
from repro.data import synthetic_lda_corpus as j_lda_corpus
from repro_torch.core import LDATrainer, LDAHyperParams, TrainConfig
from repro_torch.core.exclusion import ExclusionConfig
from repro_torch.data import synthetic_lda_corpus
from repro_torch.train import session as session_mod
from repro_torch.train.session import RunConfig, TrainSession


@pytest.fixture(scope="module")
def small():
    corpus, _ = synthetic_lda_corpus(0, 40, 60, 6, 30)
    return corpus, LDAHyperParams(num_topics=6, alpha=0.1, beta=0.05)


def _equal(a, b):
    for f in ("topic", "n_wk", "n_kd", "n_k", "stale_iters", "same_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.iteration) == int(b.iteration)


def test_train_config_fields_and_defaults_equal_the_reference():
    ref = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    port = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert list(port) == list(ref)
    for name, value in ref.items():
        if name == "exclusion":
            assert tuple(port[name]) == tuple(value)
        else:
            assert port[name] == value, name
    assert dataclasses.asdict(TrainConfig().knobs()) == \
        dataclasses.asdict(JTrainConfig().knobs())


@pytest.mark.parametrize("enabled,start", [(False, 30), (True, 0),
                                           (True, 3)])
def test_to_run_config_equals_the_reference(enabled, start):
    kw = dict(algorithm="zen_sparse", max_kd=16, bt=128, token_chunk=64,
              checkpoint_dir="/x", checkpoint_every=4)
    ref = JTrainConfig(exclusion=JExcl(enabled, start, 0.25), **kw)
    port = TrainConfig(exclusion=ExclusionConfig(enabled, start, 0.25),
                       **kw)
    run_kw = dict(num_iterations=7, eval_every=2, target_perplexity=12.5)
    jrc = ref.to_run_config(**run_kw)
    rc = port.to_run_config(**run_kw)
    assert json.loads(rc.to_json()) == json.loads(jrc.to_json())
    assert rc.exclusion_start == (max(start, 1) if enabled else 0)
    assert RunConfig.from_json(jrc.to_json()) == rc


@pytest.mark.parametrize("alg,excl_start", [
    ("zen", 0), ("zen_sparse", 0), ("zen_sparse", 3)])
def test_trainer_train_bit_equal_to_session_run(small, alg, excl_start):
    corpus, hyper = small
    iters = 6
    session = TrainSession(corpus, hyper, RunConfig(
        algorithm=alg, num_iterations=iters, exclusion_start=excl_start),
        device="cpu")
    want = session.run(11)
    tr = LDATrainer(corpus, hyper, TrainConfig(
        algorithm=alg, exclusion=ExclusionConfig(
            enabled=excl_start > 0, start_iteration=excl_start)),
        device="cpu")
    _equal(tr.train(11, iters), want)
    # from an explicit initial state: the same run
    _equal(tr.train(11, iters, state=tr.init_state(11)), want)
    # and step by step through the shim's own surface
    st = tr.init_state(11)
    if excl_start == 0:
        for _ in range(iters):
            st = tr.step(st)
        _equal(st, want)
        assert tr.change_rate(st) == session.plan.change_rate(want)
        assert tr.llh(st) == session.llh(want)
        assert tr.perplexity(st) == session.perplexity(want)


def test_target_perplexity_single_eval_per_tick(small, monkeypatch):
    corpus, hyper = small
    calls = {"n": 0}
    real = session_mod.predictive_llh

    def spy(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(session_mod, "predictive_llh", spy)
    tr = LDATrainer(corpus, hyper, TrainConfig(algorithm="zen"),
                    device="cpu")
    # no target: one likelihood pass per eval tick
    final = tr.train(0, 6, llh_every=2)
    assert int(final.iteration) == 6 and calls["n"] == 3
    # a target met at once stops at the first tick, after one pass
    calls["n"] = 0
    final = tr.train(0, 50, llh_every=1, target_perplexity=1e9)
    assert int(final.iteration) == 1 and calls["n"] == 1
    # an unreachable target: every tick checks
    calls["n"] = 0
    final = tr.train(0, 4, llh_every=1, target_perplexity=1e-9)
    assert int(final.iteration) == 4 and calls["n"] == 4


def test_resumed_train_ticks_on_the_absolute_grid(small):
    corpus, hyper = small
    tr = LDATrainer(corpus, hyper, TrainConfig(algorithm="zen"),
                    device="cpu")
    ticks = []

    def cb(state, metrics):
        if "llh" in metrics:
            ticks.append(int(state.iteration))

    st = tr.train(3, 3, llh_every=2, callback=cb)
    assert ticks == [2]
    st = tr.train(3, 4, state=st, llh_every=2, callback=cb)
    assert int(st.iteration) == 7
    assert ticks == [2, 4, 6]
    # the resumed run is the straight one
    _equal(st, tr.train(3, 7))


def test_whole_runs_match_reference_trainer_perplexity():
    jc, _ = j_lda_corpus(0, 200, 300, 10, 50)
    tc, _ = synthetic_lda_corpus(0, 200, 300, 10, 50)
    np.testing.assert_array_equal(tc.word.numpy(), np.asarray(jc.word))
    jt = JTrainer(jc, JHyper(num_topics=10, alpha=0.1, beta=0.01),
                  JTrainConfig(algorithm="zen"))
    tr = LDATrainer(tc, LDAHyperParams(num_topics=10, alpha=0.1, beta=0.01),
                    TrainConfig(algorithm="zen"), device="cpu")
    ref, port = [], []
    for c in range(3):
        jst = jt.init_state(jax.random.key(c))
        ref.append(jt.perplexity(jt.train(jax.random.key(c), 30,
                                          state=jst)))
        st = tr.init_state(100 + c, init_topics=np.asarray(jst.topic))
        port.append(tr.perplexity(tr.train(100 + c, 30, state=st)))
        if c == 0:
            # the joint likelihood's two parts, on the reference's state
            jparts = jt.llh_split(jst)
            parts = tr.llh_split(st)
            for name in ("total", "word", "doc"):
                np.testing.assert_allclose(
                    float(getattr(parts, name)),
                    float(getattr(jparts, name)), rtol=1e-5)
    assert abs(np.mean(port) / np.mean(ref) - 1) < 0.10, (port, ref)


def test_default_device_raises_without_a_card(small, monkeypatch):
    corpus, hyper = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LDATrainer(corpus, hyper, TrainConfig())


def test_sweep_and_save_model_delegate_to_the_session(small, tmp_path):
    from repro_torch.train.checkpoint import load_lda_model

    corpus, hyper = small
    tr = LDATrainer(corpus, hyper, TrainConfig(algorithm="zen_pallas"),
                    device="cpu")
    st = tr.init_state(5)
    z = tr.sweep(st)
    assert z.shape == st.topic.shape and int(z.max()) < hyper.num_topics
    st = tr.step(st)
    path = tr.save_model(st, str(tmp_path))
    n_wk, n_k, h, meta, step = load_lda_model(str(tmp_path))
    assert step == 1 and meta["algorithm"] == "zen_pallas" and path
    np.testing.assert_array_equal(n_wk, st.n_wk.numpy())
    assert tr.backend.name == "zen_pallas"
