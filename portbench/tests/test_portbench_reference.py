"""The plain reference against the port's ``kernels="off"`` path at a tiny
size on the CPU: the frozen hash, the counts, and each sampler's draws,
sweep after sweep."""
import pytest
import torch

from portbench.reference import compare, lda
from portbench.reference import hash as rhash
from portbench.tests import tiny
from portbench.traffic.lda_corpus import lda_corpus

SEEDS = (0, 12345, 2**31 + 77, 2**40 + 9)


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_hash_is_the_ports(seed):
    from repro_torch.core import keys
    from repro_torch.kernels import zen_sampler

    key = keys.as_key(seed)
    assert torch.equal(rhash.key_from_seed(seed), key)
    init_key, state_key = keys.split(key)
    assert torch.equal(rhash.run_keys(seed)[1], state_key)
    for it in (0, 1, 57):
        assert rhash.sweep_seed(seed, it) == keys.key_seed(
            keys.fold_in(state_key, it))
    tokens = torch.arange(5000)
    assert torch.equal(rhash.initial_topics(seed, tokens, 1000),
                       keys.uniform_ints(init_key, 5000, 1000))
    s = rhash.sweep_seed(seed, 3)
    assert torch.equal(rhash.stream_uniforms(s, tokens, 3),
                       keys.stream_uniforms(s, 0, 5000, 3))
    cols = torch.arange(64)[None, :]
    assert torch.equal(rhash.hash_uniform(s, tokens[:, None], cols),
                       zen_sampler.hash_uniform(s, tokens[:, None], cols))


def test_counts_are_build_counts():
    from repro_torch.core.counts import build_counts

    word, doc, z = lda_corpus(4, 50, 80, 7, 25.0, 0.1, 0.05, "cpu")
    ours = lda.counts(word, doc, z, 80, 50, 7)
    theirs = build_counts(word, doc, z, 80, 50, 7)
    assert all(torch.equal(a, b.long()) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("seed", SEEDS[1:3])
def test_every_sweep_matches_the_port(cell, seed):
    """Each sweep of the port (``kernels="off"``, the plain versions)
    equals the reference's draw for every token, from the same topics."""
    from repro_torch.core.types import Corpus, LDAHyperParams
    from repro_torch.train.session import RunConfig, TrainSession

    _, cfg, tr = tiny.spec(cell)
    word, doc, _ = lda_corpus(seed, cfg["num_docs"], cfg["num_words"],
                              cfg["num_topics"], cfg["mean_doc_len"],
                              tr["doc_prior"], tr["word_prior"], "cpu")
    hyper = LDAHyperParams(num_topics=cfg["num_topics"], alpha=cfg["alpha"],
                           beta=cfg["beta"], alpha_prime=cfg["alpha_prime"],
                           asymmetric_alpha=cfg["asymmetric_alpha"])
    run = RunConfig(algorithm=cfg["algorithm"], max_kd=cfg["max_kd"],
                    kernels="off", init="random")
    sess = TrainSession(Corpus(word, doc, cfg["num_words"],
                               cfg["num_docs"]), hyper, run, device="cpu")
    st = sess.init(seed)
    prior = lda.Prior(cfg["num_topics"], cfg["alpha"], cfg["beta"],
                      cfg["alpha_prime"], cfg["asymmetric_alpha"])
    corpus = (word, doc, cfg["num_words"], cfg["num_docs"])
    every = torch.arange(word.shape[0])
    assert compare.init_mismatch(seed, every, st.topic, 16) == 0
    for it in range(4):
        before = st.topic
        st = sess.step(st)
        assert compare.draw_mismatch(cfg["sampler"], every, st.topic,
                                     corpus, before, prior, seed, it,
                                     cfg["max_kd"]) == 0.0
        assert compare.count_mismatch(corpus, st.topic, st.n_wk, st.n_kd,
                                      st.n_k, 16) == 0


def test_control_in_lower_precision_differs():
    """bfloat16 in the program's place draws other topics."""
    _, cfg, tr = tiny.spec("nytimes-dense-sweeps", num_topics=64,
                           mean_doc_len=80)
    seed = 9
    word, doc, _ = lda_corpus(seed, cfg["num_docs"], cfg["num_words"], 64,
                              80, tr["doc_prior"], tr["word_prior"], "cpu")
    prior = lda.Prior(64, cfg["alpha"], cfg["beta"], cfg["alpha_prime"],
                      cfg["asymmetric_alpha"])
    z0 = rhash.initial_topics(seed, torch.arange(word.shape[0]), 64)
    corpus = (word, doc, cfg["num_words"], cfg["num_docs"])
    every = torch.arange(word.shape[0])
    for sampler in ("gumbel", "cdf"):
        low = compare.control_mismatch(sampler, every, corpus, z0, prior,
                                       seed, 0, 16, torch.bfloat16)
        same = compare.control_mismatch(sampler, every, corpus, z0, prior,
                                        seed, 0, 16, torch.float64)
        assert same == 0.0 and low > 0.001, (sampler, low)
