"""The port's serving slice against the JAX package, on the CPU.

* Checkpoints cross in both directions, and the port writes the
  reference's files byte for byte.
* Integer work is bit-equal: corpora, ``build_counts``, RT-LDA
  assignments, so latency-mode z and theta equal the reference engine's
  exactly on the same checkpoint.
* ``ZenPallas.infer_sweep`` fed the same per-slot key words draws the
  reference's topics (kernels on and off): the per-token seeds are integer
  work, and the only float difference is ``log``'s last bits, so every
  mismatch must be a near-tie.
* Throughput-mode chains use the port's counter-based keys, not threefry:
  thetas are compared statistically (same dominant topic; mean L1 distance
  below 0.15, the reference's own posterior-mean tolerance).
* The port's own contract: draws independent of bucket width and batch
  mates, and the dense sweep in lockstep with ``cgs_infer``.
"""
import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import algorithms as jalg
from repro.core.counts import build_counts as j_build_counts
from repro.core.counts import doc_lengths as j_doc_lengths
from repro.core.types import LDAHyperParams as JHyper
from repro.data import corpus as jcorpus
from repro.serving import FrozenLDAModel as JModel
from repro.serving import LDAEngine as JEngine
from repro.serving import LDAServeConfig as JConfig
from repro.serving import doc_completion_perplexity as j_ppl
from repro.train import checkpoint as jckpt
from repro_torch import algorithms as talg
from repro_torch.core.counts import build_counts, doc_lengths
from repro_torch.core.inference import cgs_infer
from repro_torch.core.keys import as_key
from repro_torch.core.types import LDAHyperParams
from repro_torch.data import corpus as tcorpus
from repro_torch.launch import serve_lda
from repro_torch.serving import (
    FrozenLDAModel,
    LDAEngine,
    LDAServeConfig,
    doc_completion_perplexity,
)
from repro_torch.train import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEAR_TIE = 1e-4


def _sharp(k=4, w=40, weight=100, noise_seed=None):
    """Topics with disjoint vocabulary blocks (as the reference tests'),
    optionally with background counts."""
    n_wk = np.zeros((w, k), np.int32)
    block = w // k
    for t in range(k):
        n_wk[t * block:(t + 1) * block, t] = weight
    if noise_seed is not None:
        n_wk += np.random.default_rng(noise_seed).integers(
            0, 4, (w, k)).astype(np.int32)
    return n_wk, n_wk.sum(0).astype(np.int32)


def _both(n_wk, n_k, hyper):
    """One model handed to both packages as numpy arrays."""
    jm = JModel(n_wk=jnp.asarray(n_wk), n_k=jnp.asarray(n_k), hyper=hyper)
    tm = FrozenLDAModel.from_numpy(n_wk, n_k, dataclasses.asdict(hyper),
                                   device="cpu")
    return jm, tm


def _docs(seed, n, w=40, lo=1, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, w, size=rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


# -- checkpoints --------------------------------------------------------------

def test_jax_checkpoint_served_by_port(tmp_path):
    n_wk, n_k = _sharp(noise_seed=0)
    hyper = JHyper(num_topics=4, alpha=0.1, beta=0.02, alpha_prime=2.0)
    jckpt.save_lda_model(str(tmp_path), jnp.asarray(n_wk), jnp.asarray(n_k),
                         hyper, step=3)
    model = FrozenLDAModel.from_checkpoint(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(model.n_wk.numpy(), n_wk)
    np.testing.assert_array_equal(model.n_k.numpy(), n_k)
    assert dataclasses.asdict(model.hyper) == dataclasses.asdict(hyper)
    assert tckpt.load_lda_model(str(tmp_path))[4] == 3


def test_port_checkpoint_loads_in_reference_byte_for_byte(tmp_path):
    n_wk, n_k = _sharp(noise_seed=1)
    hyper = LDAHyperParams(num_topics=4, alpha=0.05, beta=0.01)
    tdir, jdir = tmp_path / "port", tmp_path / "ref"
    tckpt.save_lda_model(str(tdir), torch.from_numpy(n_wk),
                         torch.from_numpy(n_k), hyper, step=7)
    jckpt.save_lda_model(str(jdir), jnp.asarray(n_wk), jnp.asarray(n_k),
                         JHyper(**dataclasses.asdict(hyper)), step=7)
    got_wk, got_k, got_h, meta, step = jckpt.load_lda_model(str(tdir))
    np.testing.assert_array_equal(np.asarray(got_wk), n_wk)
    np.testing.assert_array_equal(np.asarray(got_k), n_k)
    assert step == 7 and meta["kind"] == "lda_model"
    assert dataclasses.asdict(got_h) == dataclasses.asdict(hyper)
    names = sorted(os.listdir(jdir / "step_00000007"))
    assert sorted(os.listdir(tdir / "step_00000007")) == names
    match, mismatch, errors = filecmp.cmpfiles(
        tdir / "step_00000007", jdir / "step_00000007", names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_checkpoint_keeps_newest_and_skips_torn(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"a": np.full(3, step), "b": [np.zeros(2)]})
    assert [s for s, _ in tckpt.committed_steps(str(tmp_path))] == [2, 3]
    # corrupt the newest leaf: restore falls back to step 2
    leaf = tmp_path / "step_00000003" / "leaf_00000.npy"
    np.save(leaf, np.full(3, 99))
    leaves, _meta, step = mgr.restore_latest()
    assert step == 2 and leaves["a"].tolist() == [2, 2, 2]
    assert "b/0" in leaves
    with pytest.raises(FileNotFoundError):
        tckpt.load_lda_model(str(tmp_path))  # not an LDA model


# -- integer work: corpora and counts ----------------------------------------

def test_corpora_and_counts_bit_equal(tmp_path):
    jc = jcorpus.synthetic_corpus(5, num_docs=30, num_words=50,
                                  avg_doc_len=20)
    tc = tcorpus.synthetic_corpus(5, num_docs=30, num_words=50,
                                  avg_doc_len=20)
    np.testing.assert_array_equal(tc.word.numpy(), np.asarray(jc.word))
    np.testing.assert_array_equal(tc.doc.numpy(), np.asarray(jc.doc))
    jl, jphi = jcorpus.synthetic_lda_corpus(6, 20, 40, 5, 15)
    tl, tphi = tcorpus.synthetic_lda_corpus(6, 20, 40, 5, 15)
    np.testing.assert_array_equal(tl.word.numpy(), np.asarray(jl.word))
    np.testing.assert_array_equal(tphi, jphi)
    path = str(tmp_path / "c.libsvm")
    tcorpus.save_libsvm(tl, path)
    back = tcorpus.load_libsvm(path)
    jback = jcorpus.load_libsvm(path)
    np.testing.assert_array_equal(back.word.numpy(), np.asarray(jback.word))
    assert (back.num_docs, back.num_words) == (jback.num_docs,
                                               jback.num_words)

    rng = np.random.default_rng(7)
    topic = rng.integers(0, 6, tl.num_tokens).astype(np.int32)
    mask = rng.random(tl.num_tokens) < 0.8
    for m in (None, mask):
        j = j_build_counts(jl.word, jl.doc, jnp.asarray(topic), 40, 20, 6,
                           mask=None if m is None else jnp.asarray(m))
        t = build_counts(tl.word, tl.doc, torch.from_numpy(topic), 40, 20, 6,
                         mask=None if m is None else torch.from_numpy(m))
        for a, b in zip(t, j):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            doc_lengths(tl.doc, 20, None if m is None
                        else torch.from_numpy(m)).numpy(),
            np.asarray(j_doc_lengths(jl.doc, 20, None if m is None
                                     else jnp.asarray(m))))


# -- the zen_pallas serving sweep --------------------------------------------

@pytest.mark.parametrize("kernels", ["on", "off"])
def test_zen_pallas_infer_sweep_matches_reference(kernels, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", kernels)
    b, l, k, w = 4, 16, 200, 30
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, w, (b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.9
    z = rng.integers(0, k, (b, l)).astype(np.int32)
    n_kd = rng.integers(0, 6, (b, k)).astype(np.int32)
    n_wk = rng.integers(0, 40, (w, k)).astype(np.int32)
    n_k = n_wk.sum(0).astype(np.int32)
    hyper = LDAHyperParams(num_topics=k, alpha=0.1, beta=0.05)
    j = np.asarray(jalg.get("zen_pallas").infer_sweep(
        jax.random.wrap_key_data(jnp.asarray(bits)), jnp.asarray(words),
        jnp.asarray(mask), jnp.asarray(z), jnp.asarray(n_kd),
        jnp.asarray(n_wk), jnp.asarray(n_k),
        JHyper(**dataclasses.asdict(hyper)), jalg.SamplerKnobs(bk=128),
    ))
    t = talg.get("zen_pallas").infer_sweep(
        torch.from_numpy(bits.astype(np.int64)), torch.from_numpy(words),
        torch.from_numpy(mask), torch.from_numpy(z), torch.from_numpy(n_kd),
        torch.from_numpy(n_wk), torch.from_numpy(n_k), hyper,
        talg.SamplerKnobs(bk=128),
    ).numpy()
    bad = np.argwhere(t != j)
    if len(bad):  # each mismatch must be a near-tie of the port's scores
        from repro_torch.core.keys import token_seeds
        from repro_torch.kernels.zen_sampler import gumbel_noise

        seeds = token_seeds(torch.from_numpy(bits.astype(np.int64)), l)
        alpha = hyper.alpha_k(torch.from_numpy(n_k))
        for bi, li in bad:
            cand = torch.tensor([t[bi, li], j[bi, li]])
            nd = torch.from_numpy(n_kd[bi])[cand].float() \
                - (cand == int(z[bi, li])).float()
            p = (nd + alpha[cand]) * (
                torch.from_numpy(n_wk[words[bi, li]])[cand].float() + 0.05
            ) / (torch.from_numpy(n_k)[cand].float() + w * 0.05)
            s = torch.log(torch.clamp_min(p, 1e-30)) \
                + gumbel_noise(seeds[bi, li], 0, cand)
            assert abs(float(s[0] - s[1])) <= NEAR_TIE
    assert len(bad) <= b * l // 1000, bad


# -- engine parity with the reference ----------------------------------------

def test_latency_engine_equals_reference_on_one_checkpoint(tmp_path):
    n_wk, n_k = _sharp(k=6, w=60, noise_seed=2)
    jckpt.save_lda_model(str(tmp_path), jnp.asarray(n_wk), jnp.asarray(n_k),
                         JHyper(num_topics=6, alpha=0.1, beta=0.01))
    n_wk_j, n_k_j, hyper_j, _, _ = jckpt.load_lda_model(str(tmp_path))
    jm = JModel(n_wk=jnp.asarray(n_wk_j), n_k=jnp.asarray(n_k_j),
                hyper=hyper_j)
    tm = FrozenLDAModel.from_checkpoint(str(tmp_path), device="cpu")
    docs = _docs(9, 20, w=60, hi=30)
    cfg = dict(buckets=(8, 16, 32), max_batch=4, mode="latency",
               rtlda_sweeps=3)
    je, te = JEngine(jm, JConfig(**cfg)), LDAEngine(tm, LDAServeConfig(**cfg))
    ju, tu = [je.submit(d) for d in docs], [te.submit(d) for d in docs]
    jd = {r.uid: r for r in je.run_until_done()}
    td = {r.uid: r for r in te.run_until_done()}
    for a, b in zip(ju, tu):
        np.testing.assert_array_equal(td[b].z, jd[a].z)
        np.testing.assert_array_equal(td[b].theta, jd[a].theta)
    assert doc_completion_perplexity(
        LDAEngine(tm, LDAServeConfig(**cfg)), docs) == j_ppl(
        JEngine(jm, JConfig(**cfg)), docs)


@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas"])
def test_throughput_thetas_statistically_close(algorithm):
    """Different random streams, same conditional: on a sharp model both
    packages decode the same dominant topic for every document, and the
    mean L1 distance between their thetas stays below 0.15."""
    n_wk, n_k = _sharp()
    hyper = JHyper(num_topics=4, alpha=0.1, beta=0.01)
    jm, tm = _both(n_wk, n_k, hyper)
    rng = np.random.default_rng(6)
    docs = [rng.integers(t * 10, (t + 1) * 10, size=15).astype(np.int32)
            for t in (0, 1, 2, 3, 0, 1, 2, 3)]
    cfg = dict(buckets=(16, 32), max_batch=8, num_sweeps=15,
               algorithm=algorithm)
    jt = JEngine(jm, JConfig(**cfg), seed=3).infer_batch(docs)
    tt = LDAEngine(tm, LDAServeConfig(**cfg), seed=3).infer_batch(docs)
    assert [int(np.argmax(x)) for x in tt] == [0, 1, 2, 3] * 2
    assert [int(np.argmax(x)) for x in jt] == [0, 1, 2, 3] * 2
    assert np.abs(tt - jt).sum(1).mean() < 0.15


# -- the port's own serving contract -----------------------------------------

@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas"])
def test_draws_independent_of_bucket_width_and_batch_mates(algorithm):
    n_wk, n_k = _sharp(noise_seed=3)
    _, tm = _both(n_wk, n_k, JHyper(num_topics=4, alpha=0.1, beta=0.01))
    doc = _docs(10, 1, lo=10, hi=11)[0]

    def serve(buckets, seed, mates=()):
        eng = LDAEngine(tm, LDAServeConfig(buckets=buckets, max_batch=8,
                                           num_sweeps=10,
                                           algorithm=algorithm), seed=seed)
        uid = eng.submit(doc, key=[11, 12])
        for m in mates:
            eng.submit(m)
        return {r.uid: r for r in eng.run_until_done()}[uid].theta

    alone = serve((16,), 0)
    for theta in (serve((32,), 2), serve((64, 128), 3),
                  serve((16,), 4, _docs(11, 5, hi=14))):
        np.testing.assert_array_equal(alone, theta)


def test_dense_sweep_in_lockstep_with_cgs_infer():
    """Default backend, cdf sampling: every served theta is bit-equal to
    the single-document oracle under the request's key, whatever the
    bucket, batch mates or queueing."""
    n_wk, n_k = _sharp(k=5, w=50, noise_seed=4)
    _, tm = _both(n_wk, n_k, JHyper(num_topics=5, alpha=0.1, beta=0.01))
    docs = _docs(12, 14, w=50, hi=30)
    eng = LDAEngine(tm, LDAServeConfig(buckets=(8, 16, 32), max_batch=3,
                                       num_sweeps=6))
    uids = [eng.submit(d, key=100 + i) for i, d in enumerate(docs)]
    done = {r.uid: r for r in eng.run_until_done()}
    for i, u in enumerate(uids):
        oracle = cgs_infer(as_key(100 + i), tm.n_wk, tm.n_k,
                           torch.from_numpy(docs[i]), tm.hyper, 6).numpy()
        np.testing.assert_array_equal(done[u].theta, oracle)


def test_engine_edge_cases_and_ticket_lifecycle():
    n_wk, n_k = _sharp()
    _, tm = _both(n_wk, n_k, JHyper(num_topics=4, alpha=0.1, beta=0.01))
    eng = LDAEngine(tm, LDAServeConfig(buckets=(8,), max_batch=2,
                                       num_sweeps=3))
    empty = eng.submit_async([-1, 99])  # only unknown ids: prior theta
    longdoc = eng.submit_async(np.arange(20) % 40)  # truncated to 8
    zero = eng.submit_async([1, 2, 3], num_sweeps=0)
    queued = [eng.submit_async([5, 6]) for _ in range(3)]
    assert eng.poll(empty) == "done" and eng.poll(zero) == "done"
    assert eng.poll(queued[-1]) == "queued"
    assert eng.request(longdoc).truncated
    assert eng.request(empty).dropped_unknown == 2
    prior = eng.result(empty)
    np.testing.assert_allclose(prior, eng._alpha_k / eng._alpha_k.sum())
    assert eng.cancel(queued[0]) and not eng.cancel(queued[0])
    thetas = [eng.result(t, timeout=60) for t in (longdoc, zero, *queued[1:])]
    for th in thetas:
        assert th.shape == (4,) and abs(float(th.sum()) - 1) < 1e-5
    with pytest.raises(KeyError):
        eng.poll(longdoc)
    eng.start(0.001)
    tickets = [eng.submit_async([1, 2, 3, 4]) for _ in range(5)]
    assert all(eng.result(t, timeout=60).shape == (4,) for t in tickets)
    eng.stop()
    assert not eng.queue and eng.docs_done == 10  # the cancelled one never ran


def test_max_slot_wait_spills_to_wider_bucket():
    n_wk, n_k = _sharp()
    _, tm = _both(n_wk, n_k, JHyper(num_topics=4, alpha=0.1, beta=0.01))
    eng = LDAEngine(tm, LDAServeConfig(buckets=(8, 32), max_batch=1,
                                       num_sweeps=4, max_slot_wait=1))
    for _ in range(3):
        eng.submit([1, 2, 3])
    assert len(eng.run_until_done()) == 3 and eng.spills >= 1


def test_burn_in_posterior_mean_sums_to_one():
    n_wk, n_k = _sharp()
    _, tm = _both(n_wk, n_k, JHyper(num_topics=4, alpha=0.1, beta=0.01))
    eng = LDAEngine(tm, LDAServeConfig(buckets=(16,), num_sweeps=8,
                                       burn_in=2, thin=2))
    theta = eng.infer_batch([np.arange(10, 20)])[0]
    assert abs(float(theta.sum()) - 1) < 1e-5 and int(np.argmax(theta)) == 1


# -- configs, devices, deferred features -------------------------------------

def test_serve_config_json_loads_in_both_packages():
    cfg = JConfig(buckets=(16, 64), algorithm="zen_pallas", kernels="off",
                  mode="latency", max_slot_wait=2)
    port = LDAServeConfig.from_json(cfg.to_json())
    assert json.loads(port.to_json()) == json.loads(cfg.to_json())
    assert JConfig.from_json(port.to_json()) == cfg
    with pytest.raises(ValueError, match="unknown LDAServeConfig fields"):
        LDAServeConfig.from_json('{"nope": 1}')


@pytest.mark.parametrize("field,value", [
    ("mesh_shape", (1, 2)), ("metrics_out", "m.jsonl"), ("autopilot", True),
    ("autopilot_window", 8)])
def test_unported_features_are_refused(field, value, tmp_path):
    """Every field that once waited is ported. Sharded serving
    (``mesh_shape``, item 7) serves the reference's theta shape and the
    unsharded engine's thetas bit for bit; telemetry and the autopilot
    (item 5): the engine takes their fields, as the reference's does,
    builds the same hooks and serves."""
    n_wk, n_k = _sharp()
    jm, tm = _both(n_wk, n_k, JHyper(num_topics=4))
    if field == "mesh_shape":
        eng = LDAEngine(tm, LDAServeConfig(**{field: value}))
        ref = JEngine(jm, JConfig())
        doc = np.arange(10, 20)
        theta = eng.infer_batch([doc], key=3)[0]
        assert theta.shape == ref.infer_batch([doc])[0].shape
        assert eng.model.num_shards == 2
        np.testing.assert_array_equal(
            theta, LDAEngine(tm, LDAServeConfig()).infer_batch(
                [doc], key=3)[0])
        assert abs(float(theta.sum()) - 1) < 1e-5 \
            and int(np.argmax(theta)) == 1
        return
    if field == "metrics_out":
        value = str(tmp_path / value)
    cfg = LDAServeConfig(**{field: value})
    eng = LDAEngine(tm, cfg)
    ref = JEngine(jm, JConfig.from_json(cfg.to_json()))
    for attr in ("_telemetry", "_autopilot"):
        assert (getattr(eng, attr) is None) == (getattr(ref, attr) is None)
    theta = eng.infer_batch([np.arange(10, 20)])[0]
    assert abs(float(theta.sum()) - 1) < 1e-5 and int(np.argmax(theta)) == 1
    assert (eng.tick_period, eng.max_slot_wait, eng.bucket_widths) == (
        ref.tick_period, ref.max_slot_wait, ref.bucket_widths)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n_wk, n_k = _sharp()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrozenLDAModel.from_numpy(n_wk, n_k, {"num_topics": 4})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lda.main(["--checkpoint-dir", "x", "--follow"])


def test_training_half_names_the_training_slice():
    """The training slice is ported: both backends train (a sweep returns
    one topic in [0, K) per token), under the reference's names; the
    registry lists every ported backend in the reference's order."""
    from repro_torch.core.init import random_init
    from repro_torch.core.types import Corpus

    corpus = Corpus(word=torch.tensor([0, 1, 2, 1], dtype=torch.int32),
                    doc=torch.tensor([0, 0, 1, 1], dtype=torch.int32),
                    num_words=3, num_docs=2)
    hyper = LDAHyperParams(num_topics=4)
    state = random_init(as_key(0), corpus, hyper)
    for name in ("zen", "zen_pallas"):
        z = talg.get(name).sweep(state, corpus, hyper, talg.SamplerKnobs())
        assert z.shape == (4,) and bool(((z >= 0) & (z < 4)).all())
    # every backend of the reference is ported, in its registry order
    assert talg.registered() == ("zen", "std", "zen_sparse", "zen_hybrid",
                                 "sparselda", "lightlda", "zen_cdf",
                                 "zen_pallas")
    assert talg.registered() == jalg.registered()
    assert talg.get("zen_dense_kernel") is talg.get("zen_pallas")


def test_serve_cli_serves_a_jax_trained_checkpoint(tmp_path):
    """``repro.launch.train --checkpoint-dir`` writes, the port's
    ``serve_lda --device cpu --mode latency`` serves."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ckpt = str(tmp_path / "ckpt")
    train = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--single-box",
         "--algorithm", "zen", "--iters", "2", "--topics", "6",
         "--synthetic-docs", "30", "--synthetic-words", "50",
         "--synthetic-len", "15", "--llh-every", "0",
         "--checkpoint-dir", ckpt],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert train.returncode == 0, train.stderr
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lda",
         "--checkpoint-dir", ckpt, "--device", "cpu", "--mode", "latency",
         "--synthetic-docs", "8", "--synthetic-len", "12",
         "--buckets", "16,32", "--show", "2", "--eval"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert serve.returncode == 0, serve.stderr
    assert "latency ms: p50=" in serve.stdout and "on cpu" in serve.stdout
    assert "W=50 K=6" in serve.stdout
    assert "doc-completion perplexity" in serve.stdout
