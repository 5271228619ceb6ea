"""The port's sharded serving (``serving.sharded``, ``LDAServeConfig(
mesh_shape=(1, m))``) and replica router (``serving.router.LDARouter``):
the counterparts of ``tests/test_sharded_serving.py`` on the CPU.

Sharded thetas equal the unsharded engine's bit for bit for every serving
backend at (1, 2) and (1, 4) (per-token draws from the slot key and the
position: the ``infer_sweep`` contract). The port shards in one process,
so no device count is needed; the reference's multi-device cases run here
in process. Where the outcome is deterministic (admission order under
equal loads, load snapshots, version tags, validation errors) it is held
against the reference's ``LDARouter`` / ``LDAEngine`` on the same inputs.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core.types import LDAHyperParams as JHyper
from repro.serving import FrozenLDAModel as JModel
from repro.serving import LDAEngine as JEngine
from repro.serving import LDARouter as JRouter
from repro.serving import LDAServeConfig as JConfig
from repro.serving import ShardedFrozenLDAModel as JSharded
from repro_torch import algorithms
from repro_torch.core.types import LDAHyperParams
from repro_torch.launch.mesh import make_mesh
from repro_torch.observe.metrics import read_jsonl
from repro_torch.serving import (
    FrozenLDAModel,
    LDAEngine,
    LDARouter,
    LDAServeConfig,
    ShardedFrozenLDAModel,
)
from repro_torch.serving.sharded import layout_key
from repro_torch.train.checkpoint import save_lda_model

import torch

DOC_LENGTHS = (3, 9, 17, 1, 12, 30)
W, K = 40, 8


def _arrays(seed=1, scale=3.0, hot=False):
    rng = np.random.default_rng(seed)
    n_wk = rng.poisson(scale, (W, K)).astype(np.int32)
    if hot:
        # very different row masses: very different LPT permutations
        n_wk[rng.permutation(W)[:5]] += 200
    return n_wk, n_wk.sum(0).astype(np.int32)


def _model(seed=1, scale=3.0, hot=False):
    n_wk, n_k = _arrays(seed, scale, hot)
    return FrozenLDAModel.from_numpy(
        n_wk, n_k, LDAHyperParams(num_topics=K, alpha=0.5, beta=0.1),
        device="cpu")


def _ref_model(seed=1, scale=3.0, hot=False):
    n_wk, n_k = _arrays(seed, scale, hot)
    return JModel(n_wk=jnp.asarray(n_wk), n_k=jnp.asarray(n_k),
                  hyper=JHyper(num_topics=K, alpha=0.5, beta=0.1))


def _docs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, W, size=n).astype(np.int32)
            for n in DOC_LENGTHS]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("algo", algorithms.registered())
def test_sharded_serve_parity(algo, m):
    """Sharded == unsharded thetas bit for bit, and the router composes
    with sharding (2 replicas, each sharded; explicit keys)."""
    model = _model()
    docs = _docs()
    keys = [100 + i for i in range(len(docs))]
    base = dict(buckets=(8, 32), max_batch=4, num_sweeps=5, algorithm=algo)
    single = LDAEngine(model, LDAServeConfig(**base), seed=0)
    t_single = np.stack([single.infer_batch([d], key=k)[0]
                         for d, k in zip(docs, keys)])
    cfg = LDAServeConfig(mesh_shape=(1, m), **base)
    sharded = LDAEngine(model, cfg, seed=0)
    sm = sharded.model
    assert isinstance(sm, ShardedFrozenLDAModel)
    assert sm.num_words == W and sm.num_shards == m
    assert sm.n_wk.shape[0] == m * sm.words_per_shard
    assert len(sm.blocks) == m and all(b.shape == (sm.words_per_shard, K)
                                       for b in sm.blocks)
    assert torch.equal(sm.phi(), model.phi())
    t_sharded = np.stack([sharded.infer_batch([d], key=k)[0]
                          for d, k in zip(docs, keys)])
    np.testing.assert_array_equal(t_sharded, t_single)
    router = LDARouter(model, cfg, replicas=2, seed=0)
    t_router = np.stack([router.infer_batch([d], key=k)[0]
                         for d, k in zip(docs, keys)])
    np.testing.assert_array_equal(t_router, t_single)


def test_sharded_reload_relabels_at_placement():
    m0, m1 = _model(1, 3.0, hot=True), _model(2, 1.0, hot=True)
    rng = np.random.default_rng(0)
    doc_a = rng.integers(0, W, size=7).astype(np.int32)
    doc_b = rng.integers(0, W, size=6).astype(np.int32)
    cfg = LDAServeConfig(buckets=(8,), max_batch=1, num_sweeps=40,
                         algorithm="zen_cdf", mesh_shape=(1, 2))
    eng = LDAEngine(m0, cfg, seed=0)
    assert not np.array_equal(eng.model.word_perm,
                              ShardedFrozenLDAModel.shard(
                                  m1, eng._mesh).word_perm)
    ta = eng.submit_async(doc_a)
    eng.step()
    assert eng.poll(ta) == "admitted"
    eng.reload(m1)
    tb = eng.submit_async(doc_b, key=77)
    eng.step()
    assert eng.poll(tb) == "queued"  # the old version's occupant pins it
    ra, rb = eng.request(ta), eng.request(tb)
    theta_a, theta_b = eng.result(ta), eng.result(tb)
    assert theta_a.shape == (K,)
    assert ra.model_version == 0 and rb.model_version == 1
    fresh = LDAEngine(m1, cfg, seed=0)
    np.testing.assert_array_equal(
        theta_b, fresh.infer_batch([doc_b], key=77)[0])
    assert eng.model_version == 1


def test_mesh_shape_validation_matches_reference():
    model, jm = _model(), _ref_model()
    for kw, match in (({"mode": "latency", "mesh_shape": (1, 1)},
                       "latency"),
                      ({"mesh_shape": (2, 1)}, r"\(1, m\)"),
                      ({"mesh_shape": (1, 2, 1)}, r"\(1, m\)")):
        with pytest.raises(ValueError, match=match):
            JEngine(jm, JConfig(**kw))
        with pytest.raises(ValueError, match=match):
            LDAEngine(model, LDAServeConfig(**kw))


def test_one_shard_mesh_matches_single_host():
    model = _model()
    docs = _docs()
    base = dict(buckets=(8, 32), max_batch=4, num_sweeps=5,
                algorithm="zen_cdf")
    single = LDAEngine(model, LDAServeConfig(**base), seed=0)
    sharded = LDAEngine(model, LDAServeConfig(mesh_shape=(1, 1), **base),
                        seed=0)
    assert isinstance(sharded.model, ShardedFrozenLDAModel)
    for i, d in enumerate(docs):
        np.testing.assert_array_equal(
            sharded.infer_batch([d], key=100 + i)[0],
            single.infer_batch([d], key=100 + i)[0])


def test_sharded_model_relabel_phi_and_layout_match_reference():
    """The layout equals the reference's (a (1, 1) mesh: the reference
    builds it in process), the relabeling is a bijection into the padded
    space, and ``phi`` inverts it."""
    model = _model(hot=True)
    eng = LDAEngine(model, LDAServeConfig(mesh_shape=(1, 1)))
    sm = ShardedFrozenLDAModel.shard(model, eng._mesh)
    jeng = JEngine(_ref_model(hot=True), JConfig(mesh_shape=(1, 1)))
    jsm = JSharded.shard(_ref_model(hot=True), jeng._mesh)
    np.testing.assert_array_equal(sm.word_perm, jsm.word_perm)
    assert sm.words_per_shard == jsm.words_per_shard
    np.testing.assert_array_equal(sm.n_wk.numpy(), np.asarray(jsm.n_wk))
    assert layout_key(sm) == (sm.words_per_shard, W, 1)
    assert layout_key(model) is None
    for m in (2, 3):
        sm = ShardedFrozenLDAModel.shard(
            model, make_mesh((1, m), ("data", "model"), devices=["cpu"] * m))
        assert len(set(sm.word_perm.tolist())) == W
        ids = np.arange(W, dtype=np.int32)
        np.testing.assert_array_equal(sm.n_wk.numpy()[sm.relabel(ids)],
                                      model.n_wk.numpy())
        assert torch.equal(sm.phi(), model.phi())
        loads = sm.n_wk.sum(1).reshape(m, -1).sum(1)
        assert loads.max() - loads.min() <= model.n_wk.sum(1).max()


def _route(router, tickets):
    return [router.engines.index(router._tickets[t][0]) for t in tickets]


def test_router_unique_tickets_load_spread_and_admission_order():
    """Least-loaded admission, ties to the lowest replica: the same
    replica for every ticket as the reference's router, the same loads."""
    base = dict(buckets=(8, 32), max_batch=2, num_sweeps=3,
                algorithm="zen")
    router = LDARouter(_model(), LDAServeConfig(**base), replicas=3,
                       seed=0)
    jrouter = JRouter(_ref_model(), JConfig(**base), replicas=3, seed=0)
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, W, size=6).astype(np.int32) for _ in range(8)]
    tickets = [router.submit_async(d) for d in docs]
    jtickets = [jrouter.submit_async(d) for d in docs]
    assert len(set(tickets)) == len(tickets) and tickets == jtickets
    assert _route(router, tickets) == _route(jrouter, jtickets)
    assert router.loads == jrouter.loads and all(router.loads)
    router.engines[1].step()
    jrouter.engines[1].step()
    extra = router.submit_async(docs[0])
    jextra = jrouter.submit_async(docs[0])
    assert _route(router, [extra]) == _route(jrouter, [jextra])
    thetas = np.stack([router.result(t) for t in tickets + [extra]])
    assert thetas.shape == (len(docs) + 1, K)
    np.testing.assert_allclose(thetas.sum(1), 1.0, rtol=1e-5)
    assert router.docs_done == len(docs) + 1
    for t in tickets:
        with pytest.raises(KeyError):
            router.poll(t)


def test_router_parity_with_explicit_keys():
    cfg = LDAServeConfig(buckets=(8, 32), max_batch=2, num_sweeps=5,
                         algorithm="zen")
    router = LDARouter(_model(), cfg, replicas=3, seed=9)
    single = LDAEngine(_model(), cfg, seed=0)
    docs = _docs(3)
    keys = [500 + i for i in range(len(docs))]
    t_router = np.stack([router.infer_batch([d], key=k)[0]
                         for d, k in zip(docs, keys)])
    t_single = np.stack([single.infer_batch([d], key=k)[0]
                         for d, k in zip(docs, keys)])
    np.testing.assert_array_equal(t_router, t_single)


def test_router_reload_broadcast_zero_drops():
    base = dict(buckets=(8,), max_batch=1, num_sweeps=30, algorithm="zen")
    router = LDARouter(_model(1), LDAServeConfig(**base), replicas=2,
                       seed=0)
    jrouter = JRouter(_ref_model(1), JConfig(**base), replicas=2, seed=0)
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, W, size=5).astype(np.int32) for _ in range(4)]
    tickets = [router.submit_async(d) for d in docs]
    for d in docs:
        jrouter.submit_async(d)
    for e, je in zip(router.engines, jrouter.engines):
        e.step()
        je.step()
    reqs = [router.request(t) for t in tickets]
    assert router.reload(_model(2)) == jrouter.reload(_ref_model(2)) == 1
    assert [e.model_version for e in router.engines] == [1, 1]
    assert router.model_version == 1
    assert router.reload(_model(3), version=5) == 5
    thetas = [router.result(t) for t in tickets]
    assert all(th.shape == (K,) for th in thetas)
    assert router.docs_done == len(docs)
    # the two admitted before the reload finished on version 0, the two
    # queued behind them on the newest model
    assert sorted(r.model_version for r in reqs) == [0, 0, 5, 5]


def test_router_cancel_delegates_and_frees_slot():
    router = LDARouter(
        _model(), LDAServeConfig(buckets=(8,), max_batch=1, num_sweeps=50,
                                 algorithm="zen"), replicas=1, seed=0)
    rng = np.random.default_rng(0)
    ta = router.submit_async(rng.integers(0, W, 5).astype(np.int32))
    router.engines[0].step()
    assert router.poll(ta) == "admitted"
    assert router.cancel(ta) is True
    assert router.cancel(ta) is False
    tb = router.submit_async(rng.integers(0, W, 5).astype(np.int32))
    router.engines[0].step()
    assert router.poll(tb) == "admitted"


def test_router_watches_one_directory_and_logs_fleet_loads(tmp_path):
    """One watcher for the fleet: a newer committed step reloads every
    replica under one version; the fleet's load records ride on replica
    0's telemetry, as the reference's do."""
    ckpt = str(tmp_path / "ckpt")
    n_wk, n_k = _arrays(1)
    hyper = LDAHyperParams(num_topics=K, alpha=0.5, beta=0.1)
    save_lda_model(ckpt, n_wk, n_k, hyper, step=1)
    metrics = str(tmp_path / "serve.jsonl")
    router = LDARouter(_model(), LDAServeConfig(
        buckets=(8,), num_sweeps=2, metrics_out=metrics,
        autopilot_window=4), replicas=2, seed=0)
    router.watch_checkpoint_dir(ckpt, period=0.02, initial_step=1)
    n_wk2, n_k2 = _arrays(2)
    save_lda_model(ckpt, n_wk2, n_k2, hyper, step=2)
    import time

    deadline = time.monotonic() + 20
    while router.model_version < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert router.stop_watching() is None
    assert [e.model_version for e in router.engines] == [1, 1]
    np.testing.assert_array_equal(router.model.n_wk.numpy(), n_wk2)
    docs = _docs()
    router.infer_batch(docs)
    loads = [r for r in read_jsonl(metrics) if r["kind"] == "router_load"]
    assert len(loads) == len(docs) // 2
    assert all(len(r["loads"]) == 2 and r["total"] == sum(r["loads"])
               for r in loads)
