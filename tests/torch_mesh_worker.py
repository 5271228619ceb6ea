"""Rank code for ``tests/test_torch_mesh.py`` (not a test module): each
rank of a gloo world runs :func:`run`, and rank 0 writes every result as
an ``.npz`` under the output directory for the test to check against its
oracles. Spawned ranks import this file by path
(``launch.mesh.spawn_local("tests/torch_mesh_worker.py:run", ...)``).
"""
import json
import os

import numpy as np
import torch

from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_corpus, synthetic_lda_corpus
from repro_torch.train.session import RunConfig, TrainSession

HYPER = dict(num_topics=8, alpha=0.1, beta=0.05)
ITERS = 4
# explicit pads for the padded-sparse backends, so a mesh and its
# one-cell oracle sample the same row widths
PADS = dict(max_kw=8, max_kd=8)
OTHER_BACKENDS = ("zen_cdf", "zen_sparse", "zen_hybrid", "sparselda",
                  "lightlda")
# the int8 run whose deltas leave the narrow range: 39,842 tokens of 30
# words and 4 planted topics, so a cell's head-word deltas pass 127 once
# the topics form (from iteration 3 or so); an exact rebuild every 4
WRAP_CORPUS = dict(num_docs=400, num_words=30, num_topics=4,
                   avg_doc_len=100)
WRAP_HYPER = dict(num_topics=4, alpha=0.1, beta=0.05)
WRAP_ITERS, WRAP_REBUILD = 12, 4


def wrap_corpus():
    return synthetic_lda_corpus(0, **WRAP_CORPUS)[0]


def corpus():
    return synthetic_corpus(0, num_docs=50, num_words=80, avg_doc_len=30,
                            zipf_a=1.2)


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def save(out: str, name: str, **arrays) -> None:
    if rank() == 0:
        np.savez(os.path.join(out, name + ".npz"), **arrays)


def session(shape, alg, **cfg_kw) -> TrainSession:
    kw = dict(algorithm=alg, mesh_shape=tuple(shape),
              sampling_method="gumbel", exclusion_start=1)
    kw.update(cfg_kw)
    return TrainSession(corpus(), LDAHyperParams(**HYPER), RunConfig(**kw),
                        device="cpu")


def result(sess: TrainSession, st) -> dict:
    """What the test compares: the assignments in corpus order, the
    three count matrices in corpus ids, the llh and the padded sizes."""
    plan = sess.plan
    return dict(topics=plan.corpus_topics(st), n_wk=plan.host_n_wk(st),
                n_kd=plan.host_n_kd(st), n_k=st.n_k.numpy(),
                llh=sess.llh(st), w_pad=plan.num_words_pad,
                d_pad=plan.grid.num_docs_padded,
                iteration=int(st.iteration))


def train(out, name, shape, alg, iters=ITERS, **cfg_kw):
    sess = session(shape, alg, **cfg_kw)
    st = sess.init(0)
    for _ in range(iters):
        st = sess.step(st)
        sess.plan.check_invariants(st)
    save(out, name, **result(sess, st))
    return sess, st


def compressed(out: str) -> None:
    """int16/int8 reductions of per-rank deltas that overflow the narrow
    types, over every axis; and training with each keeps conservation."""
    from repro_torch.core.distributed import MeshComm, _compress_all_reduce

    comm = MeshComm(2, 2)
    rng = np.random.default_rng(100 + comm.rank)
    delta = rng.integers(-40000, 40000, (6, 5)).astype(np.int32)
    delta[0] = [127, -128, 100, -100, 32767]
    got = {}
    for dtype in ("int32", "int16", "int8"):
        for axis in ("data", "model", "all"):
            t = torch.from_numpy(delta.copy())
            got[f"{dtype}_{axis}"] = _compress_all_reduce(
                t, comm, axis, dtype).numpy()
    deltas = torch.zeros((4, 6, 5), dtype=torch.int32)
    deltas[comm.rank] = torch.from_numpy(delta)
    deltas = comm.all_reduce(deltas, "all").numpy()
    save(out, "compressed", deltas=deltas, **got)
    for dtype in ("int16", "int8"):
        train(out, f"delta_{dtype}", (2, 2), "zen_pallas", iters=3,
              delta_dtype=dtype)


def wrapped_deltas(out: str) -> None:
    """``delta_dtype="int8"`` on :func:`wrap_corpus` with ``rebuild_every``
    4, through ``TrainSession.run``: every iteration's topics (corpus
    order), counts (corpus ids) and llh, for the test to hold against
    ``build_counts`` of the topics and the reference's own int8 run."""
    sess = TrainSession(wrap_corpus(), LDAHyperParams(**WRAP_HYPER),
                        RunConfig(algorithm="zen_dense",
                                  sampling_method="gumbel",
                                  mesh_shape=(2, 2), delta_dtype="int8",
                                  rebuild_every=WRAP_REBUILD,
                                  num_iterations=WRAP_ITERS, eval_every=1),
                        device="cpu")
    rec = {k: [] for k in ("topics", "n_wk", "n_kd", "n_k", "llh")}

    def snapshot(st, metrics):
        plan = sess.plan
        rec["topics"].append(plan.corpus_topics(st))
        rec["n_wk"].append(plan.host_n_wk(st))
        rec["n_kd"].append(plan.host_n_kd(st))
        rec["n_k"].append(st.n_k.numpy().copy())
        rec["llh"].append(metrics["llh"])

    sess.run(0, callback=snapshot)
    save(out, "int8_wrap", **{k: np.stack(v) for k, v in rec.items()})


def elastic(out: str) -> None:
    """(2, 2) -> checkpoint tree -> (1, 4) and (4, 1): counts rebuilt
    from the assignments in corpus order, then training continues."""
    sess, st = train(out, "elastic_src", (2, 2), "zen_cdf", iters=3,
                     max_kd=8)
    topics = sess.plan.corpus_topics(st)
    for shape in ((1, 4), (4, 1)):
        other = session(shape, "zen_cdf", max_kd=8)
        st_b = other.plan.restore(other.init(1), {
            "topic": topics, "iteration": np.int32(3)})
        other.plan.check_invariants(st_b)
        restored = result(other, st_b)
        st_b = other.step(st_b)
        other.plan.check_invariants(st_b)
        save(out, f"elastic_{shape[0]}{shape[1]}", llh_after=other.llh(st_b),
             iteration_after=int(st_b.iteration), **restored)


def cross_package(out: str, ref_dir: str) -> None:
    """The reference's grid-layout topics rebuilt and scored here; the
    reference's (2, 2) training checkpoint restored into this MeshPlan;
    and a checkpoint of this MeshPlan written for the reference."""
    meta = json.load(open(os.path.join(ref_dir, "meta.json")))
    grid_topics = np.load(os.path.join(ref_dir, "grid_topics.npy"))
    sess = session((2, 2), "zen_cdf", max_kd=8)
    st = sess.init(0, init_topics=grid_topics)
    n_wk, n_kd = sess.plan.global_counts(st)
    save(out, "rebuild", n_wk=n_wk.numpy(), n_kd=n_kd.numpy(),
         n_k=st.n_k.numpy(), llh=sess.llh(st))
    restored = session((2, 2), "zen_cdf", max_kd=8,
                       num_iterations=meta["iterations"],
                       train_checkpoint_dir=os.path.join(ref_dir, "ckpt"))
    st = restored.run(0)
    restored.plan.check_invariants(st)
    n_wk, n_kd = restored.plan.global_counts(st)
    save(out, "from_reference", n_wk=n_wk.numpy(), n_kd=n_kd.numpy(),
         n_k=st.n_k.numpy(), iteration=int(st.iteration))
    writer = session((2, 2), "zen_cdf", max_kd=8, num_iterations=2,
                     train_checkpoint_dir=os.path.join(out, "port_ckpt"),
                     train_checkpoint_every=2)
    st = writer.run(0)
    n_wk, n_kd = writer.plan.global_counts(st)
    save(out, "port_ckpt_counts", n_wk=n_wk.numpy(), n_kd=n_kd.numpy(),
         n_k=st.n_k.numpy())


def run(out: str, world: int, ref_dir: str = "") -> None:
    """Every scenario of a world of ``world`` ranks (1, 2 or 4)."""
    shapes = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}[world]
    for shape in shapes:
        tag = "".join(str(x) for x in shape)
        for alg in ("zen_pallas", "zen_dense"):
            train(out, f"parity_{tag}_{alg}", shape, alg)
    if world != 4:
        return
    train(out, "parity_212_zen_pallas", (2, 1, 2), "zen_pallas")
    for alg in OTHER_BACKENDS:
        train(out, f"backend_{alg}", (2, 2), alg, iters=3, num_mh=2,
              **PADS)
    compressed(out)
    wrapped_deltas(out)
    elastic(out)
    if ref_dir:
        cross_package(out, ref_dir)
