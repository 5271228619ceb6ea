"""The port's mesh plan (``MeshPlan``, ``core.distributed``) in gloo worlds
of 1, 2 and 4 ranks on the CPU, held against its oracles and against the
JAX package's mesh.

* A mesh equals the one-cell oracle (the whole corpus as one cell,
  declared at (W_pad, D_pad), run through the backend's ``cell_sweep``
  with the single box's keys) bit for bit: topics, N_w|k, N_k|d and N_k,
  for ``zen_dense`` (gumbel) and ``zen_pallas``, exclusion on from
  iteration 1, on (1, 1), (1, 2), (2, 1), (2, 2) and the three-axis
  (2, 1, 2). For ``zen_pallas`` the oracle is ``SingleBoxPlan`` itself.
  ``zen_cdf``, ``zen_sparse``, ``zen_hybrid`` and ``sparselda`` at
  explicit pads are exact too: their draws read only the token's own
  rows, N_k and its index. ``lightlda``'s doc proposal reads the cell's
  tokens of the document, so it is held in the reference's band
  (``tests/test_mesh_parity.py``: llh rises, within 15% of the oracle's).
* Rebuild counts equal the reference's ``init_dist_state`` from the same
  grid-layout topics (bit for bit); the dist llh is within 1e-6
  relative of the reference's ``make_dist_llh``.
* int16 / int8 reductions equal the exact sum wrapped to the narrow type,
  as the reference's step builds and sums its deltas (it wraps; it does
  not saturate). An int8 run whose deltas pass 127 drifts from the
  counts of its topics by multiples of 256 until the ``rebuild_every``
  rebuild, equals them after it, in both packages, and ends within the
  reference's band of the reference's own int8 run.
* Elastic restore (2, 2) -> (1, 4), (4, 1); a reference mesh checkpoint
  restores into the port's ``MeshPlan`` and the reverse.
* ``launch.train --rows 2 --cols 2 --host-devices 4 --device cpu``.

The ranks run ``tests/torch_mesh_worker.py`` through
``launch.mesh.spawn_local`` (spawned, file rendezvous) in a ``python -c``
subprocess; the reference runs in ``helpers.run_with_devices``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from helpers import REPO, run_with_devices

import torch

import torch_mesh_worker as worker
from repro_torch.algorithms import CellBackend
from repro_torch.core.types import Corpus, LDAHyperParams
from repro_torch.train.checkpoint import load_lda_model
from repro_torch.train.session import RunConfig, TrainSession

WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
RANKS_TIMEOUT = 180  # seconds, per spawned world
REF_TIMEOUT = 180
LLH_BAND = 0.15  # tests/test_mesh_parity.py's band for non-exact backends


def _spawn_world(out, world, ref_dir=""):
    code = ("from repro_torch.launch.mesh import spawn_local; "
            f"spawn_local({WORKER + ':run'!r}, {world}, "
            f"args=({str(out)!r}, {world}, {str(ref_dir)!r}))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=RANKS_TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]


_REF_SETUP = """
import json, os, warnings; warnings.filterwarnings('ignore')
import numpy as np, jax, jax.numpy as jnp
from repro.core.types import LDAHyperParams
from repro.core.graph import grid_partition
from repro.core.distributed import init_dist_state, make_dist_llh
from repro.data import synthetic_corpus
from repro.launch.mesh import make_mesh
from repro.train.session import RunConfig, TrainSession
out = {out!r}
corpus = synthetic_corpus(0, num_docs=50, num_words=80, avg_doc_len=30,
                          zipf_a=1.2)
hyper = LDAHyperParams(**{hyper!r})
cfg = dict(algorithm='zen_cdf', mesh_shape=(2, 2), max_kd=8,
           num_iterations=2)
"""

_REF_WRITE = _REF_SETUP + """
mesh = make_mesh((2, 2), ('data', 'model'))
grid = grid_partition(corpus, 2, 2)
grid_topics = np.random.default_rng(5).integers(
    0, hyper.num_topics, grid.word.shape).astype(np.int32)
np.save(os.path.join(out, 'grid_topics.npy'), grid_topics)
state, data = init_dist_state(jax.random.key(0), mesh, grid, hyper,
                              init_topics=grid_topics)
llh = make_dist_llh(mesh, hyper, grid.words_per_shard, grid.docs_per_shard)
np.savez(os.path.join(out, 'rebuild.npz'), n_wk=np.asarray(state.n_wk),
         n_kd=np.asarray(state.n_kd), n_k=np.asarray(state.n_k),
         llh=float(llh(state, data)))
sess = TrainSession(corpus, hyper, RunConfig(
    train_checkpoint_dir=os.path.join(out, 'ckpt'),
    train_checkpoint_every=2, **cfg))
st = sess.run(jax.random.key(0))
np.savez(os.path.join(out, 'trained.npz'), n_wk=np.asarray(st.n_wk),
         n_kd=np.asarray(st.n_kd), n_k=np.asarray(st.n_k))
json.dump({{'iterations': 2}}, open(os.path.join(out, 'meta.json'), 'w'))
from repro.data import synthetic_lda_corpus
wc, _ = synthetic_lda_corpus(0, **{wrap_corpus!r})
wsess = TrainSession(wc, LDAHyperParams(**{wrap_hyper!r}), RunConfig(
    algorithm='zen_dense', sampling_method='gumbel', mesh_shape=(2, 2),
    delta_dtype='int8', rebuild_every={wrap_rebuild}, eval_every=1,
    num_iterations={wrap_iters}))
wg = wsess.plan.grid
gm = np.asarray(wg.mask)
gw, gd = np.asarray(wg.word)[gm], np.asarray(wg.doc)[gm]
drift = []
def wcb(st, m):
    z = np.array(st.topic)[gm]
    n_wk, n_kd = np.array(st.n_wk), np.array(st.n_kd)
    want_wk, want_kd = np.zeros_like(n_wk), np.zeros_like(n_kd)
    np.add.at(want_wk, (gw, z), 1)
    np.add.at(want_kd, (gd, z), 1)
    drift.append([n_wk - want_wk, n_kd - want_kd,
                  np.array(st.n_k) - want_wk.sum(0), m['llh']])
wsess.run(jax.random.key(0), callback=wcb)
np.savez(os.path.join(out, 'int8_wrap.npz'),
         drift_wk=np.stack([d[0] for d in drift]),
         drift_kd=np.stack([d[1] for d in drift]),
         drift_k=np.stack([d[2] for d in drift]),
         llh=np.array([d[3] for d in drift]))
print('REF_WRITE_OK')
"""

_REF_RESTORE = _REF_SETUP + """
sess = TrainSession(corpus, hyper, RunConfig(
    train_checkpoint_dir={ckpt!r}, **cfg))
st = sess.run(jax.random.key(5))
np.savez(os.path.join(out, 'restored_port.npz'), n_wk=np.asarray(st.n_wk),
         n_kd=np.asarray(st.n_kd), n_k=np.asarray(st.n_k),
         iteration=int(st.iteration))
print('REF_RESTORE_OK')
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference mesh run, then gloo worlds of 1, 2 and 4 ranks; each
    writes its results under its own directory."""
    base = tmp_path_factory.mktemp("mesh")
    ref = base / "ref"
    ref.mkdir()
    out = run_with_devices(_REF_WRITE.format(
        out=str(ref), hyper=worker.HYPER, wrap_corpus=worker.WRAP_CORPUS,
        wrap_hyper=worker.WRAP_HYPER, wrap_rebuild=worker.WRAP_REBUILD,
        wrap_iters=worker.WRAP_ITERS), n_devices=4, timeout=REF_TIMEOUT)
    assert "REF_WRITE_OK" in out
    dirs = {}
    for world in (1, 2, 4):
        d = base / f"world{world}"
        d.mkdir()
        if world == 1:
            worker.run(str(d), 1)  # a world of one: this process
        else:
            _spawn_world(d, world, ref if world == 4 else "")
        dirs[world] = d
    return {"ref": ref, **dirs}


def _load(runs, world, name):
    return np.load(runs[world] / f"{name}.npz")


def one_cell(alg, w_pad, d_pad, iters, **kw):
    """The one-cell oracle: the corpus declared at (W_pad, D_pad) on the
    single box, every sweep through the backend's ``cell_sweep`` with the
    single box's keys (``CellBackend.sweep``)."""
    c = worker.corpus()
    cp = Corpus(c.word, c.doc, int(w_pad), int(d_pad))
    cfg = dict(algorithm=alg, sampling_method="gumbel", exclusion_start=1)
    cfg.update(kw)
    sess = TrainSession(cp, LDAHyperParams(**worker.HYPER),
                        RunConfig(**cfg), device="cpu")
    plan = sess.plan
    if type(plan.backend).sweep is not CellBackend.sweep:
        plan.sweep = lambda st: CellBackend.sweep(
            plan.backend, st, plan.corpus, plan.hyper, plan._knobs)
    st = sess.init(0)
    for _ in range(iters):
        st = sess.step(st)
    return sess, st


def _assert_equals_oracle(got, sess, st):
    w, d = got["n_wk"].shape[0], got["n_kd"].shape[0]
    np.testing.assert_array_equal(got["topics"], st.topic.numpy())
    np.testing.assert_array_equal(got["n_wk"], st.n_wk.numpy()[:w])
    np.testing.assert_array_equal(got["n_kd"], st.n_kd.numpy()[:d])
    np.testing.assert_array_equal(got["n_k"], st.n_k.numpy())
    assert not st.n_wk.numpy()[w:].any() and not st.n_kd.numpy()[d:].any()
    assert float(got["llh"]) == sess.llh(st)


@pytest.mark.parametrize("world,shape,alg", [
    (world, shape, alg) for world, shape in ((1, "11"), (2, "12"), (2, "21"),
                                             (4, "22"))
    for alg in ("zen_pallas", "zen_dense")] + [(4, "212", "zen_pallas")])
def test_mesh_equals_one_cell_oracle(runs, world, shape, alg):
    got = _load(runs, world, f"parity_{shape}_{alg}")
    sess, st = one_cell(alg, got["w_pad"], got["d_pad"], worker.ITERS)
    _assert_equals_oracle(got, sess, st)
    assert int(got["iteration"]) == worker.ITERS


@pytest.mark.parametrize("world,shape", [(1, "11"), (2, "12"), (4, "22"),
                                         (4, "212")])
def test_zen_pallas_mesh_equals_single_box(runs, world, shape):
    """For zen_pallas the oracle is ``SingleBoxPlan`` as it is; on a
    (1, 1) mesh W_pad = W and D_pad = D, so it is the single-box run on
    the corpus itself."""
    got = _load(runs, world, f"parity_{shape}_zen_pallas")
    c = worker.corpus()
    if shape == "11":
        assert (int(got["w_pad"]), int(got["d_pad"])) == (c.num_words,
                                                          c.num_docs)
    cp = Corpus(c.word, c.doc, int(got["w_pad"]), int(got["d_pad"]))
    sess = TrainSession(cp, LDAHyperParams(**worker.HYPER), RunConfig(
        algorithm="zen_pallas", exclusion_start=1), device="cpu")
    st = sess.init(0)
    for _ in range(worker.ITERS):
        st = sess.step(st)
    _assert_equals_oracle(got, sess, st)


@pytest.mark.parametrize("alg", worker.OTHER_BACKENDS)
def test_other_mesh_backends_against_oracle(runs, alg):
    got = _load(runs, 4, f"backend_{alg}")
    sess, st = one_cell(alg, got["w_pad"], got["d_pad"], 3, num_mh=2,
                        **worker.PADS)
    if alg != "lightlda":
        _assert_equals_oracle(got, sess, st)
        return
    # lightlda's doc proposal draws from the cell's tokens of the document
    # (the reference's cell semantics): not the one-cell chain, the same
    # sampler; held in the reference's band, counts conserved
    c = worker.corpus()
    init, _ = one_cell(alg, got["w_pad"], got["d_pad"], 0)
    l0 = init.llh(init.init(0))
    assert float(got["llh"]) > l0
    assert abs(float(got["llh"]) - sess.llh(st)) / abs(sess.llh(st)) \
        < LLH_BAND
    assert int(got["n_k"].sum()) == c.num_tokens
    np.testing.assert_array_equal(got["n_wk"].sum(0), got["n_k"])
    np.testing.assert_array_equal(got["n_kd"].sum(0), got["n_k"])


def test_rebuild_and_llh_equal_reference(runs):
    want = np.load(runs["ref"] / "rebuild.npz")
    got = _load(runs, 4, "rebuild")
    for f in ("n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    rel = abs(float(got["llh"]) / float(want["llh"]) - 1)
    assert rel < 1e-6, (float(got["llh"]), float(want["llh"]))


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
@pytest.mark.parametrize("axis", ["data", "model", "all"])
def test_compressed_reduction_is_the_clipped_sum(runs, dtype, axis):
    """Each rank's delta in the narrow type, as the reference's step builds
    it (its scatter-adds wrap: a delta of 130 is -126 in int8, not the
    saturated 127), summed in it (wrapping as the reference's ``psum``
    does) and widened: the exact sum wrapped to the narrow type."""
    got = _load(runs, 4, "compressed")
    deltas = got["deltas"]  # (rank, 6, 5)
    ranks = {"data": [0, 2], "model": [0, 1], "all": [0, 1, 2, 3]}[axis]
    if dtype == "int32":
        want = deltas[ranks].sum(0)
    else:
        nt = np.dtype(dtype)
        narrow = deltas[ranks].astype(nt)  # wraps, as the scatter-adds do
        want = np.zeros(narrow.shape[1:], nt)
        for c in narrow:
            want = (want + c).astype(nt)  # wraps
        want = want.astype(np.int32)
        assert (want != np.clip(deltas[ranks], np.iinfo(nt).min,
                                np.iinfo(nt).max).sum(0)).any()
    np.testing.assert_array_equal(got[f"{dtype}_{axis}"], want)


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_compressed_training_conserves_counts(runs, dtype):
    """No delta of this corpus leaves the narrow range: the compressed
    run equals the int32 oracle."""
    got = _load(runs, 4, f"delta_{dtype}")
    sess, st = one_cell("zen_pallas", got["w_pad"], got["d_pad"], 3)
    _assert_equals_oracle(got, sess, st)


def _wrap_drift(got):
    """(iterations, 3) drift of N_w|k, N_k|d and N_k from the counts of
    each iteration's topics, per iteration (one numpy ``add.at`` each)."""
    c = worker.wrap_corpus()
    word, doc = c.word.numpy(), c.doc.numpy()
    k = worker.WRAP_HYPER["num_topics"]
    out = []
    for z, n_wk, n_kd, n_k in zip(got["topics"], got["n_wk"], got["n_kd"],
                                  got["n_k"]):
        want_wk = np.zeros((c.num_words, k), np.int64)
        want_kd = np.zeros((c.num_docs, k), np.int64)
        np.add.at(want_wk, (word, z), 1)
        np.add.at(want_kd, (doc, z), 1)
        out.append([n_wk - want_wk, n_kd - want_kd, n_k - want_wk.sum(0)])
    return out


def test_int8_mesh_run_drifts_until_the_rebuild(runs):
    """The int8 run whose head-word deltas pass 127: before each rebuild
    the counts drift from ``build_counts`` of the topics, by multiples of
    256 (the wrap); after each rebuild (iterations 4, 8, 12) they equal
    them; the reference's own int8 run does the same; the final llh (right
    after a rebuild) is within the reference's band of the reference's."""
    got = _load(runs, 4, "int8_wrap")
    ref = np.load(runs["ref"] / "int8_wrap.npz")
    ref_drift = [[ref["drift_wk"][i], ref["drift_kd"][i], ref["drift_k"][i]]
                 for i in range(len(ref["llh"]))]
    rebuilds = [it % worker.WRAP_REBUILD == 0
                for it in range(1, worker.WRAP_ITERS + 1)]
    for name, drift in (("port", _wrap_drift(got)), ("reference", ref_drift)):
        assert len(drift) == worker.WRAP_ITERS, name
        moved = [any(d.any() for d in it) for it in drift]
        for it, (d, rebuilt) in enumerate(zip(drift, rebuilds), 1):
            assert all((x % 256 == 0).all() for x in d), (name, it)
            if rebuilt:
                assert not moved[it - 1], (name, it)
        # a wrap happened in the iterations before a rebuild
        assert any(m for m, r in zip(moved, rebuilds) if not r), name
    port_llh, ref_llh = float(got["llh"][-1]), float(ref["llh"][-1])
    assert abs(port_llh / ref_llh - 1) < LLH_BAND, (port_llh, ref_llh)
    llh = got["llh"]
    assert llh[-1] > llh[0]


@pytest.mark.parametrize("shape", ["14", "41"])
def test_elastic_restore_onto_another_shape(runs, shape):
    src = _load(runs, 4, "elastic_src")
    got = _load(runs, 4, f"elastic_{shape}")
    np.testing.assert_array_equal(got["topics"], src["topics"])
    for f in ("n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(got[f], src[f], err_msg=f)
    assert int(got["iteration"]) == 3 and int(got["iteration_after"]) == 4
    assert np.isfinite(float(got["llh_after"]))


def test_reference_checkpoint_restores_into_port_mesh_plan(runs):
    want = np.load(runs["ref"] / "trained.npz")
    got = _load(runs, 4, "from_reference")
    for f in ("n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(got["iteration"]) == 2


def test_port_checkpoint_restores_into_reference_mesh_plan(runs):
    ckpt = str(runs[4] / "port_ckpt")
    out = run_with_devices(
        _REF_RESTORE.format(out=str(runs["ref"]), hyper=worker.HYPER,
                            ckpt=ckpt), n_devices=4, timeout=REF_TIMEOUT)
    assert "REF_RESTORE_OK" in out
    want = _load(runs, 4, "port_ckpt_counts")
    got = np.load(runs["ref"] / "restored_port.npz")
    for f in ("n_wk", "n_kd", "n_k"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(got["iteration"]) == 2


def test_train_cli_mesh_on_cpu(tmp_path):
    """``launch.train --rows 2 --cols 2 --host-devices 4 --device cpu``:
    the reference's line shapes from rank 0 alone, and a model checkpoint
    carrying the mesh."""
    ckpt = str(tmp_path / "model")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--rows", "2",
         "--cols", "2", "--host-devices", "4", "--device", "cpu",
         "--algorithm", "zen_sparse", "--iters", "2", "--topics", "8",
         "--synthetic-docs", "40", "--synthetic-words", "60",
         "--synthetic-len", "20", "--llh-every", "1", "--checkpoint-dir",
         ckpt], env=env, capture_output=True, text=True,
        timeout=RANKS_TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("mesh 2x2  tokens=")
    assert lines[1].startswith("padded-row widths: max_kw=")
    assert sum(ln.startswith("iter ") for ln in lines) == 2
    assert any(ln.startswith("finished at iteration 2; final llh -")
               for ln in lines)
    n_wk, n_k, _hyper, meta, step = load_lda_model(ckpt)
    assert step == 2 and meta["mesh"] == [2, 2]
    assert meta["algorithm"] == "zen_sparse"
    assert n_wk.shape == (60, 8) and int(n_k.sum()) == int(n_wk.sum())


def test_mesh_plan_validation():
    c = worker.corpus()
    h = LDAHyperParams(**worker.HYPER)
    with pytest.raises(RuntimeError, match="4 ranks"):
        TrainSession(c, h, RunConfig(mesh_shape=(2, 2)), device="cpu")
    with pytest.raises(ValueError, match="shard_map"):
        TrainSession(c, h, RunConfig(algorithm="std", mesh_shape=(1, 1)),
                     device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        TrainSession(c, h, RunConfig(mesh_shape=(1, 0)), device="cpu")
    sess = TrainSession(c, h, RunConfig(mesh_shape=(1, 1)), device="cpu")
    assert sess.cfg.sampling_method == "gumbel"
    assert sess._autopilot_candidates() == ("zen", "zen_sparse",
                                            "sparselda", "zen_hybrid")
    with pytest.raises(ValueError, match="topics of shape"):
        sess.init(0, init_topics=np.zeros(3, np.int32))
    st = sess.init(0)
    with pytest.raises(ValueError, match="shard_map"):
        sess.plan.set_backend("std", st)
    assert json.loads(sess.cfg.to_json())["mesh_shape"] == [1, 1]
    assert torch.equal(sess.plan.data.token[:3],
                       torch.as_tensor(sess.plan.grid.token[0][:3],
                                       dtype=torch.int32))
