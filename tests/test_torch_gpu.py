"""The port's CUDA kernels on the card (marker ``gpu``; they skip without
one). Run them where a card is:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed
(``--noconftest`` skips the suite's JAX fixtures).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fused_gather import zen_fused_infer_sample_plain
from repro_torch.kernels.zen_sampler import gumbel_noise

pytestmark = pytest.mark.gpu
NEAR_TIE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(dev, seed, t, k, w, b):
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    n_wk = torch.randint(0, 50, (w, k), generator=g, device=dev, dtype=i32)
    return dict(
        n_wk=n_wk,
        n_kd=torch.randint(0, 9, (b, k), generator=g, device=dev, dtype=i32),
        word=torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32),
        slot=torch.randint(0, b, (t,), generator=g, device=dev, dtype=i32),
        z=torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32),
        seeds=torch.randint(0, 2**31 - 1, (t,), generator=g, device=dev,
                            dtype=i32),
        alpha=torch.rand(k, generator=g, device=dev) * 0.1,
        n_k=n_wk.sum(0).to(torch.float32),
    )


@pytest.mark.parametrize("t,k,w,b", [(4096, 1000, 20000, 8),
                                     (333, 37, 50, 3), (1, 5, 2, 1)])
def test_kernels_match_plain_version_on_card(cuda, t, k, w, b):
    a = _inputs(cuda, t + k, t, k, w, b)
    args = (a["n_wk"], a["n_kd"], a["word"], a["slot"], a["z"], a["seeds"],
            a["alpha"], a["n_k"])
    kw = dict(beta=0.01, w_beta=w * 0.01)
    before = ops.launch_counts()
    fused = ops.zen_fused_infer_sample(*args, **kw)
    gathered = ops.zen_infer_sample(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["slot"].long()].contiguous(), a["z"], a["seeds"],
        a["alpha"], a["n_k"], **kw)
    plain = zen_fused_infer_sample_plain(*args, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["zen_fused_infer_sample"] == \
        before["zen_fused_infer_sample"] + 1
    assert after["zen_infer_sample"] == before["zen_infer_sample"] + 1
    assert torch.equal(fused, gathered)
    bad = (fused != plain).nonzero().flatten().tolist()
    for i in bad:  # a mismatch must be a near-tie of the two scores
        cand = torch.tensor([int(fused[i]), int(plain[i])], device=cuda)
        wi, si = int(a["word"][i]), int(a["slot"][i])
        nd = a["n_kd"][si, cand].float() - (cand == a["z"][i]).float()
        p = (nd + a["alpha"][cand]) * (a["n_wk"][wi, cand].float() + 0.01) \
            / (a["n_k"][cand] + w * 0.01)
        s = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(a["seeds"][i], 0, cand)
        assert abs(float(s[0] - s[1])) <= NEAR_TIE
    assert len(bad) <= max(1, t // 10000)


_OUT_OF_RANGE = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
i32 = torch.int32
n_wk = torch.ones((10, 16), dtype=i32, device=d)
vec = torch.zeros(64, dtype=i32, device=d)
word = vec.clone()
word[5] = 10  # W
try:
    ops.zen_fused_infer_sample(
        n_wk, torch.ones((2, 16), dtype=i32, device=d), word, vec, vec, vec,
        torch.full((16,), 0.1, device=d), n_wk.sum(0).float(), beta=0.01,
        w_beta=0.1)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


def test_out_of_range_word_raises(cuda):
    """Like the plain version's indexing, the fused kernel refuses a word
    outside n_wk. The abort leaves the CUDA context unusable, so it runs in
    a process of its own."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


def test_engine_serves_through_the_fused_kernel(cuda):
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig

    n_wk = (np.eye(8, dtype=np.int32) * 80).repeat(10, 0)
    model = FrozenLDAModel.from_numpy(n_wk, n_wk.sum(0), {"num_topics": 8},
                                      device=cuda)
    docs = [np.arange(t * 10, t * 10 + 9) for t in range(8)]
    ops.reset_launch_counts()
    for mode in ("throughput", "latency"):
        thetas = LDAEngine(model, LDAServeConfig(
            buckets=(16,), mode=mode, algorithm="zen_pallas")
        ).infer_batch(docs)
        assert [int(np.argmax(th)) for th in thetas] == list(range(8))
    assert ops.launch_counts()["zen_fused_infer_sample"] > 0


# -- training kernels (csrc/zen_train.cu) --------------------------------------

def _train_inputs(dev, seed, t, k, w, d):
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    doc = torch.randint(0, d, (t,), generator=g, device=dev, dtype=i32)
    z = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    n_wk = torch.randint(0, 50, (w, k), generator=g, device=dev, dtype=i32)
    n_kd = torch.randint(0, 9, (d, k), generator=g, device=dev, dtype=i32)
    ones = torch.ones(t, dtype=i32, device=dev)
    n_wk.index_put_((word.long(), z.long()), ones, accumulate=True)
    n_kd.index_put_((doc.long(), z.long()), ones, accumulate=True)
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, doc=doc, z=z,
                alpha=torch.rand(k, generator=g, device=dev) * 0.1,
                n_k=n_wk.sum(0).to(torch.float32))


@pytest.mark.parametrize("t,k,w,d", [(8192, 1000, 20000, 40),
                                     (333, 37, 50, 3), (1, 5, 2, 1)])
def test_training_kernels_match_plain_version_on_card(cuda, t, k, w, d):
    from repro_torch.kernels.fused_gather import zen_fused_sample_plain

    a = _train_inputs(cuda, t + k, t, k, w, d)
    args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
            a["n_k"], 12345)
    kw = dict(beta=0.01, w_beta=w * 0.01)
    before = ops.launch_counts()
    fused = ops.zen_fused_sample(*args, **kw)
    gathered = ops.zen_sample(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["doc"].long()].contiguous(), a["z"], a["alpha"],
        a["n_k"], 12345, **kw)
    plain = zen_fused_sample_plain(*args, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["zen_fused_sample"] == before["zen_fused_sample"] + 1
    assert after["zen_sample"] == before["zen_sample"] + 1
    assert torch.equal(fused, gathered)
    assert int(fused.min()) >= 0 and int(fused.max()) < k
    bad = (fused != plain).nonzero().flatten().tolist()
    for i in bad:  # a mismatch must be a near-tie of the two scores
        cand = torch.tensor([int(fused[i]), int(plain[i])], device=cuda)
        hit = (cand == a["z"][i]).float()
        wi, di = int(a["word"][i]), int(a["doc"][i])
        nw = a["n_wk"][wi, cand].float() - hit
        nd = a["n_kd"][di, cand].float() - hit
        al = a["alpha"][cand]
        p = (al * 0.01 + nw * al + nd * (nw + 0.01)) \
            / (a["n_k"][cand] - hit + w * 0.01)
        s = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(12345, i, cand)
        assert abs(float(s[0] - s[1])) <= NEAR_TIE
    assert len(bad) <= max(1, t // 10000)


_OUT_OF_RANGE_DOC = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
i32 = torch.int32
n_wk = torch.ones((10, 16), dtype=i32, device=d)
vec = torch.zeros(64, dtype=i32, device=d)
doc = vec.clone()
doc[7] = 2  # D
try:
    ops.zen_fused_sample(
        n_wk, torch.ones((2, 16), dtype=i32, device=d), vec, doc, vec,
        torch.full((16,), 0.1, device=d), n_wk.sum(0).float(), 5,
        beta=0.01, w_beta=0.1)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


def test_out_of_range_doc_raises_in_training_kernel(cuda):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE_DOC],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("kernels,kernel", [("auto", "zen_fused_sample"),
                                            ("off", "zen_sample")])
def test_train_session_runs_through_the_training_kernels(cuda, kernels,
                                                         kernel):
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus, _ = synthetic_lda_corpus(0, 200, 300, 10, 50)
    sess = TrainSession(corpus, LDAHyperParams(num_topics=10, alpha=0.1),
                        RunConfig(algorithm="zen_pallas", kernels=kernels),
                        device=cuda)
    st = sess.init(0)
    llh0 = sess.llh(st)
    ops.reset_launch_counts()
    for _ in range(3):
        st = sess.step(st)
        st.check_invariants(sess.corpus)
    counts = ops.launch_counts()
    assert counts[kernel] == 3
    assert all(v == 0 for name, v in counts.items() if name != kernel)
    assert sess.llh(st) > llh0


# -- the sparse-row kernel (csrc/sparse_row.cu) -------------------------------

@pytest.mark.parametrize("j", [1, 5, 31, 32, 33, 128, 352, 1000])
def test_sparse_row_kernel_bit_equal_to_plain_version_on_card(cuda, j):
    from repro_torch.kernels.sparse_row import sparse_row_sample_plain

    t = 4096
    g = torch.Generator(device=cuda).manual_seed(j)
    live = torch.randint(0, j + 1, (t, 1), generator=g, device=cuda)
    lanes = torch.arange(j, device=cuda)[None, :]
    vals = torch.rand((t, j), generator=g, device=cuda)
    vals = torch.where(lanes < live, vals, 0.0)
    topics = torch.sort(torch.randint(0, 1000, (t, j), generator=g,
                                      device=cuda), dim=1).values
    topics = torch.where(lanes < live, topics, 1000).to(torch.int32)
    mass = vals.sum(1)
    tgt = torch.rand(t, generator=g, device=cuda) * mass
    tgt[::7] = mass[::7]  # on the row's mass
    tgt[1::7] = 0.0
    tgt[2::7] = mass[2::7] + 1.0  # above it
    before = ops.launch_counts()["sparse_row_sample"]
    got = ops.sparse_row_sample(vals, topics, tgt)
    want = sparse_row_sample_plain(vals, topics, tgt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sparse_row_sample"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("algorithm,kernels,launches", [
    ("zen_sparse", "auto", True), ("sparselda", "auto", True),
    ("zen_hybrid", "off", True), ("lightlda", "auto", True),
    ("lightlda", "off", False)])
def test_padded_sparse_backends_train_on_card(cuda, algorithm, kernels,
                                              launches):
    """zen_sparse, sparselda and zen_hybrid send every inversion through
    the kernel whatever the policy; lightlda's policy picks the kernel or
    the per-word alias tables."""
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus, _ = synthetic_lda_corpus(0, 200, 300, 10, 50)
    sess = TrainSession(corpus, LDAHyperParams(num_topics=10, alpha=0.1),
                        RunConfig(algorithm=algorithm, kernels=kernels),
                        device=cuda)
    st = sess.init(0)
    llh0 = sess.llh(st)
    ops.reset_launch_counts()
    for _ in range(3):
        st = sess.step(st)
        st.check_invariants(sess.corpus)
    counts = ops.launch_counts()
    assert (counts["sparse_row_sample"] > 0) == launches, counts
    assert all(v == 0 for name, v in counts.items()
               if name != "sparse_row_sample")
    assert sess.llh(st) > llh0


# -- the CDF row search (csrc/cdf_search.cu) ----------------------------------

@pytest.mark.parametrize("t,k,r", [(4096, 1000, 5000), (333, 37, 50),
                                   (1, 5, 2), (2048, 32, 7), (999, 33, 9)])
def test_cdf_search_kernel_bit_equal_to_plain_version_on_card(cuda, t, k, r):
    from repro_torch.kernels.cdf_search import cdf_row_search_plain
    from repro_torch.kernels.ref import cdf_row_search_ref

    g = torch.Generator(device=cuda).manual_seed(t + k)
    counts = torch.randint(0, 50, (r, k), generator=g, device=cuda,
                           dtype=torch.int32)
    counts[0] = 0  # a zero-mass row
    rows = torch.randint(0, r, (t,), generator=g, device=cuda,
                         dtype=torch.int32)
    term = torch.rand(k, generator=g, device=cuda) + 1e-3
    mass = (counts[rows.long()].float() * term).sum(1)
    tgt = torch.rand(t, generator=g, device=cuda) * mass * 1.1
    tgt[::7] = mass[::7]  # on the row's mass
    tgt[1::7] = 0.0
    before = ops.launch_counts()["cdf_row_search"]
    got = ops.cdf_row_search(counts, rows, term, tgt)
    want = cdf_row_search_plain(counts, rows, term, tgt)
    oracle = cdf_row_search_ref(counts, rows, term, tgt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cdf_row_search"] == before + 1
    assert torch.equal(got, want)
    # the oracle counts the whole row; for a non-negative term that is the
    # same count
    assert torch.equal(got, oracle)
    assert int(got.min()) >= 0 and int(got.max()) < k


_OUT_OF_RANGE_ROW = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
counts = torch.ones((10, 16), dtype=torch.int32, device=d)
rows = torch.zeros(64, dtype=torch.int32, device=d)
rows[9] = {row}
try:
    ops.cdf_row_search(counts, rows, torch.ones(16, device=d),
                       torch.full((64,), 3.0, device=d))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("row", [10, -1])
def test_out_of_range_row_raises_in_cdf_search(cuda, row):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE_ROW.format(row=row)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


# -- the topic histogram (csrc/topic_histogram.cu) ----------------------------

@pytest.mark.parametrize("t,r,k,sort", [(100000, 3000, 1000, True),
                                        (100000, 3000, 1000, False),
                                        (33, 5, 9, True), (1, 1, 1, True),
                                        (5000, 1, 7, False)])
def test_topic_histogram_kernel_bit_equal_on_card(cuda, t, r, k, sort):
    from repro_torch.kernels.ref import topic_histogram_ref
    from repro_torch.kernels.topic_histogram import topic_histogram_plain

    g = torch.Generator(device=cuda).manual_seed(t + r + k)
    i32 = torch.int32
    rows = torch.randint(0, r, (t,), generator=g, device=cuda, dtype=i32)
    if sort:
        rows = torch.sort(rows).values
    zo = torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    zn = torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    inc = torch.randint(0, 2, (t,), generator=g, device=cuda, dtype=i32)
    inc[::11] = 3  # any int32 weight
    before = ops.launch_counts()["topic_histogram"]
    got = ops.topic_histogram(rows, zo, zn, inc, r, k)
    want = topic_histogram_plain(rows, zo, zn, inc, r, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["topic_histogram"] == before + 1
    assert torch.equal(got, want)
    if t * k <= 10**6:
        assert torch.equal(got, topic_histogram_ref(rows, zo, zn, inc, r, k))
    assert int(got.sum(1).abs().max()) == 0


_OUT_OF_RANGE_HIST = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
v = torch.zeros(64, dtype=torch.int32, device=d)
rows, zo = v.clone(), v.clone()
{which}[3] = {value}
try:
    ops.topic_histogram(rows, zo, v, v + 1, 4, 8)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("which,value", [("rows", 4), ("zo", 8),
                                         ("zo", -1)])
def test_out_of_range_id_raises_in_topic_histogram(cuda, which, value):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c",
         _OUT_OF_RANGE_HIST.format(which=which, value=value)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


# -- zen_cdf on the card ---------------------------------------------------

@pytest.mark.parametrize("kernels,launches", [("auto", True),
                                              ("off", False)])
def test_zen_cdf_session_on_card_launches_only_kernel_7(cuda, kernels,
                                                        launches):
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus, _ = synthetic_lda_corpus(0, 200, 300, 10, 50)
    sess = TrainSession(corpus, LDAHyperParams(num_topics=10, alpha=0.1),
                        RunConfig(algorithm="zen_cdf", kernels=kernels),
                        device=cuda)
    st = sess.init(0)
    llh0 = sess.llh(st)
    ops.reset_launch_counts()
    for _ in range(3):
        st = sess.step(st)
        st.check_invariants(sess.corpus)
    counts = ops.launch_counts()
    # one token chunk per sweep: two searches (draws a and b) each
    assert counts["cdf_row_search"] == (6 if launches else 0), counts
    assert all(v == 0 for name, v in counts.items()
               if name != "cdf_row_search")
    assert sess.llh(st) > llh0


def test_engine_serves_zen_cdf_on_card(cuda):
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig

    n_wk = (np.eye(8, dtype=np.int32) * 80).repeat(10, 0)
    model = FrozenLDAModel.from_numpy(n_wk, n_wk.sum(0), {"num_topics": 8},
                                      device=cuda)
    docs = [np.arange(t * 10, t * 10 + 9) for t in range(8)]
    ops.reset_launch_counts()
    thetas = LDAEngine(model, LDAServeConfig(
        buckets=(16,), algorithm="zen_cdf")).infer_batch(docs)
    assert [int(np.argmax(th)) for th in thetas] == list(range(8))
    assert all(v == 0 for v in ops.launch_counts().values())
