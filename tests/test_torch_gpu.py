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


# -- serving kernels (csrc/zen_infer.cu): bound, then verify ------------------
# The verified kernels must draw what the exact loop (zen_infer_exact: the
# exact chain for every topic) draws, bit for bit. Their adversarial grid
# is chip_smoke.py's own (SERVE_ADVERSARIAL: +inf noise, also at a z_old
# clamped at p = 1e-30, the forced bucket, exact ties in the bucket, in
# two lanes and in one, the engine's padding, the clamp, K = 1, 5, 37, 36,
# inputs outside the premise, and K = 14,464 / 14,592 / 16,385 about the
# table's move from shared to global memory).
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo's root; stdlib-only at import)


@pytest.mark.parametrize("spec", chip_smoke.SERVE_ADVERSARIAL,
                         ids=[spec[0] for spec in chip_smoke.SERVE_ADVERSARIAL])
def test_serving_kernels_adversarial_grid_on_card(cuda, spec):
    """0 mismatches against the exact loop, fused == gathered and the
    pinned draws (chip_smoke's check: a failure raises SystemExit); the
    launcher keeps the table in shared memory up to K = 14,464."""
    out = chip_smoke.serve_adversarial_check(spec, cuda)
    assert out["mismatches"] == 0 and len(out["stats"]) == 3
    assert out["table"] == ("global" if spec[3] > 14464 else "shared")


@pytest.mark.parametrize("t,k,w,b", [(16384, 1000, 101636, 32),
                                     (4096, 1000, 20000, 8),
                                     (4099, 36, 50, 7), (333, 37, 50, 3),
                                     (1, 5, 2, 1)])
def test_serving_kernels_equal_the_exact_loop_and_stats_add_up(cuda, t, k,
                                                               w, b):
    """Fused == gathered == the exact loop; each token's exact work is its
    own, so the stats of two launches over the halves add up to those of
    one launch over all tokens, and the gathered kernel counts the same."""
    from repro_torch.kernels.fused_gather import (
        zen_fused_infer_sample_cuda,
        zen_infer_exact_cuda,
    )
    from repro_torch.kernels.zen_sampler import zen_infer_sample_cuda

    a = _inputs(cuda, t + k + 1, t, k, w, b)
    names = ("n_wk", "n_kd", "word", "slot", "z", "seeds", "alpha", "n_k")
    args = tuple(a[n] for n in names)
    kw = dict(beta=0.01, w_beta=w * 0.01)
    i64 = torch.int64
    whole, split, g_stats = (torch.zeros(3, dtype=i64, device=cuda)
                             for _ in range(3))
    exact = zen_infer_exact_cuda(*args, **kw)
    fused = zen_fused_infer_sample_cuda(*args, stats=whole, **kw)
    gathered = zen_infer_sample_cuda(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["slot"].long()].contiguous(), a["z"], a["seeds"],
        a["alpha"], a["n_k"], stats=g_stats, **kw)
    h = t // 2
    parts = [zen_fused_infer_sample_cuda(
        *(x[lo:hi] if n in ("word", "slot", "z", "seeds") else x
          for n, x in zip(names, args)), stats=split, **kw)
        for lo, hi in ((0, h), (h, t))]
    torch.cuda.synchronize()
    assert torch.equal(fused, exact) and torch.equal(gathered, exact)
    assert torch.equal(torch.cat(parts), fused)
    assert torch.equal(split, whole) and torch.equal(g_stats, whole)
    forced, cands, exact_loop = whole.tolist()
    assert (exact_loop < t or t == 1) and forced + cands < t * k


def test_serving_fast_estimate_margin_premises_by_exhaustion(cuda):
    """zen_infer.cu's own estimate functions: E1 + E2 + 2^-14 within the
    margin (chip_smoke's check), with the training sampler's constants."""
    out = chip_smoke.margin_premises(cuda, kernels="infer")
    assert out["margin"] == 2.0 ** -8
    assert out["top_bucket"] == (1 << 24) - (1 << 12)
    assert 0.0 < out["E1_log"] and 0.0 < out["E2_noise"]
    assert out["sum"] <= out["margin"]


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
    # the delta merge: kernel 5 twice per step (word and doc rows) where
    # the session dispatches kernels, never under "off"
    assert counts["topic_histogram"] == (6 if kernels == "auto" else 0)
    assert all(v == 0 for name, v in counts.items()
               if name not in (kernel, "topic_histogram"))
    assert sess.llh(st) > llh0


# The adversarial grid of the training kernels is chip_smoke.py's own
# (ADVERSARIAL): +inf noise, the forced top bucket, equal-count rows with
# exact ties, p at the 1e-30 clamp, K = 37, 36 and 10,000, inputs outside
# the fast estimate's premise, and K = 14,464 / 16,384 / 16,385 about the
# table's move from shared to global memory.


@pytest.mark.parametrize("spec", chip_smoke.ADVERSARIAL,
                         ids=[spec[0] for spec in chip_smoke.ADVERSARIAL])
def test_training_kernels_adversarial_grid_on_card(cuda, spec):
    """0 mismatches against the plain version, fused == gathered and the
    pinned draws (chip_smoke's check: a failure raises SystemExit); the
    launcher keeps the table in shared memory up to K = 14,464 and reads
    it from global memory at K = 16,384 and 16,385."""
    out = chip_smoke.adversarial_check(spec, cuda)
    assert out["mismatches"] == 0 and len(out["stats"]) == 3
    assert out["table"] == ("global" if spec[3] >= 16384 else "shared")


def test_fast_estimate_margin_premises_by_exhaustion(cuda):
    """E1 = max |ln2 lg2(x) - logf(x)| over every float x in [1e-30,
    FLT_MAX], E2 = max |noise estimate - noise| over every m below the
    forced bucket, both by the kernel's own estimate functions: E1 + E2 +
    2^-14 (the analytic roundings) within the margin (chip_smoke's
    check)."""
    out = chip_smoke.margin_premises(cuda)
    assert out["margin"] == 2.0 ** -8
    assert out["top_bucket"] == (1 << 24) - (1 << 12)
    assert 0.0 < out["E1_log"] and 0.0 < out["E2_noise"]
    assert out["sum"] <= out["margin"]


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
    assert counts["topic_histogram"] == (6 if kernels == "auto" else 0)
    assert all(v == 0 for name, v in counts.items()
               if name not in ("sparse_row_sample", "topic_histogram"))
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


def _cdf_case(dev, pattern, t=20000, k=1000, r=500):
    """Kernel 7's inputs for one placement of the searching tokens (target
    > 0) among the others: the walk must give each token the plain
    version's count however the searching tokens cluster."""
    g = torch.Generator(device=dev).manual_seed(len(pattern))
    counts = torch.randint(0, 50, (r, k), generator=g, device=dev,
                           dtype=torch.int32)
    counts[3] = 0  # a zero-mass row
    rows = torch.randint(0, r, (t,), generator=g, device=dev,
                         dtype=torch.int32)
    term = torch.rand(k, generator=g, device=dev) + 1e-3
    mass = (counts[rows.long()].float() * term).sum(1)
    live = torch.rand(t, generator=g, device=dev) * mass
    pos = torch.arange(t, device=dev)
    zero = torch.zeros(t, device=dev)
    tgt = {
        "all_zero": zero,
        "all_searching": live,
        "one_per_warp": torch.where(pos % 32 == 5, live, zero),
        "one_full_warp": torch.where((pos >= 64) & (pos < 96), live, zero),
        # longer than a block of the queueing kernel (1,024 tokens)
        "clusters": torch.where((pos % 7000) < 3000, live, zero),
        "negative": torch.where(pos % 3 == 0, live, -live - 1.0),
        # past the row total, and +inf: the clamp to K - 1
        "past_total": torch.where(pos % 2 == 0, mass * 1.5 + 1.0,
                                  torch.full_like(mass, float("inf"))),
    }[pattern]
    return counts, rows, term, tgt.contiguous()


@pytest.mark.parametrize("pattern", ["all_zero", "all_searching",
                                     "one_per_warp", "one_full_warp",
                                     "clusters", "negative", "past_total"])
def test_cdf_search_kernel_on_every_placement_of_searching_tokens(cuda,
                                                                  pattern):
    from repro_torch.kernels.cdf_search import cdf_row_search_plain

    counts, rows, term, tgt = _cdf_case(cuda, pattern)
    before = ops.launch_counts()["cdf_row_search"]
    got = ops.cdf_row_search(counts, rows, term, tgt)
    want = cdf_row_search_plain(counts, rows, term, tgt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cdf_row_search"] == before + 1
    assert torch.equal(got, want)
    assert bool((got[tgt <= 0] == 0).all())
    if pattern == "past_total":
        assert bool((got == counts.shape[1] - 1).all())


@pytest.mark.parametrize("target", [3.0, 0.0])
@pytest.mark.parametrize("row", [10, -1])
def test_out_of_range_row_raises_whether_its_token_searches_or_not(
        cuda, row, target):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    script = _OUT_OF_RANGE_ROW.format(row=row).replace(
        "torch.full((64,), 3.0, device=d)",
        f"torch.full((64,), {target}, device=d)")
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": src})
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


_DECREASING_WALK = """
import torch
from repro_torch.kernels import ops
from repro_torch.kernels.topic_histogram import RowOrder
d = torch.device("cuda", 0)
v = torch.zeros(70000, dtype=torch.int32, device=d)
rows = torch.arange(70000, dtype=torch.int32, device=d) // 100
walk = rows.clone()
walk[{at}] = walk[{at} - 1] - 1  # one decrease along the walk
try:
    ops.topic_histogram(rows, v, v + 1, None, 700, 8,
                        order=RowOrder(rows, walk, None))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("at", [205, 16384, 69999])
def test_rows_decreasing_along_the_walk_raise_in_topic_histogram(cuda, at):
    """A walk whose rows decrease (inside a tile, at a block's first
    position, at the last position) aborts the launch."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _DECREASING_WALK.format(at=at)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


def _hist_case(dev, case, k):
    """Kernel 5's inputs: (rows, z_old, z_new, inc, R), 200,000 tokens in
    row order unless the case says otherwise."""
    g = torch.Generator(device=dev).manual_seed(k + len(case))
    i32 = torch.int32
    t, r = 200_000, 3000
    if case == "slab":  # K about the shared-memory boundaries
        t, r = 40_000, 400
    rows = torch.randint(0, r, (t,), generator=g, device=dev, dtype=i32)
    if case == "hot_25":  # one row holds 25% of the tokens
        rows[::4] = 7
    elif case == "hot_100":
        rows[:] = 7
    elif case == "gaps":  # most rows hold no token
        rows = rows - rows % 97
    if case != "unsorted":
        rows = torch.sort(rows).values
    zo = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    zn = torch.where(torch.rand(t, generator=g, device=dev) < 0.7,
                     torch.randint(0, k, (t,), generator=g, device=dev,
                                   dtype=i32), zo)
    inc = torch.randint(-2, 3, (t,), generator=g, device=dev, dtype=i32)
    if case == "inc_zero":
        inc.zero_()
    return rows, zo, zn, inc, r


def _dirty_pool(dev, shape):
    """Leave a block of the caching allocator full of non-zero bytes, so
    that an output entry the kernel fails to write shows."""
    torch.full(shape, -7, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()


def _boundary_k(dev, which):
    """K on either side of the launcher's two shared-memory boundaries:
    where a histogram per warp stops fitting, and where the block's own
    stops fitting (slabs)."""
    from repro_torch.kernels.topic_histogram import histogram_shape

    fit = histogram_shape(1 << 30, dev)[0]  # the widest slab
    warp_fit = max(k for k in range(fit // 9 - 64, fit // 9 + 64)
                   if histogram_shape(k, dev)[1])
    k = {"warp_fits": warp_fit, "warp_over": warp_fit + 1,
         "slab_fits": fit, "slab_over": fit + 1}[which]
    slab, warp_runs = histogram_shape(k, dev)
    assert warp_runs == (which == "warp_fits")
    assert slab == min(k, fit)
    return k


@pytest.mark.parametrize("case,k", [
    ("hot_25", 1000), ("hot_100", 1000), ("unsorted", 1000),
    ("inc_zero", 1000), ("gaps", 1000), ("plain_rows", 10_000),
    ("hot_25", 10_000), ("plain_rows", 37),
    ("slab", "warp_fits"), ("slab", "warp_over"),
    ("slab", "slab_fits"), ("slab", "slab_over")])
def test_topic_histogram_cases_bit_equal_on_card(cuda, case, k):
    from repro_torch.kernels.topic_histogram import (
        row_order,
        topic_histogram_plain,
    )

    if isinstance(k, str):
        k = _boundary_k(cuda, k)
    rows, zo, zn, inc, r = _hist_case(cuda, case, k)
    want = topic_histogram_plain(rows, zo, zn, inc, r, k)
    for weights in (inc, None):
        if weights is None:
            want = topic_histogram_plain(rows, zo, zn, None, r, k)
        for order in (None, row_order(rows)):
            _dirty_pool(cuda, (r, k))
            before = ops.launch_counts()["topic_histogram"]
            got = ops.topic_histogram(rows, zo, zn, weights, r, k,
                                      order=order)
            torch.cuda.synchronize()
            assert ops.launch_counts()["topic_histogram"] == before + 1
            assert torch.equal(got, want), (case, k, weights is None,
                                            order is None)


def test_topic_histogram_of_no_token_is_zero_on_card(cuda):
    e = torch.empty(0, dtype=torch.int32, device=cuda)
    _dirty_pool(cuda, (30, 40))
    got = ops.topic_histogram(e, e, e, e, 30, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("algorithm", ["zen", "zen_pallas", "zen_sparse"])
def test_session_merge_runs_kernel_5_only_when_dispatched(cuda, algorithm):
    """The delta merge launches kernel 5 twice per step under "auto" and
    never under "off", and both give the same counts."""
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_corpus(0, 300, 400, 60)  # Zipf words: hot rows
    states = {}
    for kernels in ("auto", "off"):
        sess = TrainSession(corpus, LDAHyperParams(num_topics=16),
                            RunConfig(algorithm=algorithm, kernels=kernels),
                            device=cuda)
        st = sess.init(0)
        ops.reset_launch_counts()
        for _ in range(3):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
        hist = ops.launch_counts()["topic_histogram"]
        assert hist == (6 if kernels == "auto" else 0), (kernels, hist)
        states[kernels] = st
    # the same draws on either route (zen_pallas: fused == gathered)
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        assert torch.equal(getattr(states["auto"], name),
                           getattr(states["off"], name)), name


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
    # one token chunk per sweep: two searches (draws a and b) each; the
    # delta merge two histograms per step
    assert counts["cdf_row_search"] == (6 if launches else 0), counts
    assert counts["topic_histogram"] == (6 if launches else 0), counts
    assert all(v == 0 for name, v in counts.items()
               if name not in ("cdf_row_search", "topic_histogram"))
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
