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


# -- zen_cdf's term-3 doc-row search (csrc/cdf_search.cu) --------------------

def _doc_row_case(dev, t, k, j, w=20000, d=None, seed=0):
    """NYTimes-like inputs of the doc-row search: doc rows of distinct
    topics with counts falling to a zero tail of random length (one row all
    zero), tokens doc by doc, and uniforms that include 0 and 1 (t3 on the
    row's mass: the clamp to J - 1)."""
    g = torch.Generator(device=dev).manual_seed(seed + t + k + j)
    i32 = torch.int32
    d = d or max(2, t // 300)
    n_wk = torch.randint(0, 50, (w, k), generator=g, device=dev, dtype=i32)
    n_wk[torch.rand((w, k), generator=g, device=dev) < 0.6] = 0
    live = torch.randint(0, j + 1, (d, 1), generator=g, device=dev)
    live[1] = 0
    cnt = torch.randint(1, 30, (d, j), generator=g, device=dev)
    cnt = torch.sort(cnt, dim=1, descending=True).values
    kd_cnt = torch.where(torch.arange(j, device=dev) < live, cnt, 0).to(i32)
    kd_idx = torch.argsort(torch.rand((d, k), generator=g, device=dev),
                           dim=1)[:, :j].to(i32).contiguous()
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    doc = torch.sort(torch.randint(0, d, (t,), generator=g, device=dev)
                     ).values.to(i32)
    t1 = torch.rand(k, generator=g, device=dev) * 1e-3 + 1e-5
    m2_all = torch.rand(w, generator=g, device=dev) * 0.05
    g_cdf = torch.cumsum(torch.rand(k, generator=g, device=dev) * 1e-4, 0)
    u = torch.rand((3, t), generator=g, device=dev)
    u[0, ::97] = 0.0
    u[1, ::89] = 1.0
    return (n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf, u[0], u[1])


@pytest.mark.parametrize("t,k,j", [(1 << 17, 1000, 128), (50000, 1000, 100),
                                   (20000, 300, 37), (6000, 1000, 200),
                                   (3000, 64, 64), (33, 5, 1)])
def test_doc_row_search_kernel_bit_equal_to_plain_version_on_card(cuda, t,
                                                                  k, j):
    """A NYTimes-like chunk (K 1000, J 128), ragged J (100, 37, 1), a row
    wider than the kernel's registers (200: two passes) and J == K."""
    from repro_torch.kernels.cdf_search import doc_row_search_plain

    args = _doc_row_case(cuda, t, k, j)
    before = ops.launch_counts()["doc_row_search"]
    total, z = ops.doc_row_search(*args, beta=0.01)
    want_total, want_z = doc_row_search_plain(*args, 0.01)
    torch.cuda.synchronize()
    assert ops.launch_counts()["doc_row_search"] == before + 1
    assert torch.equal(total, want_total)
    assert torch.equal(z, want_z)
    kd_idx, doc = args[4], args[2].long()
    assert bool((kd_idx[doc] == z[0].long()[:, None]).any(1).all())


_OUT_OF_RANGE_DOC_ROW = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
i32 = torch.int32
ids = [torch.zeros(64, dtype=i32, device=d) for _ in range(2)]
ids[{which}][9] = {value}
try:
    ops.doc_row_search(
        torch.ones((10, 16), dtype=i32, device=d), ids[0], ids[1],
        torch.ones((5, 4), dtype=i32, device=d),
        torch.zeros((5, 4), dtype=i32, device=d), torch.ones(16, device=d),
        torch.ones(10, device=d), torch.ones(16, device=d),
        torch.full((64,), 0.5, device=d), torch.full((64,), 0.5, device=d),
        beta=0.01)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("which,value", [(0, 10), (1, 5), (1, -1)])
def test_out_of_range_id_raises_in_doc_row_search(cuda, which, value):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c",
         _OUT_OF_RANGE_DOC_ROW.format(which=which, value=value)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("use_kernel", [True, False])
def test_kernel_route_allocates_no_chunk_by_row_tensor_on_card(cuda,
                                                               use_kernel):
    """The token path at T = 2^18, J = 128: on the kernel route the peak
    above what was allocated stays under half of one (T, J) float32 array;
    the plain route, the control, allocates several."""
    from repro_torch.algorithms import zen_cdf as zc
    from repro_torch.core.types import LDAHyperParams

    t, k, j, w, d = 1 << 18, 1000, 128, 20000, 800
    g = torch.Generator(device=cuda).manual_seed(3)
    i32 = torch.int32
    n_wk = torch.randint(0, 20, (w, k), generator=g, device=cuda, dtype=i32)
    n_kd = torch.randint(0, 3, (d, k), generator=g, device=cuda, dtype=i32)
    word = torch.randint(0, w, (t,), generator=g, device=cuda, dtype=i32)
    doc = torch.sort(torch.randint(0, d, (t,), generator=g, device=cuda)
                     ).values.to(i32)
    z_old = torch.randint(0, k, (t,), generator=g, device=cuda, dtype=i32)
    hyper = LDAHyperParams(num_topics=k)
    tables = zc.build_cdf_tables(
        n_wk, n_kd, n_kd.sum(0), hyper, w, j,
        zc.KERNEL_ROUTE if use_kernel else zc.PLAIN_ROUTE)
    u = torch.rand((3, t), generator=g, device=cuda)
    zc.zen_cdf_tokens(tables, word, doc, z_old, n_wk, n_kd, hyper, u)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    zc.zen_cdf_tokens(tables, word, doc, z_old, n_wk, n_kd, hyper, u)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda) - base
    if use_kernel:
        assert rise < t * j * 4 // 2, rise
    else:
        assert rise > t * j * 4, rise


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
    # one token chunk per sweep: two searches (draws a and b), and one
    # doc-row search, uniforms, draws and remedy launch each; the delta
    # merge two histograms per step
    once = ("doc_row_search", "cdf_uniforms", "cdf_draws", "cdf_remedy")
    assert counts["cdf_row_search"] == (6 if launches else 0), counts
    for name in once:
        assert counts[name] == (3 if launches else 0), counts
    assert counts["topic_histogram"] == (6 if launches else 0), counts
    assert all(v == 0 for name, v in counts.items()
               if name not in ("cdf_row_search", "topic_histogram") + once)
    assert sess.llh(st) > llh0


def test_zen_cdf_launches_the_doc_row_search_once_a_chunk_on_card(
        cuda, monkeypatch):
    """1,099,652 tokens in chunks of the kernel route's width (one chunk),
    of 2^20 tokens (the off route's at max_kd 128, two chunks) and of 4,099
    tokens: one doc-row search, uniforms, draws and remedy launch and two
    kernel-7 searches a chunk, and the topics after two sweeps bit-equal
    across the three widths."""
    from repro_torch.algorithms import zen_cdf as zc
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus, _ = synthetic_lda_corpus(0, 2200, 300, 10, 500)
    hyper = LDAHyperParams(num_topics=10, alpha=0.1)
    states, chunk_counts = [], []
    for width in (zc.CDF_KERNEL_CHUNK_TOKENS, 1 << 20, 4099):
        monkeypatch.setattr(zc, "CDF_KERNEL_CHUNK_TOKENS", width)
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm="zen_cdf", max_kd=8), device=cuda)
        st = sess.init(0)
        ops.reset_launch_counts()
        for _ in range(2):
            st = sess.step(st)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        chunks = -(-sess.corpus.num_tokens // width)
        for name in ("doc_row_search", "cdf_uniforms", "cdf_draws",
                     "cdf_remedy"):
            assert counts[name] == 2 * chunks, (name, chunks, counts)
        assert counts["cdf_row_search"] == 4 * chunks, (chunks, counts)
        states.append(st.topic.cpu())
        chunk_counts.append(chunks)
    assert chunk_counts == [1, 2, 269]
    assert torch.equal(states[0], states[1])
    assert torch.equal(states[0], states[2])


# -- zen_cdf's uniforms, draws and remedy (csrc/cdf_tokens.cu) ---------------

def _glue_case(dev, t, k=1000, w=20000, seed=0):
    """Inputs of the draws and the remedy at NYTimes-like widths: masses
    that give each of the three branches, term-3 topics, kernel 7's
    answers, and previous topics equal to draw a's topic for half the
    tokens (so the remedy engages)."""
    g = torch.Generator(device=dev).manual_seed(seed + t)
    i32 = torch.int32
    d = max(2, t // 300)
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    doc = torch.sort(torch.randint(0, d, (t,), generator=g, device=dev)
                     ).values.to(i32)
    g_cdf = torch.cumsum(torch.rand(k, generator=g, device=dev) * 1e-4, 0)
    m2_all = torch.rand(w, generator=g, device=dev) * 0.05
    total = g_cdf[-1] + m2_all[word.long()] + torch.rand(
        t, generator=g, device=dev) * 0.1
    z_d = torch.randint(0, k, (2, t), generator=g, device=dev, dtype=i32)
    z_w = torch.randint(0, k, (2, t), generator=g, device=dev, dtype=i32)
    n_wk = torch.randint(0, 6, (w, k), generator=g, device=dev, dtype=i32)
    n_kd = torch.randint(0, 4, (d, k), generator=g, device=dev, dtype=i32)
    return word, doc, g_cdf, m2_all, total, z_d, z_w, n_wk, n_kd


@pytest.mark.parametrize("t", [1 << 24, 1 << 20, 4099])
@pytest.mark.parametrize("indexed", [False, True])
def test_glue_kernels_bit_equal_to_plain_versions_on_card(cuda, t, indexed):
    """The uniforms (from a start past 2^32, or a mesh cell's int32 corpus
    indices), the draws and the remedy, each launch against its plain
    version on the same inputs: bit-equal at a path chunk (2^24 tokens),
    2^20 and 4,099; every branch taken and the remedy engaged."""
    from repro_torch.core.keys import stream_uniforms
    from repro_torch.kernels import cdf_tokens as ct

    word, doc, g_cdf, m2_all, total, z_d, z_w, n_wk, n_kd = _glue_case(
        cuda, t)
    seed, start = 2**31 - 3, 2**32 - t // 2
    if indexed:
        start = torch.randint(0, 2**31 - 1, (t,), device=cuda,
                              dtype=torch.int32)
    before = ops.launch_counts()
    u = ops.cdf_uniforms(seed, start, t, 3, device=cuda)
    assert torch.equal(u, stream_uniforms(seed, start, t, 3, cuda))
    targets, code = ops.cdf_draws(word, total, u[0], u[1], m2_all, g_cdf,
                                  z_d)
    want_targets, want_code = ct.cdf_draws_plain(word, total, u[0], u[1],
                                                 m2_all, g_cdf, z_d)
    assert torch.equal(targets, want_targets)
    assert torch.equal(code, want_code)
    assert bool((code[0] >= 0).any() and (code[0] == -1).any()
                and (code[0] < -1).any())
    z1 = torch.clamp_max(torch.where(code[0] >= 0, code[0], torch.where(
        code[0] == -1, z_w[0], -2 - code[0])), 999)
    z_old = torch.where(torch.arange(t, device=cuda) % 2 == 0, z1,
                        torch.randint(0, 1000, (t,), device=cuda,
                                      dtype=torch.int32))
    args = (code, z_w[0], z_w[1], z_old, word, doc, n_wk, n_kd, u[2])
    got = ops.cdf_remedy(*args)
    want, second = ct.cdf_remedy_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0 < int(second.sum()) < t
    after = ops.launch_counts()
    for name in ("cdf_uniforms", "cdf_draws", "cdf_remedy"):
        assert after[name] == before[name] + 1, name


def test_zen_cdf_session_bit_equal_to_the_plain_glue_on_card(cuda,
                                                             monkeypatch):
    """Two sweeps of a ``zen_cdf`` session on the kernel route, and again
    with the uniforms, draws and remedy run as their plain versions on
    the card: the same topics and counts."""
    from repro_torch.algorithms import zen_cdf as zc
    from repro_torch.core.keys import stream_uniforms
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.kernels import cdf_tokens as ct
    from repro_torch.train.session import RunConfig, TrainSession

    corpus, _ = synthetic_lda_corpus(0, 2200, 300, 64, 500)
    hyper = LDAHyperParams(num_topics=64, alpha=0.1)
    states = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(zc, "KERNEL_ROUTE", zc.KERNEL_ROUTE._replace(
                uniforms=stream_uniforms, draws=ct.cdf_draws_plain,
                remedy=lambda *a, count=False: ct.cdf_remedy_plain(*a)[0]))
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm="zen_cdf", max_kd=8), device=cuda)
        st = sess.init(0)
        ops.reset_launch_counts()
        for _ in range(2):
            st = sess.step(st)
        torch.cuda.synchronize()
        assert ops.launch_counts()["cdf_remedy"] == (0 if plain else 2)
        states.append(st)
    for name in ("topic", "n_wk", "n_kd", "n_k"):
        assert torch.equal(getattr(states[0], name),
                           getattr(states[1], name)), name


_OUT_OF_RANGE_GLUE = """
import torch
from repro_torch.kernels import ops
d = torch.device("cuda", 0)
i32 = torch.int32
ids = [torch.zeros(64, dtype=i32, device=d) for _ in range(3)]
ids[{which}][9] = {value}
word, doc, z_old = ids
u = torch.full((64,), 0.5, device=d)
try:
    if {which} == 0:
        ops.cdf_draws(word, u, u, u, torch.ones(10, device=d),
                      torch.arange(1.0, 17.0, device=d),
                      torch.zeros((2, 64), dtype=i32, device=d))
    else:
        code = torch.zeros((2, 64), dtype=i32, device=d)
        ops.cdf_remedy(code, z_old, z_old, z_old, word, doc,
                       torch.ones((10, 16), dtype=i32, device=d),
                       torch.ones((5, 16), dtype=i32, device=d), u)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("RAISED", e)
"""


@pytest.mark.parametrize("which,value", [(0, 10), (2, 16), (2, -1)])
def test_out_of_range_id_raises_in_the_glue_kernels(cuda, which, value):
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-c",
         _OUT_OF_RANGE_GLUE.format(which=which, value=value)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src})
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr


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


def _stream_on_card(cuda, kernels, algorithm="zen_pallas"):
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.data.stream import ReplaySource
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    corpus = synthetic_corpus(1, num_docs=300, num_words=500, avg_doc_len=40)
    src = ReplaySource(corpus, window_docs=128, epochs=2)  # 128, 128, 44
    sess = StreamingSession(
        src, LDAHyperParams(num_topics=64),
        RunConfig(algorithm=algorithm, kernels=kernels, num_iterations=0,
                  window_docs=128, window_sweeps=2), device=cuda)
    metrics = []
    ops.reset_launch_counts()
    sess.run(0, callback=lambda s, m: metrics.append(m))
    torch.cuda.synchronize()
    return sess, metrics, ops.launch_counts()


def test_stream_on_kernels_equals_kernels_off_on_card(cuda):
    """Six windows (two epochs of three) of ``zen_pallas``: the fused
    kernel and kernel 5's merge (``auto``) against the gathered kernel and
    the plain merge (``off``): the same counts, retained topics and window
    llh, since every kernel is exact against its plain version."""
    a, ma, ca = _stream_on_card(cuda, "auto")
    b, mb, cb = _stream_on_card(cuda, "off")
    assert torch.equal(a.n_wk, b.n_wk) and torch.equal(a.n_k, b.n_k)
    assert sorted(a._retained) == sorted(b._retained) == ["w0", "w1", "w2"]
    for uid, z in a._retained.items():
        np.testing.assert_array_equal(z, b._retained[uid])
    assert [m["llh"] for m in ma] == [m["llh"] for m in mb]
    assert a.n_wk.device.type == "cuda"
    assert {n: v for n, v in ca.items() if v} == {
        "zen_fused_sample": 12, "topic_histogram": 24}
    assert {n: v for n, v in cb.items() if v} == {"zen_sample": 12}
    st = a.assembled_state()
    assert torch.equal(st.n_wk, a.n_wk) and torch.equal(st.n_k, a.n_k)


@pytest.mark.parametrize("algorithm", ["zen_pallas", "zen_cdf"])
def test_zero_token_window_on_card(cuda, tmp_path, algorithm):
    """A libsvm window of documents without tokens passes through the
    kernels' paths: nothing is launched for its sweeps but kernel 5's
    zero fill, and the model keeps the earlier window's counts."""
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import save_libsvm, synthetic_corpus
    from repro_torch.data.stream import LibsvmStreamSource
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    path = str(tmp_path / "s.libsvm")
    c = synthetic_corpus(2, num_docs=3, num_words=50, avg_doc_len=20)
    save_libsvm(c, path)
    with open(path, "a") as f:
        f.write("0\n0\n0\n")
    sess = StreamingSession(
        LibsvmStreamSource(path, 3, 50), LDAHyperParams(num_topics=16),
        RunConfig(algorithm=algorithm, num_iterations=0, window_docs=3,
                  max_kd=8 if algorithm == "zen_cdf" else 0), device=cuda)
    metrics = []
    sess.run(0, callback=lambda s, m: metrics.append(m))
    torch.cuda.synchronize()
    assert [m["tokens"] for m in metrics] == [c.num_tokens, 0]
    assert metrics[1]["llh"] == 0.0
    assert int(sess.n_wk.sum()) == c.num_tokens
    assert torch.equal(sess.n_k, sess.n_wk.sum(0).to(torch.int32))


def test_reload_under_ticker_while_watcher_builds_on_card(cuda, tmp_path):
    """A throughput engine on the card under its background ticker and a
    client, following a checkpoint directory: the watcher thread builds
    each new model on the card while the ticker launches sweeps; every
    ticket finishes with a finite theta, versions never decrease."""
    import threading
    import time

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig
    from repro_torch.train.checkpoint import save_lda_model

    rng = np.random.default_rng(0)
    w, k = 2000, 64
    hyper = LDAHyperParams(num_topics=k)
    models = [rng.integers(0, 30, (w, k)).astype(np.int32) for _ in range(3)]
    td = str(tmp_path)
    save_lda_model(td, models[0], models[0].sum(0), hyper, step=1)
    eng = LDAEngine(FrozenLDAModel.from_checkpoint(td, device=cuda),
                    LDAServeConfig(buckets=(32, 64), max_batch=8,
                                   num_sweeps=4, algorithm="zen_pallas"))
    eng.start(0.001)
    eng.watch_checkpoint_dir(td, period=0.02, initial_step=1)
    stop = threading.Event()
    tickets, lock = [], threading.Lock()

    def client():
        r = np.random.default_rng(1)
        while not stop.is_set():
            doc = r.integers(0, w, size=int(r.integers(5, 60)))
            with lock:
                tickets.append(eng.submit_async(doc))
            time.sleep(0.001)

    t = threading.Thread(target=client)
    t.start()
    try:
        for step, n in ((2, models[1]), (3, models[2])):
            time.sleep(0.2)
            save_lda_model(td, n, n.sum(0), hyper, step=step)
            deadline = time.monotonic() + 30
            while eng.model_version < step - 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        time.sleep(0.1)
    finally:
        stop.set()
        t.join(timeout=30)
        with lock:
            reqs = [eng.request(tk) for tk in tickets]
            thetas = [eng.result(tk, timeout=60) for tk in tickets]
        err = eng.stop_watching()
        eng.stop()
    assert not t.is_alive()
    assert err is None and eng.model_version == 2 and eng.reloads == 2
    assert eng.model.device.type == "cuda"
    assert torch.equal(eng.model.n_wk.cpu(), torch.from_numpy(models[2]))
    assert len(thetas) == len(tickets) > 0
    assert all(np.isfinite(th).all() for th in thetas)
    versions = [r.model_version for r in reqs]
    assert versions[-1] == 2 and set(versions) <= {0, 1, 2}


def test_stream_entry_points_default_to_cuda_on_card(cuda):
    from repro_torch.core.types import CGSState, LDAHyperParams
    from repro_torch.data.stream import DriftSource
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    sess = StreamingSession(DriftSource(0, 4, 1, 30),
                            LDAHyperParams(num_topics=4),
                            RunConfig(window_docs=4))
    assert sess.device.type == "cuda" and sess.n_wk.device.type == "cuda"
    sess.run(0)
    assert sess.windows_done == 1 and sess.n_wk.device.type == "cuda"
    z = np.zeros(3, np.int32)
    st = CGSState.from_numpy({"topic": z, "prev_topic": z,
                              "n_wk": np.eye(4, dtype=np.int32)[:, :4],
                              "n_kd": np.zeros((1, 4), np.int32),
                              "n_k": np.ones(4, np.int32),
                              "rng": np.zeros(2, np.uint32)})
    assert st.topic.device.type == "cuda" and st.n_wk.device.type == "cuda"


# -- quality evaluation and telemetry on the card -----------------------------

def _coherence_corpus(seed, d=400, w=300, mean_len=40):
    rng = np.random.default_rng(seed)
    lens = rng.poisson(mean_len, d)
    lens[:3] = (0, 5, 10)
    doc = np.repeat(np.arange(d), lens).astype(np.int32)
    zipf = 1.0 / np.arange(1, w + 1) ** 1.1
    word = rng.choice(w, size=doc.size, p=zipf / zipf.sum()).astype(np.int32)
    return word, doc, d, w


@pytest.mark.parametrize("window", [1, 4, 10])
def test_coherence_integers_on_card_equal_cpu(cuda, window):
    from repro_torch.eval import CoherenceStats, top_topic_words

    word, doc, d, w = _coherence_corpus(window)
    cpu = CoherenceStats(torch.from_numpy(word), torch.from_numpy(doc), d,
                         window=window, num_words=w)
    card = CoherenceStats(torch.from_numpy(word).to(cuda),
                          torch.from_numpy(doc).to(cuda), d, window=window,
                          num_words=w)
    assert card.num_windows == cpu.num_windows
    ids = np.arange(w)
    np.testing.assert_array_equal(card.doc_freq(ids), cpu.doc_freq(ids))
    np.testing.assert_array_equal(card.window_count(ids),
                                  cpu.window_count(ids))
    rng = np.random.default_rng(window)
    n_wk = rng.integers(0, 5, (w, 40)).astype(np.int32)
    top = top_topic_words(torch.from_numpy(n_wk).to(cuda), 10)
    np.testing.assert_array_equal(
        top.cpu().numpy(), top_topic_words(torch.from_numpy(n_wk), 10).numpy())
    # numpy inputs are counted on the card by default
    assert top_topic_words(n_wk, 10).device.type == "cuda"
    host_in = CoherenceStats(word, doc, d, window=window, num_words=w)
    assert host_in.device.type == "cuda"
    assert host_in.num_windows == cpu.num_windows
    a = np.repeat(top.cpu().numpy()[:, :1], 9, 1).ravel()
    b = top.cpu().numpy()[:, 1:].ravel()
    np.testing.assert_array_equal(card.co_doc_freq(a, b),
                                  cpu.co_doc_freq(a, b))
    np.testing.assert_array_equal(card.co_window_count(a, b),
                                  cpu.co_window_count(a, b))


def test_left_to_right_on_card_equals_cpu_but_counted_near_ties(cuda):
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.eval import left_to_right_llh_batch

    rng = np.random.default_rng(5)
    w, k = 500, 300
    n_wk = rng.integers(0, 40, (w, k)).astype(np.int32)
    n_k = n_wk.sum(0).astype(np.int32)
    hyper = LDAHyperParams(num_topics=k, alpha=0.1, beta=0.01)
    docs = [rng.integers(0, w, int(n)) for n in rng.integers(0, 24, 30)]

    def run(dev):
        return left_to_right_llh_batch(
            torch.from_numpy(n_wk).to(dev), torch.from_numpy(n_k).to(dev),
            docs, hyper, num_particles=10,
            rngs=[np.random.default_rng((0, 1, i)) for i in range(len(docs))])

    cpu, cpu_near = run("cpu")
    card, card_near = run(cuda)
    assert not cpu_near.any()
    gap = np.abs(card - cpu) / np.maximum(np.abs(cpu), 1.0)
    clean = card_near == 0
    print(f"left-to-right on the card: {int(card_near.sum())} near-ties in "
          f"{int((~clean).sum())} of {len(docs)} documents, largest "
          f"relative gap {gap.max():.3e} ({gap[clean].max():.3e} where "
          f"none)")
    # a document with no near-tie draws the host's particles exactly
    assert clean.any() and gap[clean].max() <= 1e-10
    assert np.isfinite(card).all()


def test_nnz_row_stats_from_a_card_tensor_equal_numpy(cuda):
    from repro_torch.observe.metrics import nnz_row_stats

    rng = np.random.default_rng(2)
    counts = ((rng.random((3000, 1000)) < 0.07)
              * rng.integers(1, 9, (3000, 1000))).astype(np.int32)
    assert nnz_row_stats(torch.from_numpy(counts).to(cuda)) == \
        nnz_row_stats(counts)


def test_quality_and_telemetry_leave_a_card_run_bit_identical(cuda,
                                                             tmp_path):
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.observe.metrics import read_jsonl
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_corpus(0, num_docs=300, num_words=2000,
                              avg_doc_len=60)
    hyper = LDAHyperParams(num_topics=64)
    base = dict(algorithm="zen_pallas", num_iterations=3, eval_every=1)
    runs = []
    for extra in ({}, dict(quality_every=1, quality_l2r_docs=8,
                           metrics_out=str(tmp_path / "m.jsonl"))):
        sess = TrainSession(corpus, hyper, RunConfig(**base, **extra),
                            device=cuda)
        seen = []
        st = sess.run(0, callback=lambda s, m: seen.append(m))
        runs.append((st, seen))
    (a, ma), (b, mb) = runs
    assert torch.equal(a.topic, b.topic) and torch.equal(a.n_wk, b.n_wk)
    assert [m["llh"] for m in ma] == [m["llh"] for m in mb]
    assert all(np.isfinite(m["coherence_npmi"]) for m in mb)
    assert [r["iteration"] for r in read_jsonl(str(tmp_path / "m.jsonl"))
            if r["kind"] == "train_iter"] == [1, 2, 3]


@pytest.mark.parametrize("t,k,w,d,row0", [(8192, 1000, 20000, 40, 1000),
                                          (333, 37, 50, 3, 0)])
def test_training_kernels_token_index_equals_row_offset_on_card(
        cuda, t, k, w, d, row0):
    """Kernels 1-2 with a per-token index ``row0 + t`` draw what their
    index-free launch at ``row_offset=row0`` draws (every draw kept)."""
    a = _train_inputs(cuda, t + k + 1, t, k, w, d)
    args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
            a["n_k"], 777)
    kw = dict(beta=0.01, w_beta=w * 0.01)
    index = torch.arange(row0, row0 + t, dtype=torch.int32, device=cuda)
    rows = (a["n_wk"][a["word"].long()].contiguous(),
            a["n_kd"][a["doc"].long()].contiguous())
    before = ops.launch_counts()
    fused = ops.zen_fused_sample(*args, row_offset=row0, **kw)
    fused_i = ops.zen_fused_sample(*args, token_index=index, **kw)
    gathered = ops.zen_sample(*rows, a["z"], a["alpha"], a["n_k"], 777,
                              row_offset=row0, **kw)
    gathered_i = ops.zen_sample(*rows, a["z"], a["alpha"], a["n_k"], 777,
                                token_index=index, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["zen_fused_sample"] == before["zen_fused_sample"] + 2
    assert after["zen_sample"] == before["zen_sample"] + 2
    assert torch.equal(fused_i, fused) and torch.equal(gathered_i, gathered)
    assert torch.equal(fused, gathered)


def test_training_kernels_permuted_tokens_permute_the_draws_on_card(cuda):
    """Tokens launched in the order pi with index pi draw, each, what it
    draws at its own place: a mesh cell's reordered tokens keep the single
    box's draws."""
    t, k, w, d = 6000, 300, 5000, 30
    a = _train_inputs(cuda, 99, t, k, w, d)
    kw = dict(beta=0.01, w_beta=w * 0.01)
    g = torch.Generator(device=cuda).manual_seed(5)
    pi = torch.randperm(t, generator=g, device=cuda)
    base = ops.zen_fused_sample(a["n_wk"], a["n_kd"], a["word"], a["doc"],
                                a["z"], a["alpha"], a["n_k"], 4242, **kw)
    p = pi.long()
    pi32 = pi.to(torch.int32).contiguous()
    fused = ops.zen_fused_sample(
        a["n_wk"], a["n_kd"], a["word"][p].contiguous(),
        a["doc"][p].contiguous(), a["z"][p].contiguous(), a["alpha"],
        a["n_k"], 4242, token_index=pi32, **kw)
    gathered = ops.zen_sample(
        a["n_wk"][a["word"][p].long()].contiguous(),
        a["n_kd"][a["doc"][p].long()].contiguous(), a["z"][p].contiguous(),
        a["alpha"], a["n_k"], 4242, token_index=pi32, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fused, base[p]) and torch.equal(gathered, base[p])


_NCCL_WORLD_OF_ONE = """
import os, tempfile
import torch, torch.distributed as dist
from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.kernels import ops
from repro_torch.train.session import RunConfig, TrainSession

dev = torch.device("cuda", 0)
rdv = os.path.join(tempfile.mkdtemp(), "rdv")
dist.init_process_group("nccl", init_method="file://" + rdv, rank=0,
                        world_size=1, device_id=dev)
corpus = synthetic_corpus(0, num_docs=300, num_words=2000, avg_doc_len=60)
hyper = LDAHyperParams(num_topics=64)
runs = {}
for shape, kernels in ((None, "auto"), ((1, 1), "auto"), ((1, 1), "off")):
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_pallas", mesh_shape=shape, exclusion_start=2,
        kernels=kernels), device=dev)
    st = sess.init(0)
    ops.reset_launch_counts()
    for _ in range(3):
        st = sess.step(st)
    runs[shape, kernels] = (sess, st, ops.launch_counts())
sb, a, ca = runs[None, "auto"]
for kernels, kernel, merges in (("auto", "zen_fused_sample", 6),
                                ("off", "zen_sample", 0)):
    mesh, b, cb = runs[(1, 1), kernels]
    assert mesh.plan.comm.backend == "nccl"
    mesh.plan.check_invariants(b)
    assert (mesh.plan.corpus_topics(b) == a.topic.cpu().numpy()).all()
    assert (mesh.plan.host_n_wk(b) == a.n_wk.cpu().numpy()).all()
    assert (mesh.plan.host_n_kd(b) == a.n_kd.cpu().numpy()).all()
    assert torch.equal(a.n_k, b.n_k) and sb.llh(a) == mesh.llh(b)
    assert cb[kernel] == 3 and cb["topic_histogram"] == merges, cb
    assert sum(cb.values()) == 3 + merges, cb
assert ca == runs[(1, 1), "auto"][2], ca
dist.destroy_process_group()
print("NCCL_WORLD_OF_ONE_OK")
"""


def test_world_of_one_under_nccl_equals_the_single_box_on_card(cuda):
    """A (1, 1) mesh under NCCL, through the fused kernel and (with
    ``kernels="off"``) the gathered one with the plain merge, draws what
    the single box draws."""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run([sys.executable, "-c", _NCCL_WORLD_OF_ONE],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": src})
    assert "NCCL_WORLD_OF_ONE_OK" in proc.stdout, \
        proc.stdout + proc.stderr[-4000:]


# -- the LM zoo's serving path (the lm_serve phase's checks, smoke width) --

def _lm(arch="qwen3-8b", **changes):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch + "-smoke"),
                               **{"dtype": "float32", **changes})


def test_lm_engine_bookkeeping_and_replay_on_card(cuda):
    """The engine on the card: the fed tokens are the prompt then the
    outputs, each output the argmax of the engine's own logits, and a
    replay from a fresh cache gives the same logits."""
    from repro_torch.models import model as M
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = _lm(num_layers=2)
    lm = M.init_params(0, cfg, device=cuda)
    engine = ServingEngine(lm, cfg, ServeConfig(max_batch=2, max_len=32),
                           device=cuda)
    decode, calls = engine._decode, []

    def spy(p, t, c):
        logits, caches = decode(p, t, c)
        calls.append((t.clone(), logits.float().cpu().numpy()))
        return logits, caches

    engine._decode = spy
    prompt = [5, 9, 11]
    engine.submit(prompt, max_new=4)
    done = engine.run_until_done()
    assert engine.caches.k.device.type == "cuda"
    assert [int(t[0]) for t, _ in calls] == prompt + done[0].out[:-1]
    for i, tok in enumerate(done[0].out):
        assert tok == int(np.argmax(calls[len(prompt) - 1 + i][1][0]))
    cache = M.init_cache(cfg, 2, 32, device=cuda)
    with torch.no_grad():
        for fed, logits in calls:
            replay, cache = M.decode_step(lm, cfg, fed, cache)
            np.testing.assert_array_equal(replay.float().cpu().numpy(),
                                          logits)


def test_lm_prefill_decode_equals_forward_on_card(cuda):
    from repro_torch.models import model as M

    cfg = _lm()
    lm = M.init_params(0, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 13), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    with torch.no_grad():
        pre, cache = M.prefill_with_cache(lm, cfg, tokens[:, :12], 32)
        dec, _ = M.decode_step(lm, cfg, tokens[:, 12], cache)
        full, _ = M.forward(lm, cfg, tokens=tokens)
    torch.testing.assert_close(dec, full[:, 12, :cfg.vocab_size],
                               rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(pre, full[:, 11], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", [
    "gemma3-4b", "qwen1.5-4b", "qwen3-8b", "minicpm3-4b", "zamba2-1.2b",
    "whisper-medium", "grok-1-314b", "arctic-480b", "falcon-mamba-7b",
    "qwen2-vl-2b"])
def test_lm_forward_and_decode_on_card_equal_cpu(cuda, arch):
    """Every family (MoE, MLA, M-RoPE, the sliding ring, mamba1/2, hybrid,
    enc-dec): the same parameters on the card and the CPU, forward and 8
    decode steps within 1e-4."""
    import copy

    from repro_torch.models import model as M

    cfg = _lm(arch)
    cpu = M.init_params(0, cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                           dtype=torch.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_embeds"] = torch.randn((2, 16, cfg.d_model), generator=g)
    s_enc = 16 if cfg.family == "encdec" else 0
    with torch.no_grad():
        lc, _ = M.forward(cpu, cfg, tokens=tokens, **kw)
        lg, _ = M.forward(gpu, cfg, tokens=tokens.to(cuda),
                          **{k: v.to(cuda) for k, v in kw.items()})
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        cc = M.init_cache(cfg, 2, 32, s_enc=s_enc, device="cpu")
        cg = M.init_cache(cfg, 2, 32, s_enc=s_enc, device=cuda)
        for t in torch.randint(0, cfg.vocab_size, (8, 2), generator=g,
                               dtype=torch.int32):
            dc, cc = M.decode_step(cpu, cfg, t, cc)
            dg, cg = M.decode_step(gpu, cfg, t.to(cuda), cg)
            torch.testing.assert_close(dg.cpu(), dc, rtol=1e-4, atol=1e-4)


# -- LM training (the lm_train phase's checks, smoke width) -----------------

def _lm_train_batch(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                           dtype=torch.int32)
    b = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.randn((2, 16, cfg.d_model), generator=g)
    return b


@pytest.mark.parametrize("arch", [
    "gemma3-4b", "qwen1.5-4b", "qwen3-8b", "minicpm3-4b", "zamba2-1.2b",
    "whisper-medium", "grok-1-314b", "arctic-480b", "falcon-mamba-7b",
    "qwen2-vl-2b"])
def test_lm_train_step_on_card_equals_cpu(cuda, arch):
    """One train step of each family (its own optimizer: Adafactor for
    grok-1 and arctic) from the same parameters and batch on the card and
    on the CPU: the loss, every gradient and the parameters after the step
    within 1e-4 (an element whose CPU gradient is below 1e-6 of its leaf's
    largest is left out of the parameters: AdamW's first step moves it by
    lr times a sign that rounding noise decides)."""
    import copy

    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, make_optimizer
    from repro_torch.train.train_step import (
        TrainState,
        compute_grads,
        make_train_step,
    )

    cfg = _lm(arch)
    cpu = M.init_params(0, cfg, device="cpu").requires_grad_(True)
    gpu = copy.deepcopy(cpu).to(cuda)
    b = _lm_train_batch(cfg)
    bg = {k: v.to(cuda) for k, v in b.items()}
    lc, _, gc = compute_grads(cpu, cfg, b)
    lg, _, gg = compute_grads(gpu, cfg, bg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for n in gc:
        scale = float(gc[n].abs().max()) or 1.0
        torch.testing.assert_close(gg[n].cpu() / scale, gc[n] / scale,
                                   rtol=1e-4, atol=1e-4, msg=n)
    opt = OptConfig(learning_rate=1e-3)
    init, _ = make_optimizer(cfg.optimizer, opt)
    step = make_train_step(cfg, opt)
    zero = torch.zeros((), dtype=torch.int32)
    step(TrainState(cpu, init(cpu), zero), b)
    step(TrainState(gpu, init(gpu), zero.to(cuda)), bg)
    for (n, pc), (_, pg) in zip(cpu.named_parameters(),
                                gpu.named_parameters()):
        keep = gc[n].abs() >= 1e-6 * (float(gc[n].abs().max()) or 1.0)
        torch.testing.assert_close(pg.detach().cpu()[keep],
                                   pc.detach()[keep], rtol=1e-4, atol=1e-4,
                                   msg=n)


@pytest.mark.parametrize("arch", ["qwen3-8b", "grok-1-314b", "zamba2-1.2b",
                                  "gemma3-4b", "whisper-medium"])
def test_lm_remat_policies_equal_on_card(cuda, arch):
    """``none``, ``nothing_saveable`` and ``dots`` on the card: the same
    loss and gradients (the recomputed forward runs the same kernels on
    the same inputs)."""
    from repro_torch.models import model as M
    from repro_torch.train.train_step import compute_grads

    b = {k: v.to(cuda) for k, v in _lm_train_batch(_lm(arch)).items()}
    out = {}
    for policy in ("none", "nothing_saveable", "dots"):
        cfg = _lm(arch, remat_policy=policy)
        lm = M.init_params(0, cfg, device=cuda).requires_grad_(True)
        out[policy] = compute_grads(lm, cfg, b)
    loss0, _, g0 = out["none"]
    for policy in ("nothing_saveable", "dots"):
        loss, _, g = out[policy]
        torch.testing.assert_close(loss, loss0, rtol=0, atol=0)
        for n in g0:
            torch.testing.assert_close(g[n], g0[n], rtol=1e-6, atol=1e-7,
                                       msg=f"{policy} {n}")


# -- block shapes (_build.variant) and the autotuner -------------------------

def _at_shape(source, macro, value, default):
    """The block under ``source`` rebuilt with ``macro`` = ``value``
    (nothing to rebuild at the default)."""
    import contextlib

    from repro_torch.kernels import _build

    if value == default:
        return contextlib.nullcontext()
    return _build.variant(source, f"{macro}={value}")


@pytest.mark.parametrize("t,k,w,d", [(8192, 1000, 20000, 40),
                                     (333, 37, 50, 3), (700, 16385, 30, 5)])
def test_training_kernels_bit_equal_at_every_block_shape(cuda, t, k, w, d):
    """Kernels 1 and 2 at 8, 16 and 32 warps per block: every draw and the
    exact-work stats equal the default shape's (K = 16,385 puts the
    per-topic table in global memory, K = 37 takes the scalar loads)."""
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda
    from repro_torch.kernels.zen_sampler import zen_sample_cuda

    a = _train_inputs(cuda, t + k + 1, t, k, w, d)
    rows = (a["n_wk"][a["word"].long()].contiguous(),
            a["n_kd"][a["doc"].long()].contiguous())
    kw = dict(beta=0.01, w_beta=w * 0.01)
    out = {}
    for warps in (8, 16, 32):
        stats_f = torch.zeros(3, dtype=torch.int64, device=cuda)
        stats_g = torch.zeros(3, dtype=torch.int64, device=cuda)
        with _at_shape("zen_train.cu", "ZEN_TRAIN_WARPS", warps, 32):
            fused = zen_fused_sample_cuda(
                a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"],
                a["alpha"], a["n_k"], 777, stats=stats_f, **kw)
            gathered = zen_sample_cuda(*rows, a["z"], a["alpha"], a["n_k"],
                                       777, stats=stats_g, **kw)
            torch.cuda.synchronize()
        out[warps] = (fused, gathered, stats_f, stats_g)
    base = out[32]
    assert torch.equal(base[0], base[1])
    for warps, got in out.items():
        for x, y in zip(got, base):
            assert torch.equal(x, y), warps


def test_sparse_and_cdf_kernels_bit_equal_at_every_block_shape(cuda):
    """Kernel 6 at 2-16 warps and kernel 7 at 128-512 threads per block
    equal their default shapes, token for token."""
    from repro_torch.kernels.cdf_search import cdf_row_search_cuda
    from repro_torch.kernels.sparse_row import sparse_row_sample_cuda

    t, j = 5000, 70
    g = torch.Generator(device=cuda).manual_seed(5)
    vals = torch.rand((t, j), generator=g, device=cuda)
    topics = torch.randint(0, 1000, (t, j), generator=g, device=cuda,
                           dtype=torch.int32)
    tgt = torch.rand(t, generator=g, device=cuda) * vals.sum(1)
    sparse = {}
    for w in (2, 4, 8, 16):
        with _at_shape("sparse_row.cu", "SPARSE_ROW_WARPS", w, 8):
            sparse[w] = sparse_row_sample_cuda(vals, topics, tgt)
    for pattern in ("all_searching", "clusters", "one_per_warp"):
        counts, rows, term, ctgt = _cdf_case(cuda, pattern)
        cdf = {}
        for n in (128, 256, 512):
            with _at_shape("cdf_search.cu", "CDF_SEARCH_THREADS", n, 256):
                cdf[n] = cdf_row_search_cuda(counts, rows, term, ctgt)
                torch.cuda.synchronize()
        for n, got in cdf.items():
            assert torch.equal(got, cdf[256]), (pattern, n)
    for w, got in sparse.items():
        assert torch.equal(got, sparse[8]), w


def test_a_shape_outside_the_set_fails_its_build(cuda):
    """ZEN_TRAIN_WARPS must divide 32: nvcc refuses 3 (a static_assert),
    and the launchers stay bound to the default build."""
    from repro_torch.kernels import _build

    before = _build.library()
    with pytest.raises(RuntimeError, match="CUDA build of"):
        with _build.variant("zen_train.cu", "ZEN_TRAIN_WARPS=3"):
            pass
    assert _build.library() is before


def test_autotune_on_card_times_every_point_and_applies_the_best(cuda):
    from repro_torch.algorithms import SamplerKnobs
    from repro_torch.kernels.autotune import (
        apply_best,
        autotune_cdf,
        autotune_fused,
        autotune_sparse,
    )

    a = _train_inputs(cuda, 9, 4096, 256, 300, 20)
    kw = dict(iters=3, warmup=1)
    timings = autotune_fused(a["n_wk"], a["n_kd"], a["word"], a["doc"],
                             a["z"], a["alpha"], a["n_k"], 7, beta=0.01,
                             w_beta=3.0, bts=(64, 128, 256), bks=(128,),
                             **kw)
    counts, rows, term, tgt = _cdf_case(cuda, "all_searching")
    timings += autotune_cdf(counts, rows, term, tgt, bts=(128, 256, 512),
                            bks=(128,), **kw)
    vals = torch.rand((4096, 40), device=cuda)
    topics = torch.randint(0, 256, (4096, 40), dtype=torch.int32,
                           device=cuda)
    timings += autotune_sparse(vals, topics, vals.sum(1) * 0.5,
                               bts=(64, 128, 256, 512), bss=(128, 256),
                               **kw)
    assert len(timings) == 3 + 3 + 8
    assert all(tt.us_per_call > 0 and tt.tokens_per_sec > 0
               for tt in timings)
    # one launch per kernel: every point of a sweep has its timing
    for kernel in ("fused_sample", "cdf_search", "sparse_row"):
        assert len({tt.us_per_call for tt in timings
                    if tt.kernel == kernel}) == 1, kernel
    tuned = apply_best(timings, SamplerKnobs())
    assert tuned.bt in (64, 128, 256, 512) and tuned.bk == 128
    assert tuned.bs in (128, 256)
    SamplerKnobs(**{f: getattr(tuned, f) for f in (
        "bt", "bk", "bs", "kernels")})  # re-validates
