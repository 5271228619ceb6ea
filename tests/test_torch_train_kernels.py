"""The port's training samplers (queue-2 kernels 1 and 2) against the JAX
package, on the CPU.

* The plain versions of ``ops.zen_sample`` (gathered rows) and
  ``ops.zen_fused_sample`` against the reference's Pallas kernels in
  interpret mode and its unpadded oracle ``ref.zen_sample_ref``, with the
  same seed, at K not a multiple of ``bk`` and T not a multiple of ``bt``.
  Every mismatch must be either a near-tie (the port's two scores within
  1e-4: torch's and XLA's CPU ``log`` differ in the last bits) or a
  reference draw >= K: the reference pads K to ``bk`` and a padded topic
  wins where its noise is +inf (its hash's top 24 bits all ones). The
  port walks the real K, so it draws the oracle's topic there.
* Two pinned cases show that reference fault: training (seed 1857, T=256,
  K=200, bk=128: token 118 draws 230, the oracle 181) and serving
  (per-token seed 161537, K=200, bk=128: every such token draws 226).
* Fused == gathered == the port's own oracle, bit for bit; chunking and
  the noise-row offset change no draw.
* The hash coordinates that chip_smoke.py's adversarial grid uses (+inf
  noise, the forced top bucket, exact ties) give the reference's bits, and
  the plain version draws the reference oracle's topic there.
"""
import pathlib
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import zen_sampler as jzs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import fused_gather as tfg
from repro_torch.kernels import zen_sampler as tzs

NEAR_TIE = 1e-4
BETA = 0.01


def _inputs(seed, t, k, w, d):
    """Counts with each token's own old topic present, so the exclusion
    leaves them non-negative, as in a real sweep."""
    rng = np.random.default_rng(seed)
    word = rng.integers(0, w, t).astype(np.int32)
    doc = rng.integers(0, d, t).astype(np.int32)
    z = rng.integers(0, k, t).astype(np.int32)
    n_wk = rng.integers(0, 40, (w, k)).astype(np.int32)
    n_kd = rng.integers(0, 8, (d, k)).astype(np.int32)
    np.add.at(n_wk, (word, z), 1)
    np.add.at(n_kd, (doc, z), 1)
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, doc=doc, z=z,
                ak=(rng.random(k) * 0.2 + 0.001).astype(np.float32),
                nk=n_wk.sum(0).astype(np.float32))


def _port_scores(a, seed, w_beta):
    """The port's float32 training scores (T, K) for inputs ``a``."""
    nw = torch.from_numpy(a["n_wk"][a["word"]])
    nd = torch.from_numpy(a["n_kd"][a["doc"]])
    t, k = nw.shape
    cols = torch.arange(k)[None, :]
    hit = (cols == torch.from_numpy(a["z"]).long()[:, None]).float()
    nwf, ndf = nw.float() - hit, nd.float() - hit
    nk = torch.from_numpy(a["nk"])[None, :] - hit
    ak = torch.from_numpy(a["ak"])[None, :]
    p = (ak * BETA + nwf * ak + ndf * (nwf + BETA)) / (nk + w_beta)
    g = tzs.gumbel_noise(seed, torch.arange(t)[:, None], cols)
    return (torch.log(torch.clamp_min(p, 1e-30)) + g).numpy()


def classify_mismatches(port, jax_out, scores, k):
    """(near-ties, padded reference draws) where the topics differ;
    asserts every mismatch is one of the two."""
    ties, padded = [], []
    for i in np.flatnonzero(port != jax_out):
        assert 0 <= port[i] < k
        if jax_out[i] >= k:
            padded.append(int(i))
            continue
        gap = abs(scores[i, port[i]] - scores[i, jax_out[i]])
        assert gap <= NEAR_TIE, (i, port[i], jax_out[i], gap)
        ties.append(int(i))
    return ties, padded


@pytest.mark.parametrize(
    "seed,t,k,w,d,bt",
    [(11, 100, 200, 30, 5, 32), (1857, 256, 200, 40, 6, 256),
     (3, 45, 300, 60, 4, 16), (4, 9, 37, 7, 3, 8)],
)
def test_plain_training_samplers_match_reference_kernels(seed, t, k, w, d,
                                                         bt):
    a = _inputs(seed, t, k, w, d)
    w_beta = w * BETA
    kw = dict(beta=BETA, w_beta=w_beta)
    rows = (a["n_wk"][a["word"]], a["n_kd"][a["doc"]])
    tail = [a["z"], a["ak"], a["nk"]]
    j_gath = np.asarray(jops.zen_sample(
        *(jnp.asarray(x) for x in rows + tuple(tail)), jnp.int32(seed),
        bt=bt, bk=128, **kw))
    j_fused = np.asarray(jops.zen_fused_sample(
        *(jnp.asarray(a[n]) for n in ("n_wk", "n_kd", "word", "doc", "z",
                                      "ak", "nk")),
        jnp.int32(seed), bt=bt, bk=128, **kw))
    j_ref = np.asarray(jref.zen_sample_ref(
        *(jnp.asarray(x) for x in rows + tuple(tail)), jnp.int32(seed), **kw))
    np.testing.assert_array_equal(j_fused, j_gath)

    tt = {n: torch.from_numpy(v) for n, v in a.items()}
    t_fused = ops.zen_fused_sample(
        tt["n_wk"], tt["n_kd"], tt["word"], tt["doc"], tt["z"], tt["ak"],
        tt["nk"], seed, bt=bt, bk=128, **kw).numpy()
    t_gath = ops.zen_sample(
        *(torch.from_numpy(x) for x in rows), tt["z"], tt["ak"], tt["nk"],
        seed, **kw).numpy()
    t_ref = ref.zen_fused_sample_ref(
        tt["n_wk"], tt["n_kd"], tt["word"], tt["doc"], tt["z"], tt["ak"],
        tt["nk"], seed, **kw).numpy()
    assert t_fused.dtype == np.int32
    np.testing.assert_array_equal(t_fused, t_gath)
    np.testing.assert_array_equal(t_fused, t_ref)

    scores = _port_scores(a, seed, w_beta)
    ties, padded = classify_mismatches(t_fused, j_fused, scores, k)
    assert len(ties) <= max(1, t // 1000), ties
    ties_ref, padded_ref = classify_mismatches(t_fused, j_ref, scores, k)
    assert not padded_ref and len(ties_ref) <= max(1, t // 1000)
    # the oracle walks the real K too: the padded draws are the kernel's
    assert all(j_ref[i] < k for i in padded)


def test_pinned_padded_topic_fault_in_reference_training_kernel():
    """seed 1857, T=256, K=200, bt=256, bk=128: the reference's padded
    grid gives token 118 topic 230 >= K (noise +inf in a padded column,
    whatever the counts); its oracle and the port give 181."""
    t, k, seed = 256, 200, 1857
    for counts_seed in (None, 0):
        if counts_seed is None:
            nw = np.zeros((t, k), np.int32)
            nd = np.zeros((t, k), np.int32)
            z = np.zeros(t, np.int32)
        else:
            rng = np.random.default_rng(counts_seed)
            nw = rng.integers(0, 40, (t, k)).astype(np.int32)
            nd = rng.integers(0, 8, (t, k)).astype(np.int32)
            z = rng.integers(0, k, t).astype(np.int32)
        hit = (np.arange(k)[None, :] == z[:, None]).astype(np.int32)
        nw, nd = nw + hit, nd + hit
        nk = (nw.sum(0) + 1).astype(np.float32)
        ak = np.full(k, 0.05, np.float32)
        args = (nw, nd, z, ak, nk)
        kw = dict(beta=BETA, w_beta=1.0)
        j_out = np.asarray(jops.zen_sample(
            *(jnp.asarray(x) for x in args), jnp.int32(seed), bt=256,
            bk=128, **kw))
        j_ref = np.asarray(jref.zen_sample_ref(
            *(jnp.asarray(x) for x in args), jnp.int32(seed), **kw))
        port = ops.zen_sample(*(torch.from_numpy(x) for x in args), seed,
                              **kw).numpy()
        assert j_out[118] == 230
        assert np.flatnonzero(j_out >= k).tolist() == [118]
        assert j_ref[118] == 181 and port[118] == 181
        np.testing.assert_array_equal(port, j_ref)
        noise = tzs.gumbel_noise(seed, 118, torch.tensor(230))
        assert float(noise) == np.inf


def test_pinned_padded_topic_fault_in_reference_serving_kernel():
    """Per-token seed 161537 at K=200, bk=128: the reference's padded
    serving kernel draws topic 226 >= K for every such token; the port
    draws its oracle's topic."""
    k, n = 200, 16
    rng = np.random.default_rng(1)
    nw = rng.integers(0, 40, (n, k)).astype(np.int32)
    nd = rng.integers(1, 8, (n, k)).astype(np.int32)
    z = np.zeros(n, np.int32)
    seeds = np.full(n, 161537, np.int32)
    nk = (nw.sum(0) + 1).astype(np.float32)
    ak = np.full(k, 0.05, np.float32)
    args = (nw, nd, z, seeds, ak, nk)
    kw = dict(beta=BETA, w_beta=1.0)
    j_out = np.asarray(jops.zen_infer_sample(
        *(jnp.asarray(x) for x in args), bt=8, bk=128, **kw))
    j_ref = np.asarray(jref.zen_infer_sample_ref(
        *(jnp.asarray(x) for x in args), **kw))
    port = ops.zen_infer_sample(*(torch.from_numpy(x) for x in args),
                                **kw).numpy()
    assert (j_out == 226).all()
    assert (j_ref < k).all() and (port < k).all()
    np.testing.assert_array_equal(port, j_ref)


def test_chunking_and_row_offset_change_no_draw(monkeypatch):
    a = _inputs(5, 50, 130, 30, 5)
    tt = {n: torch.from_numpy(v) for n, v in a.items()}
    kw = dict(beta=BETA, w_beta=0.3)
    args = (tt["n_wk"], tt["n_kd"], tt["word"], tt["doc"], tt["z"],
            tt["ak"], tt["nk"], 77)
    whole = ops.zen_fused_sample(*args, **kw)
    monkeypatch.setattr(tzs, "PLAIN_CHUNK", 7)
    monkeypatch.setattr(tfg, "PLAIN_CHUNK", 7)
    np.testing.assert_array_equal(ops.zen_fused_sample(*args, **kw).numpy(),
                                  whole.numpy())
    rows_w = tt["n_wk"][tt["word"].long()]
    rows_d = tt["n_kd"][tt["doc"].long()]
    parts = [ops.zen_sample(rows_w[s:s + 13], rows_d[s:s + 13],
                            tt["z"][s:s + 13], tt["ak"], tt["nk"], 77,
                            row_offset=s, **kw) for s in range(0, 50, 13)]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), whole.numpy())


def test_probs_oracle_matches_reference():
    a = _inputs(6, 40, 150, 20, 4)
    rows = (a["n_wk"][a["word"]], a["n_kd"][a["doc"]], a["z"], a["ak"],
            a["nk"])
    kw = dict(beta=BETA, w_beta=0.2)
    j = np.asarray(jref.zen_probs_ref(*(jnp.asarray(x) for x in rows), **kw))
    t = ref.zen_probs_ref(*(torch.from_numpy(x) for x in rows), **kw)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-9)


def test_training_wrappers_route_by_device_and_count_only_launches():
    a = _inputs(7, 8, 16, 5, 2)
    tt = {n: torch.from_numpy(v) for n, v in a.items()}
    args = (tt["n_wk"], tt["n_kd"], tt["word"], tt["doc"], tt["z"],
            tt["ak"], tt["nk"], 3)
    ops.reset_launch_counts()
    ops.zen_fused_sample(*args, beta=BETA, w_beta=0.05)
    ops.zen_sample(tt["n_wk"][tt["word"].long()],
                   tt["n_kd"][tt["doc"].long()], tt["z"], tt["ak"],
                   tt["nk"], 3, beta=BETA, w_beta=0.05)
    assert set(ops.launch_counts().values()) == {0}
    meta = [x.to("meta") for x in args[:-1]]
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.zen_fused_sample(*meta, 3, beta=BETA, w_beta=0.05)


def test_training_cuda_launchers_validate_before_launch():
    a = _inputs(8, 8, 16, 5, 2)
    tt = {n: torch.from_numpy(v) for n, v in a.items()}
    rows = tt["n_wk"][tt["word"].long()]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tzs.zen_sample_cuda(rows, rows, tt["z"], tt["ak"], tt["nk"], 3,
                            beta=BETA, w_beta=0.05)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tfg.zen_fused_sample_cuda(tt["n_wk"], tt["n_kd"], tt["word"],
                                  tt["doc"], tt["z"], tt["ak"], tt["nk"], 3,
                                  beta=BETA, w_beta=0.05)
    with pytest.raises(ValueError, match="int31"):
        tzs.check_seed(2**31, 0, 8)
    with pytest.raises(ValueError, match="int31"):
        tzs.check_seed(0, 2**31 - 4, 8)


def test_training_launch_extras_validate_before_launch(monkeypatch):
    """The stats output is checked before any launch, and the global
    table's scratch is allocated only where the library puts the table in
    global memory (its count of float4 entries, 0 for shared memory)."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tzs.train_launch_extras(8, cpu, torch.zeros(3, dtype=torch.int64))
    monkeypatch.setattr(tzs, "train_global_table_entries", lambda k, d: 0)
    assert tzs.train_launch_extras(1000, cpu, None) == (None, (None, None))
    monkeypatch.setattr(tzs, "train_global_table_entries",
                        lambda k, d: -(-k // 128) * 128)
    scratch, (ptr, stats) = tzs.train_launch_extras(16385, cpu, None)
    assert scratch.shape == (16512, 4) and ptr == scratch.data_ptr()
    assert stats is None


def test_build_covers_both_sources_in_parallel_targets():
    """Each source builds into a library of its own (so nvcc runs once
    per source, all at once), and every launcher is exported by one."""
    names = [s.name for s in _build.SOURCES]
    assert names == ["zen_infer.cu", "zen_train.cu", "sparse_row.cu",
                     "cdf_search.cu", "topic_histogram.cu", "cdf_tokens.cu"]
    targets = {_build.target(s) for s in _build.SOURCES}
    assert len(targets) == 6
    texts = [s.read_text() for s in _build.SOURCES]
    for fn in _build.SIGNATURES:
        assert sum(f'extern "C" int {fn}(' in t for t in texts) == 1, fn
    train = texts[1]
    assert "#pragma unroll 1" in train and "__trap()" in train
    assert "size_t" in train


# -- the hash coordinates of chip_smoke.py's adversarial grid ----------------
# The verified CUDA sampler scores exactly the topics whose hash lands in
# the top bucket m >= 2^24 - 2^12 (m = h >> 8), m = 2^24 - 1 among them
# (noise +inf), and must keep the lower topic on exact ties. These pins tie
# the grid's coordinates to the JAX package's hash and oracle.
TOP_BUCKET = (1 << 24) - (1 << 12)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo's root; stdlib-only at import)

PINNED_SPECS = [spec for spec in chip_smoke.ADVERSARIAL if spec[7]]


def _reference_bits(seed, row, col):
    """The reference's hash of (seed, row, col): hash_uniform's own
    construction, as uint32."""
    return int(jzs._mix(jnp.uint32(seed) ^ (jnp.uint32(row)
                                            * jnp.uint32(jzs._GOLD))
                        ^ jzs._mix(jnp.uint32(col))))


@pytest.mark.parametrize("seed,row,col,m", [
    (1857, 118, 230, (1 << 24) - 1),  # +inf noise
    (1857, 4, 104, 16776472),  # the forced top bucket
    (88, 642, 26, 16776797), (88, 642, 336, 16776797),  # tie in the bucket
    (2, 760, 147, 16719178), (2, 760, 808, 16719178),  # tie, two lanes
    (458, 104, 254, 16762413), (458, 104, 893, 16762413),  # tie, one lane
])
def test_pinned_hash_coordinates_match_reference(seed, row, col, m):
    port = int(tzs.hash_bits(seed, row, col))
    assert port == _reference_bits(seed, row, col)
    assert port >> 8 == m
    assert (m >= TOP_BUCKET) == (seed in (1857, 88))
    u_port = tzs.hash_uniform(seed, row, col).numpy()
    u_ref = np.asarray(jzs.hash_uniform(jnp.int32(seed), jnp.int32(row),
                                        jnp.int32(col)))
    assert u_port.view(np.uint32) == u_ref.view(np.uint32)
    g = float(tzs.gumbel_noise(seed, row, torch.tensor(col)))
    assert (g == np.inf) == (m == (1 << 24) - 1)


def test_pinned_ties_share_one_uniform():
    """m = 16776797 twice, or m = 2j and 2j + 1 rounding to one u: the
    pinned pairs have equal noise, so equal counts give exact-score ties."""
    for seed, row, a, b in ((88, 642, 26, 336), (2, 760, 147, 808),
                            (458, 104, 254, 893)):
        g = tzs.gumbel_noise(seed, row, torch.tensor([a, b]))
        assert float(g[0]) == float(g[1])


@pytest.mark.parametrize("spec", PINNED_SPECS,
                         ids=[spec[0] for spec in PINNED_SPECS])
def test_plain_version_and_reference_oracle_draw_the_pinned_topics(spec):
    """train_argmax_rows (through zen_sample_plain) and the reference's
    ref.zen_sample_ref draw the pinned topic on chip_smoke.py's inputs:
    the +inf winner and the lower topic of each exact tie. Elsewhere they
    may differ only at near-ties (torch's and XLA's CPU log)."""
    name, seed, t, k, w, _, _, pins = spec
    a = chip_smoke.adversarial_case(spec, torch.device("cpu"))
    rows = (a["n_wk"][a["word"].long()], a["n_kd"][a["doc"].long()])
    kw = dict(beta=0.01, w_beta=w * 0.01)
    port = tzs.zen_sample_plain(*rows, a["z"], a["alpha"], a["n_k"], seed,
                                **kw).numpy()
    j_ref = np.asarray(jref.zen_sample_ref(
        *(jnp.asarray(x.numpy()) for x in rows + (a["z"], a["alpha"],
                                                  a["n_k"])),
        jnp.int32(seed), **kw))
    for tok, topic in pins.items():
        assert port[tok] == topic and j_ref[tok] == topic, (name, tok)
    scores = _port_scores({"n_wk": a["n_wk"].numpy(),
                           "n_kd": a["n_kd"].numpy(),
                           "word": a["word"].numpy(),
                           "doc": a["doc"].numpy(), "z": a["z"].numpy(),
                           "ak": a["alpha"].numpy(),
                           "nk": a["n_k"].numpy()}, seed, w * 0.01)
    ties, padded = classify_mismatches(port, j_ref, scores, k)
    assert not padded and len(ties) <= max(1, t // 1000)
