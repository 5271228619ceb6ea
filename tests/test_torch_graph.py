"""The port's corpus-graph partitioning, row sharding and active-token
compaction against the JAX package's, on the same numpy corpora: every
array bit-equal (integers and permutations), every metric equal."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import exclusion as jexcl
from repro.core import graph as jgraph
from repro.data import synthetic_corpus as j_synthetic_corpus
from repro.sharding.partition import shard_rows_balanced as j_shard_rows
from repro_torch.core import exclusion as texcl
from repro_torch.core import graph as tgraph
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.sharding import shard_rows_balanced

import torch


@pytest.fixture(scope="module")
def skewed():
    """A Zipf(1.4) corpus (the reference's skewed fixture) in both
    packages."""
    kw = dict(num_docs=400, num_words=600, avg_doc_len=40, zipf_a=1.4)
    jc = j_synthetic_corpus(0, **kw)
    tc = synthetic_corpus(0, **kw)
    np.testing.assert_array_equal(np.asarray(jc.word), tc.word.numpy())
    np.testing.assert_array_equal(np.asarray(jc.doc), tc.doc.numpy())
    return jc, tc


@pytest.mark.parametrize("name", sorted(jgraph.PARTITIONERS))
@pytest.mark.parametrize("p", [3, 8])
def test_partitioners_and_metrics_equal_reference(skewed, name, p):
    jc, _ = skewed
    w, d = np.asarray(jc.word), np.asarray(jc.doc)
    want = jgraph.PARTITIONERS[name](w, d, p)
    got = tgraph.PARTITIONERS[name](w, d, p)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert tgraph.partition_metrics(w, d, got, p) == \
        jgraph.partition_metrics(w, d, want, p)


def test_hash_and_balanced_ranges_equal_reference():
    x = np.random.default_rng(3).integers(0, 2**31, 4096)
    np.testing.assert_array_equal(tgraph._hash(x), jgraph._hash(x))
    np.testing.assert_array_equal(tgraph._hash(x, 17), jgraph._hash(x, 17))
    loads = np.random.default_rng(4).zipf(1.3, 500).astype(np.int64)
    for bins in (1, 2, 7):
        np.testing.assert_array_equal(tgraph._balanced_ranges(loads, bins),
                                      jgraph._balanced_ranges(loads, bins))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 1), (3, 2)])
@pytest.mark.parametrize("balance", ["lpt", "hash"])
@pytest.mark.parametrize("sort_by", ["word", "doc"])
def test_grid_partition_equals_reference(skewed, shape, balance, sort_by):
    """Every array of the reference's GridPartition, bit for bit; the
    port's ``token`` maps each slot back to its corpus token."""
    jc, tc = skewed
    want = jgraph.grid_partition(jc, *shape, balance=balance,
                                 sort_tokens_by=sort_by)
    got = tgraph.grid_partition(tc, *shape, balance=balance,
                                sort_tokens_by=sort_by)
    for f in ("word", "doc", "mask", "word_perm", "doc_perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in ("data_parallel", "model_parallel", "words_per_shard",
              "docs_per_shard", "num_words_padded", "num_docs_padded",
              "padding_overhead"):
        assert getattr(got, f) == getattr(want, f), f
    m = got.mask
    tok = got.token[m]
    assert np.array_equal(np.sort(tok), np.arange(tc.num_tokens))
    np.testing.assert_array_equal(got.word_perm[tc.word.numpy()[tok]],
                                  got.word[m])
    np.testing.assert_array_equal(got.doc_perm[tc.doc.numpy()[tok]],
                                  got.doc[m])
    assert (got.token[~m] == 0).all()
    # each cell's real tokens are a prefix (the mesh step relies on it)
    n = m.sum(1)
    assert all(m[c, :n[c]].all() for c in range(m.shape[0]))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_shard_rows_balanced_equals_reference(shards):
    rng = np.random.default_rng(shards)
    loads = rng.poisson(3.0, 97) * (1 + (rng.random(97) < 0.1) * 50)
    perm, per = shard_rows_balanced(loads, shards)
    jperm, jper = j_shard_rows(loads, shards)
    np.testing.assert_array_equal(perm, jperm)
    assert per == jper and perm.dtype == jperm.dtype
    assert len(set(perm.tolist())) == loads.shape[0]


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_compact_active_equals_reference(frac):
    rng = np.random.default_rng(int(frac * 10))
    mask = rng.random(257) < frac
    a = rng.integers(0, 1000, 257).astype(np.int32)
    b = rng.integers(0, 9, 257).astype(np.int32)
    jperm, (ja, jb), jn = jexcl.compact_active(
        jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    perm, (ta, tb), n = texcl.compact_active(
        torch.from_numpy(mask), torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(n) == int(jn) == int(mask.sum())


@pytest.mark.parametrize("shape", [(2, 2), (3, 2)])
@pytest.mark.parametrize("balance", ["lpt", "hash"])
@pytest.mark.parametrize("sort_by", ["word", "doc"])
def test_grid_partition_of_a_shuffled_corpus_equals_reference(
        skewed, shape, balance, sort_by):
    """Tokens not in document order: the doc key is sorted too."""
    jc, tc = skewed
    perm = np.random.default_rng(7).permutation(tc.num_tokens)
    word, doc = tc.word.numpy()[perm], tc.doc.numpy()[perm]
    jshuf = type(jc)(word=jnp.asarray(word), doc=jnp.asarray(doc),
                     num_words=jc.num_words, num_docs=jc.num_docs)
    tshuf = type(tc)(word=torch.from_numpy(word), doc=torch.from_numpy(doc),
                     num_words=tc.num_words, num_docs=tc.num_docs)
    want = jgraph.grid_partition(jshuf, *shape, balance=balance,
                                 sort_tokens_by=sort_by)
    got = tgraph.grid_partition(tshuf, *shape, balance=balance,
                                sort_tokens_by=sort_by)
    for f in ("word", "doc", "mask", "word_perm", "doc_perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.word_perm[word[got.token[got.mask]]],
                                  got.word[got.mask])


@pytest.mark.parametrize("sizes", [(7, 5, 3), (70000, 300, 4),
                                   (2**20, 2**20, 4), (2**31, 2**31, 2)])
def test_stable_lexsort_equals_numpy_lexsort(sizes):
    """Each branch (16-bit radix passes, one int64 argsort, np.lexsort)
    gives np.lexsort's permutation, ties by position."""
    rng = np.random.default_rng(len(sizes) + sizes[0] % 97)
    keys = tuple(rng.integers(0, min(n, 50), 20000) for n in sizes)
    np.testing.assert_array_equal(tgraph._stable_lexsort(keys, sizes),
                                  np.lexsort(keys))
