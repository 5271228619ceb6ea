"""The corpus generator at a tiny size on the CPU."""
import pytest
import torch

from portbench.traffic.lda_corpus import lda_corpus

ARGS = dict(num_docs=120, num_words=500, num_topics=10, mean_doc_len=30.0,
            doc_prior=0.1, word_prior=0.05, device="cpu")


def test_shapes_ranges_and_layout():
    word, doc, z = lda_corpus(2**31 + 5, **ARGS)
    assert word.dtype == doc.dtype == z.dtype == torch.int32
    assert word.shape == doc.shape == z.shape
    assert int(word.min()) >= 0 and int(word.max()) < ARGS["num_words"]
    assert int(z.min()) >= 0 and int(z.max()) < ARGS["num_topics"]
    # document by document, every document holds a token or more
    assert bool((doc[1:] >= doc[:-1]).all())
    lengths = torch.bincount(doc.long(), minlength=ARGS["num_docs"])
    assert int(lengths.min()) >= 1
    assert abs(lengths.float().mean().item() - ARGS["mean_doc_len"]) < 3


def test_same_seed_same_corpus_other_seed_other():
    a = lda_corpus(7, **ARGS)
    b = lda_corpus(7, **ARGS)
    c = lda_corpus(8, **ARGS)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0][:100], c[0][:100])


def test_topics_are_planted():
    """Documents draw from few topics and topics from few words, as the
    Dirichlet priors make them: far from the uniform draw."""
    word, doc, z = lda_corpus(3, **dict(ARGS, num_docs=400))
    k, w = ARGS["num_topics"], ARGS["num_words"]
    per_doc = torch.zeros(400, k).index_put_(
        (doc.long(), z.long()), torch.ones(z.shape), accumulate=True)
    top_share = (per_doc.max(1).values / per_doc.sum(1)).mean().item()
    assert top_share > 0.5  # uniform over 10 topics: ~0.2
    per_topic = torch.zeros(k, w).index_put_(
        (z.long(), word.long()), torch.ones(z.shape), accumulate=True)
    distinct = (per_topic > 0).sum(1).float().mean().item()
    tokens = per_topic.sum(1).mean().item()
    assert distinct < 0.5 * min(tokens, w)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3, 2**40 + 1])
def test_wide_seeds(seed):
    word, _, _ = lda_corpus(seed, **ARGS)
    assert word.numel() > 0
