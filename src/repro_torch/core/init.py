"""Topic-assignment initialisation (``repro/core/init.py``, paper §5.1
"Sparse model initialization").

* ``random_init``       — every token draws uniformly from K.
* ``sparse_word_init``  — each word samples a private subset S of
  ceil(deg*K) topics; its tokens draw uniformly from S only.
* ``sparse_doc_init``   — the same per document.

The draws are counter-based (``core.keys``), not threefry: the run key is
split as the reference splits it, and each draw hashes (subkey, token or
group index), so the assignments depend on nothing but the key and the
corpus order. Subsets are built as in the reference: group g's subset is
{(offset_g + j * stride_g) mod K : j < s}, with an odd stride.
"""
from __future__ import annotations

import torch

from repro_torch.core import counts as counts_lib
from repro_torch.core.keys import split, uniform_ints
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams


def make_state(topic: torch.Tensor, corpus: Corpus, hyper: LDAHyperParams,
               rng: torch.Tensor) -> CGSState:
    """A fresh state at iteration 0 with counts built from ``topic``."""
    topic = topic.to(torch.int32)
    n_wk, n_kd, n_k = counts_lib.build_counts(
        corpus.word, corpus.doc, topic,
        corpus.num_words, corpus.num_docs, hyper.num_topics,
    )
    zeros = torch.zeros_like(topic)
    return CGSState(
        topic=topic, prev_topic=topic, n_wk=n_wk, n_kd=n_kd, n_k=n_k,
        rng=rng, iteration=0, stale_iters=zeros, same_count=zeros.clone(),
    )


def random_init(rng: torch.Tensor, corpus: Corpus,
                hyper: LDAHyperParams) -> CGSState:
    key, state_key = split(rng)
    topic = uniform_ints(key, corpus.num_tokens, hyper.num_topics,
                         device=corpus.word.device)
    return make_state(topic, corpus, hyper, state_key)


def _subset_init(rng: torch.Tensor, corpus: Corpus, hyper: LDAHyperParams,
                 group: torch.Tensor, num_groups: int,
                 degree: float) -> CGSState:
    """Group g's tokens draw uniformly from a subset of s = round(deg*K)
    topics: a per-group offset plus an odd stride, mod K."""
    k = hyper.num_topics
    s = max(1, int(round(degree * k)))
    dev = corpus.word.device
    key_off, key_stride, key_j, state_key = split(rng, 4)
    offsets = uniform_ints(key_off, num_groups, k, device=dev)
    strides = 2 * uniform_ints(key_stride, num_groups, max(1, k // 2),
                               device=dev) + 1
    j = uniform_ints(key_j, corpus.num_tokens, s, device=dev)
    g = group.long()
    topic = (offsets[g] + j * strides[g]) % k
    return make_state(topic, corpus, hyper, state_key)


def sparse_word_init(rng: torch.Tensor, corpus: Corpus,
                     hyper: LDAHyperParams,
                     degree: float = 0.1) -> CGSState:
    return _subset_init(rng, corpus, hyper, corpus.word, corpus.num_words,
                        degree)


def sparse_doc_init(rng: torch.Tensor, corpus: Corpus,
                    hyper: LDAHyperParams,
                    degree: float = 0.1) -> CGSState:
    return _subset_init(rng, corpus, hyper, corpus.doc, corpus.num_docs,
                        degree)


def beta_boost(state: CGSState, hyper: LDAHyperParams,
               boost: float = 2.0) -> torch.Tensor:
    """Per-(w, k) effective beta, boosted where the word never got the
    topic at init (paper §5.1). (W, K) float32."""
    return torch.where(state.n_wk == 0,
                       torch.tensor(hyper.beta * boost, dtype=torch.float32),
                       torch.tensor(hyper.beta, dtype=torch.float32))
