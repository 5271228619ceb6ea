"""Count matrices and their deltas from token assignments
(``repro/core/counts.py``): integer sums, bit-equal to the reference's
scatter-adds in any order. The counts are built by
``index_put_(accumulate=True)`` (on the card it sorts its indices first,
so the ~20% of tokens on a Zipf corpus's top word do not contend on one
address); the per-sweep deltas go through kernel 5 where the caller
dispatches kernels, else through its plain version."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.topic_histogram import (
    CHANGED_TOKENS,
    RowOrder,
    topic_histogram_plain,
)
from repro_torch.observe import metrics


def _ones(ids: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(ids.shape, dtype=torch.int32, device=ids.device)
    return mask.to(torch.int32)


def build_counts(
    word: torch.Tensor,
    doc: torch.Tensor,
    topic: torch.Tensor,
    num_words: int,
    num_docs: int,
    num_topics: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n_wk, n_kd, n_k) int32 from token assignments; ``mask`` (bool
    (E,)) marks real tokens, padded tokens contribute nothing."""
    ones = _ones(topic, mask)
    dev = topic.device
    w, d, z = word.long(), doc.long(), topic.long()
    n_wk = torch.zeros((num_words, num_topics), dtype=torch.int32,
                       device=dev).index_put_((w, z), ones, accumulate=True)
    n_kd = torch.zeros((num_docs, num_topics), dtype=torch.int32,
                       device=dev).index_put_((d, z), ones, accumulate=True)
    n_k = torch.zeros((num_topics,), dtype=torch.int32,
                      device=dev).index_put_((z,), ones, accumulate=True)
    return n_wk, n_kd, n_k


def doc_lengths(doc: torch.Tensor, num_docs: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tokens per document, (D,) int32."""
    return torch.zeros((num_docs,), dtype=torch.int32,
                       device=doc.device).index_put_(
        (doc.long(),), _ones(doc, mask), accumulate=True)


def delta_counts(
    word: torch.Tensor,
    doc: torch.Tensor,
    old_topic: torch.Tensor,
    new_topic: torch.Tensor,
    num_words: int,
    num_docs: int,
    num_topics: int,
    mask: Optional[torch.Tensor] = None,
    *,
    use_kernel: bool = False,
    orders: Optional[Tuple[RowOrder, RowOrder]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Delta aggregation (paper §5.2): (d_wk, d_kd, d_k) int32 with
    ``new_counts = old_counts + delta``; tokens whose topic did not change
    (or that ``mask`` marks padded) contribute exactly zero. d_k is d_wk's
    column sum (exact in int32).

    The two (rows, K) deltas are kernel 5 (``ops.topic_histogram``) when
    ``use_kernel`` (the caller's ``kernel_dispatch``), walking the
    ``orders`` (word, doc) :class:`RowOrder` of these tokens where given;
    else its plain version. Both give the same integers. While a profiler
    records, the tokens that change are added to the trace's
    ``counts.changed_tokens`` (by kernel 5 on its word-side call)."""
    counting = metrics.tracing()
    if use_kernel:
        inc = None if mask is None else mask.to(torch.int32)
        w_order, d_order = orders if orders is not None else (None, None)
        d_wk = ops.topic_histogram(word, old_topic, new_topic, inc,
                                   num_words, num_topics, order=w_order,
                                   count=counting)
        d_kd = ops.topic_histogram(doc, old_topic, new_topic, inc,
                                   num_docs, num_topics, order=d_order)
        return d_wk, d_kd, d_wk.sum(0, dtype=torch.int32)
    changed = old_topic != new_topic
    if mask is not None:
        changed = changed & mask
    if counting:
        metrics.count(CHANGED_TOKENS, changed.sum())
    inc = changed.to(torch.int32)
    d_wk = topic_histogram_plain(word, old_topic, new_topic, inc,
                                 num_words, num_topics)
    d_kd = topic_histogram_plain(doc, old_topic, new_topic, inc,
                                 num_docs, num_topics)
    return d_wk, d_kd, d_wk.sum(0, dtype=torch.int32)


def word_frequencies(word: torch.Tensor, num_words: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tokens per word, (W,) int32."""
    return torch.zeros((num_words,), dtype=torch.int32,
                       device=word.device).index_put_(
        (word.long(),), _ones(word, mask), accumulate=True)
