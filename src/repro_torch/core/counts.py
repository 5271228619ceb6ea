"""Count matrices from token assignments (``repro/core/counts.py``), by
``index_put_(accumulate=True)``: integer sums, bit-equal to the reference's
scatter-adds in any order."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
