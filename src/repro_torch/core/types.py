"""Hyper-parameters and the token-level corpus (``repro/core/types.py``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LDAHyperParams:
    """Hyper-parameters of the (asymmetric-prior) LDA model, paper Eq. 3.

    Same fields as the reference, so ``dataclasses.asdict`` of either loads
    in the other (the checkpoint's ``hyper`` metadata)."""

    num_topics: int
    alpha: float = 0.01
    beta: float = 0.01
    alpha_prime: float = 1.0
    asymmetric_alpha: bool = True

    def alpha_k(self, n_k: torch.Tensor) -> torch.Tensor:
        """Per-topic alpha_k, float32 on ``n_k``'s device. The float32 sum
        of N_k is exact while the total stays below 2^24 tokens; above
        that it depends on summation order, as the reference's does."""
        if not self.asymmetric_alpha:
            return torch.full((self.num_topics,), self.alpha,
                              dtype=torch.float32, device=n_k.device)
        n_k = n_k.to(torch.float32)
        n_total = torch.sum(n_k)
        k = float(self.num_topics)
        return (k * self.alpha) * (n_k + self.alpha_prime / k) / (
            n_total + self.alpha_prime
        )


@dataclasses.dataclass(frozen=True)
class Corpus:
    """A token-level (edge list) corpus: one row per token occurrence."""

    word: torch.Tensor  # (E,) int32 word id per token
    doc: torch.Tensor  # (E,) int32 doc id per token
    num_words: int  # W
    num_docs: int  # D

    @property
    def num_tokens(self) -> int:
        return int(self.word.shape[0])

    def validate(self) -> None:
        if self.word.shape != self.doc.shape:
            raise ValueError(f"word {tuple(self.word.shape)} and doc "
                             f"{tuple(self.doc.shape)} differ in shape")
        if self.word.dtype != torch.int32 or self.doc.dtype != torch.int32:
            raise ValueError("corpus ids must be int32")
