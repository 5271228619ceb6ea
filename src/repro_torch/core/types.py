"""Hyper-parameters, the token-level corpus and the CGS sampler state
(``repro/core/types.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
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

    def to(self, device) -> "Corpus":
        """The same corpus with its id vectors on ``device``."""
        return Corpus(word=self.word.to(device), doc=self.doc.to(device),
                      num_words=self.num_words, num_docs=self.num_docs)


_STATE_TENSORS = ("topic", "prev_topic", "n_wk", "n_kd", "n_k",
                  "stale_iters", "same_count")


@dataclasses.dataclass
class CGSState:
    """Full sampler state: assignments, derived counts and the run key.

    ``topic`` is the per-token assignment z_dw, ``prev_topic`` the one of
    the previous iteration (the delta merge needs both, paper §5.2).
    ``stale_iters``/``same_count`` drive "converged" token exclusion
    (§5.1): i = iterations not processed, t = times processed with an
    unchanged topic. ``rng`` is a (2,) int64 key of two uint32 words
    (``core.keys``), the port's stand-in for a ``jax.random`` key. All
    tensors but ``rng`` lie on one device."""

    topic: torch.Tensor  # (E,) int32
    prev_topic: torch.Tensor  # (E,) int32
    n_wk: torch.Tensor  # (W, K) int32
    n_kd: torch.Tensor  # (D, K) int32
    n_k: torch.Tensor  # (K,) int32
    rng: torch.Tensor  # (2,) int64 key words
    iteration: int = 0
    stale_iters: Optional[torch.Tensor] = None  # (E,) int32
    same_count: Optional[torch.Tensor] = None  # (E,) int32

    def check_invariants(self, corpus: Corpus) -> None:
        """Count conservation, with int64 sums (a sum of int32 counts over
        ~10^8 tokens must not wrap). Raises ``AssertionError``."""
        i64 = torch.int64
        e = corpus.num_tokens
        n_k = self.n_k.to(i64)
        checks = (
            ("sum n_wk == E", int(self.n_wk.sum(dtype=i64)) == e),
            ("sum n_kd == E", int(self.n_kd.sum(dtype=i64)) == e),
            ("sum n_k == E", int(n_k.sum()) == e),
            ("n_wk column sums == n_k",
             bool(torch.equal(self.n_wk.sum(0, dtype=i64), n_k))),
            ("n_kd column sums == n_k",
             bool(torch.equal(self.n_kd.sum(0, dtype=i64), n_k))),
            ("counts >= 0", bool((self.n_wk >= 0).all()
                                 and (self.n_kd >= 0).all()
                                 and (self.n_k >= 0).all())),
        )
        failed = [name for name, ok in checks if not ok]
        if failed:
            raise AssertionError(f"count invariants violated at iteration "
                                 f"{self.iteration}: {', '.join(failed)}")

    def to_numpy(self) -> Dict[str, object]:
        """The state as numpy leaves (``rng`` as two uint32 words), the
        form a reference ``CGSState`` converts to field by field."""
        out: Dict[str, object] = {
            name: getattr(self, name).cpu().numpy()
            for name in _STATE_TENSORS if getattr(self, name) is not None
        }
        out["rng"] = self.rng.cpu().numpy().astype(np.uint32)
        out["iteration"] = int(self.iteration)
        return out

    @classmethod
    def from_numpy(cls, leaves: Dict[str, object],
                   device=None) -> "CGSState":
        """Inverse of :meth:`to_numpy`. ``rng`` may be any two uint32
        words, e.g. ``jax.random.key_data`` of a reference state's key.
        ``device`` defaults to ``cuda`` and raises without a card."""
        from repro_torch.core.keys import as_key
        from repro_torch.device import resolve_device

        device = resolve_device(device)
        kw = {}
        for name in _STATE_TENSORS:
            if leaves.get(name) is not None:
                kw[name] = torch.as_tensor(
                    np.asarray(leaves[name], np.int32), device=device)
        return cls(rng=as_key(np.asarray(leaves["rng"])),
                   iteration=int(leaves.get("iteration", 0)), **kw)
