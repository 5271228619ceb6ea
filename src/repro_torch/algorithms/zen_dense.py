"""Dense (T, K) backends in plain torch (the reference has no kernel for
them either): ``zen`` (+ ``zen_dense`` alias), the three-term
decomposition, and ``std``, Eq. 3 as written.

Per-token dense (T, K) probabilities with exact ¬dw self-exclusion,
sampled by inverse CDF or Gumbel-max. The single-box ``sweep`` is the
oracle sweep ``core.sampler.cgs_sweep_stale``, as in the reference;
``zen``'s ``cell_sweep`` is the per-cell form (``zen_dense_cell``); ``std``
is single-box only, as in the reference. Both serve through the default
dense frozen-phi sweep.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms.base import (
    CellBackend,
    SamplerBackend,
    SamplerKnobs,
    chunked_token_map,
)
from repro_torch.algorithms.registry import register
from repro_torch.core.keys import token_rows
from repro_torch.core.sampler import cgs_sweep_stale, sample_categorical


def _searchsorted_rows(cdf: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Row-wise lower bound: cdf (T, N) ascending, targets (T,) -> (T,)
    int32, clamped to N - 1."""
    return torch.clamp_max(torch.sum(cdf < targets[:, None], dim=-1),
                           cdf.shape[-1] - 1).to(torch.int32)


def zen_dense_cell(seed: int, word_l, doc_l, z_old, mask, n_wk_l, n_kd_l,
                   n_k, hyper, num_words_pad: int, method: str,
                   token_chunk: int, token_index=None) -> torch.Tensor:
    """Dense per-token (T, K) three-term probabilities; exact ¬dw. Token
    t's noise hashes (seed, token_index[t]) (default: (seed, t))."""
    k = hyper.num_topics
    alpha_k = hyper.alpha_k(n_k)[None, :]
    w_beta = num_words_pad * hyper.beta
    cols = torch.arange(k, device=n_k.device)

    def chunk(start, w, d, z):
        onehot = (cols[None, :] == z.long()[:, None]).to(torch.int32)
        nw = (n_wk_l[w.long()] - onehot).to(torch.float32)
        nd = (n_kd_l[d.long()] - onehot).to(torch.float32)
        nk = (n_k[None, :] - onehot).to(torch.float32)
        t1 = 1.0 / (nk + w_beta)
        p = (alpha_k * hyper.beta + nw * alpha_k
             + nd * (nw + hyper.beta)) * t1
        rows = token_rows(start, w.shape[0], w.device)
        return sample_categorical(p, seed, rows, method)

    return chunked_token_map(chunk, (word_l, doc_l, z_old), token_chunk, k,
                             token_index=token_index)


@register("zen", "zen_dense")
class ZenDense(CellBackend):
    """ZenLDA three-term decomposition over dense rows (paper Eq. 3)."""

    decomposition = "zen"

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs, aux=None):
        return cgs_sweep_stale(
            state, corpus, hyper, method=knobs.sampling_method,
            decomposition=self.decomposition,
            token_chunk=knobs.chunk_or_none(),
        )

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        return zen_dense_cell(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, knobs.sampling_method, knobs.token_chunk,
            token_index,
        )


@register("std")
class StdDense(SamplerBackend):
    """Textbook (non-decomposed) Eq. 3 conditional — dense, single-box."""

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs, aux=None):
        return cgs_sweep_stale(
            state, corpus, hyper, method=knobs.sampling_method,
            decomposition="std", token_chunk=knobs.chunk_or_none(),
        )
