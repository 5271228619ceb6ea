"""Model-quality metrics (``repro/core/likelihood.py``): the paper's
footnote-6 predictive log-likelihood, perplexity, and the collapsed joint
log p(w, z) split into its word and doc parts.

Each value is computed in float32, as the reference computes it, and
summed in float64. ``predictive_llh`` walks the tokens in chunks even
when ``token_chunk`` is 0: at NYTIMES width one (E, K) float32 matrix
would take 400 GB.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import counts as counts_lib
from repro_torch.core.sampler import chunk_size
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams


class LLH(NamedTuple):
    total: torch.Tensor
    word: torch.Tensor
    doc: torch.Tensor


def predictive_llh(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                   token_chunk: Optional[int] = None) -> torch.Tensor:
    """sum_tokens log sum_k (N_kd + α_k)/(N_d + Σα) · (N_wk + β)/(N_k + Wβ),
    a float64 scalar."""
    alpha_k = hyper.alpha_k(state.n_k)
    alpha_sum = torch.sum(alpha_k)
    n_d = counts_lib.doc_lengths(corpus.doc, corpus.num_docs).to(
        torch.float32)
    w_beta = corpus.num_words * hyper.beta
    phi_denom = state.n_k.to(torch.float32) + w_beta
    e = corpus.num_tokens
    size = chunk_size(e, hyper.num_topics, token_chunk)
    total = torch.zeros((), dtype=torch.float64, device=state.n_k.device)
    for s in range(0, e, size):
        w = corpus.word[s:s + size].long()
        d = corpus.doc[s:s + size].long()
        theta = (state.n_kd[d].to(torch.float32) + alpha_k[None, :]) / (
            n_d[d][:, None] + alpha_sum)
        phi = (state.n_wk[w].to(torch.float32) + hyper.beta) \
            / phi_denom[None, :]
        per_token = torch.log(torch.clamp_min(torch.sum(theta * phi, -1),
                                              1e-30))
        total += torch.sum(per_token, dtype=torch.float64)
    return total


def perplexity(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
               token_chunk: Optional[int] = None) -> torch.Tensor:
    llh = predictive_llh(state, corpus, hyper, token_chunk=token_chunk)
    return torch.exp(-llh / corpus.num_tokens)


def _lgamma_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.lgamma(x), dtype=torch.float64)


def joint_llh(state: CGSState, corpus: Corpus,
              hyper: LDAHyperParams) -> LLH:
    """Collapsed joint log p(w, z | α, β) = word part + doc part."""
    f32 = torch.float32
    k, w, d = hyper.num_topics, corpus.num_words, corpus.num_docs
    beta = hyper.beta
    dev = state.n_k.device
    alpha_k = hyper.alpha_k(state.n_k)
    alpha_sum = torch.sum(alpha_k)
    n_d = counts_lib.doc_lengths(corpus.doc, d).to(f32)

    def lg(v: float) -> float:
        return float(torch.lgamma(torch.tensor(v, dtype=f32)))

    # word part: prod_k [Γ(Wβ)/Γ(N_k+Wβ)] * prod_w Γ(N_wk+β)/Γ(β)
    word_part = (k * lg(w * beta)
                 - _lgamma_sum(state.n_k.to(f32) + w * beta)
                 + _lgamma_sum(state.n_wk.to(f32) + beta)
                 - k * w * lg(beta))
    # doc part: prod_d [Γ(Σα)/Γ(N_d+Σα)] * prod_k Γ(N_kd+α_k)/Γ(α_k)
    doc_part = (d * float(torch.lgamma(alpha_sum))
                - _lgamma_sum(n_d + alpha_sum)
                + _lgamma_sum(state.n_kd.to(f32) + alpha_k[None, :])
                - d * _lgamma_sum(alpha_k))
    word_part = torch.as_tensor(word_part, dtype=torch.float64, device=dev)
    doc_part = torch.as_tensor(doc_part, dtype=torch.float64, device=dev)
    return LLH(total=word_part + doc_part, word=word_part, doc=doc_part)
