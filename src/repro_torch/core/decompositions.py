"""Formula decompositions of the CGS conditional (paper §3.1, Table 1;
``repro/core/decompositions.py``).

All target Eq. 3, p(z=k) ∝ (N_w|k + β) / (N_k + Wβ) · (N_k|d + α_k):

* ``precompute_zen_terms`` — paper Alg. 5's loop invariants t1..t5 and
  gDense, once per iteration. Its ``alpha_k`` is ``t4 * (N_k + W beta)``,
  which rounds differently from ``LDAHyperParams.alpha_k``; the samplers
  use this one, as the reference does.
* ``zen_probs`` — gDense + wSparse + dSparse (ZenLDA's choice);
* ``std_probs`` — Eq. 3 as written;
* ``sparselda_buckets`` — SparseLDA's s, r and q buckets.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from repro_torch.core.types import LDAHyperParams


class Decomposition(enum.Enum):
    """Which sampling algorithm / decomposition to use (paper Table 1)."""

    STD = "std"  # O(K) standard CGS, fresh
    ZEN = "zen"  # gDense + wSparse + dSparse (the paper's choice)
    ZEN_HYBRID = "zen_hybrid"  # per-token min(K_d, K_w) alternation
    SPARSE_LDA = "sparselda"  # s + r + q buckets, LSearch
    ALIAS_LDA = "aliaslda"  # stale alias + fresh K_d term, MH
    LIGHT_LDA = "lightlda"  # cycle MH word/doc proposals


class ZenTerms(NamedTuple):
    """Per-iteration loop invariants (paper Alg. 5)."""

    t1: torch.Tensor  # (K,) 1 / (N_k + W*beta)
    t4: torch.Tensor  # (K,) alpha_k / (N_k + W*beta)
    t5: torch.Tensor  # (K,) beta / (N_k + W*beta)
    g_dense: torch.Tensor  # (K,) alpha_k * beta / (N_k + W*beta)
    alpha_k: torch.Tensor  # (K,)
    g_mass: torch.Tensor  # () sum of g_dense


def precompute_zen_terms(n_k: torch.Tensor, hyper: LDAHyperParams,
                         num_words: int) -> ZenTerms:
    """Paper Alg. 5 lines 1-6, in the reference's float32 op order."""
    n_k = n_k.to(torch.float32)
    w_beta = num_words * hyper.beta
    t1 = 1.0 / (n_k + w_beta)
    if hyper.asymmetric_alpha:
        n_total = torch.sum(n_k)
        k = float(hyper.num_topics)
        t2 = k * hyper.alpha / (n_total + hyper.alpha_prime)
        t3 = hyper.alpha_prime / k - w_beta
        t4 = t2 + (t2 * t3) * t1
        alpha_k = t4 * (n_k + w_beta)
    else:
        alpha_k = torch.full_like(n_k, hyper.alpha)
        t4 = alpha_k * t1
    t5 = hyper.beta * t1
    g_dense = hyper.beta * t4
    return ZenTerms(t1=t1, t4=t4, t5=t5, g_dense=g_dense, alpha_k=alpha_k,
                    g_mass=torch.sum(g_dense))


def zen_probs(n_wk_rows: torch.Tensor, n_kd_rows: torch.Tensor,
              terms: ZenTerms, beta: float) -> torch.Tensor:
    """Unnormalised p (T, K) = gDense + N_wk·t4 + N_kd·(N_wk + β)·t1 on
    gathered rows; Eq. 3 when the counts are fresh."""
    nw = n_wk_rows.to(torch.float32)
    nd = n_kd_rows.to(torch.float32)
    w_sparse = nw * terms.t4[None, :]
    d_sparse = nd * (nw + beta) * terms.t1[None, :]
    return terms.g_dense[None, :] + w_sparse + d_sparse


def std_probs(n_wk_rows: torch.Tensor, n_kd_rows: torch.Tensor,
              n_k: torch.Tensor, alpha_k: torch.Tensor, beta: float,
              num_words: int) -> torch.Tensor:
    """Unnormalised p (T, K) straight from Eq. 3; ``n_k`` is (K,) or
    per-token (T, K)."""
    denom = n_k.to(torch.float32) + num_words * beta
    return ((n_wk_rows.to(torch.float32) + beta) / denom
            * (n_kd_rows.to(torch.float32) + alpha_k))


def sparselda_buckets(n_wk_rows: torch.Tensor, n_kd_rows: torch.Tensor,
                      terms: ZenTerms, beta: float):
    """SparseLDA's buckets (Table 1): s = α_k·β·t1 (dense), r = N_kd·β·t1
    (K_d sparse), q = N_wk·(N_kd·t1 + t4) (K_w sparse); s + r + q is
    Eq. 3."""
    nd = n_kd_rows.to(torch.float32)
    s = terms.g_dense[None, :] * torch.ones_like(nd)
    r = nd * terms.t5[None, :]
    q = n_wk_rows.to(torch.float32) * (nd * terms.t1[None, :]
                                       + terms.t4[None, :])
    return s, r, q
