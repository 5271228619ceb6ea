"""Paper Alg. 5 loop invariants of the ZenLDA conditional
(``repro/core/decompositions.py``), only what ``core.sampler`` needs.

Its ``alpha_k`` is ``t4 * (N_k + W beta)``, which rounds differently from
``LDAHyperParams.alpha_k``; the dense sweep uses this one, as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import LDAHyperParams


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
