"""Model inference for new documents (``repro/core/inference.py``).

* ``cgs_infer``    — CGS sweeps over one document with the word-topic
  model frozen; the single-document oracle of the engine's default dense
  sweep (``algorithms.base._dense_infer_sweep``). Both run
  :func:`chain_sweep` under the key schedule of ``core.keys``, so a served
  theta is bit-equal to this function's.
* ``rtlda_assign`` — the RT-LDA decode on a padded (B, L) slot batch
  (the reference's ``vmap`` written out as a batch dimension, its ``scan``
  as a loop): deterministic argmax passes, padding ignored exactly.
* ``rtlda_infer``  — RT-LDA theta for one document.

RT-LDA uses no randomness, so its assignments equal the reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.keys import fold_in, init_topics, token_seeds
from repro_torch.core.keys import token_uniforms
from repro_torch.core.types import LDAHyperParams
from repro_torch.kernels.zen_sampler import gumbel_noise


def frozen_phi_rows(n_wk, n_k, words, hyper: LDAHyperParams,
                    w_total: Optional[int] = None) -> torch.Tensor:
    """``(N_wk[words] + beta) / (N_k + W beta)``, shape ``words.shape +
    (K,)`` float32. ``W beta`` is formed in double and rounded once."""
    w_total = n_wk.shape[0] if w_total is None else w_total
    denom = n_k.to(torch.float32) + w_total * hyper.beta
    return (n_wk[words.long()].to(torch.float32) + hyper.beta) / denom


def _counts(z: torch.Tensor, live: torch.Tensor, k: int) -> torch.Tensor:
    """Doc-topic counts (B, K) int32 of assignments (B, L) over live
    tokens."""
    return torch.zeros((z.shape[0], k), dtype=torch.int32,
                       device=z.device).scatter_add_(1, z.long(), live)


def chain_sweep(phi, alpha_k, keys, z, mask, n_kd,
                method: str = "cdf") -> torch.Tensor:
    """One frozen-phi CGS sweep over slots: ``phi`` (B, L, K), per-slot
    ``keys`` (B, 2), assignments ``z``/``mask`` (B, L), counts ``n_kd``
    (B, K). Doc-side self-exclusion on live tokens. Returns (B, L) int32.

    ``cdf`` inverts the cumulative conditional at a hashed uniform;
    ``gumbel`` takes the argmax under the kernels' hash noise."""
    b, l, k = phi.shape
    onehot = torch.nn.functional.one_hot(z.long(), k).to(torch.int32)
    onehot = onehot * mask.to(torch.int32)[..., None]
    probs = phi * ((n_kd[:, None, :] - onehot).to(torch.float32) + alpha_k)
    if method == "gumbel":
        cols = torch.arange(k, device=phi.device)
        g = gumbel_noise(token_seeds(keys, l)[..., None], 0, cols)
        return torch.argmax(
            torch.log(torch.clamp_min(probs, 1e-30)) + g, dim=-1
        ).to(torch.int32)
    if method != "cdf":
        raise ValueError(f"unknown sampling method {method!r}")
    cdf = torch.cumsum(probs, dim=-1)
    u = token_uniforms(keys, l)[..., None]
    return torch.clamp_max(
        torch.sum(cdf < u * cdf[..., -1:], dim=-1), k - 1
    ).to(torch.int32)


def cgs_infer(key, n_wk, n_k, words, hyper: LDAHyperParams,
              num_sweeps: int = 10) -> torch.Tensor:
    """Infer theta (K,) for one document of ``words`` by CGS with frozen
    phi; ``key`` is a (2,) request key (``core.keys``)."""
    dev = n_wk.device
    l, k = int(words.shape[0]), hyper.num_topics
    key = key.to(dev)
    z = init_topics(key, l, k, device=dev)[None, :]
    live = torch.ones((1, l), dtype=torch.int32, device=dev)
    n_kd = _counts(z, live, k)
    alpha_k = hyper.alpha_k(n_k)
    phi = frozen_phi_rows(n_wk, n_k, words[None, :], hyper)
    for j in range(num_sweeps):
        z_new = chain_sweep(phi, alpha_k, fold_in(key, j + 1)[None, :], z,
                            live.bool(), n_kd)
        n_kd = n_kd + _counts(z_new, live, k) - _counts(z, live, k)
        z = z_new
    return (n_kd[0].to(torch.float32) + alpha_k) / (l + torch.sum(alpha_k))


def rtlda_assign(n_wk, n_k, words, mask, hyper: LDAHyperParams,
                 num_sweeps: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """RT-LDA decode on a padded slot batch.

    Args:
        words: ``(B, L)`` token ids (padding may hold any in-vocabulary id).
        mask: ``(B, L)`` bool, True on live tokens; padding never enters
            the counts, so the live prefix decodes the same at every width.
        num_sweeps: argmax passes after the greedy initial assignment.

    Returns:
        ``(z, n_kd)``: ``(B, L)`` int32 topics (garbage at padding) and
        ``(B, K)`` int32 counts over live tokens.
    """
    k = hyper.num_topics
    live = mask.to(torch.int32)
    alpha_k = hyper.alpha_k(n_k)
    phi = frozen_phi_rows(n_wk, n_k, words, hyper)
    # zero counts: 0.0 + alpha_k is alpha_k exactly, as in the reference
    z = torch.argmax(phi * alpha_k, dim=-1)
    for _ in range(num_sweeps):
        n_kd = _counts(z, live, k).to(torch.float32)
        z = torch.argmax(phi * (n_kd[:, None, :] + alpha_k), dim=-1)
    return z.to(torch.int32), _counts(z, live, k)


def rtlda_infer(n_wk, n_k, words, hyper: LDAHyperParams,
                num_sweeps: int = 3) -> torch.Tensor:
    """RT-LDA theta (K,) float32 for one document ``words`` (L,)."""
    l = int(words.shape[0])
    _, n_kd = rtlda_assign(
        n_wk, n_k, words[None, :],
        torch.ones((1, l), dtype=torch.bool, device=words.device),
        hyper, num_sweeps,
    )
    alpha_k = hyper.alpha_k(n_k)
    return (n_kd[0].to(torch.float32) + alpha_k) / (l + torch.sum(alpha_k))
