"""Collapsed-Gibbs LDA worked out plainly: counts from topics, and the
draws of one sweep for a sample of tokens, from the corpus, the topics
before the sweep and the sweep's seed alone.

A sweep draws every token against the counts at the sweep's start, with
the token's own assignment taken out (¬dw). Eq. 3 of the paper gives

    p(z = k) ∝ (N_kd + α_k)(N_wk + β) / (N_k + Wβ)

with the asymmetric prior α_k = K·α·(N_k + α'/K) / (N + α'). Two samplers
draw from it:

* ``gumbel``: the Gumbel-max draw, argmax_k log p_k + g(seed, t, k) with
  g = -log(-log u) and u the float32 uniform of ``hash.hash_uniform``;
  the lowest k wins a tie.
* ``cdf``: ZenLDA's three-term CDF sampler (``zen_cdf``): the terms
  gDense α_kβ/(N_k+Wβ), wSparse N_wk·α_k/(N_k+Wβ) and dSparse
  N_kd(N_wk+β)/(N_k+Wβ) over the doc's ``max_kd`` largest counts (the
  lower topic first among equal counts), from stale counts that still
  hold the token; the term by mass, then the topic by a lower-bound
  search, twice (uniform streams 0 and 1), and the paper's §3.1 remedy
  (stream 2) takes the second draw where the first equals the token's
  previous topic, with probability 1/N_wk (term 2) or
  1/N_kd + (N_kd + N_wk - 1)/(N_kd·N_wk) (term 3).

``dtype`` is the precision of the model's arithmetic: float64 for the
reference, a lower one for the control that must come out wrong.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import hash as rhash

# sampled tokens per block of the (block, K) temporaries
BLOCK = 1 << 14


@dataclass(frozen=True)
class Prior:
    num_topics: int
    alpha: float
    beta: float
    alpha_prime: float
    asymmetric: bool


def counts(word, doc, topic, num_words: int, num_docs: int,
           num_topics: int):
    """(N_wk (W, K), N_kd (D, K), N_k (K,)) int64 by bincount."""
    k = num_topics
    z = topic.long()
    n_wk = torch.bincount(word.long() * k + z, minlength=num_words * k)
    n_kd = torch.bincount(doc.long() * k + z, minlength=num_docs * k)
    n_k = torch.bincount(z, minlength=k)
    return n_wk.view(num_words, k), n_kd.view(num_docs, k), n_k


def alpha_k(n_k: torch.Tensor, prior: Prior, dtype) -> torch.Tensor:
    n = n_k.to(dtype)
    if not prior.asymmetric:
        return torch.full_like(n, prior.alpha)
    k = prior.num_topics
    return (k * prior.alpha) * (n + prior.alpha_prime / k) \
        / (n.sum() + prior.alpha_prime)


def gumbel_draws(sample, word, doc, z_old, n_wk, n_kd, n_k, prior: Prior,
                 num_words: int, seed: int, dtype=torch.float64):
    """New topics (S,) of the sampled tokens ``sample`` (S,) int64 under
    the Gumbel-max sampler."""
    k = prior.num_topics
    cols = torch.arange(k, device=sample.device)
    a = alpha_k(n_k, prior, dtype)
    nk_all = n_k.to(dtype)
    wb = num_words * prior.beta
    out = torch.empty(sample.shape, dtype=torch.int64, device=sample.device)
    for s in range(0, sample.shape[0], BLOCK):
        t = sample[s:s + BLOCK]
        zo = z_old[t].long()
        own = (cols[None, :] == zo[:, None]).to(dtype)
        nw = n_wk[word[t].long()].to(dtype) - own
        nd = n_kd[doc[t].long()].to(dtype) - own
        nk = nk_all[None, :] - own
        p = (nd + a[None, :]) * (nw + prior.beta) / (nk + wb)
        u = rhash.hash_uniform(seed, t[:, None], cols[None, :]).to(dtype)
        score = torch.log(torch.clamp_min(p, 1e-30)) - torch.log(-torch.log(u))
        out[s:s + BLOCK] = torch.argmax(score, dim=1)
    return out


def doc_top(n_kd_rows: torch.Tensor, kd: int):
    """The ``kd`` largest counts of each row (higher count first, the
    lower topic first among equal counts): (counts, topics) int64."""
    r, k = n_kd_rows.shape
    key = n_kd_rows.long() * k + torch.arange(k - 1, -1, -1,
                                             device=n_kd_rows.device)
    top = torch.sort(key, dim=1, descending=True).values[:, :kd]
    return top // k, (k - 1) - top % k


def cdf_draws(sample, word, doc, z_old, n_wk, n_kd, n_k, prior: Prior,
              num_words: int, max_kd: int, seed: int, dtype=torch.float64):
    """New topics (S,) of the sampled tokens under the three-term CDF
    sampler with doc rows of ``max_kd`` topics."""
    k = prior.num_topics
    dev = sample.device
    a = alpha_k(n_k, prior, dtype)
    t1 = 1.0 / (n_k.to(dtype) + num_words * prior.beta)
    g_cdf = torch.cumsum(a * prior.beta * t1, 0)
    m1 = g_cdf[-1]
    w_term = a * t1
    kd = min(max_kd, k)
    out = torch.empty(sample.shape, dtype=torch.int64, device=dev)
    for s in range(0, sample.shape[0], BLOCK):
        t = sample[s:s + BLOCK]
        w, d, zo = word[t].long(), doc[t].long(), z_old[t].long()
        u = rhash.stream_uniforms(seed, t, 3).to(dtype)
        nw_rows = n_wk[w]
        w_cdf = torch.cumsum(nw_rows.to(dtype) * w_term[None, :], 1)
        m2 = w_cdf[:, -1]
        cnt, top = doc_top(n_kd[d], kd)
        d_vals = cnt.to(dtype) * (torch.gather(nw_rows, 1, top).to(dtype)
                                  + prior.beta) * t1[top]
        d_cdf = torch.cumsum(torch.where(cnt > 0, d_vals, 0.0), 1)
        total = m1 + m2 + d_cdf[:, -1]

        def lower_bound(cdf, target):
            n = cdf.shape[-1]
            return torch.clamp_max((cdf < target[:, None]).sum(1), n - 1)

        def draw(u01):
            x = u01 * total
            branch = torch.where(x < m1, 0, torch.where(x < m1 + m2, 1, 2))
            z_g = lower_bound(g_cdf[None, :].expand(x.shape[0], k), x)
            z_w = lower_bound(w_cdf, torch.clamp_min(x - m1, 0.0))
            pos = lower_bound(d_cdf, torch.clamp_min(x - m1 - m2, 0.0))
            z_d = torch.gather(top, 1, pos[:, None])[:, 0]
            z = torch.where(branch == 0, z_g,
                            torch.where(branch == 1, z_w, z_d))
            return torch.clamp_max(z, k - 1), branch

        z1, branch = draw(u[0])
        z2, _ = draw(u[1])
        nw_prev = torch.clamp_min(nw_rows.gather(1, zo[:, None])[:, 0]
                                  .to(dtype), 1.0)
        nd_prev = torch.clamp_min(n_kd[d, zo].to(dtype), 1.0)
        p_w = 1.0 / nw_prev
        p_d = torch.clamp(1.0 / nd_prev + (nd_prev + nw_prev - 1.0)
                          / (nd_prev * nw_prev), 0.0, 1.0)
        p = torch.where(branch == 1, p_w,
                        torch.where(branch == 2, p_d, torch.zeros_like(p_w)))
        take_second = (z1 == zo) & (u[2] < p)
        out[s:s + BLOCK] = torch.where(take_second, z2, z1)
    return out

