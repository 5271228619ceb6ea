"""The numbers that decide ``correct`` for a training cell, from the
program's outputs and the plain reference.

* ``init``: sampled tokens whose initial topic differs from the seed's
  (exact, limit 0).
* ``first_sweep``: the share of sampled tokens whose topic after the
  first sweep differs from the reference's draw, worked out from the
  seed alone (initial topics, their counts, the sweep's noise).
* ``last_sweep``: the same share for the window's last sweep, worked out
  from the program's topics before it (``prev_topic``): the reference
  recounts them and draws again. The sweeps between the first and the
  last are the same code on other counts; ``counts`` covers them.
* ``counts``: entries of N_wk, N_kd and N_k that differ from a recount of
  the final topics (exact, limit 0): every sweep's delta merge, summed.

A share is a fraction of the sample, so an alteration of a fraction f of
the draws is caught with probability 1 - (1 - f)^S.
"""
from __future__ import annotations

import torch

from portbench.reference import hash as rhash
from portbench.reference import lda


def sample_tokens(seed: int, num_tokens: int, size: int, device):
    """``size`` token indices (sorted, int64, drawn with replacement) from
    the seed; every token where the corpus is no larger."""
    if size >= num_tokens:
        return torch.arange(num_tokens, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed ^ 0x5EED)
    idx = torch.randint(0, num_tokens, (size,), generator=g, device=device)
    return torch.sort(idx).values


def init_mismatch(seed: int, sample, init_topics, num_topics: int) -> int:
    ref = rhash.initial_topics(seed, sample, num_topics)
    return int((ref != init_topics.long()).sum())


def draw_mismatch(sampler: str, sample, drawn, corpus, z_before, prior,
                  seed: int, iteration: int, max_kd: int) -> float:
    """Share of ``sample`` whose program topic ``drawn`` (S,) differs from
    the reference's draw in sweep ``iteration`` from topics ``z_before``."""
    word, doc, w, d = corpus
    n_wk, n_kd, n_k = lda.counts(word, doc, z_before, w, d,
                                 prior.num_topics)
    ref = reference_draws(sampler, sample, corpus, z_before, n_wk, n_kd,
                          n_k, prior, seed, iteration, max_kd)
    return share(ref, drawn, sample)


def control_mismatch(sampler: str, sample, corpus, z_before, prior,
                     seed: int, iteration: int, max_kd: int,
                     dtype) -> float:
    """``draw_mismatch`` of the control: the reference computed in
    ``dtype`` in the program's place, judged by the reference."""
    word, doc, w, d = corpus
    n_wk, n_kd, n_k = lda.counts(word, doc, z_before, w, d,
                                 prior.num_topics)
    args = (sampler, sample, corpus, z_before, n_wk, n_kd, n_k, prior,
            seed, iteration, max_kd)
    return share(reference_draws(*args), reference_draws(*args, dtype),
                 sample)


def share(ref, drawn, sample) -> float:
    return float((ref != drawn.long()).sum()) / max(1, sample.shape[0])


def reference_draws(sampler, sample, corpus, z_before, n_wk, n_kd, n_k,
                    prior, seed: int, iteration: int, max_kd: int,
                    dtype=torch.float64):
    word, doc, w, _ = corpus
    sweep = rhash.sweep_seed(seed, iteration)
    if sampler == "gumbel":
        return lda.gumbel_draws(sample, word, doc, z_before, n_wk, n_kd,
                                n_k, prior, w, sweep, dtype)
    if sampler == "cdf":
        return lda.cdf_draws(sample, word, doc, z_before, n_wk, n_kd, n_k,
                             prior, w, max_kd, sweep, dtype)
    raise ValueError(f"unknown sampler {sampler!r}")


def count_mismatch(corpus, topic, n_wk, n_kd, n_k, num_topics: int) -> int:
    word, doc, w, d = corpus
    r_wk, r_kd, r_k = lda.counts(word, doc, topic, w, d, num_topics)
    bad = int((r_wk != n_wk.long()).sum())
    del r_wk
    bad += int((r_kd != n_kd.long()).sum())
    del r_kd
    return bad + int((r_k != n_k.long()).sum())
