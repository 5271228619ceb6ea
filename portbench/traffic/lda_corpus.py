"""A corpus drawn on the device from a seed by LDA's generative process
(the paper's Eq. 1): φ_k ~ Dir(word_prior) over W words for each of K
topics, θ_d ~ Dir(doc_prior) over K for each of D documents, a length
L_d ~ Poisson(mean_doc_len) (at least 1), and for each token a topic
z ~ θ_d and a word w ~ φ_z. Tokens are laid out document by document.

Everything is drawn with one ``torch.Generator`` on the device in a few
large calls: Dirichlet rows as normalised Gamma draws, categorical draws
by a lower-bound search in float64 cumulative rows. The same seed on the
same device gives the same corpus.
"""
from __future__ import annotations

import torch

# documents per block of the (block, K) document-topic rows
DOC_BLOCK = 1 << 16


def _dirichlet_cdf(rows: int, cols: int, conc: float, g, device):
    """(rows, cols) float64 cumulative rows of Dir(conc) draws, each
    ending at exactly 1."""
    gam = torch._standard_gamma(
        torch.full((rows, cols), conc, dtype=torch.float32, device=device),
        generator=g).to(torch.float64)
    # a row whose draws all underflowed is uniform
    empty = gam.sum(1, keepdim=True) == 0
    gam = torch.where(empty, torch.ones_like(gam), gam)
    cdf = torch.cumsum(gam, 1)
    cdf /= cdf[:, -1:].clone()
    cdf[:, -1] = 1.0
    return cdf


def lda_corpus(seed: int, num_docs: int, num_words: int, num_topics: int,
               mean_doc_len: float, doc_prior: float, word_prior: float,
               device):
    """(word (T,) int32, doc (T,) int32, true topic (T,) int32)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    lengths = torch.poisson(
        torch.full((num_docs,), float(mean_doc_len), device=device),
        generator=g).clamp_min(1).to(torch.int64)
    phi_cdf = _dirichlet_cdf(num_topics, num_words, word_prior, g, device)
    lmax = int(lengths.max())
    topics = []
    for s in range(0, num_docs, DOC_BLOCK):
        n = min(DOC_BLOCK, num_docs - s)
        theta_cdf = _dirichlet_cdf(n, num_topics, doc_prior, g, device)
        u = torch.rand((n, lmax), dtype=torch.float64, generator=g,
                       device=device)
        z = torch.searchsorted(theta_cdf, u, right=True)
        live = torch.arange(lmax, device=device)[None, :] \
            < lengths[s:s + n, None]
        topics.append(torch.clamp_max(z, num_topics - 1)[live])
        del theta_cdf, u, z, live
    z = torch.cat(topics)
    doc = torch.repeat_interleave(
        torch.arange(num_docs, device=device), lengths)
    # w ~ φ_z: one search in the rows laid end to end, row k shifted by k
    u = torch.rand(z.shape, dtype=torch.float64, generator=g, device=device)
    flat = (phi_cdf + torch.arange(num_topics, device=device,
                                   dtype=torch.float64)[:, None]).reshape(-1)
    del phi_cdf
    pos = torch.searchsorted(flat, z.to(torch.float64) + u, right=True)
    del flat, u
    w = torch.clamp(pos - z * num_words, 0, num_words - 1)
    return w.to(torch.int32), doc.to(torch.int32), z.to(torch.int32)
