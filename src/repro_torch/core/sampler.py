"""Dense CGS sweep against iteration-start counts (``repro/core/sampler.py``,
``decomposition="zen"``).

``cgs_sweep_stale`` is the paper's production semantics: every token is
sampled against the counts frozen at the start of the iteration, with its
own previous assignment excluded exactly (¬dw), and counts merge once at
the end (``gibbs_iteration``). It walks the tokens in chunks, so the
(chunk, K) float temporaries stay bounded at any corpus size; every draw
hashes (sweep seed, global token index), so neither ``token_chunk`` nor
the internal chunk size changes a draw.

Sampling methods: inverse CDF (``cdf``: one uniform per token) and
Gumbel-max (``gumbel``: noise per (token, topic), the coordinates of the
``zen_pallas`` kernels). ``cgs_sweep_serial`` and the ``std``
decomposition are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import counts as counts_lib
from repro_torch.core.decompositions import precompute_zen_terms
from repro_torch.core.keys import fold_in, key_seed
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.kernels.zen_sampler import gumbel_noise, hash_uniform

# elements of one (chunk, K) float temporary of the dense paths
DENSE_CHUNK_ELEMS = 1 << 24


def check_token_chunk(num_tokens: int, token_chunk: Optional[int]) -> None:
    """The reference's ``token_chunk`` contract: E divisible by it."""
    if token_chunk and token_chunk < num_tokens \
            and num_tokens % token_chunk:
        raise ValueError(f"token_chunk={token_chunk} does not divide the "
                         f"{num_tokens} tokens")


def chunk_size(num_tokens: int, num_topics: int,
               token_chunk: Optional[int],
               elems: int = DENSE_CHUNK_ELEMS) -> int:
    """``token_chunk`` when set (validated), else a size whose (chunk, K)
    temporaries hold ``elems`` elements."""
    check_token_chunk(num_tokens, token_chunk)
    if token_chunk and token_chunk < num_tokens:
        return token_chunk
    return max(1, min(num_tokens, elems // max(1, num_topics)))


def chunked_token_map(chunk_fn: Callable[..., torch.Tensor],
                      arrays: Sequence[torch.Tensor], token_chunk: int,
                      num_topics: int,
                      elems: int = DENSE_CHUNK_ELEMS) -> torch.Tensor:
    """``chunk_fn(start, *chunks) -> (chunk,)`` over token chunks of the
    (E,) ``arrays``, concatenated. The chunk is ``token_chunk`` when set
    (E must divide evenly, as in the reference), else a size whose
    (chunk, K) temporaries hold ``elems`` elements. ``start`` is the
    chunk's first global token index: draws hash it, so the chunking
    changes no draw."""
    e = arrays[0].shape[0]
    size = chunk_size(e, num_topics, token_chunk, elems)
    out = torch.empty(e, dtype=torch.int32, device=arrays[0].device)
    for s in range(0, e, size):
        out[s:s + size] = chunk_fn(s, *(a[s:s + size] for a in arrays))
    return out


def sample_categorical(probs: torch.Tensor, seed: int, rows: torch.Tensor,
                       method: str = "cdf") -> torch.Tensor:
    """One draw per row of unnormalised ``probs`` (T, K); row t's noise
    hashes (seed, rows[t]) (and the topic, for ``gumbel``)."""
    if method == "cdf":
        cdf = torch.cumsum(probs, dim=-1)
        u = hash_uniform(seed, rows[:, None], 0) * cdf[:, -1:]
        idx = torch.sum(cdf < u, dim=-1)
        return torch.clamp_max(idx, probs.shape[-1] - 1).to(torch.int32)
    if method == "gumbel":
        cols = torch.arange(probs.shape[-1], device=probs.device)
        g = gumbel_noise(seed, rows[:, None], cols[None, :])
        logits = torch.log(torch.clamp_min(probs.to(torch.float32), 1e-30))
        return torch.argmax(logits + g, dim=-1).to(torch.int32)
    raise ValueError(f"unknown sampling method {method!r}")


def _zen_rows(n_wk, n_kd, n_k, word, doc, topic, hyper: LDAHyperParams,
              num_words: int, alpha_k: torch.Tensor,
              exclude_self: bool) -> torch.Tensor:
    """Eq. 3 conditional (T, K) of the tokens (word, doc, topic), in the
    reference's op order: (α·β + N_wk·α + N_kd·(N_wk+β)) · 1/(N_k+Wβ)."""
    nw_i, nd_i = n_wk[word.long()], n_kd[doc.long()]
    if exclude_self:
        cols = torch.arange(n_k.shape[0], device=n_k.device)
        onehot = (cols[None, :] == topic.long()[:, None]).to(torch.int32)
        nw_i, nd_i = nw_i - onehot, nd_i - onehot
        nk = n_k[None, :] - onehot
    else:
        nk = n_k[None, :]
    w_beta = num_words * hyper.beta
    t1 = 1.0 / (nk.to(torch.float32) + w_beta)
    a = alpha_k[None, :]
    nw = nw_i.to(torch.float32)
    nd = nd_i.to(torch.float32)
    return (a * hyper.beta + nw * a + nd * (nw + hyper.beta)) * t1


def conditional_probs(state: CGSState, corpus: Corpus,
                      hyper: LDAHyperParams, exclude_self: bool = True,
                      decomposition: str = "zen") -> torch.Tensor:
    """Eq. 3 conditional for every token, (E, K), unnormalised."""
    if decomposition != "zen":
        raise ValueError(f"decomposition {decomposition!r} is not ported "
                         f"yet (only 'zen')")
    terms = precompute_zen_terms(state.n_k, hyper, corpus.num_words)
    return _zen_rows(state.n_wk, state.n_kd, state.n_k, corpus.word,
                     corpus.doc, state.topic, hyper, corpus.num_words,
                     terms.alpha_k, exclude_self)


def cgs_sweep_stale(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                    method: str = "cdf", exclude_self: bool = True,
                    decomposition: str = "zen",
                    token_chunk: Optional[int] = None) -> torch.Tensor:
    """New topics (E,) int32, every token against iteration-start counts.
    Sweep ``n`` draws from ``key_seed(fold_in(state.rng, n))``."""
    if decomposition != "zen":
        raise ValueError(f"decomposition {decomposition!r} is not ported "
                         f"yet (only 'zen')")
    seed = key_seed(fold_in(state.rng, state.iteration))
    e = corpus.num_tokens
    terms = precompute_zen_terms(state.n_k, hyper, corpus.num_words)
    size = chunk_size(e, hyper.num_topics, token_chunk)
    dev = state.topic.device
    out = torch.empty(e, dtype=torch.int32, device=dev)
    for s in range(0, e, size):
        sl = slice(s, s + size)
        probs = _zen_rows(state.n_wk, state.n_kd, state.n_k, corpus.word[sl],
                          corpus.doc[sl], state.topic[sl], hyper,
                          corpus.num_words, terms.alpha_k, exclude_self)
        rows = torch.arange(s, s + probs.shape[0], device=dev)
        out[sl] = sample_categorical(probs, seed, rows, method)
    return out


def gibbs_iteration(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                    method: str = "cdf", exclude_self: bool = True,
                    decomposition: str = "zen",
                    token_chunk: Optional[int] = None) -> CGSState:
    """One single-box iteration: stale sweep, then the delta merge."""
    new_topic = cgs_sweep_stale(state, corpus, hyper, method=method,
                                exclude_self=exclude_self,
                                decomposition=decomposition,
                                token_chunk=token_chunk)
    d_wk, d_kd, d_k = counts_lib.delta_counts(
        corpus.word, corpus.doc, state.topic, new_topic,
        corpus.num_words, corpus.num_docs, hyper.num_topics,
    )
    return CGSState(
        topic=new_topic, prev_topic=state.topic,
        n_wk=state.n_wk + d_wk, n_kd=state.n_kd + d_kd,
        n_k=state.n_k + d_k, rng=state.rng,
        iteration=state.iteration + 1,
        stale_iters=state.stale_iters, same_count=state.same_count,
    )
