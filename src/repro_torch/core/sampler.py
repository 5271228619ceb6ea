"""Dense CGS sweeps (``repro/core/sampler.py``).

``cgs_sweep_stale`` is the paper's production semantics: every token is
sampled against the counts frozen at the start of the iteration, with its
own previous assignment excluded exactly (¬dw), and counts merge once at
the end (``gibbs_iteration``). It walks the tokens in chunks, so the
(chunk, K) float temporaries stay bounded at any corpus size; every draw
hashes (sweep seed, global token index), so neither ``token_chunk`` nor
the internal chunk size changes a draw.

Sampling methods: inverse CDF (``cdf``: one uniform per token) and
Gumbel-max (``gumbel``: noise per (token, topic), the coordinates of the
``zen_pallas`` kernels). Decompositions: ``zen`` (gDense + wSparse +
dSparse, in the reference's op order) and ``std`` (Eq. 3 as written, the
``std`` backend); the two are the same conditional up to float rounding.

``cgs_sweep_serial`` is the true sequential chain (paper Alg. 1): each
token is resampled against counts that already hold every earlier token's
new topic. It is the oracle of the tests, at test sizes only (a Python
loop over tokens); token ``i`` of sweep ``n`` draws from the uniform at
(``key_seed(fold_in(state.rng, n))``, ``i``), as the stale sweep's does,
unless the caller passes the (E,) ``uniforms`` (a test feeds the
reference's).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import counts as counts_lib
from repro_torch.core.decompositions import (  # noqa: F401
    ZenTerms,  # ZenTerms and zen_probs: the reference's module surface
    precompute_zen_terms,
    std_probs,
    zen_probs,
)
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
                      elems: int = DENSE_CHUNK_ELEMS,
                      token_index: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``chunk_fn(start, *chunks) -> (chunk,)`` over token chunks of the
    (E,) ``arrays``, concatenated. The chunk is ``token_chunk`` when set
    (E must divide evenly, as in the reference), else a size whose
    (chunk, K) temporaries hold ``elems`` elements. ``start`` is the
    chunk's first global token index, or, with ``token_index`` (E,) (a
    mesh cell's corpus indices), the chunk's slice of it
    (``core.keys.token_rows`` reads both): draws hash it, so the chunking
    changes no draw."""
    e = arrays[0].shape[0]
    size = chunk_size(e, num_topics, token_chunk, elems)
    out = torch.empty(e, dtype=torch.int32, device=arrays[0].device)
    for s in range(0, e, size):
        start = s if token_index is None else token_index[s:s + size]
        out[s:s + size] = chunk_fn(start, *(a[s:s + size] for a in arrays))
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


def _probs_rows(n_wk, n_kd, n_k, word, doc, topic, hyper: LDAHyperParams,
                num_words: int, alpha_k: torch.Tensor, exclude_self: bool,
                decomposition: str) -> torch.Tensor:
    """Eq. 3 conditional (T, K) of the tokens (word, doc, topic): ``zen``
    in the reference's op order, (α·β + N_wk·α + N_kd·(N_wk+β)) ·
    1/(N_k+Wβ); ``std`` as written, (N_wk+β)/(N_k+Wβ)·(N_kd+α_k)."""
    if decomposition not in ("zen", "std"):
        raise ValueError(f"unknown decomposition {decomposition!r}: "
                         f"expected 'zen' or 'std'")
    nw_i, nd_i = n_wk[word.long()], n_kd[doc.long()]
    if exclude_self:
        cols = torch.arange(n_k.shape[0], device=n_k.device)
        onehot = (cols[None, :] == topic.long()[:, None]).to(torch.int32)
        nw_i, nd_i = nw_i - onehot, nd_i - onehot
        nk = n_k[None, :] - onehot
    else:
        nk = n_k[None, :]
    if decomposition == "std":
        return std_probs(nw_i, nd_i, nk, alpha_k, hyper.beta, num_words)
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
    terms = precompute_zen_terms(state.n_k, hyper, corpus.num_words)
    return _probs_rows(state.n_wk, state.n_kd, state.n_k, corpus.word,
                       corpus.doc, state.topic, hyper, corpus.num_words,
                       terms.alpha_k, exclude_self, decomposition)


def cgs_sweep_stale(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                    method: str = "cdf", exclude_self: bool = True,
                    decomposition: str = "zen",
                    token_chunk: Optional[int] = None) -> torch.Tensor:
    """New topics (E,) int32, every token against iteration-start counts.
    Sweep ``n`` draws from ``key_seed(fold_in(state.rng, n))``."""
    seed = key_seed(fold_in(state.rng, state.iteration))
    e = corpus.num_tokens
    terms = precompute_zen_terms(state.n_k, hyper, corpus.num_words)
    size = chunk_size(e, hyper.num_topics, token_chunk)
    dev = state.topic.device
    out = torch.empty(e, dtype=torch.int32, device=dev)
    for s in range(0, e, size):
        sl = slice(s, s + size)
        probs = _probs_rows(state.n_wk, state.n_kd, state.n_k,
                            corpus.word[sl], corpus.doc[sl], state.topic[sl],
                            hyper, corpus.num_words, terms.alpha_k,
                            exclude_self, decomposition)
        rows = torch.arange(s, s + probs.shape[0], device=dev)
        out[sl] = sample_categorical(probs, seed, rows, method)
    return out


def cgs_sweep_serial(state: CGSState, corpus: Corpus,
                     hyper: LDAHyperParams,
                     uniforms: Optional[torch.Tensor] = None) -> CGSState:
    """True sequential collapsed Gibbs sweep (paper Alg. 1), O(E K): token
    by token, remove its topic from the counts, draw from Eq. 3 by inverse
    CDF on uniform ``uniforms[i]`` (default: the sweep's counter-based
    stream), add the new topic back. Returns the next state."""
    dev = state.topic.device
    if uniforms is None:
        seed = key_seed(fold_in(state.rng, state.iteration))
        uniforms = hash_uniform(
            seed, torch.arange(corpus.num_tokens, device=dev), 0)
    n_wk, n_kd, n_k = state.n_wk.clone(), state.n_kd.clone(), \
        state.n_k.clone()
    topics = state.topic.clone()
    w_beta = corpus.num_words * hyper.beta
    k_max = hyper.num_topics - 1
    for i in range(corpus.num_tokens):
        w, d, z_old = int(corpus.word[i]), int(corpus.doc[i]), \
            int(topics[i])
        n_wk[w, z_old] -= 1
        n_kd[d, z_old] -= 1
        n_k[z_old] -= 1
        alpha_k = hyper.alpha_k(n_k)
        p = ((n_wk[w].to(torch.float32) + hyper.beta)
             / (n_k.to(torch.float32) + w_beta)
             * (n_kd[d].to(torch.float32) + alpha_k))
        cdf = torch.cumsum(p, dim=0)
        z_new = min(int((cdf < uniforms[i] * cdf[-1]).sum()), k_max)
        n_wk[w, z_new] += 1
        n_kd[d, z_new] += 1
        n_k[z_new] += 1
        topics[i] = z_new
    return CGSState(
        topic=topics, prev_topic=state.topic, n_wk=n_wk, n_kd=n_kd,
        n_k=n_k, rng=state.rng, iteration=state.iteration + 1,
        stale_iters=state.stale_iters, same_count=state.same_count,
    )


def gibbs_iteration(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                    method: str = "cdf", exclude_self: bool = True,
                    decomposition: str = "zen",
                    token_chunk: Optional[int] = None) -> CGSState:
    """One single-box iteration: stale sweep, then the delta merge. A
    plain-torch reference loop: its merge stays on kernel 5's plain version
    (``TrainSession``'s plan dispatches the kernel)."""
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
