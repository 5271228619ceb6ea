"""``zen_cdf``: ZenLDA on precomputed CDFs and sparse doc rows
(``repro/algorithms/zen_cdf.py``).

Per sweep, CDFs replace the alias tables: term 1 (gDense) is one shared
CDF over K, term 2 (wSparse, N_w|k·t4) a per-word CDF row, term 3
(dSparse) the doc's top-``max_kd`` topics by count with their fresh
N_w|k. The token then draws the term by mass and a topic within it by a
lower-bound search, twice, and the paper's §3.1 remedy picks the second
draw where the first equals the token's previous topic (the term-2 and
term-3 tables are stale: they include it).

Term 2 has two routes, as in the reference. With kernels dispatched
(``kernel_dispatch``: the tensors on the card under ``kernels="auto"``)
it goes through kernel 7 (``kernels.ops.cdf_row_search``), which reads
each token's integer count row in place and searches the prefix sums of
counts·t4; the branch masses are then one matvec. Otherwise it searches a
(W, K) float ``w_cdf`` matrix by ``log K`` scalar gathers per token
(:func:`_bsearch_gather`). The two add in different orders, so they are
equal in distribution, not bit for bit (the reference's contract too).
Kernel 7 is only asked for the tokens whose draw takes term 2; the others
get target 0, which its walk answers at once (their term-2 topic is
never used).

Term 3 follows the same choice. With kernels dispatched one launch a
chunk (``kernels.ops.doc_row_search``) builds, scans and searches each
token's top-``max_kd`` doc row in a warp's registers, for both draws,
and returns the token's total mass and its two term-3 topics: no (chunk,
max_kd) tensor exists. Otherwise :func:`doc_rows` gathers the rows and
``torch.cumsum`` adds them, and each draw searches the (chunk, max_kd)
CDF. The two add in different orders: equal in distribution, a draw
differing only at a near-tie.

The rest of a token's work follows it too. On the kernel route three
more kernels (``kernels.cdf_tokens``) hash the chunk's uniforms, take each
draw's branch, term-1 topic and term-2 target, and pick the topics and
apply the remedy, each token in registers (:func:`_kernel_tokens`), bit-
equal to the torch chain that is their plain version; the plain route
keeps its own chain. The two routes share no logic.

Differences from the reference, none of which changes the sampler:

* The doc rows are the exact top-``max_kd`` by count, lower topic id first
  among equal counts: ``jax.lax.top_k``'s order (the reference's serving
  rows). The reference's training rows come from ``approx_max_k`` (recall
  0.95), an approximation on a TPU's reduction unit; on the CPU it equals
  ``top_k`` for 1 < max_kd < K, and at max_kd == 1 or K it puts another
  member of a tie first (still a valid top-k). The port has no such unit
  and takes the exact top-k. ``torch.topk`` does not keep the tie order,
  so the rows are ranked by the tie-free key ``count·K + (K - 1 -
  topic)``; another tie order would change draws.
* Tokens go in chunks (the reference takes all at once), sized by what a
  chunk keeps live (:func:`cdf_chunk_tokens`): off the kernels, its (chunk,
  max_kd) gathered rows hold at most :data:`CDF_CHUNK_ELEMS` elements (at
  NYTIMES width the (T, 64) int64 index rows alone would be 51 GB); on the
  kernel route only per-token vectors are left, and a chunk is
  :data:`CDF_KERNEL_CHUNK_TOKENS` tokens: 11 launches a chunk, 6 chunks a
  NYTIMES sweep.
* Randomness: three uniform streams per token (draw a, draw b, the
  remedy; ``core.keys.stream_uniforms``, on the kernel route the same
  values from ``kernels.ops.cdf_uniforms``: sweep seed, global token
  index, stream) passed in as one (3, T) tensor, so no chunking changes a
  draw and a test can feed the reference's ``jax.random`` uniforms
  instead.

While a profiler records, the sweep's phases are spans
(``observe.metrics.span``): ``zen_cdf.tables`` (:func:`build_cdf_tables`)
once, and in each chunk ``zen_cdf.doc_rows`` (:func:`doc_rows`, or the
doc-row search), ``zen_cdf.draws`` (the uniforms, then both draws) and
``zen_cdf.remedy``; the tokens whose draw searches a term-2 row (target >
0, what kernel 7 queues) add to the counter ``zen_cdf.search_tokens``,
and on the kernel route the live (count > 0) doc-row entries to
``zen_cdf.row_entries`` and the tokens whose remedy takes draw b to
``zen_cdf.remedy_second``.

Serving (``native_infer``): the model is frozen, so the per-sweep tables
collapse to one precompute, :class:`FrozenCdfTables` (per-word CDFs of the
doc-independent prior term), built once by ``prepare_infer``; a frozen
sweep is a two-branch draw over them and the slot's sparse doc row, one
uniform per token from the slot key (``core.keys.token_uniforms``). It
uses no kernel, in the reference either.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.algorithms.base import (
    CellBackend,
    SamplerKnobs,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import register
from repro_torch.algorithms.zen_dense import _searchsorted_rows
from repro_torch.core.decompositions import ZenTerms, precompute_zen_terms
from repro_torch.core.keys import stream_uniforms, token_uniforms
from repro_torch.core.sampler import chunk_size, chunked_token_map
from repro_torch.core.types import LDAHyperParams
from repro_torch.kernels.cdf_search import SEARCH_TOKENS
from repro_torch.kernels.ops import (
    cdf_draws,
    cdf_remedy,
    cdf_row_search,
    cdf_uniforms,
    doc_row_search,
)
from repro_torch.observe import metrics

# sparse doc-row width when the config leaves max_kd = 0 (auto)
DEFAULT_MAX_KD = 64
# off the kernel route: elements of the widest gathered (chunk, max_kd)
# temporary (doc_rows' rows, weights and CDF)
CDF_CHUNK_ELEMS = 1 << 27
# on the kernel route: tokens a chunk. Only per-token vectors live there,
# 68 B a token at their peak, in the second draw's kernel 7 (the (3, n)
# uniforms, the totals, the (2, n) term-3 topics, targets and codes, kernel
# 7's two answers and its 16-byte queue entries, the output's 4 B to come),
# so ~1.1 GB a chunk, 6 a NYTIMES sweep
CDF_KERNEL_CHUNK_TOKENS = 1 << 24
# elements of one block of the doc top-k's int64 keys
_TOPK_ELEMS = 1 << 24
# uniforms per token: draw a, draw b, the remedy
CDF_STREAMS = 3


def _bsearch_gather(mat: torch.Tensor, rows: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """O(log K) lower bound of ``targets[t]`` in the ascending row
    ``mat[rows[t]]``: one scalar gather per halving step, never a (T, K)
    temporary; (T,) int32, clamped to K - 1."""
    k = mat.shape[1]
    flat = mat.reshape(-1)
    base = rows.long() * k
    pos = torch.zeros(rows.shape, dtype=torch.int64, device=rows.device)
    step = 1 << (k - 1).bit_length()
    while step > 0:
        cand = pos + step
        safe = torch.clamp_max(cand - 1, k - 1)
        take = (cand <= k) & (flat[base + safe] < targets)
        pos = torch.where(take, cand, pos)
        step //= 2
    return torch.clamp_max(pos, k - 1).to(torch.int32)


def _bsearch_shared(cdf: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """Lower bound of each target in one shared ascending CDF (K,)."""
    return torch.clamp_max(torch.searchsorted(cdf, targets),
                           cdf.shape[0] - 1)


def doc_topk(n_kd: torch.Tensor, kd: int):
    """The ``kd`` largest counts of every row of ``n_kd`` (R, K): (cnt (R,
    kd) int32, topic (R, kd) int64), higher count first and the lower
    topic first among equal counts (``jax.lax.top_k``'s order)."""
    r, k = n_kd.shape
    rev = torch.arange(k - 1, -1, -1, device=n_kd.device)
    cnt = torch.empty((r, kd), dtype=torch.int32, device=n_kd.device)
    idx = torch.empty((r, kd), dtype=torch.int64, device=n_kd.device)
    block = max(1, _TOPK_ELEMS // k)
    for s in range(0, r, block):
        key = n_kd[s:s + block].long() * k + rev
        top = torch.topk(key, kd, dim=1).values
        cnt[s:s + block] = torch.div(top, k, rounding_mode="floor")
        idx[s:s + block] = (k - 1) - torch.remainder(top, k)
    return cnt, idx


class CdfTables(NamedTuple):
    """One sweep's tables (paper Alg. 2 l.5-13, in CDF form)."""

    terms: ZenTerms
    g_cdf: torch.Tensor  # (K,) CDF of gDense
    m2_all: torch.Tensor  # (W,) term-2 mass per word
    w_cdf: Optional[torch.Tensor]  # (W, K) term-2 CDF rows; None: kernel
    kd_cnt: torch.Tensor  # (D, max_kd) int32 top counts per doc
    kd_idx: torch.Tensor  # (D, max_kd) their topics; int32 with w_cdf None


def build_cdf_tables(n_wk, n_kd, n_k, hyper: LDAHyperParams,
                     num_words_pad: int, max_kd: int,
                     use_kernel: bool) -> CdfTables:
    terms = precompute_zen_terms(n_k, hyper, num_words_pad)
    g_cdf = torch.cumsum(terms.g_dense, dim=0)
    if use_kernel:
        # branch masses only: no (W, K) float CDF matrix
        w_cdf = None
        m2_all = n_wk.to(torch.float32) @ terms.t4
    else:
        w_cdf = torch.cumsum(n_wk.to(torch.float32) * terms.t4[None, :],
                             dim=-1)
        m2_all = w_cdf[:, -1]
    kd_cnt, kd_idx = doc_topk(n_kd, min(max_kd, hyper.num_topics))
    if use_kernel:
        kd_idx = kd_idx.to(torch.int32)  # what the doc-row search reads
    return CdfTables(terms=terms, g_cdf=g_cdf, m2_all=m2_all, w_cdf=w_cdf,
                     kd_cnt=kd_cnt, kd_idx=kd_idx)


def doc_rows(tables: CdfTables, word: torch.Tensor, doc: torch.Tensor,
             n_wk: torch.Tensor, hyper: LDAHyperParams):
    """Term 3 of T tokens: (topics (T, max_kd) int64 of the doc's top
    rows, the CDF (T, max_kd) of cnt·(N_w|k + β)·t1 over them)."""
    k = hyper.num_topics
    w, d = word.long(), doc.long()
    rows_idx = tables.kd_idx[d]
    rows_cnt = tables.kd_cnt[d]
    nwk_at = n_wk.reshape(-1)[w[:, None] * k + rows_idx]
    d_vals = (rows_cnt.to(torch.float32)
              * (nwk_at.to(torch.float32) + hyper.beta)
              * tables.terms.t1[rows_idx])
    d_vals = torch.where(rows_cnt > 0, d_vals, 0.0)
    return rows_idx, torch.cumsum(d_vals, dim=-1)


def zen_cdf_tokens(tables: CdfTables, word: torch.Tensor, doc: torch.Tensor,
                   z_old: torch.Tensor, n_wk: torch.Tensor,
                   n_kd: torch.Tensor, hyper: LDAHyperParams,
                   uniforms: torch.Tensor) -> torch.Tensor:
    """New topics (T,) int32: the three-term CDF draw twice, then the
    remedy. ``uniforms`` (3, T) in [0, 1): draw a, draw b, remedy (the
    reference's ``split(key, 3)``; each draw's u is the first half of its
    key's split). When ``tables.w_cdf`` is None the tokens take the kernel
    route (:func:`_kernel_tokens`), else the plain route."""
    if tables.w_cdf is None:
        return _kernel_tokens(tables, word, doc, z_old, n_wk, n_kd, hyper,
                              uniforms)
    k = hyper.num_topics
    dev = word.device
    counting = metrics.tracing()
    with metrics.span("zen_cdf.doc_rows", dev):
        rows_idx, d_cdf = doc_rows(tables, word, doc, n_wk, hyper)

    with metrics.span("zen_cdf.draws", dev):
        w, d = word.long(), doc.long()
        m1 = tables.g_cdf[-1]
        m2 = tables.m2_all[w]
        m12 = m1 + m2
        total = m12 + d_cdf[:, -1]

        def draw(i):
            u = uniforms[i] * total
            branch = torch.where(u < m1, 0, torch.where(u < m12, 1, 2))
            # term 1: the shared global CDF (replaces gTable)
            z_g = _bsearch_shared(tables.g_cdf, u)
            # term 2: the word's CDF row (replaces wTable); only term-2 draws
            # need it, the others search target 0
            t2 = torch.where(branch == 1, torch.clamp_min(u - m1, 0.0), 0.0)
            z_w = _bsearch_gather(tables.w_cdf, word, t2)
            if counting:
                metrics.count(SEARCH_TOKENS, (t2 > 0).sum())
            # term 3: the doc's sparse row CDF (dSparse + BSearch)
            pos = _searchsorted_rows(d_cdf, torch.clamp_min(u - m1 - m2, 0.0))
            z_d = rows_idx.gather(1, pos.long()[:, None])[:, 0]
            z = torch.where(branch == 0, z_g,
                            torch.where(branch == 1, z_w.long(), z_d))
            return torch.clamp_max(z, k - 1).to(torch.int32), branch

        z1, branch = draw(0)
        z2, _ = draw(1)

    # resampling remedy (§3.1) for the staleness of terms 2 and 3
    with metrics.span("zen_cdf.remedy", dev):
        zo = z_old.long()
        nw_prev = torch.clamp_min(n_wk[w, zo].to(torch.float32), 1.0)
        nd_prev = torch.clamp_min(n_kd[d, zo].to(torch.float32), 1.0)
        p_w = 1.0 / nw_prev
        p_d = torch.clamp(1.0 / nd_prev + (nd_prev + nw_prev - 1.0)
                          / (nd_prev * nw_prev), 0.0, 1.0)
        remedy_p = torch.where(branch == 1, p_w,
                               torch.where(branch == 2, p_d, 0.0))
        take_second = (z1 == z_old) & (uniforms[2] < remedy_p)
        return torch.where(take_second, z2, z1)


def _kernel_tokens(tables: CdfTables, word, doc, z_old, n_wk, n_kd,
                   hyper: LDAHyperParams, uniforms) -> torch.Tensor:
    """:func:`zen_cdf_tokens` on the kernel route, three kernels and
    kernel 7 twice: the doc-row search (both draws' term-3 topics and each
    token's total), the draws (``kernels.ops.cdf_draws``: branch, term-1
    topic, term-2 target), kernel 7 on each draw's target and the remedy
    (``kernels.ops.cdf_remedy``); no per-token temporary but their inputs
    and outputs."""
    terms = tables.terms
    dev = word.device
    counting = metrics.tracing()
    with metrics.span("zen_cdf.doc_rows", dev):
        total, z_d = doc_row_search(
            n_wk, word, doc, tables.kd_cnt, tables.kd_idx, terms.t1,
            tables.m2_all, tables.g_cdf, uniforms[0], uniforms[1],
            beta=hyper.beta, count=counting)
    with metrics.span("zen_cdf.draws", dev):
        targets, code = cdf_draws(word, total, uniforms[0], uniforms[1],
                                  tables.m2_all, tables.g_cdf, z_d)
        z_wa, z_wb = (cdf_row_search(n_wk, word, terms.t4, targets[i],
                                     count=counting) for i in (0, 1))
    with metrics.span("zen_cdf.remedy", dev):
        return cdf_remedy(code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd,
                          uniforms[2], count=counting)


def _chunk_budget(max_kd: int, use_kernel: bool) -> tuple[int, int]:
    """(row width, elements) that size :func:`zen_cdf_cell`'s chunks:
    per-token vectors only on the kernel route, (chunk, max_kd) gathered
    rows off it."""
    if use_kernel:
        return 1, CDF_KERNEL_CHUNK_TOKENS
    return max_kd, CDF_CHUNK_ELEMS


def cdf_chunk_tokens(num_tokens: int, max_kd: int, use_kernel: bool,
                     token_chunk: int = 0) -> int:
    """Tokens a chunk of :func:`zen_cdf_cell`: ``token_chunk`` when set,
    else :data:`CDF_KERNEL_CHUNK_TOKENS` on the kernel route and
    ``CDF_CHUNK_ELEMS // max_kd`` off it, at most ``num_tokens``."""
    width, elems = _chunk_budget(max_kd, use_kernel)
    return chunk_size(num_tokens, width, token_chunk, elems)


def zen_cdf_cell(seed: int, word: torch.Tensor, doc: torch.Tensor,
                 z_old: torch.Tensor, mask, n_wk: torch.Tensor,
                 n_kd: torch.Tensor, n_k: torch.Tensor,
                 hyper: LDAHyperParams, num_words_pad: int, max_kd: int,
                 use_kernel: bool = False, token_chunk: int = 0,
                 token_index=None) -> torch.Tensor:
    """One precomputed-CDF ZenLDA pass over a cell's tokens (stale counts)
    -> (T,) int32: the tables once, then the tokens in chunks
    (``token_index``: the tokens' global indices, default their
    positions). Work per
    token: O(log K) (term 1, and term 2 off the kernel) + O(max_kd)
    (term 3); kernel 7 walks a term-2 row up to its lower bound."""
    with metrics.span("zen_cdf.tables", word.device):
        tables = build_cdf_tables(n_wk, n_kd, n_k, hyper, num_words_pad,
                                  max_kd, use_kernel)

    def chunk(start, w, d, z):
        with metrics.span("zen_cdf.draws", w.device):
            if tables.w_cdf is None:
                u = cdf_uniforms(seed, start, w.shape[0], CDF_STREAMS,
                                 device=w.device)
            else:
                u = stream_uniforms(seed, start, w.shape[0], CDF_STREAMS,
                                    device=w.device)
        return zen_cdf_tokens(tables, w, d, z, n_wk, n_kd, hyper, u)

    width, elems = _chunk_budget(tables.kd_idx.shape[1], use_kernel)
    return chunked_token_map(chunk, (word, doc, z_old), token_chunk, width,
                             elems, token_index)


class FrozenCdfTables(NamedTuple):
    """Sampling-ready frozen model: the per-word prior-term CDFs.

    The model never moves while serving, so the per-sweep table build of
    training collapses to one precompute: ``a_cdf[w]`` is the cumulative
    of the doc-independent term alpha_k·(N_w|k + beta)·t1, and branch-1
    draws are O(log K) scalar gathers per token for the engine's whole
    lifetime."""

    a_cdf: torch.Tensor  # (W, K) f32 row-wise CDF of the prior term
    a_mass: torch.Tensor  # (W,) f32 row masses
    t1: torch.Tensor  # (K,) f32 1 / (N_k + W*beta)
    alpha_k: torch.Tensor  # (K,) f32


def zen_cdf_infer_tokens(u01: torch.Tensor, words: torch.Tensor,
                         mask: torch.Tensor, z_old: torch.Tensor,
                         n_kd: torch.Tensor, n_wk: torch.Tensor,
                         hyper: LDAHyperParams, max_kd: int,
                         tables: FrozenCdfTables) -> torch.Tensor:
    """The frozen two-branch draw on a padded (B, L) slot batch, given one
    uniform per token ``u01`` (B, L); (B, L) int32.

        p(k) = [alpha_k + N_k|d^(-t)] * (N_w|k + beta) * t1

    splits into the prior term (``tables``, branch 1) and the sparse doc
    term over the slot's top-``max_kd`` topics with the token's own
    assignment excluded (branch 2)."""
    b, l = words.shape
    k = hyper.num_topics
    kd_cnt, kd_idx = doc_topk(n_kd, min(max_kd, k))  # (B, kd)
    slot = torch.arange(b, device=words.device).repeat_interleave(l)
    w = words.reshape(-1).long()
    z = z_old.reshape(-1).long()
    live = mask.reshape(-1).bool()
    rows_idx = kd_idx[slot]  # (BL, kd)
    self_hit = (rows_idx == z[:, None]) & live[:, None]
    rows_cnt = kd_cnt[slot] - self_hit.to(torch.int32)
    nwk_at = n_wk.reshape(-1)[w[:, None] * k + rows_idx].to(torch.float32)
    d_vals = (rows_cnt.to(torch.float32) * (nwk_at + hyper.beta)
              * tables.t1[rows_idx])
    d_vals = torch.where(rows_cnt > 0, d_vals, 0.0)
    d_cdf = torch.cumsum(d_vals, dim=-1)
    m_a = tables.a_mass[w]
    u = u01.reshape(-1) * (m_a + d_cdf[:, -1])
    z_a = _bsearch_gather(tables.a_cdf, w, torch.minimum(u, m_a))
    pos = _searchsorted_rows(d_cdf, torch.clamp_min(u - m_a, 0.0))
    z_d = rows_idx.gather(1, pos.long()[:, None])[:, 0]
    z_new = torch.where(u < m_a, z_a.long(), z_d)
    return torch.clamp_max(z_new, k - 1).to(torch.int32).reshape(b, l)


def zen_cdf_infer_sweep(keys, words, mask, z_old, n_kd, n_wk, n_k,
                        hyper: LDAHyperParams, max_kd: int,
                        tables: FrozenCdfTables) -> torch.Tensor:
    """Frozen-model sweep via the two-branch CDF decomposition. Each
    token's uniform comes from its slot's key and its position only, so
    slots are independent and draws prefix-stable in the bucket pad."""
    u01 = token_uniforms(keys.to(words.device), words.shape[1])
    return zen_cdf_infer_tokens(u01, words, mask, z_old, n_kd, n_wk, hyper,
                                max_kd, tables)


@register("zen_cdf")
class ZenCdf(CellBackend):
    """Precomputed-CDF ZenLDA, single-box (one cell), with native
    frozen-model serving."""

    native_infer = True
    infer_aux_word_fields = ("a_cdf", "a_mass")

    def resolve_cell_knobs(self, knobs: SamplerKnobs, hyper):
        return dataclasses.replace(
            knobs,
            max_kd=min(knobs.max_kd or DEFAULT_MAX_KD, hyper.num_topics),
        )

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None):
        return zen_cdf_cell(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, knobs.max_kd or DEFAULT_MAX_KD,
            use_kernel=kernel_dispatch(knobs.kernels, word.device),
            token_chunk=knobs.token_chunk, token_index=token_index,
        )

    def prepare_infer(self, n_wk, n_k, hyper, knobs: SamplerKnobs,
                      num_words_total=None) -> FrozenCdfTables:
        w_total = (n_wk.shape[0] if num_words_total is None
                   else num_words_total)
        alpha_k = hyper.alpha_k(n_k)
        t1 = 1.0 / (n_k.to(torch.float32) + w_total * hyper.beta)
        a_vals = (n_wk.to(torch.float32) + hyper.beta) * (alpha_k * t1)
        a_cdf = torch.cumsum(a_vals, dim=-1)
        return FrozenCdfTables(a_cdf=a_cdf, a_mass=a_cdf[:, -1].contiguous(),
                               t1=t1, alpha_k=alpha_k)

    def infer_sweep(self, keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
                    knobs: SamplerKnobs, aux=None, num_words_total=None):
        if aux is None:
            aux = self.prepare_infer(n_wk, n_k, hyper, knobs,
                                     num_words_total=num_words_total)
        return zen_cdf_infer_sweep(
            keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
            knobs.max_kd or DEFAULT_MAX_KD, aux,
        )
