"""``zen_cdf``: ZenLDA on precomputed CDFs and sparse doc rows
(``repro/algorithms/zen_cdf.py``).

Per sweep, CDFs replace the alias tables: term 1 (gDense) is one shared
CDF over K, term 2 (wSparse, N_w|k·t4) a per-word CDF row, term 3
(dSparse) the doc's top-``max_kd`` topics by count with their fresh
N_w|k. The token then draws the term by mass and a topic within it by a
lower-bound search, twice, and the paper's §3.1 remedy picks the second
draw where the first equals the token's previous topic (the term-2 and
term-3 tables are stale: they include it).

A chunk of tokens takes five steps: its three uniform streams; term 3
(each token's total mass and both draws' term-3 topics); the draws (each
one's branch, term-1 topic and term-2 target, as a code); term 2, once a
draw; the remedy (:func:`zen_cdf_tokens` runs the last four). A route
(:class:`CdfRoute`) says how each step runs and how wide a chunk is.
:func:`zen_cdf_cell` chooses it once a sweep from ``kernel_dispatch``
(the tensors on the card under ``kernels="auto"``), and the tables carry
it.

* :data:`KERNEL_ROUTE` launches kernels (``kernels.ops``): the uniforms,
  the draws and the remedy with each token's work in registers
  (``kernels.cdf_tokens``);
  term 3 as one doc-row search that builds, scans and searches each
  token's top-``max_kd`` doc row in a warp's registers, so no (chunk,
  max_kd) tensor exists; term 2 as kernel 7, which reads each token's
  integer count row in place and searches the prefix sums of counts·t4
  (the branch masses are then one matvec). The single box's ``prepare``
  builds, once a run, each chunk's tokens in word order
  (:func:`cdf_token_order`), and the doc-row search walks them so: the
  warps running at once then share a few ``n_wk`` rows in the card's
  cache. The order changes no draw; a mesh cell walks token order.
* :data:`PLAIN_ROUTE` runs torch ops and launches no ``zen_cdf`` kernel:
  the same uniforms, draws and remedy (``core.keys.stream_uniforms`` and
  the kernels' plain versions, called directly); term 3 as :func:`doc_rows`,
  whose ``torch.cumsum`` each draw searches; term 2 as ``log K`` scalar
  gathers into a (W, K) float ``w_cdf`` matrix (:func:`_bsearch_gather`).

Terms 2 and 3 add in another order on each route, so the routes are equal
in distribution, not bit for bit (the reference's contract too): a draw
differs only at a near-tie. Term 2 is only searched for the tokens whose
draw takes it; the others get target 0, which kernel 7's walk answers at
once (their term-2 topic is never used).

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
  chunk keeps live (the route's ``chunk``): on the plain route, its (chunk,
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
once, and in each chunk ``zen_cdf.doc_rows`` (term 3), ``zen_cdf.draws``
(the uniforms, then both draws and their term-2 searches) and
``zen_cdf.remedy``. On either route the tokens whose draw searches a
term-2 row (target > 0, what kernel 7 queues) add to the counter
``zen_cdf.search_tokens``, the live (count > 0) doc-row entries to
``zen_cdf.row_entries`` and the tokens whose remedy takes draw b to
``zen_cdf.remedy_second``; where the doc-row search walks a word order,
that order's runs of equal words add to ``zen_cdf.word_runs`` (counted
once in ``prepare``, added with no launch).

Serving (``native_infer``): the model is frozen, so the per-sweep tables
collapse to one precompute, :class:`FrozenCdfTables` (per-word CDFs of the
doc-independent prior term), built once by ``prepare_infer``; a frozen
sweep is a two-branch draw over them and the slot's sparse doc row, one
uniform per token from the slot key (``core.keys.token_uniforms``). It
uses no kernel, in the reference either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.algorithms.base import (
    CellBackend,
    SamplerKnobs,
    kernel_dispatch,
)
from repro_torch.algorithms.registry import register
from repro_torch.algorithms.zen_dense import _searchsorted_rows
from repro_torch.core.decompositions import ZenTerms, precompute_zen_terms
from repro_torch.core.keys import (
    fold_in,
    key_seed,
    stream_uniforms,
    token_uniforms,
)
from repro_torch.core.sampler import chunk_size, chunked_token_map
from repro_torch.core.types import LDAHyperParams
from repro_torch.kernels.cdf_search import ROW_ENTRIES, SEARCH_TOKENS
from repro_torch.kernels.cdf_tokens import (
    REMEDY_SECOND,
    cdf_draws_plain,
    cdf_remedy_plain,
)
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
# on the plain route: elements of the widest gathered (chunk, max_kd)
# temporary (doc_rows' rows, weights and CDF)
CDF_CHUNK_ELEMS = 1 << 27
# on the kernel route: tokens a chunk. Only per-token vectors live there,
# 68 B a token at their peak, in the second draw's kernel 7 (the (3, n)
# uniforms, the totals, the (2, n) term-3 topics, targets and codes, kernel
# 7's two answers and its 16-byte queue entries, the output's 4 B to come),
# so ~1.1 GB a chunk, 6 a NYTIMES sweep
CDF_KERNEL_CHUNK_TOKENS = 1 << 24
# on the kernel route: tokens a tile of the doc-row search's word order (a
# chunk's tokens are sorted by word within each tile). On NYTimes an H100
# runs the search fastest at 2^20: a tile's ~3,200 doc rows stay in L2 while
# each word's n_wk row serves ~10 tokens (2^19-2^22 within 9%, whole-chunk
# tiles 22-26% slower)
CDF_ORDER_TILE_TOKENS = 1 << 20
# the profiled stretch's counter of runs of equal words along the word
# orders the doc-row search walked
WORD_RUNS = "zen_cdf.word_runs"
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


class CdfOrder(NamedTuple):
    """The doc-row search's walk of a run's chunks (:func:`cdf_token_order`):
    built once, since the corpus never changes."""

    order: torch.Tensor  # (T,) int32: each chunk's chunk-local positions
    runs: Tuple[torch.Tensor, ...]  # per chunk: its runs of equal words
    chunk: int  # tokens a chunk, as the route's chunk rule sizes it


def cdf_token_order(word: torch.Tensor, chunk: int, tile: int) -> CdfOrder:
    """Each ``chunk``-token chunk's chunk-local positions sorted by word
    within tiles of ``tile`` tokens (the tiles in turn, positions ascending
    among equal words), and each chunk's runs of equal words along that
    order (a run ends with its tile): 0-d int64 on the host, so that
    counting them while tracing launches nothing on the card."""
    e = word.shape[0]
    order = torch.empty(e, dtype=torch.int32, device=word.device)
    runs = []
    for s in range(0, e, chunk):
        w = word[s:s + chunk].long()
        tiles = torch.arange(w.shape[0], device=w.device) // tile
        key, pos = torch.sort((tiles << 32) + w, stable=True)
        order[s:s + chunk] = pos.to(torch.int32)
        runs.append((key[1:] != key[:-1]).sum() + 1)
    runs = torch.stack(runs).cpu().unbind() if runs else ()
    return CdfOrder(order=order, runs=runs, chunk=chunk)


class CdfRoute(NamedTuple):
    """How a sweep's tokens run: the step functions of
    :func:`zen_cdf_tokens` and the rule that sizes :func:`zen_cdf_cell`'s
    chunks (:data:`KERNEL_ROUTE` or :data:`PLAIN_ROUTE`)."""

    # (n_wk, t4) -> ((W, K) term-2 CDF rows or None, m2_all (W,))
    term2_table: Callable
    # ops.cdf_uniforms' arguments -> (streams, n) float32
    uniforms: Callable
    # (tables, word, doc, n_wk, hyper, u_a, u_b, count, walk) -> (total
    # (T,) float32, each draw's term-3 topic (2, T) int32); walk: None, or
    # the chunk's (order, runs) of its CdfOrder
    term3: Callable
    # ops.cdf_draws' arguments -> (targets (2, T) float32, code (2, T) int32)
    draws: Callable
    # (tables, n_wk, word, targets (T,), count) -> term-2 topics (T,) int32
    term2: Callable
    # ops.cdf_remedy's arguments -> the new topics (T,) int32
    remedy: Callable
    # max_kd -> (row width, elements) of a chunk (core.sampler.chunk_size)
    chunk: Callable


class CdfTables(NamedTuple):
    """One sweep's tables (paper Alg. 2 l.5-13, in CDF form) and the route
    its tokens take."""

    terms: ZenTerms
    g_cdf: torch.Tensor  # (K,) CDF of gDense
    m2_all: torch.Tensor  # (W,) term-2 mass per word
    w_cdf: Optional[torch.Tensor]  # (W, K) term-2 CDF rows; plain route
    kd_cnt: torch.Tensor  # (D, max_kd) int32 top counts per doc
    kd_idx: torch.Tensor  # (D, max_kd) int32 their topics
    route: CdfRoute


def build_cdf_tables(n_wk, n_kd, n_k, hyper: LDAHyperParams,
                     num_words_pad: int, max_kd: int,
                     route: CdfRoute) -> CdfTables:
    terms = precompute_zen_terms(n_k, hyper, num_words_pad)
    g_cdf = torch.cumsum(terms.g_dense, dim=0)
    w_cdf, m2_all = route.term2_table(n_wk, terms.t4)
    kd_cnt, kd_idx = doc_topk(n_kd, min(max_kd, hyper.num_topics))
    return CdfTables(terms=terms, g_cdf=g_cdf, m2_all=m2_all, w_cdf=w_cdf,
                     kd_cnt=kd_cnt, kd_idx=kd_idx.to(torch.int32),
                     route=route)


def doc_rows(tables: CdfTables, word: torch.Tensor, doc: torch.Tensor,
             n_wk: torch.Tensor, hyper: LDAHyperParams):
    """Term 3 of T tokens: (topics (T, max_kd) of the doc's top rows, the
    CDF (T, max_kd) of cnt·(N_w|k + β)·t1 over them)."""
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


def _plain_term2_table(n_wk, t4):
    w_cdf = torch.cumsum(n_wk.to(torch.float32) * t4[None, :], dim=-1)
    return w_cdf, w_cdf[:, -1]


def _plain_term3(tables: CdfTables, word, doc, n_wk,
                 hyper: LDAHyperParams, u_a, u_b, count: bool, walk=None):
    """The plain route's term 3: :func:`doc_rows`, then each draw's lower
    bound of ``max(u·total - m1 - m2, 0)`` in its (T, max_kd) CDF; what
    ``ops.doc_row_search`` gives, but for the order of the adds. It takes
    the tokens all at once, so a ``walk`` changes nothing here."""
    if count:
        metrics.count(ROW_ENTRIES,
                      (tables.kd_cnt > 0).sum(1)[doc.long()].sum())
    rows_idx, d_cdf = doc_rows(tables, word, doc, n_wk, hyper)
    m1, m2 = tables.g_cdf[-1], tables.m2_all[word.long()]
    total = (m1 + m2) + d_cdf[:, -1]
    z_d = [rows_idx.gather(1, _searchsorted_rows(d_cdf, torch.clamp_min(
        u * total - m1 - m2, 0.0)).long()[:, None])[:, 0] for u in (u_a, u_b)]
    return total, torch.stack(z_d)


def _plain_term2(tables: CdfTables, n_wk, word, targets, count: bool):
    """The plain route's term 2: each target's lower bound in its word's
    ``w_cdf`` row."""
    if count:
        metrics.count(SEARCH_TOKENS, (targets > 0).sum())
    return _bsearch_gather(tables.w_cdf, word, targets)


def _plain_remedy(*args, count: bool = False):
    z, second = cdf_remedy_plain(*args)
    if count:
        metrics.count(REMEDY_SECOND, second.sum())
    return z


def _kernel_term3(tables: CdfTables, word, doc, n_wk,
                  hyper: LDAHyperParams, u_a, u_b, count: bool, walk=None):
    order = None
    if walk is not None:
        order, runs = walk
        if count:
            metrics.count(WORD_RUNS, runs)
    return doc_row_search(
        n_wk, word, doc, tables.kd_cnt, tables.kd_idx, tables.terms.t1,
        tables.m2_all, tables.g_cdf, u_a, u_b, beta=hyper.beta, order=order,
        count=count)


def _kernel_term2(tables: CdfTables, n_wk, word, targets, count: bool):
    return cdf_row_search(n_wk, word, tables.terms.t4, targets, count=count)


KERNEL_ROUTE = CdfRoute(
    term2_table=lambda n_wk, t4: (None, n_wk.to(torch.float32) @ t4),
    uniforms=cdf_uniforms, term3=_kernel_term3, draws=cdf_draws,
    term2=_kernel_term2, remedy=cdf_remedy,
    chunk=lambda max_kd: (1, CDF_KERNEL_CHUNK_TOKENS))
PLAIN_ROUTE = CdfRoute(
    term2_table=_plain_term2_table, uniforms=stream_uniforms,
    term3=_plain_term3, draws=cdf_draws_plain, term2=_plain_term2,
    remedy=_plain_remedy,
    chunk=lambda max_kd: (max_kd, CDF_CHUNK_ELEMS))


def zen_cdf_tokens(tables: CdfTables, word: torch.Tensor, doc: torch.Tensor,
                   z_old: torch.Tensor, n_wk: torch.Tensor,
                   n_kd: torch.Tensor, hyper: LDAHyperParams,
                   uniforms: torch.Tensor, walk=None) -> torch.Tensor:
    """New topics (T,) int32: the three-term CDF draw twice, then the
    remedy, on ``tables.route``. ``uniforms`` (3, T) in [0, 1): draw a,
    draw b, remedy (the reference's ``split(key, 3)``; each draw's u is the
    first half of its key's split). A draw's code is its term-1 topic,
    -1 for term 2 (its search's answer is the topic) or ``-2 - z3`` for
    term 3 (``z3`` its term-3 topic). ``walk``: None (token order) or the
    (order (T,) int32, runs) that term 3 walks the tokens in."""
    route = tables.route
    dev = word.device
    counting = metrics.tracing()
    with metrics.span("zen_cdf.doc_rows", dev):
        total, z_d = route.term3(tables, word, doc, n_wk, hyper, uniforms[0],
                                 uniforms[1], counting, walk)
    with metrics.span("zen_cdf.draws", dev):
        targets, code = route.draws(word, total, uniforms[0], uniforms[1],
                                    tables.m2_all, tables.g_cdf, z_d)
        z_wa, z_wb = (route.term2(tables, n_wk, word, targets[i], counting)
                      for i in (0, 1))
    # resampling remedy (§3.1) for the staleness of terms 2 and 3
    with metrics.span("zen_cdf.remedy", dev):
        return route.remedy(code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd,
                            uniforms[2], count=counting)


def _chunk_tokens(route: CdfRoute, num_tokens: int, max_kd: int,
                  token_chunk: int) -> int:
    """Tokens a chunk on ``route``: ``chunked_token_map``'s own rule."""
    width, elems = route.chunk(max_kd)
    return chunk_size(num_tokens, width, token_chunk, elems)


def zen_cdf_cell(seed: int, word: torch.Tensor, doc: torch.Tensor,
                 z_old: torch.Tensor, mask, n_wk: torch.Tensor,
                 n_kd: torch.Tensor, n_k: torch.Tensor,
                 hyper: LDAHyperParams, num_words_pad: int, max_kd: int,
                 use_kernel: bool = False, token_chunk: int = 0,
                 token_index=None,
                 order: Optional[CdfOrder] = None) -> torch.Tensor:
    """One precomputed-CDF ZenLDA pass over a cell's tokens (stale counts)
    -> (T,) int32: the tables once, then the tokens in chunks
    (``token_index``: the tokens' global indices, default their
    positions), on :data:`KERNEL_ROUTE` where ``use_kernel`` and
    :data:`PLAIN_ROUTE` otherwise. ``order`` (:func:`cdf_token_order`, for
    these chunks) is the walk of term 3 on the kernel route; it changes no
    draw. Work per token: O(log K) (term 1, and term 2 on the plain route)
    + O(max_kd) (term 3); kernel 7 walks a term-2 row up to its lower
    bound."""
    route = KERNEL_ROUTE if use_kernel else PLAIN_ROUTE
    with metrics.span("zen_cdf.tables", word.device):
        tables = build_cdf_tables(n_wk, n_kd, n_k, hyper, num_words_pad,
                                  max_kd, route)
    kd = tables.kd_idx.shape[1]
    arrays, runs = (word, doc, z_old), iter(())
    if order is not None and use_kernel:
        size = _chunk_tokens(route, word.shape[0], kd, token_chunk)
        if order.chunk != size or order.order.shape != word.shape:
            raise ValueError(
                f"a word order of {order.order.shape[0]} tokens in chunks "
                f"of {order.chunk} for {word.shape[0]} in chunks of {size}")
        arrays, runs = arrays + (order.order,), iter(order.runs)

    def chunk(start, w, d, z, *walk):
        with metrics.span("zen_cdf.draws", w.device):
            u = route.uniforms(seed, start, w.shape[0], CDF_STREAMS,
                               device=w.device)
        return zen_cdf_tokens(tables, w, d, z, n_wk, n_kd, hyper, u,
                              (walk[0], next(runs)) if walk else None)

    width, elems = route.chunk(kd)
    return chunked_token_map(chunk, arrays, token_chunk, width, elems,
                             token_index)


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

    def prepare(self, corpus, hyper, knobs: SamplerKnobs):
        """On the kernel route, the word order of every chunk of the corpus
        (:class:`CdfOrder`) that term 3 walks; None off it."""
        if not kernel_dispatch(knobs.kernels, corpus.word.device):
            return None
        chunk = _chunk_tokens(KERNEL_ROUTE, corpus.word.shape[0],
                              knobs.max_kd or DEFAULT_MAX_KD,
                              knobs.token_chunk)
        return cdf_token_order(corpus.word, chunk, CDF_ORDER_TILE_TOKENS)

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs, aux=None):
        seed = key_seed(fold_in(state.rng, state.iteration))
        return self.cell_sweep(
            seed, corpus.word, corpus.doc, state.topic, None, state.n_wk,
            state.n_kd, state.n_k, hyper, corpus.num_words, knobs,
            order=aux)

    def cell_sweep(self, seed, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad, knobs: SamplerKnobs,
                   token_index=None, order: Optional[CdfOrder] = None):
        return zen_cdf_cell(
            seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
            num_words_pad, knobs.max_kd or DEFAULT_MAX_KD,
            use_kernel=kernel_dispatch(knobs.kernels, word.device),
            token_chunk=knobs.token_chunk, token_index=token_index,
            order=order,
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
