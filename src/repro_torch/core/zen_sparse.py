"""The faithful ZenLDA sampler on padded-sparse topic rows (paper Alg. 2;
``repro/core/zen_sparse.py``).

Doc-topic and word-topic rows are stored as ``(idx, cnt)`` pairs padded to
a row width (``max_kd`` / ``max_kw``), so the work per token tracks the
padded width, not K. Per iteration:

* gDense = α_k·β/(N_k + Wβ) -> one alias table over K;
* wSparse[w] = N_w|k·α_k/(N_k + Wβ) -> one alias table per word, over the
  word's padded slots (stale; remedied below);
* dSparse = N_k|d·(N_w|k + β)/(N_k + Wβ) over the doc's padded slots,
  inverted by kernel 6 (``kernels.ops.sparse_row_sample``);
* a two-level draw: pick the term by mass, then a topic within it; and the
  §3.1 remedy: where the draw equals the token's previous topic, take a
  second draw with the paper's per-term probability.

The tables are built once per sweep; the tokens then go in chunks whose
gathered rows hold at most :data:`SPARSE_CHUNK_ELEMS` elements. The
uniforms of a chunk come in as one (streams, chunk) tensor
(``core.keys.stream_uniforms``: sweep seed, global token index, stream),
so no chunking changes a draw, and a test can feed the reference's own
``jax.random`` uniforms instead. Both draws read the same dSparse rows
(the reference computes them twice, from the same inputs), and the
remedy's lookups reuse the rows the draws gathered.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.alias import AliasTable, build_alias, sample_alias
from repro_torch.core.decompositions import ZenTerms, precompute_zen_terms
from repro_torch.core.keys import fold_in, key_seed, stream_uniforms
from repro_torch.core.sampler import chunked_token_map
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.kernels.ops import sparse_row_sample

# elements of the widest gathered (chunk, row width) temporary
SPARSE_CHUNK_ELEMS = 1 << 27
# rows of one block of sparsify_rows' (block, K) temporaries
_SPARSIFY_ELEMS = 1 << 26
# uniforms per token: draw a (u, g1, g2, w1, w2), draw b (the same), remedy
ZEN_STREAMS = 11


class SparseRows(NamedTuple):
    """Padded-sparse rows of a count matrix: row r = {(idx[r,j], cnt[r,j])}.

    ``idx`` ascends per row; empty slots hold idx == K (the sentinel) and
    cnt == 0, so a searchsorted lookup misses them."""

    idx: torch.Tensor  # (R, max_nnz) int32
    cnt: torch.Tensor  # (R, max_nnz) int32
    num_topics: int

    @property
    def nnz(self) -> torch.Tensor:  # (R,)
        return torch.sum(self.cnt > 0, dim=-1)


def sparsify_rows(dense: torch.Tensor, max_nnz: int) -> SparseRows:
    """Dense (R, K) -> padded-sparse: each row's nonzero topics in
    ascending order; a row with more than ``max_nnz`` keeps its first
    ``max_nnz`` (callers size ``max_nnz`` with :func:`max_row_nnz`). The
    width is ``min(max_nnz, K)``, as the reference's slice gives."""
    r, k = dense.shape
    max_nnz = min(max_nnz, k)
    dev = dense.device
    idx = torch.full((r, max_nnz + 1), k, dtype=torch.int32, device=dev)
    cnt = torch.zeros((r, max_nnz + 1), dtype=torch.int32, device=dev)
    topic = torch.arange(k, dtype=torch.int32, device=dev)
    block = max(1, _SPARSIFY_ELEMS // max(1, k))
    for a in range(0, r, block):
        blk = dense[a:a + block]
        nz = blk > 0
        rank = torch.cumsum(nz, dim=1, dtype=torch.int32) - 1
        # column of each kept nonzero; the rest land in a spill column
        col = torch.where(nz & (rank < max_nnz), rank, max_nnz).long()
        idx[a:a + block].scatter_(1, col, topic.expand(blk.shape[0], k))
        cnt[a:a + block].scatter_(1, col, blk.to(torch.int32))
    idx = idx[:, :max_nnz].contiguous()
    cnt = torch.where(idx < k, cnt[:, :max_nnz], 0).contiguous()
    return SparseRows(idx=idx, cnt=cnt, num_topics=k)


def max_row_nnz(dense: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.sum(dense > 0, dim=-1))


def shard_row_capacity(dense_block: torch.Tensor, multiple: int = 8) -> int:
    """Padded-row capacity for one count block (host-side): the block's
    max row nnz rounded up to ``multiple``, capped at K."""
    k = dense_block.shape[-1]
    m = int(max_row_nnz(dense_block))
    m = max(multiple, ((m + multiple - 1) // multiple) * multiple)
    return min(m, k)


def densify_rows(rows: SparseRows) -> torch.Tensor:
    r = rows.idx.shape[0]
    out = torch.zeros((r, rows.num_topics + 1), dtype=torch.int32,
                      device=rows.idx.device)
    out.scatter_add_(1, rows.idx.long(), rows.cnt)
    return out[:, :rows.num_topics]


def gather_rows(rows: SparseRows, row_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (idx, cnt) rows of ``row_ids``, (T, max_nnz) each."""
    ids = row_ids.long()
    return rows.idx[ids], rows.cnt[ids]


def lookup_gathered(idx: torch.Tensor, cnt: torch.Tensor,
                    topics: torch.Tensor) -> torch.Tensor:
    """``cnt`` at ``topics`` (T, J) in gathered rows (T, max_nnz), by a
    batched left-side binary search; 0 where a row lacks the topic."""
    pos = torch.searchsorted(idx, topics.to(idx.dtype).contiguous())
    pos = torch.clamp_max(pos, idx.shape[-1] - 1)
    hit = torch.gather(idx, -1, pos) == topics
    val = torch.gather(cnt, -1, pos)
    return torch.where(hit, val, 0)


def lookup_rows(rows: SparseRows, row_ids: torch.Tensor,
                topics: torch.Tensor) -> torch.Tensor:
    """cnt[row_ids, topics] via per-row binary search: row_ids (T,),
    topics (T, J) -> (T, J)."""
    return lookup_gathered(*gather_rows(rows, row_ids), topics)


class ZenTables(NamedTuple):
    """Per-iteration sampling state (the "ship model state" payload)."""

    terms: ZenTerms
    g_table: AliasTable  # over K
    w_prob: torch.Tensor  # (W, max_kw) alias prob over padded slots
    w_alias: torch.Tensor  # (W, max_kw) alias target (slot index)
    w_mass: torch.Tensor  # (W,) total wSparse mass per word
    wk_rows: SparseRows
    kd_rows: SparseRows


def _pad_topic(vec: torch.Tensor) -> torch.Tensor:
    """A (K,) vector with a 0 appended at the sentinel index K."""
    return torch.cat([vec, torch.zeros(1, dtype=vec.dtype,
                                       device=vec.device)])


def build_tables(n_wk: torch.Tensor, n_kd: torch.Tensor, n_k: torch.Tensor,
                 hyper: LDAHyperParams, num_words: int, max_kw: int,
                 max_kd: int) -> ZenTables:
    terms = precompute_zen_terms(n_k, hyper, num_words)
    g_table = build_alias(terms.g_dense)
    wk_rows = sparsify_rows(n_wk, max_kw)
    kd_rows = sparsify_rows(n_kd, max_kd)
    # wSparse over padded slots: cnt * t4[idx]; empty slots -> 0 mass
    w_vals = wk_rows.cnt.to(torch.float32) \
        * _pad_topic(terms.t4)[wk_rows.idx.long()]
    w_table = build_alias(w_vals)
    return ZenTables(
        terms=terms, g_table=g_table, w_prob=w_table.prob,
        w_alias=w_table.alias, w_mass=torch.sum(w_vals, dim=-1),
        wk_rows=wk_rows, kd_rows=kd_rows,
    )


def _d_vals(tables: ZenTables, wk, kd, beta: float) -> torch.Tensor:
    """dSparse over the doc's padded slots from gathered rows."""
    kd_idx, kd_cnt = kd
    n_wk_at = lookup_gathered(*wk, kd_idx)
    t1 = _pad_topic(tables.terms.t1)
    vals = (kd_cnt.to(torch.float32) * (n_wk_at.to(torch.float32) + beta)
            * t1[kd_idx.long()])
    return torch.where(kd_cnt > 0, vals, 0.0)


def _d_sparse(tables: ZenTables, word: torch.Tensor, doc: torch.Tensor,
              beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dSparse values over the doc's padded slots: (vals (T, max_kd),
    topics (T, max_kd))."""
    kd = gather_rows(tables.kd_rows, doc)
    return _d_vals(tables, gather_rows(tables.wk_rows, word), kd, beta), \
        kd[0]


def zen_sample_tokens(tables: ZenTables, word: torch.Tensor,
                      doc: torch.Tensor, prev_topic: torch.Tensor,
                      hyper: LDAHyperParams,
                      uniforms: torch.Tensor) -> torch.Tensor:
    """New topics (T,) int32 for T tokens: the two-level ZenLDA draw
    twice, then the §3.1 remedy. ``uniforms`` is (11, T) in [0, 1):
    draw a's u, g1, g2, w1, w2, draw b's, then the remedy's, the streams
    of the reference's ``split(key, 3)`` / ``split(key_a, 6)``. Term 3
    goes through kernel 6 on the card (its plain version on the CPU)."""
    k = hyper.num_topics
    wk = gather_rows(tables.wk_rows, word)
    kd = gather_rows(tables.kd_rows, doc)
    d_vals = _d_vals(tables, wk, kd, hyper.beta)
    d_topics = kd[0]
    m1 = tables.terms.g_mass
    m2 = tables.w_mass[word.long()]
    m3 = torch.sum(d_vals, dim=-1)
    total = m1 + m2 + m3
    nbins = tables.w_prob.shape[-1]
    w_ids = word.long()

    def draw(u01, u_g1, u_g2, u_w1, u_w2):
        u = u01 * total
        # term 1: the global alias table
        z_g = sample_alias(tables.g_table, u_g1, u_g2)
        # term 2: the word's alias table over its padded slots -> topic id
        bins = torch.clamp_max((u_w1 * nbins).to(torch.int64), nbins - 1)
        keep = u_w2 < tables.w_prob[w_ids, bins]
        slot = torch.where(keep, bins,
                           tables.w_alias[w_ids, bins].to(torch.int64))
        z_w = wk[0].gather(1, slot[:, None])[:, 0]
        # term 3: CDF inversion over the doc's padded slots (kernel 6)
        target = torch.clamp_min(u - (m1 + m2), 0.0)
        z_d = sparse_row_sample(d_vals, d_topics, target)
        branch = torch.where(u < m1, 0, torch.where(u < m1 + m2, 1, 2))
        z = torch.where(branch == 0, z_g,
                        torch.where(branch == 1, z_w, z_d).to(torch.int64))
        # the sentinel K can only come from a fully padded row
        return torch.clamp_max(z, k - 1).to(torch.int32), branch

    z1, branch1 = draw(*uniforms[0:5])
    z2, _ = draw(*uniforms[5:10])

    # remedy (§3.1): the stale tables did not exclude the token's own
    # previous assignment; where the draw equals it, redraw once with the
    # per-term probability
    prev = prev_topic[:, None]
    n_wk_prev = lookup_gathered(*wk, prev)[:, 0]
    n_kd_prev = lookup_gathered(*kd, prev)[:, 0]
    nw = torch.clamp_min(n_wk_prev.to(torch.float32), 1.0)
    nd = torch.clamp_min(n_kd_prev.to(torch.float32), 1.0)
    p_w = 1.0 / nw
    p_d = torch.clamp(1.0 / nd + (nd + nw - 1.0) / (nd * nw), 0.0, 1.0)
    remedy_p = torch.where(branch1 == 1, p_w,
                           torch.where(branch1 == 2, p_d, 0.0))
    take_second = (z1 == prev_topic) & (uniforms[10] < remedy_p)
    return torch.where(take_second, z2, z1).to(torch.int32)


def zen_sparse_cell(seed: int, word: torch.Tensor, doc: torch.Tensor,
                    z_old: torch.Tensor, n_wk: torch.Tensor,
                    n_kd: torch.Tensor, n_k: torch.Tensor,
                    hyper: LDAHyperParams, num_words: int, max_kw: int,
                    max_kd: int, token_chunk: int = 0,
                    token_index=None) -> torch.Tensor:
    """One faithful ZenLDA pass over a cell's tokens (stale counts) ->
    (T,): the tables once, then the tokens in chunks. ``token_index``
    (T,): the tokens' global indices the uniforms hash (default: their
    positions here)."""
    tables = build_tables(n_wk, n_kd, n_k, hyper, num_words, max_kw, max_kd)

    def chunk(start, w, d, z):
        u = stream_uniforms(seed, start, w.shape[0], ZEN_STREAMS,
                            device=w.device)
        return zen_sample_tokens(tables, w, d, z, hyper, u)

    return chunked_token_map(chunk, (word, doc, z_old), token_chunk,
                             max(max_kw, max_kd), SPARSE_CHUNK_ELEMS,
                             token_index)


def zen_sparse_sweep(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                     max_kw: int, max_kd: int,
                     token_chunk: int = 0) -> torch.Tensor:
    """One faithful ZenLDA sweep over all tokens (stale counts) -> (E,);
    sweep ``n`` draws from ``key_seed(fold_in(state.rng, n))``."""
    seed = key_seed(fold_in(state.rng, state.iteration))
    return zen_sparse_cell(seed, corpus.word, corpus.doc, state.topic,
                           state.n_wk, state.n_kd, state.n_k, hyper,
                           corpus.num_words, max_kw, max_kd, token_chunk)
