"""Baseline CGS algorithms on the shared substrate (paper §7.2;
``repro/core/baselines.py``).

* SparseLDA (Yao et al.): the s/r/q three-bucket decomposition with a
  linear search in each bucket; exact ¬dw on the gathered values. The r
  and q buckets are inverted by kernel 6 (``kernels.ops.sparse_row_sample``)
  on the card, its plain version on the CPU; the dense s bucket is one
  (K,) prefix sum per sweep, searched per token.
* LightLDA (Yuan et al.): cycle Metropolis-Hastings alternating the word
  proposal (N_wk + β)/(N_k + Wβ) (a per-word alias table, or kernel 6 over
  the same density) and the doc proposal N_kd + α (a random token of the
  same doc, through a doc -> token index).

Both sample against iteration-start counts. Their uniforms come in as
tensors, one stream each (``core.keys.stream_uniforms``: sweep seed,
global token index, stream), where the reference splits a key; the
tables are built once per sweep and the tokens go in chunks.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.alias import AliasTable, build_alias, sample_alias
from repro_torch.core.decompositions import ZenTerms, precompute_zen_terms
from repro_torch.core.keys import fold_in, key_seed, stream_uniforms
from repro_torch.core.sampler import chunked_token_map
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.core.zen_sparse import (
    SPARSE_CHUNK_ELEMS,
    SparseRows,
    _pad_topic,
    gather_rows,
    lookup_gathered,
    lookup_rows,  # noqa: F401  (the reference's module surface)
    sparsify_rows,
)
from repro_torch.kernels.ops import sparse_row_sample

# -- SparseLDA ----------------------------------------------------------------


class SparseLDATables(NamedTuple):
    """SparseLDA's per-sweep state: padded rows, the topic vectors with a 0
    at the sentinel K, and the dense s bucket."""

    terms: ZenTerms
    kd_rows: SparseRows
    wk_rows: SparseRows
    t1: torch.Tensor  # (K + 1,)
    t4: torch.Tensor  # (K + 1,)
    t5: torch.Tensor  # (K + 1,)
    s_mass: torch.Tensor  # ()
    s_cdf: torch.Tensor  # (K,) prefix sums of the s bucket


def sparselda_tables(n_wk, n_kd, n_k, hyper: LDAHyperParams, num_words: int,
                     max_kw: int, max_kd: int) -> SparseLDATables:
    terms = precompute_zen_terms(n_k, hyper, num_words)
    s_vals = terms.g_dense  # alpha_k * beta * t1, shared by every token
    return SparseLDATables(
        terms=terms, kd_rows=sparsify_rows(n_kd, max_kd),
        wk_rows=sparsify_rows(n_wk, max_kw), t1=_pad_topic(terms.t1),
        t4=_pad_topic(terms.t4), t5=_pad_topic(terms.t5),
        s_mass=torch.sum(s_vals), s_cdf=torch.cumsum(s_vals, dim=0),
    )


def sparselda_rows(tables: SparseLDATables, word, doc, z_old):
    """The r and q bucket rows of T tokens, with exact self-exclusion:
    (r_vals, kd_idx) (T, max_kd) and (q_vals, wk_idx) (T, max_kw)."""
    z = z_old[:, None]
    kd_idx, kd_cnt = gather_rows(tables.kd_rows, doc)
    kd_cnt_x = kd_cnt - (kd_idx == z).to(torch.int32)
    r_vals = kd_cnt_x.to(torch.float32) * tables.t5[kd_idx.long()]
    wk_idx, wk_cnt = gather_rows(tables.wk_rows, word)
    self_wk = (wk_idx == z).to(torch.int32)
    wk_cnt_x = wk_cnt - self_wk
    n_kd_at = lookup_gathered(kd_idx, kd_cnt, wk_idx) - self_wk
    wl = wk_idx.long()
    q_coef = n_kd_at.to(torch.float32) * tables.t1[wl] + tables.t4[wl]
    q_vals = wk_cnt_x.to(torch.float32) * q_coef
    return r_vals, kd_idx, q_vals, wk_idx


def sparselda_tokens(tables: SparseLDATables, word, doc, z_old,
                     hyper: LDAHyperParams, u01: torch.Tensor
                     ) -> torch.Tensor:
    """New topics (T,) int32: one uniform per token picks a bucket and a
    topic in it; ``u01`` is the reference's ``uniform(split(key)[0])``."""
    k = hyper.num_topics
    r_vals, kd_idx, q_vals, wk_idx = sparselda_rows(tables, word, doc, z_old)
    r_mass = torch.sum(r_vals, dim=-1)
    q_mass = torch.sum(q_vals, dim=-1)
    s_mass = tables.s_mass
    u = u01 * (s_mass + r_mass + q_mass)
    # the dense s bucket: count of s prefix sums below u (they ascend)
    z_s = torch.clamp_max(torch.searchsorted(tables.s_cdf, u), k - 1)
    r_target = torch.clamp_min(u - s_mass, 0.0)
    q_target = torch.clamp_min(u - s_mass - r_mass, 0.0)
    z_r = sparse_row_sample(r_vals, kd_idx, r_target)
    z_q = sparse_row_sample(q_vals, wk_idx, q_target)
    z_new = torch.where(u < s_mass, z_s, torch.where(
        u < s_mass + r_mass, z_r, z_q).to(torch.int64))
    return torch.clamp_max(z_new, k - 1).to(torch.int32)


def sparselda_cell(seed: int, word, doc, z_old, n_wk, n_kd, n_k,
                   hyper: LDAHyperParams, num_words: int, max_kw: int,
                   max_kd: int, token_chunk: int = 0,
                   token_index=None) -> torch.Tensor:
    """One SparseLDA pass over a cell's tokens (stale counts, exact
    self-exclusion) -> (T,). ``token_index`` (T,): the tokens' global
    indices the uniforms hash (default: their positions here)."""
    tables = sparselda_tables(n_wk, n_kd, n_k, hyper, num_words, max_kw,
                              max_kd)

    def chunk(start, w, d, z):
        u = stream_uniforms(seed, start, w.shape[0], 1, device=w.device)
        return sparselda_tokens(tables, w, d, z, hyper, u[0])

    return chunked_token_map(chunk, (word, doc, z_old), token_chunk,
                             max(max_kw, max_kd), SPARSE_CHUNK_ELEMS,
                             token_index)


def sparselda_sweep(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                    max_kw: int, max_kd: int,
                    token_chunk: int = 0) -> torch.Tensor:
    """One SparseLDA sweep (stale counts, exact self-exclusion) -> (E,)."""
    seed = key_seed(fold_in(state.rng, state.iteration))
    return sparselda_cell(seed, corpus.word, corpus.doc, state.topic,
                          state.n_wk, state.n_kd, state.n_k, hyper,
                          corpus.num_words, max_kw, max_kd, token_chunk)


# -- LightLDA -----------------------------------------------------------------


class DocIndex(NamedTuple):
    """CSR doc -> token index for the O(1) doc proposal."""

    token_of: torch.Tensor  # (E,) int32 token ids sorted by doc
    offsets: torch.Tensor  # (D+1,) int32 start of each doc's slice
    lengths: torch.Tensor  # (D,) int32


def build_doc_index(corpus: Corpus) -> DocIndex:
    return build_cell_doc_index(corpus.doc, None, corpus.num_docs)


def build_cell_doc_index(doc: torch.Tensor, mask: Optional[torch.Tensor],
                         num_docs: int) -> DocIndex:
    """``DocIndex`` over one cell's tokens: masked-out tokens sort to the
    end behind the sentinel doc id and count in no length (``mask=None``:
    every token is live)."""
    live = torch.ones_like(doc, dtype=torch.bool) if mask is None else mask
    sort_key = torch.where(live, doc, num_docs)
    order = torch.argsort(sort_key, stable=True).to(torch.int32)
    lengths = torch.zeros(num_docs, dtype=torch.int32,
                          device=doc.device).index_put_(
        (doc.long(),), live.to(torch.int32), accumulate=True)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=doc.device),
                         torch.cumsum(lengths, 0).to(torch.int32)])
    return DocIndex(token_of=order, offsets=offsets, lengths=lengths)


def _true_prob(n_wk_m, n_kd_m, n_k_v, w, d, z_self, ks,
               hyper: LDAHyperParams, num_words: int,
               alpha_k: Optional[torch.Tensor] = None):
    """Exact Eq. 3 p(k) at candidate topics ks (T,) with ¬dw exclusion;
    ``alpha_k`` is ``hyper.alpha_k(n_k_v)`` when given."""
    if alpha_k is None:
        alpha_k = hyper.alpha_k(n_k_v)
    wl, dl, kl = w.long(), d.long(), ks.long()
    self_hit = (ks == z_self).to(torch.float32)
    n_wk = n_wk_m[wl, kl].to(torch.float32) - self_hit
    n_kd = n_kd_m[dl, kl].to(torch.float32) - self_hit
    n_k = n_k_v[kl].to(torch.float32) - self_hit
    return ((n_wk + hyper.beta) / (n_k + num_words * hyper.beta)
            * (n_kd + alpha_k[kl]))


class LightTables(NamedTuple):
    """LightLDA's per-sweep state."""

    terms: ZenTerms
    alpha_k: torch.Tensor  # (K,) hyper.alpha_k(n_k), for the MH target
    alpha_bar: torch.Tensor  # () the doc proposal's symmetric alpha
    n_kd_cell: torch.Tensor  # (D, K) the cell's live (doc, z_old) counts
    wk_rows: SparseRows
    w_vals: torch.Tensor  # (W, max_kw) N_wk * t1 over padded slots
    w_alias: Optional[AliasTable]  # per-word tables (None: kernel 6)
    w_sparse_mass: torch.Tensor  # (W,)
    dense_tab: AliasTable  # over beta * t1
    dense_mass: torch.Tensor  # ()
    n_d: torch.Tensor  # (D,) float32 doc lengths
    doc_index: DocIndex


def lightlda_tables(doc, z_old, mask, n_wk, n_kd, n_k,
                    hyper: LDAHyperParams, num_words: int,
                    doc_index: DocIndex, max_kw: int,
                    use_kernel: bool) -> LightTables:
    terms = precompute_zen_terms(n_k, hyper, num_words)
    live = torch.ones_like(doc, dtype=torch.int32) if mask is None \
        else mask.to(torch.int32)
    # the density the doc proposal samples from: this cell's live
    # (doc, topic) histogram (== n_kd when the cell is the whole corpus)
    n_kd_cell = torch.zeros(n_kd.shape, dtype=torch.int32,
                            device=n_kd.device).index_put_(
        (doc.long(), z_old.long()), live, accumulate=True)
    wk_rows = sparsify_rows(n_wk, max_kw)
    w_vals = wk_rows.cnt.to(torch.float32) \
        * _pad_topic(terms.t1)[wk_rows.idx.long()]
    return LightTables(
        terms=terms, alpha_k=hyper.alpha_k(n_k),
        alpha_bar=torch.mean(terms.alpha_k), n_kd_cell=n_kd_cell,
        wk_rows=wk_rows, w_vals=w_vals,
        # the kernel path draws the sparse branch by CDF inversion and
        # needs no per-word alias tables
        w_alias=None if use_kernel else build_alias(w_vals),
        w_sparse_mass=torch.sum(w_vals, dim=-1),
        dense_tab=build_alias(terms.t5), dense_mass=torch.sum(terms.t5),
        n_d=doc_index.lengths.to(torch.float32), doc_index=doc_index,
    )


# uniforms per MH step; step i reads streams [8 i, 8 i + 6)
MH_STREAMS = 8


def lightlda_draws(u: torch.Tensor, i: int, num_topics: int
                   ) -> Dict[str, torch.Tensor]:
    """Step ``i``'s named draws from the chunk's uniforms (streams, T).
    Word steps (even i): pick, u1, u2, dense_bin, dense_split, acc; doc
    steps: pick, tok, unif (a topic in [0, K)), acc."""
    s = u[MH_STREAMS * i:MH_STREAMS * (i + 1)]
    if i % 2 == 0:
        return dict(pick=s[0], u1=s[1], u2=s[2], dense_bin=s[3],
                    dense_split=s[4], acc=s[5])
    unif = torch.clamp_max((s[2] * num_topics).to(torch.int64),
                           num_topics - 1)
    return dict(pick=s[0], tok=s[1], unif=unif, acc=s[5])


def lightlda_mh_step(i: int, z_cur, z0, w, d, z_old, tab: LightTables,
                     n_wk, n_kd, n_k, hyper: LDAHyperParams, num_words: int,
                     draws: Dict[str, torch.Tensor], use_kernel: bool,
                     w_rows=None) -> torch.Tensor:
    """One cycle-MH step for T tokens: the word proposal on even ``i``, the
    doc proposal on odd ``i`` (the reference computes both and keeps one:
    with per-stream uniforms the other changes no draw), then the
    acceptance test against Eq. 3. ``z_old`` is the cell's whole (E,)
    iteration-start assignment (the doc proposal reads it); ``w_rows`` the
    chunk's gathered (w_vals, idx) rows for kernel 6."""
    k = hyper.num_topics
    beta = hyper.beta
    t1 = tab.terms.t1
    if i % 2 == 0:
        m_s = tab.w_sparse_mass[w.long()]
        pick_sparse = draws["pick"] * (m_s + tab.dense_mass) < m_s
        if use_kernel:
            vals, idx = w_rows
            z_sparse = sparse_row_sample(vals, idx, draws["u1"] * m_s)
        else:
            nbins = tab.wk_rows.idx.shape[-1]
            wl = w.long()
            bins = torch.clamp_max((draws["u1"] * nbins).to(torch.int64),
                                   nbins - 1)
            slot = torch.where(draws["u2"] < tab.w_alias.prob[wl, bins],
                               bins,
                               tab.w_alias.alias[wl, bins].to(torch.int64))
            z_sparse = tab.wk_rows.idx[wl, slot]
        z_dense = sample_alias(tab.dense_tab, draws["dense_bin"],
                               draws["dense_split"])
        z_new = torch.clamp_max(torch.where(
            pick_sparse, z_sparse.to(torch.int64), z_dense), k - 1)

        def q(ks):
            kl = ks.long()
            return (n_wk[w.long(), kl].to(torch.float32) + beta) * t1[kl]
    else:
        dl = d.long()
        mass_doc = tab.n_d[dl]
        pick_doc = draws["pick"] * (mass_doc + k * tab.alpha_bar) < mass_doc
        # O(1): the topic of a uniformly random token of the same doc
        di = tab.doc_index
        tok = di.offsets[dl] + torch.minimum(
            (draws["tok"] * torch.clamp_min(mass_doc, 1.0)).to(torch.int32),
            torch.clamp_min(di.lengths[dl] - 1, 0))
        z_doc = z_old[di.token_of[tok.long()].long()]
        z_new = torch.where(pick_doc, z_doc.to(torch.int64), draws["unif"])

        def q(ks):
            return tab.n_kd_cell[dl, ks.long()].to(torch.float32) \
                + tab.alpha_bar
    p_new = _true_prob(n_wk, n_kd, n_k, w, d, z0, z_new, hyper, num_words,
                       tab.alpha_k)
    p_old = _true_prob(n_wk, n_kd, n_k, w, d, z0, z_cur, hyper, num_words,
                       tab.alpha_k)
    ratio = (p_new * q(z_cur)) / torch.clamp_min(p_old * q(z_new), 1e-30)
    accept = draws["acc"] < torch.clamp_max(ratio, 1.0)
    return torch.where(accept, z_new.to(torch.int32), z_cur)


def lightlda_cell(seed: int, word, doc, z_old, mask, n_wk, n_kd, n_k,
                  hyper: LDAHyperParams, num_words: int,
                  doc_index: DocIndex, max_kw: int, num_mh: int = 8,
                  use_kernel: bool = False,
                  token_chunk: int = 0, token_index=None) -> torch.Tensor:
    """One LightLDA pass over a cell's tokens: ``num_mh`` cycle-MH steps
    per token -> (T,); ``token_index`` as in :func:`sparselda_cell`.

    ``use_kernel`` draws the word proposal's sparse branch by CDF inversion
    through kernel 6 over the same N_wk·t1 density, and builds no per-word
    alias tables; the proposal distribution, so the MH ratio, is the same.
    The doc proposal draws from the doc's tokens within this cell and its
    MH density is this cell's (doc, z_old) histogram (``mask`` False on
    cell padding; ``None`` = every token live)."""
    tab = lightlda_tables(doc, z_old, mask, n_wk, n_kd, n_k, hyper,
                          num_words, doc_index, max_kw, use_kernel)

    def chunk(start, w, d, z0):
        u = stream_uniforms(seed, start, w.shape[0], MH_STREAMS * num_mh,
                            device=w.device)
        w_rows = None
        if use_kernel:
            wl = w.long()
            w_rows = (tab.w_vals[wl], tab.wk_rows.idx[wl])
        z = z0
        for i in range(num_mh):
            z = lightlda_mh_step(
                i, z, z0, w, d, z_old, tab, n_wk, n_kd, n_k, hyper,
                num_words, lightlda_draws(u, i, hyper.num_topics),
                use_kernel, w_rows)
        return z

    return chunked_token_map(chunk, (word, doc, z_old), token_chunk,
                             max_kw, SPARSE_CHUNK_ELEMS, token_index)


def lightlda_sweep(state: CGSState, corpus: Corpus, hyper: LDAHyperParams,
                   doc_index: DocIndex, max_kw: int, num_mh: int = 8,
                   use_kernel: bool = False,
                   token_chunk: int = 0) -> torch.Tensor:
    """One LightLDA sweep: ``num_mh`` cycle-MH steps per token -> (E,)."""
    seed = key_seed(fold_in(state.rng, state.iteration))
    return lightlda_cell(seed, corpus.word, corpus.doc, state.topic, None,
                         state.n_wk, state.n_kd, state.n_k, hyper,
                         corpus.num_words, doc_index, max_kw, num_mh=num_mh,
                         use_kernel=use_kernel, token_chunk=token_chunk)
