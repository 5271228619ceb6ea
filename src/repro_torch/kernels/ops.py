"""Public kernel wrappers: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel, any other device raises.

Arguments mirror ``repro/kernels/ops.py``. ``bt``/``bk``/``bs`` are
accepted so that callers and configs carry over, but they reach no kernel
and change no draw: the CUDA kernels walk the real K (or row width J) with
no tile to pad to, and each has one block shape, a constant of its source
(``chip_smoke.py``'s autotune phase measures the others).

Each wrapper counts its kernel launches in a plain int
(:func:`launch_counts`), so a run can show that its main path went
through the kernels; plain-version calls are not counted, nor is a call
with no tokens, whose launcher launches nothing (kernel 5's launcher
zero-fills its output then, and counts). ``count=True`` on kernels 5 and
7, on the doc-row search and on ``zen_cdf``'s remedy (only while a
profiler records) adds their work to the profiled stretch's counters: the
kernel counts on the card, the plain version with torch ops.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.cdf_search import (
    ROW_ENTRIES,
    SEARCH_TOKENS,
    cdf_row_search_cuda,
    cdf_row_search_plain,
    doc_row_search_cuda,
    doc_row_search_plain,
)
from repro_torch.kernels.cdf_tokens import (
    REMEDY_SECOND,
    cdf_draws_cuda,
    cdf_draws_plain,
    cdf_remedy_cuda,
    cdf_remedy_plain,
    cdf_uniforms_cuda,
)
from repro_torch.kernels.fused_gather import (
    zen_fused_infer_sample_cuda,
    zen_fused_infer_sample_plain,
    zen_fused_sample_cuda,
    zen_fused_sample_plain,
)
from repro_torch.kernels.sparse_row import (
    sparse_row_sample_cuda,
    sparse_row_sample_plain,
)
from repro_torch.kernels.topic_histogram import (
    CHANGED_TOKENS,
    topic_histogram_cuda,
    topic_histogram_plain,
)
from repro_torch.kernels.zen_sampler import (
    zen_infer_sample_cuda,
    zen_infer_sample_plain,
    zen_sample_cuda,
    zen_sample_plain,
)
from repro_torch.observe import metrics

_LAUNCHES: Dict[str, int] = {
    "zen_sample": 0,
    "zen_fused_sample": 0,
    "zen_infer_sample": 0,
    "zen_fused_infer_sample": 0,
    "sparse_row_sample": 0,
    "cdf_row_search": 0,
    "doc_row_search": 0,
    "cdf_uniforms": 0,
    "cdf_draws": 0,
    "cdf_remedy": 0,
    "topic_histogram": 0,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _count(name: str, tokens: int) -> None:
    if tokens > 0:
        _LAUNCHES[name] += 1


def _route(t) -> str:
    """The route of a tensor, or of a device."""
    dev = t if isinstance(t, torch.device) else t.device
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"no kernel or plain version for device {dev}")


def zen_sample(nwk_rows, nkd_rows, z_old, alpha_k, n_k, seed: int, *,
               beta: float, w_beta: float, bt: int = 256, bk: int = 512,
               row_offset: int = 0, token_index=None):
    """Training draw on gathered (T, K) rows: exact ¬dw exclusion on all
    three counts, noise at (seed, row_offset + t, topic), or at (seed,
    token_index[t], topic) when a (T,) int32 ``token_index`` is given (a
    mesh cell's corpus indices). Returns (T,) int32. Unlike the
    reference's padded Pallas grid, no topic id >= K can come out."""
    if _route(nwk_rows) == "cpu":
        return zen_sample_plain(nwk_rows, nkd_rows, z_old, alpha_k, n_k,
                                seed, beta=beta, w_beta=w_beta,
                                row_offset=row_offset,
                                token_index=token_index)
    out = zen_sample_cuda(nwk_rows, nkd_rows, z_old, alpha_k, n_k, seed,
                          beta=beta, w_beta=w_beta, row_offset=row_offset,
                          token_index=token_index)
    _count("zen_sample", z_old.shape[0])
    return out


def zen_fused_sample(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, seed: int,
                     *, beta: float, w_beta: float, bt: int = 256,
                     bk: int = 512, row_offset: int = 0, token_index=None):
    """``zen_sample(n_wk[word], n_kd[doc], ...)`` without the gathered
    rows; bit-identical to it. Returns (T,) int32."""
    if _route(n_wk) == "cpu":
        return zen_fused_sample_plain(n_wk, n_kd, word, doc, z_old, alpha_k,
                                      n_k, seed, beta=beta, w_beta=w_beta,
                                      row_offset=row_offset,
                                      token_index=token_index)
    out = zen_fused_sample_cuda(n_wk, n_kd, word, doc, z_old, alpha_k, n_k,
                                seed, beta=beta, w_beta=w_beta,
                                row_offset=row_offset,
                                token_index=token_index)
    _count("zen_fused_sample", word.shape[0])
    return out


def zen_infer_sample(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k, *,
                     beta: float, w_beta: float, bt: int = 256,
                     bk: int = 512):
    """Frozen-model serving draw on gathered (T, K) rows: doc-side
    exclusion only, per-token counter-based seeds. Returns (T,) int32."""
    if _route(nwk_rows) == "cpu":
        return zen_infer_sample_plain(
            nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
            beta=beta, w_beta=w_beta,
        )
    out = zen_infer_sample_cuda(
        nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )
    _count("zen_infer_sample", z_old.shape[0])
    return out


def zen_fused_infer_sample(n_wk, n_kd, word, slot, z_old, seeds, alpha_k,
                           n_k, *, beta: float, w_beta: float,
                           bt: int = 256, bk: int = 512):
    """``zen_infer_sample(n_wk[word], n_kd[slot], ...)`` without the
    gathered rows; bit-identical to it. Returns (T,) int32."""
    if _route(n_wk) == "cpu":
        return zen_fused_infer_sample_plain(
            n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
            beta=beta, w_beta=w_beta,
        )
    out = zen_fused_infer_sample_cuda(
        n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )
    _count("zen_fused_infer_sample", word.shape[0])
    return out


def sparse_row_sample(vals, topics, targets, *, bt: int = 256,
                      bs: int = 128):
    """Whole-row sparse CDF inversion: the topic id at the lower-bound
    position of ``targets[t]`` in the prefix sums of ``vals[t]``, clamped
    to the last lane. (T, J) float32 weights, (T, J) int32 topic ids and
    (T,) float32 targets in; (T,) int32 out."""
    if _route(vals) == "cpu":
        return sparse_row_sample_plain(vals, topics, targets)
    out = sparse_row_sample_cuda(vals, topics, targets)
    _count("sparse_row_sample", targets.shape[0])
    return out


def cdf_row_search(counts, rows, term, targets, *, bt: int = 256,
                   bk: int = 512, count: bool = False):
    """Gather + CDF lower-bound search: ``min(#{k : prefix(counts[rows[t]]
    * term)[k] < targets[t]}, K - 1)`` per token, the count rows read in
    place. (R, K) int32 counts, (T,) int32 rows, (K,) float32 term and (T,)
    float32 targets in; (T,) int32 out. ``count``: add the tokens that
    search (target > 0) to the trace's ``zen_cdf.search_tokens``."""
    if _route(counts) == "cpu":
        if count:
            metrics.count(SEARCH_TOKENS, (targets > 0).sum())
        return cdf_row_search_plain(counts, rows, term, targets)
    out = cdf_row_search_cuda(counts, rows, term, targets, count=count)
    _count("cdf_row_search", rows.shape[0])
    return out


def doc_row_search(n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf, u_a,
                   u_b, *, beta: float, order=None, count: bool = False):
    """``zen_cdf``'s term 3 for both draws, the doc rows read in place:
    (total (T,) float32, z (2, T) int32), the token's total mass and each
    draw's term-3 topic (``cdf_search.doc_row_search_cuda``). (W, K) int32
    ``n_wk``, (T,) int32 word and doc ids, (D, J) int32 ``kd_cnt`` and
    ``kd_idx``, (K,) float32 ``t1`` and ``g_cdf``, (W,) float32 ``m2_all``
    and the two draws' (T,) float32 uniforms in. ``order`` (T,) int32, a
    permutation of the tokens or None, is the order the tokens are taken
    in; it changes no output. ``count``: add the live row entries (count >
    0) to the trace's ``zen_cdf.row_entries``."""
    args = (n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf, u_a, u_b,
            beta)
    if _route(n_wk) == "cpu":
        if count:
            metrics.count(ROW_ENTRIES,
                          (kd_cnt > 0).sum(1)[doc.long()].sum())
        return doc_row_search_plain(*args, order=order)
    out = doc_row_search_cuda(*args, order=order, count=count)
    _count("doc_row_search", word.shape[0])
    return out


def cdf_uniforms(seed: int, start, n: int, streams: int, *, device):
    """``zen_cdf``'s uniform streams of a token chunk on ``device``:
    (streams, n) float32 U[0, 1), entry (s, i) the top 24 bits of
    ``hash(seed, row_i, s)`` times 2^-24, ``row_i`` = ``start + i`` (mod
    2^32) or, where ``start`` is a (n,) int32 tensor (a mesh cell's corpus
    indices), ``start[i]``. The plain version is
    ``core.keys.stream_uniforms``."""
    device = torch.device(device)
    if _route(device) == "cpu":
        # imported here: repro_torch.core's package imports this module
        from repro_torch.core.keys import stream_uniforms

        return stream_uniforms(seed, start, n, streams, device)
    out = cdf_uniforms_cuda(seed, start, n, streams, device)
    _count("cdf_uniforms", n * streams)
    return out


def cdf_draws(word, total, u_a, u_b, m2_all, g_cdf, z_d):
    """``zen_cdf``'s two draws of each token after the doc-row search:
    (targets (2, T) float32, code (2, T) int32), kernel 7's term-2 target
    and the draw's code (its term-1 topic, -1 for term 2, ``-2 - z3`` for
    term 3; ``cdf_tokens.cdf_draws_cuda``). (T,) int32 word ids, (T,)
    float32 totals and uniforms, (W,) ``m2_all``, (K,) ``g_cdf`` and the
    (2, T) int32 term-3 topics in."""
    if _route(word) == "cpu":
        return cdf_draws_plain(word, total, u_a, u_b, m2_all, g_cdf, z_d)
    out = cdf_draws_cuda(word, total, u_a, u_b, m2_all, g_cdf, z_d)
    _count("cdf_draws", word.shape[0])
    return out


def cdf_remedy(code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd, u_r, *,
               count: bool = False):
    """``zen_cdf``'s new topics (T,) int32: each draw's topic from its code
    and kernel 7's answers ``z_wa``/``z_wb``, then the §3.1 remedy with
    the uniform ``u_r`` (``cdf_tokens.cdf_remedy_cuda``). ``count``: add
    the tokens that take draw b to the trace's ``zen_cdf.remedy_second``."""
    args = (code, z_wa, z_wb, z_old, word, doc, n_wk, n_kd, u_r)
    if _route(z_old) == "cpu":
        z, second = cdf_remedy_plain(*args)
        if count:
            metrics.count(REMEDY_SECOND, second.sum())
        return z
    out = cdf_remedy_cuda(*args, count=count)
    _count("cdf_remedy", z_old.shape[0])
    return out


def topic_histogram(rows, z_old, z_new, inc, num_rows: int,
                    num_topics: int, *, order=None, bt: int = 256,
                    bk: int = 512, count: bool = False):
    """Signed delta histogram (num_rows, num_topics) int32: ``+inc[t]`` at
    (rows[t], z_new[t]) and ``-inc[t]`` at (rows[t], z_old[t]); ``inc``
    None counts every token once. Rows need not be sorted (the
    reference's must be); ``order`` (``topic_histogram.row_order(rows)``)
    is the sorted walk the kernel takes (without it the kernel's wrapper
    builds one), and changes no result. (T,) int32 ids and inc in.
    ``count``: add the tokens whose topic changes (``inc != 0`` and
    ``z_old != z_new``) to the trace's ``counts.changed_tokens``."""
    if _route(rows) == "cpu":
        if count:
            changed = z_old != z_new
            if inc is not None:
                changed &= inc != 0
            metrics.count(CHANGED_TOKENS, changed.sum())
        return topic_histogram_plain(rows, z_old, z_new, inc, num_rows,
                                     num_topics)
    out = topic_histogram_cuda(rows, z_old, z_new, inc, num_rows,
                               num_topics, order=order, count=count)
    _LAUNCHES["topic_histogram"] += 1
    return out
