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
zero-fills its output then, and counts).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.cdf_search import (
    cdf_row_search_cuda,
    cdf_row_search_plain,
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
    topic_histogram_cuda,
    topic_histogram_plain,
)
from repro_torch.kernels.zen_sampler import (
    zen_infer_sample_cuda,
    zen_infer_sample_plain,
    zen_sample_cuda,
    zen_sample_plain,
)

_LAUNCHES: Dict[str, int] = {
    "zen_sample": 0,
    "zen_fused_sample": 0,
    "zen_infer_sample": 0,
    "zen_fused_infer_sample": 0,
    "sparse_row_sample": 0,
    "cdf_row_search": 0,
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
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"no kernel or plain version for device {t.device}")


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
                   bk: int = 512):
    """Gather + CDF lower-bound search: ``min(#{k : prefix(counts[rows[t]]
    * term)[k] < targets[t]}, K - 1)`` per token, the count rows read in
    place. (R, K) int32 counts, (T,) int32 rows, (K,) float32 term and (T,)
    float32 targets in; (T,) int32 out."""
    if _route(counts) == "cpu":
        return cdf_row_search_plain(counts, rows, term, targets)
    out = cdf_row_search_cuda(counts, rows, term, targets)
    _count("cdf_row_search", rows.shape[0])
    return out


def topic_histogram(rows, z_old, z_new, inc, num_rows: int,
                    num_topics: int, *, order=None, bt: int = 256,
                    bk: int = 512):
    """Signed delta histogram (num_rows, num_topics) int32: ``+inc[t]`` at
    (rows[t], z_new[t]) and ``-inc[t]`` at (rows[t], z_old[t]); ``inc``
    None counts every token once. Rows need not be sorted (the
    reference's must be); ``order`` (``topic_histogram.row_order(rows)``)
    is the sorted walk the kernel takes (without it the kernel's wrapper
    builds one), and changes no result. (T,) int32 ids and inc in."""
    if _route(rows) == "cpu":
        return topic_histogram_plain(rows, z_old, z_new, inc, num_rows,
                                     num_topics)
    out = topic_histogram_cuda(rows, z_old, z_new, inc, num_rows,
                               num_topics, order=order)
    _LAUNCHES["topic_histogram"] += 1
    return out
