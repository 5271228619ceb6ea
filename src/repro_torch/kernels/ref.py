"""Plain oracles of the kernels, mirroring ``repro/kernels/ref.py``:
the whole (T, K) score (or (T, J) prefix) matrix at once, with no chunking,
written apart from the kernels' plain versions so that each can be held
against the other."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.zen_sampler import gumbel_noise


def zen_infer_sample_ref(nwk_rows, nkd_rows, z_old, seeds, alpha_k, n_k, *,
                         beta: float, w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_infer_sample``: doc-side-only exclusion, frozen
    word/topic totals, noise at (seed[t], 0, topic)."""
    t, k = nwk_rows.shape
    cols = torch.arange(k, device=nwk_rows.device)[None, :]
    self_hit = (cols == z_old[:, None]).to(torch.float32)
    nw = nwk_rows.to(torch.float32)
    nd = nkd_rows.to(torch.float32) - self_hit
    a = alpha_k.to(torch.float32)[None, :]
    p = (nd + a) * (nw + beta) / (n_k.to(torch.float32)[None, :] + w_beta)
    g = gumbel_noise(seeds[:, None], 0, cols)
    score = torch.log(torch.clamp_min(p, 1e-30)) + g
    return torch.argmax(score, dim=-1).to(torch.int32)


def zen_fused_infer_sample_ref(n_wk, n_kd, word, slot, z_old, seeds,
                               alpha_k, n_k, *, beta: float,
                               w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_fused_infer_sample``: gather, then the
    gathered-row oracle."""
    return zen_infer_sample_ref(
        n_wk[word.long()], n_kd[slot.long()], z_old, seeds, alpha_k, n_k,
        beta=beta, w_beta=w_beta,
    )


def _train_probs(nwk_rows, nkd_rows, z_old, alpha_k, n_k, beta, w_beta):
    t, k = nwk_rows.shape
    cols = torch.arange(k, device=nwk_rows.device)[None, :]
    self_hit = (cols == z_old[:, None]).to(torch.float32)
    nw = nwk_rows.to(torch.float32) - self_hit
    nd = nkd_rows.to(torch.float32) - self_hit
    nk = n_k.to(torch.float32)[None, :] - self_hit
    a = alpha_k.to(torch.float32)[None, :]
    return (a * beta + nw * a + nd * (nw + beta)) / (nk + w_beta)


def zen_sample_ref(nwk_rows, nkd_rows, z_old, alpha_k, n_k, seed, *,
                   beta: float, w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_sample``: exact ¬dw exclusion on all three
    counts, noise at (seed, token, topic), the real K only."""
    t, k = nwk_rows.shape
    p = _train_probs(nwk_rows, nkd_rows, z_old, alpha_k, n_k, beta, w_beta)
    rows = torch.arange(t, device=nwk_rows.device)[:, None]
    cols = torch.arange(k, device=nwk_rows.device)[None, :]
    g = gumbel_noise(int(seed), rows, cols)
    score = torch.log(torch.clamp_min(p, 1e-30)) + g
    return torch.argmax(score, dim=-1).to(torch.int32)


def zen_probs_ref(nwk_rows, nkd_rows, z_old, alpha_k, n_k, *, beta: float,
                  w_beta: float) -> torch.Tensor:
    """The exact ¬dw conditional the training kernels draw from,
    normalised per row (for chi-square tests)."""
    p = _train_probs(nwk_rows, nkd_rows, z_old, alpha_k, n_k, beta, w_beta)
    return p / torch.sum(p, dim=-1, keepdim=True)


def zen_fused_sample_ref(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, seed,
                         *, beta: float, w_beta: float) -> torch.Tensor:
    """Oracle of ``ops.zen_fused_sample``: gather, then the gathered-row
    oracle."""
    return zen_sample_ref(
        n_wk[word.long()], n_kd[doc.long()], z_old, alpha_k, n_k, seed,
        beta=beta, w_beta=w_beta,
    )


def sparse_row_prefix_ref(vals) -> torch.Tensor:
    """The (T, J) prefix sums the sparse-row kernel compares, all strips at
    once: each 32-lane strip scanned in the warp shuffle order, plus the
    running sum of the earlier strips' lane 31."""
    t, j = vals.shape
    strips = -(-j // 32)
    x = F.pad(vals.to(torch.float32), (0, strips * 32 - j)).reshape(
        t, strips, 32)
    lanes = torch.arange(32, device=vals.device)
    for off in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(x)
        shifted[..., off:] = x[..., :32 - off]
        x = torch.where(lanes >= off, x + shifted, x)
    carries = [torch.zeros(t, dtype=torch.float32, device=vals.device)]
    for i in range(strips - 1):
        carries.append(carries[-1] + x[:, i, 31])
    prefix = torch.stack(carries, 1)[:, :, None] + x
    return prefix.reshape(t, strips * 32)[:, :j]


def sparse_row_sample_ref(vals, topics, targets) -> torch.Tensor:
    """Oracle of ``ops.sparse_row_sample``: count the prefix sums below the
    target over the whole (T, J) matrix, clamp to J - 1, select the id."""
    j = vals.shape[1]
    prefix = sparse_row_prefix_ref(vals)
    cnt = torch.sum(prefix < targets.to(torch.float32)[:, None], dim=1)
    pos = torch.clamp_max(cnt, j - 1)
    return torch.take_along_dim(topics.to(torch.int32), pos[:, None],
                                dim=1)[:, 0]


def cdf_row_search_ref(counts, rows, term, targets) -> torch.Tensor:
    """Oracle of ``ops.cdf_row_search``: the whole (T, K) matrix of
    kernel-order prefix sums of the gathered rows times the term, the
    count of those below the target, clamped to K - 1. It counts over the
    whole row; the kernel stops once its carry reaches the target, which
    changes no count for non-negative terms."""
    k = counts.shape[1]
    vals = counts[rows.long()].to(torch.float32) \
        * term.to(torch.float32)[None, :]
    prefix = sparse_row_prefix_ref(vals)
    cnt = torch.sum(prefix < targets.to(torch.float32)[:, None], dim=1)
    return torch.clamp_max(cnt, k - 1).to(torch.int32)


def topic_histogram_ref(rows, z_old, z_new, inc, num_rows: int,
                        num_topics: int) -> torch.Tensor:
    """Oracle of ``ops.topic_histogram``: signed one-hot rows (T, K)
    summed into their rows by ``index_add_``."""
    cols = torch.arange(num_topics, device=rows.device)[None, :]
    delta = ((cols == z_new.long()[:, None]).to(torch.int32)
             - (cols == z_old.long()[:, None]).to(torch.int32)) \
        * inc.to(torch.int32)[:, None]
    out = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                      device=rows.device)
    return out.index_add_(0, rows.long(), delta)
