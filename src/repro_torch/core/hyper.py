"""Hyper-parameter maintenance (``repro/core/hyper.py``): duplicate-topic
merging (paper §4.3) and the Alg. 5 moves (Minka alpha step, beta anneal).

``merge_topics`` merges count columns with ``index_add_`` on int32, not the
reference's ``n_wk @ onehot``: torch has no int32 matrix product on CUDA,
and the column sums are exact integers either way. ``topic_l1_distances``
walks one topic at a time, so it needs a (W, K) temporary, not the
reference's (W, K, K).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def topic_l1_distances(n_wk: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distance between topic word distributions, (K, K)
    float32."""
    col = n_wk.to(torch.float32)
    col = col / torch.clamp_min(torch.sum(col, dim=0, keepdim=True), 1e-30)
    k = col.shape[1]
    out = torch.empty((k, k), dtype=torch.float32, device=col.device)
    for i in range(k):
        out[i] = torch.sum(torch.abs(col[:, i:i + 1] - col), dim=0)
    return out


def duplicate_topic_map(n_wk, threshold: float,
                        min_topics: int = 2) -> np.ndarray:
    """Map each topic to its cluster representative (lowest id wins).

    Host-side union-find over the below-threshold pairs, closest pairs
    first, stopping at ``min_topics`` surviving clusters. Returns (K,)
    int32."""
    dist = topic_l1_distances(torch.as_tensor(n_wk)).cpu().numpy()
    k = dist.shape[0]
    parent = np.arange(k)
    clusters = k
    floor = max(1, min(int(min_topics), k))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.where((dist < threshold)
                      & (np.arange(k)[:, None] < np.arange(k)))
    order = np.lexsort((jj, ii, dist[ii, jj]))
    for a, b in zip(ii[order], jj[order]):
        if clusters <= floor:
            break
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
            clusters -= 1
    return np.array([find(x) for x in range(k)], dtype=np.int32)


def merge_topics(topic: torch.Tensor, n_wk: torch.Tensor,
                 n_kd: torch.Tensor, n_k: torch.Tensor,
                 topic_map: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Apply a duplicate map: remap assignments, merge count columns."""
    tm = topic_map.to(device=topic.device, dtype=torch.long)

    def merge(counts):
        return torch.zeros_like(counts).index_add_(counts.dim() - 1, tm,
                                                   counts)

    return (tm[topic.long()].to(torch.int32), merge(n_wk), merge(n_kd),
            merge(n_k))


def minka_alpha_update(n_kd, alpha: float, alpha_min: float = 1e-5,
                       alpha_max: float = 1e3) -> float:
    """One Minka fixed-point step on the scalar alpha concentration
    (Minka 2000, eq. 55), in float64 on the host:

        alpha' = alpha * sum_{d,k} [psi(n_kd + a) - psi(a)]
                       / (K * sum_d [psi(n_d + K a) - psi(K a)])

    A degenerate window keeps the old value."""
    n = torch.tensor(np.asarray(n_kd, np.float64))
    a = float(alpha)
    k = n.shape[1]
    n_d = n.sum(dim=1)
    psi = torch.special.digamma
    num = float(torch.sum(psi(n + a))) - n.numel() * float(
        psi(torch.tensor(a, dtype=torch.float64)))
    den = float(k * (float(torch.sum(psi(n_d + k * a))) - n_d.shape[0]
                     * float(psi(torch.tensor(k * a,
                                              dtype=torch.float64)))))
    if not np.isfinite(num) or not np.isfinite(den) or den <= 0 \
            or num <= 0:
        return a
    return float(np.clip(a * num / den, alpha_min, alpha_max))


def anneal_beta(beta: float, factor: float, floor: float) -> float:
    """``max(beta * factor, floor)``; ``factor=1`` is the identity."""
    if factor == 1.0:
        return float(beta)
    return float(max(beta * factor, floor))


def optimize_hyper(hyper, n_kd, update_alpha: bool = True,
                   beta_anneal: float = 1.0, beta_floor: float = 1e-4):
    """One Alg. 5 hyper move; a no-op move returns ``hyper`` itself."""
    alpha = minka_alpha_update(n_kd, hyper.alpha) if update_alpha \
        else hyper.alpha
    beta = anneal_beta(hyper.beta, beta_anneal, beta_floor)
    if alpha == hyper.alpha and beta == hyper.beta:
        return hyper
    return dataclasses.replace(hyper, alpha=alpha, beta=beta)
