"""The yardstick's arithmetic: the card's peaks, and the work and bytes
of each kernel and of each step, computed from the cell's shapes alone
(whatever the implementation does).

A share of a roofline is the least time the card could take, the larger
of work over the peak rate and bytes over the memory's peak, divided by
the time measured. Bytes count each input the work needs read once and
each output written once.
"""
from __future__ import annotations

from typing import Optional

# published peaks, dense, without sparsity, at the 700 W power limit
# (NVIDIA H100 SXM data sheet): float32 outside the tensor cores, and HBM3
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}

# Eq. 3 per (token, topic): (N_kd + α_k)(N_wk + β) / (N_k + Wβ) is two
# adds, one multiply and one divide, and one add more carries the draw
# (a running sum, or the noise of a Gumbel-max)
EQ3_FLOPS = 5


def peak(kind: str, what: str) -> Optional[float]:
    """A peak of the card named ``kind``; None for a card not listed."""
    return PEAKS.get(kind, {}).get(what)


def sweep_flops(tokens: int, topics: int) -> int:
    """The model's work in one sweep: Eq. 3 at every (token, topic), 5·T·K
    float operations, with no hash, padding or recomputation counted, and
    the same for a sparse sampler."""
    return EQ3_FLOPS * tokens * topics


def zen_train_fused_bytes(tokens: int, words: int, docs: int,
                          topics: int) -> int:
    """Kernel 2 (``zen_train_fused``): reads N_wk (W·K) and N_kd (D·K)
    int32 counts, each token's word, doc and old topic (int32) and the
    (K,) float32 α_k and N_k once; writes each token's new topic (int32)
    once."""
    return 4 * (words * topics + docs * topics + 3 * tokens + 2 * topics
                + tokens)


def topic_histogram_bytes(tokens: int, words: int, docs: int,
                          topics: int) -> int:
    """Kernel 5 (``topic_histogram``) on one delta merge, its two calls
    together: the merge needs each token's word, doc, old and new topic
    (int32) read once, and writes ΔN_wk (W·K) and ΔN_kd (D·K) int32 once."""
    return 4 * (4 * tokens + (words + docs) * topics)


def least_seconds(kind: str, flops: float = 0.0,
                  nbytes: float = 0.0) -> Optional[float]:
    """The larger of ``flops`` at the float32 peak and ``nbytes`` at the
    memory's peak; None for a card with no peaks listed."""
    f, b = peak(kind, "fp32_flops"), peak(kind, "hbm_bytes_per_s")
    if f is None or b is None:
        return None
    return max(flops / f, nbytes / b)
