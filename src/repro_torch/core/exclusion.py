""""Converged" token exclusion (``repro/core/exclusion.py``, paper §5.1).

A converged token (its topic unchanged since the last sample) is still
resampled, with probability 2^(i - t): i = iterations since it was last
processed, t = consecutive unchanged samples (both reset on a change).
The uniforms are counter-based: token ``e`` of iteration ``n`` hashes
(the int31 seed of its key, e), where ``e`` is the token's corpus index
(a mesh cell passes its tokens' indices as ``rows``). ``compact_active``
stable-partitions the active tokens to the front.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.keys import key_seed
from repro_torch.core.types import CGSState
from repro_torch.kernels.zen_sampler import hash_uniform


class ExclusionConfig(NamedTuple):
    enabled: bool = False
    start_iteration: int = 30  # paper turns it on after iteration 30
    min_sample_prob: float = 0.0  # floor on the resample probability


def resample_prob(stale_iters: torch.Tensor, same_count: torch.Tensor,
                  min_sample_prob: float) -> torch.Tensor:
    """clip(2^(i - t), floor, 1), float32 (E,)."""
    i = stale_iters.to(torch.float32)
    t = same_count.to(torch.float32)
    return torch.clamp(torch.exp2(i - t), min_sample_prob, 1.0)


def active_mask(state: CGSState, cfg: ExclusionConfig,
                key: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bool (E,): which tokens are sampled this iteration. The uniforms
    lie in (0, 1], so a token is sampled when u <= its probability.
    ``rows`` (E,): the tokens' corpus indices (default: 0..E-1)."""
    if not cfg.enabled or state.iteration < cfg.start_iteration:
        return torch.ones_like(state.topic, dtype=torch.bool)
    prob = resample_prob(state.stale_iters, state.same_count,
                         cfg.min_sample_prob)
    if rows is None:
        rows = torch.arange(state.topic.shape[0], device=state.topic.device)
    return hash_uniform(key_seed(key), rows.to(torch.int64), 0) <= prob


def update_exclusion_stats(state: CGSState, new_topic: torch.Tensor,
                           mask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (stale_iters, same_count) after an iteration.

    Processed & changed   -> i=0, t=0
    Processed & unchanged -> i=0, t+1
    Skipped               -> i+1, t
    """
    changed = new_topic != state.topic
    zero = torch.zeros_like(state.stale_iters)
    i = torch.where(mask, zero, state.stale_iters + 1)
    t = torch.where(mask, torch.where(changed, zero, state.same_count + 1),
                    state.same_count)
    return i.to(torch.int32), t.to(torch.int32)


def compact_active(mask: torch.Tensor, *arrays: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                              torch.Tensor]:
    """Stable-partition tokens so the active ones are contiguous at the
    front: returns (perm int32, the arrays permuted, num_active). A
    kernel can then walk ``num_active`` tokens instead of E; the inverse
    is ``torch.argsort(perm)``."""
    key = torch.where(mask, 0, 1)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    num_active = torch.sum(mask.to(torch.int32))
    return perm, tuple(a[perm.long()] for a in arrays), num_active
