"""Load-balanced row layout of a table sharded over the ``model`` axis
(``repro/sharding/partition.py``: ``shard_rows_balanced``), bit-equal to
the reference's."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.graph import _balanced_ranges


def shard_rows_balanced(
    loads: np.ndarray, shards: int
) -> Tuple[np.ndarray, int]:
    """Assign rows to ``shards`` bins by greedy LPT on ``loads`` (the
    heuristic ``core.graph.grid_partition`` uses for word columns), then
    relabel so each bin's rows are contiguous and every bin is padded to
    the largest bin.

    Returns ``(perm, rows_per_shard)``: ``perm[old_row]`` is the row in the
    padded ``(shards * rows_per_shard, ...)`` layout, in bin
    ``perm[r] // rows_per_shard``; pad rows (outside ``perm``'s image) are
    the caller's to zero-fill.
    """
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    assign = _balanced_ranges(loads, shards)
    counts = np.bincount(assign, minlength=shards)
    per = max(int(counts.max()), 1)
    perm = np.empty(loads.shape[0], dtype=np.int64)
    for b in range(shards):
        ids = np.where(assign == b)[0]
        perm[ids] = b * per + np.arange(ids.size)
    return perm, per
