"""Signed topic-delta histogram (``repro/kernels/topic_histogram.py``):

    out[r, k] = sum_t inc[t] * ([k == z_new[t]] - [k == z_old[t]])

over tokens t with row ``rows[t]``, an (R, K) int32 matrix: the per-row
count deltas of one sweep (ΔN_w|k with word rows, ΔN_k|d with doc rows).
As in the reference, no backend dispatches the kernel;
``core.counts.delta_counts`` builds its two row deltas with the plain
version.

``topic_histogram_cuda`` launches ``topic_histogram``
(``csrc/topic_histogram.cu``: a zero fill of the output, then one thread
per token adding its two signed entries by integer atomics). Integer sums
are exact in any order, so the kernel is bit-equal to
``topic_histogram_plain`` (two accumulating ``index_put_``) for sorted and
unsorted rows alike; the reference's rows must be sorted for its tile
ranks, the port's need not be.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zen_sampler import check_cuda_args, check_ids


def topic_histogram_plain(rows: torch.Tensor, z_old: torch.Tensor,
                          z_new: torch.Tensor, inc: torch.Tensor,
                          num_rows: int, num_topics: int) -> torch.Tensor:
    """Plain-torch version: two accumulating ``index_put_``; (R, K)
    int32."""
    check_ids(rows, num_rows)
    check_ids(z_old, num_topics, "z_old")
    check_ids(z_new, num_topics, "z_new")
    r = rows.long()
    inc = inc.to(torch.int32)
    out = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                      device=rows.device)
    out.index_put_((r, z_new.long()), inc, accumulate=True)
    return out.index_put_((r, z_old.long()), -inc, accumulate=True)


def topic_histogram_cuda(rows: torch.Tensor, z_old: torch.Tensor,
                         z_new: torch.Tensor, inc: torch.Tensor,
                         num_rows: int, num_topics: int) -> torch.Tensor:
    """Launch ``topic_histogram`` on the current stream; no sync. A row or
    topic id out of range aborts the kernel (no write lands out of
    bounds), and the caller's next synchronize raises."""
    from repro_torch.kernels._build import check_launch, library

    i32 = torch.int32
    check_cuda_args([("rows", rows), ("z_old", z_old), ("z_new", z_new),
                     ("inc", inc)], [i32, i32, i32, i32])
    t = rows.shape[0]
    if any(x.shape != (t,) for x in (rows, z_old, z_new, inc)):
        raise ValueError(
            f"shape mismatch: rows {tuple(rows.shape)}, z_old "
            f"{tuple(z_old.shape)}, z_new {tuple(z_new.shape)}, inc "
            f"{tuple(inc.shape)}"
        )
    if num_rows < 1 or num_topics < 1 or t >= 2**31 \
            or num_rows >= 2**31 or num_topics >= 2**31:
        raise ValueError(f"{t} tokens into ({num_rows}, {num_topics}) "
                         f"outside the kernel's int sizes")
    out = torch.empty((num_rows, num_topics), dtype=i32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        check_launch("topic_histogram", library().topic_histogram(
            rows.data_ptr(), z_old.data_ptr(), z_new.data_ptr(),
            inc.data_ptr(), out.data_ptr(), t, num_rows, num_topics,
            stream,
        ))
    return out
