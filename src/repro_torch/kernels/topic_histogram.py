"""Signed topic-delta histogram (``repro/kernels/topic_histogram.py``):

    out[r, k] = sum_t inc[t] * ([k == z_new[t]] - [k == z_old[t]])

over tokens t with row ``rows[t]``, an (R, K) int32 matrix: the per-row
count deltas of one sweep (ΔN_w|k with word rows, ΔN_k|d with doc rows).
``core.counts.delta_counts`` builds its two row deltas with it where the
session dispatches kernels (``kernels="auto"`` on the card); the
reference's delta merge scatters.

``topic_histogram_cuda`` launches ``topic_histogram``
(``csrc/topic_histogram.cu``): it walks the tokens along a
:class:`RowOrder`, in which their rows do not decrease, accumulates each
run of equal rows in shared memory and writes each row once. Without
one it builds the walk itself (:func:`row_order`: the tokens' own order
where the rows are sorted, else a stable sort), so rows in any order
stay correct.
Integer sums are exact in any order, so the kernel is bit-equal to
``topic_histogram_plain`` (two accumulating ``index_put_``); the
reference's rows must be sorted for its tile ranks, the port's need not
be. ``inc=None`` counts every token once.

While a trace asks for it (``count=True``), the kernel also adds the
tokens whose topic changes (``inc != 0`` and ``z_old != z_new``: its
useful work) to the profiled stretch's counter :data:`CHANGED_TOKENS`
(``observe.metrics``), one atomic a block into a counter of its library;
its output is the same either way.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.zen_sampler import check_cuda_args, check_ids

# the kernel's int positions: a block's last position must fit an int
MAX_TOKENS = 2**31 - 2**16
# the profiled stretch's counter of tokens whose topic changes in a merge
CHANGED_TOKENS = "counts.changed_tokens"


@dataclass(frozen=True)
class RowOrder:
    """A walk of the tokens along which their rows do not decrease:
    ``rows[i]`` is the row of token ``order[i]``; ``order`` None walks the
    tokens in their own order (their rows are already sorted). ``source``
    is the (T,) row tensor it was built from: a walk serves only those
    rows."""

    source: torch.Tensor
    rows: torch.Tensor
    order: Optional[torch.Tensor]


def row_order(rows: torch.Tensor) -> RowOrder:
    """The stable row-major walk of ``rows`` (T,) int32: the tokens' own
    order where it is already sorted, else a stable sort (two int32 (T,)
    tensors more)."""
    if rows.numel() < 2 or bool((rows[1:] >= rows[:-1]).all()):
        return RowOrder(rows, rows, None)
    order = torch.sort(rows, stable=True).indices
    return RowOrder(rows, rows[order].contiguous(), order.to(torch.int32))


def topic_histogram_plain(rows: torch.Tensor, z_old: torch.Tensor,
                          z_new: torch.Tensor, inc: Optional[torch.Tensor],
                          num_rows: int, num_topics: int) -> torch.Tensor:
    """Plain-torch version: two accumulating ``index_put_``; (R, K)
    int32."""
    check_ids(rows, num_rows)
    check_ids(z_old, num_topics, "z_old")
    check_ids(z_new, num_topics, "z_new")
    r = rows.long()
    inc = (torch.ones_like(rows, dtype=torch.int32) if inc is None
           else inc.to(torch.int32))
    out = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                      device=rows.device)
    out.index_put_((r, z_new.long()), inc, accumulate=True)
    return out.index_put_((r, z_old.long()), -inc, accumulate=True)


def histogram_shape(k: int, device) -> Tuple[int, bool]:
    """The kernel's launch shape at ``k`` topics on ``device`` (the
    launcher's rule, from K and the card alone): the topics a block keeps
    in shared memory at once (``k`` itself where it fits what a block can
    opt into, else the widest slab that does), and whether each warp takes
    the short runs itself (where a histogram per warp fits too)."""
    from repro_torch.kernels._build import library

    slab, warp_runs = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = library().topic_histogram_shape(
            int(k), ctypes.addressof(slab), ctypes.addressof(warp_runs))
    if err:
        raise RuntimeError(f"topic_histogram_shape: cudaError {err}")
    return slab.value, bool(warp_runs.value)


def topic_histogram_cuda(rows: torch.Tensor, z_old: torch.Tensor,
                         z_new: torch.Tensor, inc: Optional[torch.Tensor],
                         num_rows: int, num_topics: int,
                         order: Optional[RowOrder] = None,
                         count: bool = False) -> torch.Tensor:
    """Launch ``topic_histogram`` on the current stream; no sync. ``order``
    (from :func:`row_order` of these ``rows``) is the walk; without it the
    wrapper builds one. ``count`` (only while tracing) adds the changed
    tokens to :data:`CHANGED_TOKENS`. A row or topic id out of range, or
    rows that decrease along the walk, abort the kernel (no write lands
    out of bounds), and the caller's next synchronize raises."""
    from repro_torch.kernels._build import (check_launch, library,
                                            work_counter)

    if order is not None and (order.source.data_ptr() != rows.data_ptr()
                              or order.source.shape != rows.shape):
        raise ValueError("order was built from other rows than these")
    i32 = torch.int32
    named = [("rows", rows), ("z_old", z_old), ("z_new", z_new)]
    if inc is not None:
        named.append(("inc", inc))
    if order is not None:
        named.append(("order.rows", order.rows))
        if order.order is not None:
            named.append(("order.order", order.order))
    check_cuda_args(named, [i32] * len(named))
    t = rows.shape[0]
    if any(x.shape != (t,) for _, x in named):
        raise ValueError("shape mismatch: " + ", ".join(
            f"{n} {tuple(x.shape)}" for n, x in named))
    if num_rows < 1 or num_topics < 1 or t > MAX_TOKENS \
            or num_rows >= 2**31 or num_topics >= 2**31:
        raise ValueError(f"{t} tokens into ({num_rows}, {num_topics}) "
                         f"outside the kernel's int sizes")
    walk = order if order is not None else row_order(rows)
    out = torch.empty((num_rows, num_topics), dtype=i32, device=rows.device)
    changed = (work_counter("topic_histogram_changed", CHANGED_TOKENS,
                            rows.device) if count and t > 0 else None)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    with torch.cuda.device(rows.device):
        check_launch("topic_histogram", library().topic_histogram(
            walk.rows.data_ptr(),
            None if walk.order is None else walk.order.data_ptr(),
            z_old.data_ptr(), z_new.data_ptr(),
            None if inc is None else inc.data_ptr(), out.data_ptr(),
            t, num_rows, num_topics, changed, stream,
        ))
    return out
