"""CDF row search: the lower bound of a target in the prefix sums of a
count row times a per-topic term (``repro/kernels/cdf_search.py``).

For token t the row is ``counts[rows[t]]`` (K int32 counts, read in place
from the resident matrix) times ``term`` (K float32); the result is
``min(#{k : prefix[k] < targets[t]}, K - 1)``. ``zen_cdf`` draws its
term-2 word topic this way, so neither the (W, K) float CDF matrix nor
gathered (T, K) rows exist.

``cdf_row_search_cuda`` launches ``cdf_search`` (``csrc/cdf_search.cu``:
one thread per token answers a target <= 0 with 0 and queues the others,
then every warp of the card walks queued tokens, one at a time). Its
prefix sums add in 32-lane strips in the warp shuffle scan's order plus
the carry of the strips before, as kernel 6's do, and its walk stops
once that carry reaches the target: the terms
must be non-negative (``zen_cdf``'s t4 is), so no later prefix lies below
it. ``cdf_row_search_plain`` adds in exactly that order
(``sparse_row.strip_count``) and never calls ``torch.cumsum``, so on the
card the two are bit-equal. The reference's tiled oracle adds in its own
(``jnp.cumsum`` per K tile) order: against it a result may differ only
where the target lies within float round-off of a prefix sum.

While a trace asks for it (``count=True``), the kernel also adds the
tokens it queues (target > 0: its real work) to the profiled stretch's
counter :data:`SEARCH_TOKENS` (``observe.metrics``), one atomic a block
into a counter of its library; its output is the same either way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sparse_row import strip_count
from repro_torch.kernels.zen_sampler import check_cuda_args, check_ids

# tokens per chunk of the plain version: its (chunk, K) gathered rows stay
# bounded at any T
PLAIN_ROWS = 1 << 15
# the profiled stretch's counter of tokens that search a term-2 row
SEARCH_TOKENS = "zen_cdf.search_tokens"


def cdf_row_search_plain(counts: torch.Tensor, rows: torch.Tensor,
                         term: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel, one chunk of gathered rows at a
    time; (T,) int32."""
    r, k = counts.shape
    check_ids(rows, r)
    t = rows.shape[0]
    term = term.to(torch.float32)
    out = torch.empty(t, dtype=torch.int32, device=counts.device)
    for s in range(0, t, PLAIN_ROWS):
        vals = counts[rows[s:s + PLAIN_ROWS].long()].to(torch.float32) \
            * term[None, :]
        cnt = strip_count(vals, targets[s:s + PLAIN_ROWS])
        out[s:s + PLAIN_ROWS] = torch.clamp_max(cnt, k - 1).to(torch.int32)
    return out


def cdf_row_search_cuda(counts: torch.Tensor, rows: torch.Tensor,
                        term: torch.Tensor, targets: torch.Tensor,
                        count: bool = False) -> torch.Tensor:
    """Launch ``cdf_search`` on the current stream; no sync. ``count``
    (only while tracing) adds the queued tokens to :data:`SEARCH_TOKENS`.
    A row id outside ``counts`` aborts the kernel, and the caller's next
    synchronize raises, as the plain version's indexing does."""
    from repro_torch.kernels._build import (check_launch, library,
                                            work_counter)

    check_cuda_args(
        [("counts", counts), ("rows", rows), ("term", term),
         ("targets", targets)],
        [torch.int32, torch.int32, torch.float32, torch.float32],
    )
    (r, k), t = counts.shape, rows.shape[0]
    if k < 1 or term.shape != (k,) or targets.shape != (t,) \
            or rows.shape != (t,):
        raise ValueError(
            f"shape mismatch: counts {tuple(counts.shape)}, rows "
            f"{tuple(rows.shape)}, term {tuple(term.shape)}, targets "
            f"{tuple(targets.shape)} (K >= 1)"
        )
    if t > 2**31 - 2**16 or r >= 2**31 or k >= 2**31:
        raise ValueError(f"{t} tokens over {r} rows of {k} exceed the "
                         f"kernel's int sizes")
    out = torch.empty(t, dtype=torch.int32, device=counts.device)
    # the queue's length, then one (token, row, target, 0) entry per
    # searching token: 16-byte aligned, as a fresh allocation is
    queue = torch.empty((t + 1) * 4, dtype=torch.int32, device=counts.device)
    searched = (work_counter("cdf_search_searched", SEARCH_TOKENS,
                             counts.device) if count and t > 0 else None)
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    with torch.cuda.device(counts.device):
        check_launch("cdf_search", library().cdf_search(
            counts.data_ptr(), rows.data_ptr(), term.data_ptr(),
            targets.data_ptr(), out.data_ptr(), queue.data_ptr(), t, k, r,
            searched, stream,
        ))
    return out
