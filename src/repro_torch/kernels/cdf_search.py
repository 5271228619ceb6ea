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

The same source holds ``zen_cdf``'s term 3 for both draws
(``doc_row_search_cuda``, ``doc_row_kernel``: one warp per token builds,
scans and searches the doc's top-J row in registers, the ``n_wk`` values
gathered in place), so that no (tokens, J) array exists. Its plain
version forms each weight as ``zen_cdf.doc_rows`` does and adds in the
kernel's order (``sparse_row.strip_prefix``), so the two are bit-equal on
the card; against ``doc_rows`` and its ``torch.cumsum`` a draw may differ
only at a near-tie. Its counter :data:`ROW_ENTRIES` adds the live (count
> 0) row entries it gathers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sparse_row import strip_count, strip_prefix
from repro_torch.kernels.zen_sampler import check_cuda_args, check_ids

# tokens per chunk of the plain version: its (chunk, K) gathered rows stay
# bounded at any T
PLAIN_ROWS = 1 << 15
# the profiled stretch's counter of tokens that search a term-2 row
SEARCH_TOKENS = "zen_cdf.search_tokens"
# the profiled stretch's counter of live doc-row entries gathered in term 3
ROW_ENTRIES = "zen_cdf.row_entries"


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


def doc_row_search_plain(n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf,
                         u_a, u_b, beta: float):
    """Plain-torch version of ``doc_row_kernel``, one chunk of tokens at a
    time: (total (T,) float32, z (2, T) int32), as
    :func:`doc_row_search_cuda` documents."""
    check_ids(word, n_wk.shape[0], "word")
    check_ids(doc, kd_cnt.shape[0], "doc")
    t, j = word.shape[0], kd_cnt.shape[1]
    m1 = g_cdf[-1]
    total = torch.empty(t, dtype=torch.float32, device=n_wk.device)
    z = torch.empty((2, t), dtype=torch.int32, device=n_wk.device)
    for s in range(0, t, PLAIN_ROWS):
        w, d = word[s:s + PLAIN_ROWS].long(), doc[s:s + PLAIN_ROWS].long()
        cnt, idx = kd_cnt[d], kd_idx[d].long()
        vals = (cnt.to(torch.float32)
                * (n_wk[w[:, None], idx].to(torch.float32) + beta)
                * t1[idx])
        pre, d_mass = strip_prefix(torch.where(cnt > 0, vals, 0.0))
        m2 = m2_all[w]
        tot = (m1 + m2) + d_mass
        total[s:s + PLAIN_ROWS] = tot
        for i, u01 in enumerate((u_a, u_b)):
            t3 = torch.clamp_min(u01[s:s + PLAIN_ROWS] * tot - m1 - m2, 0.0)
            pos = torch.clamp_max((pre < t3[:, None]).sum(1), j - 1)
            z[i, s:s + PLAIN_ROWS] = idx.gather(1, pos[:, None])[:, 0]
    return total, z


def doc_row_search_cuda(n_wk, word, doc, kd_cnt, kd_idx, t1, m2_all, g_cdf,
                        u_a, u_b, beta: float, count: bool = False):
    """Launch ``doc_row_search`` on the current stream; no sync. For token
    t and its doc's row r = doc[t] of the (D, J) int32 ``kd_cnt`` and
    ``kd_idx``: the weights ``cnt·(n_wk[word[t], idx] + beta)·t1[idx]``
    (0 where cnt is 0), their prefix sums in strip order and their total
    d_mass; ``total[t] = (m1 + m2_all[word[t]]) + d_mass`` with ``m1 =
    g_cdf[K - 1]`` (read on the card, never by the host); for each draw
    (``u_a``, ``u_b``) ``t3 = max(u01·total - m1 - m2, 0)`` and ``z[i, t] =
    idx[min(#{prefix < t3}, J - 1)]``. ``count`` (only while tracing) adds
    the live row entries to :data:`ROW_ENTRIES`. An id out of range aborts
    the kernel, and the caller's next synchronize raises."""
    from repro_torch.kernels._build import (check_launch, library,
                                            work_counter)

    i32, f32 = torch.int32, torch.float32
    check_cuda_args(
        [("n_wk", n_wk), ("word", word), ("doc", doc), ("kd_cnt", kd_cnt),
         ("kd_idx", kd_idx), ("t1", t1), ("m2_all", m2_all),
         ("g_cdf", g_cdf), ("u_a", u_a), ("u_b", u_b)],
        [i32, i32, i32, i32, i32, f32, f32, f32, f32, f32],
    )
    (w, k), t, (d, j) = n_wk.shape, word.shape[0], kd_cnt.shape
    if k < 1 or j < 1 or kd_idx.shape != (d, j) or t1.shape != (k,) \
            or g_cdf.shape != (k,) or m2_all.shape != (w,) \
            or any(x.shape != (t,) for x in (word, doc, u_a, u_b)):
        raise ValueError(
            f"shape mismatch: n_wk {tuple(n_wk.shape)}, word/doc/u_a/u_b "
            f"{[tuple(x.shape) for x in (word, doc, u_a, u_b)]}, kd_cnt "
            f"{tuple(kd_cnt.shape)}, kd_idx {tuple(kd_idx.shape)}, t1 "
            f"{tuple(t1.shape)}, m2_all {tuple(m2_all.shape)}, g_cdf "
            f"{tuple(g_cdf.shape)} (K, J >= 1)"
        )
    if t >= 2**31 or max(w, k, d, j) >= 2**31:
        raise ValueError(f"{t} tokens, rows of {w} x {k} and {d} x {j} "
                         f"exceed the kernel's int sizes")
    total = torch.empty(t, dtype=f32, device=n_wk.device)
    z = torch.empty((2, t), dtype=i32, device=n_wk.device)
    entries = (work_counter("doc_row_search_entries", ROW_ENTRIES,
                            n_wk.device) if count and t > 0 else None)
    stream = torch.cuda.current_stream(n_wk.device).cuda_stream
    with torch.cuda.device(n_wk.device):
        check_launch("doc_row_search", library().doc_row_search(
            n_wk.data_ptr(), word.data_ptr(), doc.data_ptr(),
            kd_cnt.data_ptr(), kd_idx.data_ptr(), t1.data_ptr(),
            m2_all.data_ptr(), g_cdf.data_ptr(), u_a.data_ptr(),
            u_b.data_ptr(), total.data_ptr(), z.data_ptr(), t, k, j, w, d,
            beta, entries, stream,
        ))
    return total, z
