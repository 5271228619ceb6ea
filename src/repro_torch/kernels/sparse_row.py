"""Padded-sparse row sampler: lower-bound CDF inversion over compact rows.

For token t, ``vals[t]`` holds J weights and ``topics[t]`` their J topic
ids (padded lanes: weight 0, a sentinel id); the draw is
``topics[t, min(cnt, J - 1)]`` with ``cnt`` the number of prefix sums of
``vals[t]`` below ``targets[t]`` (``repro/kernels/sparse_row.py``).

``sparse_row_sample_cuda`` launches ``sparse_row`` (``csrc/sparse_row.cu``,
one warp per token). Float prefix sums depend on their order, so
``sparse_row_sample_plain`` adds in exactly the kernel's order: per
32-lane strip, the shuffle scan's steps (lane i adds lane i - off for off
= 1, 2, 4, 8, 16), then the carry of the strips before it, which grows by
each strip's lane 31. It never calls ``torch.cumsum``, whose order differs
between devices. On the card the two are bit-equal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.zen_sampler import check_cuda_args

WARP = 32
# tokens per chunk of the plain version: its (chunk, 32) strip temporaries
# stay small at any J, and every token is independent
PLAIN_ROWS = 1 << 16


def strip_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of each 32-lane strip (..., 32) in the warp
    shuffle scan's order."""
    lane = torch.arange(WARP, device=x.device)
    for off in (1, 2, 4, 8, 16):
        y = F.pad(x[..., :WARP - off], (off, 0))
        x = torch.where(lane >= off, x + y, x)
    return x


def strip_prefix(vals: torch.Tensor):
    """The prefix sums (n, J) float32 of each row of ``vals`` (n, J),
    added strip by strip in the warp kernels' order (each strip's shuffle
    scan, then the carry of the strips before it), and the carry (n,)
    after the last strip, which grows by each strip's lane 31."""
    n, j = vals.shape
    carry = torch.zeros((n, 1), dtype=torch.float32, device=vals.device)
    pre = torch.empty((n, j), dtype=torch.float32, device=vals.device)
    for j0 in range(0, j, WARP):
        strip = vals[:, j0:j0 + WARP].to(torch.float32)
        width = strip.shape[1]
        x = strip_scan(F.pad(strip, (0, WARP - width)))
        pre[:, j0:j0 + width] = carry + x[:, :width]
        carry = carry + x[:, WARP - 1:]
    return pre, carry[:, 0]


def strip_count(vals: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(n,) int64: how many prefix sums of each row of ``vals`` (n, J)
    lie below its target, the prefix sums added strip by strip in the
    warp kernels' order. For non-negative weights this is also the count
    of kernel 7's walk, which stops once the carry reaches the target."""
    n, j = vals.shape
    lane = torch.arange(WARP, device=vals.device)
    tgt = targets.to(torch.float32)[:, None]
    carry = torch.zeros_like(tgt)
    cnt = torch.zeros(n, dtype=torch.int64, device=vals.device)
    for j0 in range(0, j, WARP):
        strip = vals[:, j0:j0 + WARP].to(torch.float32)
        width = strip.shape[1]
        x = strip_scan(F.pad(strip, (0, WARP - width)))
        cnt += (((carry + x) < tgt) & (lane < width)).sum(1)
        carry = carry + x[:, WARP - 1:]
    return cnt


def sparse_row_sample_plain(vals: torch.Tensor, topics: torch.Tensor,
                            targets: torch.Tensor) -> torch.Tensor:
    """Plain-torch version of the kernel, strip by strip; (T,) int32."""
    t, j = vals.shape
    out = torch.empty(t, dtype=torch.int32, device=vals.device)
    for s in range(0, t, PLAIN_ROWS):
        cnt = strip_count(vals[s:s + PLAIN_ROWS],
                          targets[s:s + PLAIN_ROWS])
        pos = torch.clamp_max(cnt, j - 1)
        out[s:s + PLAIN_ROWS] = topics[s:s + PLAIN_ROWS].gather(
            1, pos[:, None])[:, 0].to(torch.int32)
    return out


def sparse_row_sample_cuda(vals: torch.Tensor, topics: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """Launch ``sparse_row`` on the current stream; no sync."""
    from repro_torch.kernels._build import check_launch, library

    check_cuda_args(
        [("vals", vals), ("topics", topics), ("targets", targets)],
        [torch.float32, torch.int32, torch.float32],
    )
    t, j = vals.shape
    if j < 1 or topics.shape != (t, j) or targets.shape != (t,):
        raise ValueError(
            f"shape mismatch: vals {tuple(vals.shape)}, topics "
            f"{tuple(topics.shape)}, targets {tuple(targets.shape)} "
            f"(rows of J >= 1 lanes)"
        )
    if t >= 2**31 or j >= 2**31:
        raise ValueError(f"{t} rows of {j} lanes exceed the kernel's int "
                         f"sizes")
    out = torch.empty(t, dtype=torch.int32, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        check_launch("sparse_row", library().sparse_row(
            vals.data_ptr(), topics.data_ptr(), targets.data_ptr(),
            out.data_ptr(), t, j, stream,
        ))
    return out
