"""The reference's tile autotuner (``repro/kernels/autotune.py``), on the
port's kernels.

The reference sweeps its Pallas tile knobs (``bt`` token rows, ``bk``
topic lanes, ``bs`` sparse-row lanes) over a workload and folds the
winners into a ``SamplerKnobs`` (:func:`apply_best`), so the sweep's
result is a config that flows through ``knobs_from``. Here no knob
reaches a kernel (``kernels.ops``): each CUDA kernel has one block shape,
a constant of its source, because a sweep of the others (``chip_smoke.py``'s
autotune phase, on ``_build.variant`` builds) found none faster by more
than the card's run-to-run spread. Every grid point is therefore the same
launch: each sweep times it once and reports that timing under every
point, and :func:`apply_best` keeps the reference's rule (a tie goes to
the first point).

On CUDA tensors the call is timed with CUDA events after ``warmup``
calls, the median of ``iters`` calls; on CPU tensors the plain versions
run, timed by the wall clock (as the reference times interpret mode), so
their numbers say nothing of the card. ``interpret`` is accepted for the
reference's signature and ignored: there is no interpret mode here.
Every call goes through ``kernels.ops``, so it counts as a launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Iterable, List, Optional, Sequence

import torch

if TYPE_CHECKING:  # the algorithms import the kernels, not the reverse
    from repro_torch.algorithms.knobs import SamplerKnobs


@dataclasses.dataclass(frozen=True)
class TileTiming:
    """One timed (kernel, tile config) point. ``bk`` is 0 for the sparse
    kernel (it has no topic tiling), ``bs`` is 0 for the K-tiled kernels."""

    kernel: str  # fused_sample | fused_infer | cdf_search | sparse_row
    bt: int
    bk: int
    bs: int
    us_per_call: float
    tokens_per_sec: float


def _time_call(fn: Callable[[], torch.Tensor], device: torch.device,
               iters: int, warmup: int) -> float:
    """Median time per call in microseconds: CUDA events on a card, the
    wall clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def _sweep(kernel: str, points, call, device, tokens: int, iters: int,
           warmup: int) -> List[TileTiming]:
    """Time ``call`` (the one launch every point of ``points``, (bt, bk,
    bs), makes) once; one TileTiming per point, in grid order."""
    if iters < 1:
        raise ValueError(f"iters={iters}: at least one timed call")
    points = list(points)
    if not points:
        return []
    us = _time_call(call, device, iters, warmup)
    return [TileTiming(kernel, bt, bk, bs, us, tokens / us * 1e6)
            for bt, bk, bs in points]


def autotune_fused(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, seed, *,
                   beta: float, w_beta: float,
                   bts: Sequence[int] = (128, 256),
                   bks: Sequence[int] = (256, 512), iters: int = 3,
                   warmup: int = 1,
                   interpret: Optional[bool] = None) -> List[TileTiming]:
    """Sweep (bt, bk) over the fused gather+sample training kernel
    (kernel 2)."""
    from repro_torch.kernels.ops import zen_fused_sample

    return _sweep("fused_sample", [(bt, bk, 0) for bt in bts for bk in bks],
                  lambda: zen_fused_sample(n_wk, n_kd, word, doc, z_old,
                                           alpha_k, n_k, int(seed),
                                           beta=beta, w_beta=w_beta),
                  n_wk.device, word.shape[0], iters, warmup)


def autotune_cdf(counts, rows, term, targets, *,
                 bts: Sequence[int] = (128, 256),
                 bks: Sequence[int] = (256, 512), iters: int = 3,
                 warmup: int = 1,
                 interpret: Optional[bool] = None) -> List[TileTiming]:
    """Sweep (bt, bk) over the CDF lower-bound search kernel (kernel 7)."""
    from repro_torch.kernels.ops import cdf_row_search

    return _sweep("cdf_search", [(bt, bk, 0) for bt in bts for bk in bks],
                  lambda: cdf_row_search(counts, rows, term, targets),
                  counts.device, rows.shape[0], iters, warmup)


def autotune_sparse(vals, topics, targets, *,
                    bts: Sequence[int] = (128, 256),
                    bss: Sequence[int] = (128, 256), iters: int = 3,
                    warmup: int = 1,
                    interpret: Optional[bool] = None) -> List[TileTiming]:
    """Sweep (bt, bs) over the padded-sparse row kernel (kernel 6)."""
    from repro_torch.kernels.ops import sparse_row_sample

    return _sweep("sparse_row", [(bt, 0, bs) for bt in bts for bs in bss],
                  lambda: sparse_row_sample(vals, topics, targets),
                  vals.device, vals.shape[0], iters, warmup)


def apply_best(timings: Iterable[TileTiming],
               knobs: SamplerKnobs) -> SamplerKnobs:
    """Fold a sweep's winners into a ``SamplerKnobs`` (the reference's
    rule).

    Per-kernel argmin of ``us_per_call`` (the first point wins a tie); the
    K-tiled kernels set ``bt``/``bk``, the sparse kernel sets ``bs``. When
    both families were swept, the K-tiled winner owns ``bt``.
    ``SamplerKnobs`` re-validates the winners, so a sweep can never
    smuggle in an illegal tile.
    """
    best = {}
    for tt in timings:
        cur = best.get(tt.kernel)
        if cur is None or tt.us_per_call < cur.us_per_call:
            best[tt.kernel] = tt
    updates = {}
    sparse = best.pop("sparse_row", None)
    if sparse is not None:
        updates["bs"] = sparse.bs
        updates["bt"] = sparse.bt
    if best:  # any K-tiled kernel: fused_sample / fused_infer / cdf_search
        win = min(best.values(), key=lambda tt: tt.us_per_call)
        updates["bt"] = win.bt
        updates["bk"] = win.bk
    return dataclasses.replace(knobs, **updates) if updates else knobs
