"""Distributed ZenLDA iteration under ``torch.distributed``
(``repro/core/distributed.py``, paper Fig. 2).

A training mesh is one rank per cell of a ``(rows, cols)`` grid
(``core.graph.grid_partition``): rank = row * cols + col. A rank holds its
cell's tokens, the word block of its column ``N_w|k (W_pad / cols, K)``,
the doc block of its row ``N_k|d (D_pad / rows, K)`` and all of ``N_k``.
One iteration (:func:`dist_step`):

  step 1  ``N_k`` is replicated on every rank;
  step 2  the count blocks are resident (the master -> mirror ship is the
          layout itself);
  step 3  every rank samples its cell against the iteration-start counts
          (the "unsynchronized model", §4.1), through the registry
          backend's ``cell_sweep``;
  step 4  delta aggregation (§5.2): the cell's ΔN_w|k and ΔN_k|d by
          kernel 5 (``counts.delta_counts``), all-reduced over the column
          group (the ranks of one column: the reference's ``psum`` over
          the data axes) and the row group (``psum`` over ``model``),
          optionally width-compressed (:func:`_compress_all_reduce`);
  step 5  ΔN_k from the word side only: ΔN_w|k's column sum, all-reduced
          over the row group.

Every rank creates every group, in one order (:class:`MeshComm`). The
groups run on NCCL when each rank has its own card, and on gloo on the
CPU or when ranks share a card; gloo reduces card tensors only through
``all_reduce``, so whatever is gathered (the checkpoint's topics, the
global ``N_w|k``) is summed into a zeroed buffer (:meth:`MeshComm.gather`).
A ``(1, 1)`` mesh outside any process group is a world of one and needs
no collective.

The reference builds jitted step, rebuild and llh functions
(``make_dist_step``, ``make_rebuild_counts``, ``make_dist_llh``); here
they are plain functions of one rank's state (:func:`dist_step`,
:func:`rebuild_counts`, :func:`dist_llh`), and ``_compress_psum`` is
:func:`_compress_all_reduce`.

Keys keep the single box's contract (``core.keys``): a draw depends on
(run key, iteration, the token's corpus index), and each cell passes its
tokens' corpus indices (``GridPartition.token``) where the single box
hashes ``start + i``. A mesh therefore equals one cell holding the whole
corpus declared at (W_pad, D_pad) wherever a draw reads only the token's
own rows, ``N_k`` and its index (the Gumbel-max backends), bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import algorithms
from repro_torch.algorithms import SamplerKnobs
from repro_torch.core import counts as counts_lib
from repro_torch.core.exclusion import (
    ExclusionConfig,
    active_mask,
    update_exclusion_stats,
)
from repro_torch.core.graph import GridPartition
from repro_torch.core.keys import fold_in, key_seed
from repro_torch.core.sampler import chunk_size
from repro_torch.core.types import LDAHyperParams
from repro_torch.kernels.topic_histogram import RowOrder, row_order


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """The mesh step's knobs: the reference's fields and defaults.
    ``rebuild_every`` and ``exclusion_start`` are carried for parity; the
    session's schedule owns those events."""

    algorithm: str = "zen_cdf"  # any registered backend w/ supports_shard_map
    sampling_method: str = "gumbel"  # zen_dense: gumbel | cdf
    # padded-sparse row widths; 0 = fill from the sharded counts
    # (:func:`resolve_dist_row_pads`), else the backend's static default
    max_kd: int = 0
    max_kw: int = 0
    num_mh: int = 8
    delta_dtype: str = "int32"  # int32 | int16 | int8 (reduction payload)
    rebuild_every: int = 0
    exclusion_start: int = 0
    token_chunk: int = 0
    kd_dtype: str = "int32"  # int32 | int16 (N_kd storage)
    bt: int = 256
    bk: int = 512
    bs: int = 128
    kernels: str = "auto"

    def knobs(self) -> SamplerKnobs:
        return algorithms.knobs_from(self)


class MeshComm:
    """One rank's place in a ``(rows, cols)`` mesh and its process groups;
    the rank trains cell ``rank``.

    ``all_reduce(t, "data")`` sums over the ranks of this rank's column
    (the reference's data axes), ``"model"`` over the ranks of its row,
    ``"all"`` over the world; in place, returning ``t``. A world must hold
    exactly rows x cols ranks; a ``(1, 1)`` mesh with no process group
    initialised is a world of one."""

    def __init__(self, rows: int, cols: int):
        import torch.distributed as dist

        self.rows, self.cols = int(rows), int(cols)
        cells = self.rows * self.cols
        self._groups = None
        if not dist.is_available() or not dist.is_initialized():
            if cells != 1:
                raise RuntimeError(
                    f"a {rows}x{cols} mesh needs torch.distributed with "
                    f"{cells} ranks (launch.train --host-devices {cells}, or "
                    f"torchrun --nproc-per-node {cells}); no process group "
                    f"is initialised")
            self.rank, self.backend = 0, None
        else:
            world = dist.get_world_size()
            if world != cells:
                raise RuntimeError(
                    f"a {rows}x{cols} mesh needs {cells} ranks; the world "
                    f"has {world}")
            self.rank = dist.get_rank()
            self.backend = str(dist.get_backend())
            # every rank creates every group, in one order
            by_col = [dist.new_group([r * self.cols + c
                                      for r in range(self.rows)])
                      for c in range(self.cols)]
            by_row = [dist.new_group([r * self.cols + c
                                      for c in range(self.cols)])
                      for r in range(self.rows)]
            self._groups = {"data": by_col[self.rank % self.cols],
                            "model": by_row[self.rank // self.cols],
                            "all": None}
        self.row, self.col = divmod(self.rank, self.cols)

    def size(self, axis: str) -> int:
        return {"data": self.rows, "model": self.cols,
                "all": self.rows * self.cols}[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "all",
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` (``op`` "sum" or "max");
        inside a process group always a collective, even over one rank."""
        if self._groups is not None:
            import torch.distributed as dist

            dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                            group=self._groups[axis])
        return t

    def gather(self, block: torch.Tensor, axis: str, index: int,
               total: int) -> torch.Tensor:
        """Blocks of equal rows along ``axis`` stacked into ``(total *
        rows, ...)``: each rank writes its block at ``index`` into a zeroed
        buffer and the buffer is summed (an all-gather every backend runs
        on card tensors)."""
        n = block.shape[0]
        out = torch.zeros((total * n,) + tuple(block.shape[1:]),
                          dtype=block.dtype, device=block.device)
        out[index * n:(index + 1) * n] = block
        return self.all_reduce(out, axis)


class DistLDAState(NamedTuple):
    """One rank's state: its cell's assignments and exclusion counters
    (``(e_cell,)``: real tokens first, then padding), the count blocks of
    its column and row, replicated ``n_k``, the iteration and the run
    key (two uint32 words)."""

    topic: torch.Tensor  # (e_cell,) int32
    prev_topic: torch.Tensor  # (e_cell,) int32
    n_wk: torch.Tensor  # (W_pad / cols, K) int32
    n_kd: torch.Tensor  # (D_pad / rows, K) int32 | int16
    n_k: torch.Tensor  # (K,) int32
    stale_iters: torch.Tensor  # (e_cell,) int32
    same_count: torch.Tensor  # (e_cell,) int32
    iteration: int
    rng: torch.Tensor  # (2,) key words


class DistLDAData(NamedTuple):
    """One rank's static cell: cell-local word and doc rows, the padding
    mask, the tokens' corpus indices (int32) and the count of real tokens
    (a prefix of the cell)."""

    word: torch.Tensor  # (e_cell,) int32, row in the column's word block
    doc: torch.Tensor  # (e_cell,) int32, row in the row's doc block
    mask: torch.Tensor  # (e_cell,) bool
    token: torch.Tensor  # (e_cell,) int32 corpus index, 0 on padding
    num_real: int


def cell_data(grid: GridPartition, cell: int, device) -> DistLDAData:
    """Cell ``cell`` of ``grid`` as a rank's :class:`DistLDAData` on
    ``device``: ids made local to the cell's blocks. Reads only that
    cell's rows of the grid (which may be memory-mapped)."""
    row, col = divmod(cell, grid.model_parallel)
    mask = np.asarray(grid.mask[cell])
    n = int(mask.sum())
    if not mask[:n].all():
        raise ValueError(f"cell {cell}: real tokens are not a prefix")
    word = np.asarray(grid.word[cell], np.int64) - col * grid.words_per_shard
    doc = np.asarray(grid.doc[cell], np.int64) - row * grid.docs_per_shard

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return DistLDAData(word=put(word, np.int32), doc=put(doc, np.int32),
                       mask=put(mask, np.bool_),
                       token=put(grid.token[cell], np.int32), num_real=n)


def _compress_all_reduce(delta: torch.Tensor, comm: MeshComm, axis: str,
                         dtype: str) -> torch.Tensor:
    """Width-compressed all-reduce (§5.2) as the reference's step does it:
    each rank's delta is built in the narrow type (its scatter-adds wrap
    modulo 2^8 or 2^16, they do not saturate), summed in it (wrapping
    again) and widened, so the result is the exact sum wrapped to the
    narrow type. int8 ships int8. Neither NCCL nor gloo sums int16, so
    int16 sums its wrapped values in int32 and wraps the sum: the
    reference's integers at int32 payload. Whatever the wrap lost is left
    for the periodic exact rebuild."""
    if dtype == "int32":
        return comm.all_reduce(delta, axis)
    if dtype == "int8":
        return comm.all_reduce(delta.to(torch.int8), axis).to(torch.int32)
    wrapped = delta.to(torch.int16).to(torch.int32)
    return comm.all_reduce(wrapped, axis).to(torch.int16).to(torch.int32)


def resolve_dist_row_pads(state: DistLDAState, cfg: DistConfig,
                          comm: MeshComm) -> DistConfig:
    """Fill auto (0) padded-row widths from the sharded counts: the
    largest per-shard ``shard_row_capacity`` over the world (an
    all-reduce of one scalar each) plus one lane multiple of headroom,
    clamped to K. Explicit widths are kept."""
    backend = algorithms.get(cfg.algorithm)
    if not backend.needs_row_pads or (cfg.max_kw and cfg.max_kd):
        return cfg
    from repro_torch.core.zen_sparse import shard_row_capacity

    k = state.n_wk.shape[-1]
    caps = torch.tensor([shard_row_capacity(state.n_wk),
                         shard_row_capacity(state.n_kd)],
                        dtype=torch.int64, device=state.n_k.device)
    kw, kd = (int(c) for c in comm.all_reduce(caps, "all", op="max").cpu())
    return dataclasses.replace(
        cfg, max_kw=cfg.max_kw or min(kw + 8, k),
        max_kd=cfg.max_kd or min(kd + 8, k))


def cell_orders(data: DistLDAData) -> Tuple[RowOrder, RowOrder]:
    """Kernel 5's walks of the cell's real tokens: the word rows are in
    order (the cell is sorted word-major), the doc rows sorted once."""
    n = data.num_real
    return row_order(data.word[:n]), row_order(data.doc[:n])


def dist_step(state: DistLDAState, data: DistLDAData, comm: MeshComm,
              hyper: LDAHyperParams, cfg: DistConfig, knobs: SamplerKnobs,
              num_words_pad: int, excl: ExclusionConfig,
              orders: Optional[Tuple[RowOrder, RowOrder]] = None,
              timer=None) -> DistLDAState:
    """One mesh iteration on this rank (the module docstring's steps 1-5).
    ``knobs`` are the backend's resolved cell knobs; ``orders`` kernel 5's
    walks (:func:`cell_orders`), used when the kernel policy dispatches
    kernels; ``timer(name)``, when given, is called after each phase
    ("sweep", "merge", "all_reduce_wk", then "all_reduce_kd" with N_k's)
    so a caller can stamp it."""
    backend = algorithms.get(cfg.algorithm)
    n = data.num_real
    it = int(state.iteration)
    dev = state.n_k.device
    word, doc, tok = data.word[:n], data.doc[:n], data.token[:n]
    z_old = state.topic[:n]
    view = _TokenView(z_old, state.stale_iters[:n], state.same_count[:n], it)
    active = active_mask(view, excl, fold_in(state.rng, 2**20 + it),
                         rows=tok)
    seed = key_seed(fold_in(state.rng, it))
    z_prop = backend.cell_sweep(
        seed, word, doc, z_old, data.mask[:n], state.n_wk, state.n_kd,
        state.n_k, hyper, num_words_pad, knobs, token_index=tok)
    z_new = torch.where(active, z_prop, z_old)
    if timer is not None:
        timer("sweep")
    use_kernel = algorithms.kernel_dispatch(knobs.kernels, dev)
    d_wk, d_kd, _ = counts_lib.delta_counts(
        word, doc, z_old, z_new, state.n_wk.shape[0], state.n_kd.shape[0],
        hyper.num_topics, use_kernel=use_kernel,
        orders=orders if use_kernel else None)
    if timer is not None:
        timer("merge")
    d_wk = _compress_all_reduce(d_wk, comm, "data", cfg.delta_dtype)
    if timer is not None:
        timer("all_reduce_wk")
    d_kd = _compress_all_reduce(d_kd, comm, "model", cfg.delta_dtype)
    # step 5: N_k from the word side only
    d_k = comm.all_reduce(d_wk.sum(0, dtype=torch.int32), "model")
    if timer is not None:
        timer("all_reduce_kd")
    i_new, t_new = update_exclusion_stats(view, z_new, active)
    topic = state.topic.clone()
    topic[:n] = z_new
    stale, same = state.stale_iters.clone(), state.same_count.clone()
    stale[:n], same[:n] = i_new, t_new
    n_kd = (state.n_kd.to(torch.int32) + d_kd).to(state.n_kd.dtype)
    return DistLDAState(
        topic=topic, prev_topic=state.topic, n_wk=state.n_wk + d_wk,
        n_kd=n_kd, n_k=state.n_k + d_k, stale_iters=stale,
        same_count=same, iteration=it + 1, rng=state.rng)


class _TokenView(NamedTuple):
    """The fields ``core.exclusion`` reads, over a cell's real tokens."""

    topic: torch.Tensor
    stale_iters: torch.Tensor
    same_count: torch.Tensor
    iteration: int


def rebuild_counts(state: DistLDAState, data: DistLDAData, comm: MeshComm,
                   num_topics: int) -> DistLDAState:
    """Exact count rebuild from the assignments (init, restore, drift
    fix): each cell's counts, summed over its column (N_w|k) and its row
    (N_k|d); N_k is N_w|k's column sum over the row."""
    n = data.num_real
    n_wk, n_kd, _ = counts_lib.build_counts(
        data.word[:n], data.doc[:n], state.topic[:n], state.n_wk.shape[0],
        state.n_kd.shape[0], num_topics)
    n_wk = comm.all_reduce(n_wk, "data")
    n_kd = comm.all_reduce(n_kd, "model").to(state.n_kd.dtype)
    n_k = comm.all_reduce(n_wk.sum(0, dtype=torch.int32), "model")
    return state._replace(n_wk=n_wk, n_kd=n_kd, n_k=n_k)


def dist_llh(state: DistLDAState, data: DistLDAData, comm: MeshComm,
             hyper: LDAHyperParams, num_words_pad: int,
             token_chunk: Optional[int] = None) -> float:
    """Predictive log-likelihood (paper footnote 6) over the mesh: each
    cell's tokens in float32, as ``likelihood.predictive_llh`` computes
    them (``W_pad`` in ``W·β``, N_d the doc row's count), summed in
    float64 and all-reduced."""
    n = data.num_real
    alpha_k = hyper.alpha_k(state.n_k)
    alpha_sum = torch.sum(alpha_k)
    n_d = state.n_kd.sum(-1, dtype=torch.int32).to(torch.float32)
    phi_denom = state.n_k.to(torch.float32) + num_words_pad * hyper.beta
    size = chunk_size(n, hyper.num_topics, token_chunk) if n else 1
    total = torch.zeros((), dtype=torch.float64, device=state.n_k.device)
    for s in range(0, n, size):
        w = data.word[s:min(s + size, n)].long()
        d = data.doc[s:min(s + size, n)].long()
        theta = (state.n_kd[d].to(torch.float32) + alpha_k[None, :]) / (
            n_d[d][:, None] + alpha_sum)
        phi = (state.n_wk[w].to(torch.float32) + hyper.beta) \
            / phi_denom[None, :]
        per_token = torch.log(torch.clamp_min(torch.sum(theta * phi, -1),
                                              1e-30))
        total += torch.sum(per_token, dtype=torch.float64)
    return float(comm.all_reduce(total, "all"))


def init_dist_state(rng: torch.Tensor, data: DistLDAData, comm: MeshComm,
                    grid: GridPartition, hyper: LDAHyperParams,
                    cell_topics: np.ndarray,
                    kd_dtype: torch.dtype = torch.int32) -> DistLDAState:
    """This rank's state from its cell's initial topics (``(e_cell,)``;
    padding may hold anything), counts by :func:`rebuild_counts`."""
    dev = data.word.device
    k = hyper.num_topics
    topic = torch.from_numpy(np.ascontiguousarray(cell_topics, np.int32))
    topic = topic.to(dev)
    topic[data.num_real:] = 0
    zeros = torch.zeros_like(topic)
    state = DistLDAState(
        topic=topic, prev_topic=topic.clone(),
        n_wk=torch.zeros((grid.words_per_shard, k), dtype=torch.int32,
                         device=dev),
        n_kd=torch.zeros((grid.docs_per_shard, k), dtype=kd_dtype,
                         device=dev),
        n_k=torch.zeros((k,), dtype=torch.int32, device=dev),
        stale_iters=zeros, same_count=zeros.clone(), iteration=0, rng=rng)
    return rebuild_counts(state, data, comm, k)
