"""Training sessions (``repro/train/session.py``): the single-box and
the mesh plan.

* ``RunConfig`` — the declarative run description, with the reference's
  fields, defaults and JSON, so one run file means the same run in both
  packages (``launch/train.py --config run.json``). ``mesh_shape=None``
  selects the single box, ``(rows, cols)`` (or ``(pod, data, model)``,
  pod and data folded into the row) the mesh. The streaming fields
  (``window_docs``, ``stream_source``) drive
  ``train.online.StreamingSession``; ``TrainSession`` ignores them, as
  the reference's does.
* ``ExecutionPlan`` — the plans' common surface (the reference's base
  class).
* ``SingleBoxPlan`` — the whole corpus as one cell on one device: sweep
  (the registry backend), exclusion mask, delta merge and exclusion
  statistics, as the reference's single-box plan does them, and
  ``llh_split`` (``joint_llh``'s word and doc parts).
* ``MeshPlan`` — one rank per cell under ``torch.distributed``
  (``core.distributed``): ``grid_partition``'s layout, the paper's
  Fig. 2 step, with the reference plan's surface. Every rank runs the
  same session, so evals, the schedule and the autopilot fire alike on
  all of them; only rank 0 writes checkpoints.
* ``TrainSession`` — ``init() / step() / run() / llh() / perplexity() /
  metrics() / save_model() / merge_duplicates() / with_run_params()``
  (``plan=`` shares a prepared plan), with the reference's
  schedule actions: ``exclusion_on``, ``rebuild``, ``repad``,
  ``autopilot``, ``hyper``, ``merge``, ``eval``, ``quality``,
  ``model_checkpoint``, ``train_checkpoint`` and ``telemetry``; ``run()``
  resumes from the newest elastic training checkpoint, the reference's
  ``{"topic", "iteration"}`` tree included. With exclusion configured the
  single box also keeps its exclusion statistics beside that tree (an
  ``exclusion/`` directory under ``train_checkpoint_dir``, which the
  reference's restore does not read), so a resumed run draws what the
  straight run draws; without them they restart at zero, as the
  reference's do. Telemetry
  (``metrics_out``), the autopilot (``autopilot``) and quality evaluation
  (``quality_every``) are built only when enabled, and read the counts on
  the card; they change no draw.

Sessions and plans run on ``device`` (default ``cuda``) and raise rather
than fall back when no card is present; a mesh rank's device is its own
card under NCCL, or the card its ranks share under gloo. The run key is an int seed or two
uint32 words (``core.keys``), not a ``jax.random`` key; a reference
state's initial topics pass in as ``init(seed, init_topics=...)``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import algorithms
from repro_torch.algorithms import SamplerKnobs, knobs_from
from repro_torch.core import counts as counts_lib
from repro_torch.core import init as init_lib
from repro_torch.core.exclusion import (
    ExclusionConfig,
    active_mask,
    update_exclusion_stats,
)
from repro_torch.core.hyper import duplicate_topic_map, merge_topics
from repro_torch.core.keys import as_key, fold_in, split, uniform_ints_at
from repro_torch.core.likelihood import joint_llh, predictive_llh
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.device import resolve_device
from repro_torch.kernels.topic_histogram import RowOrder, row_order
from repro_torch.train.schedule import ActionContext, Schedule, ScheduledAction


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Declarative description of one training run; the reference's
    fields and defaults (see ``repro/train/session.py`` for each one).

    ``mesh_shape=None`` selects the single-box plan, ``(rows, cols)`` the
    mesh plan. Cadences count post-step iterations (the first step is
    iteration 1); 0 disables. ``num_iterations`` is the absolute target
    iteration. ``sampling_method=None`` resolves to ``cdf`` on the single
    box and ``gumbel`` on the mesh.
    """

    # -- algorithm + sampler knobs (one SamplerKnobs derivation) ----------
    algorithm: str = "zen"
    sampling_method: Optional[str] = None
    max_kw: int = 0
    max_kd: int = 0
    num_mh: int = 8
    token_chunk: int = 0
    bt: int = 256
    bk: int = 512
    bs: int = 128
    kernels: str = "auto"
    # -- initialization ---------------------------------------------------
    init: str = "random"  # random | sparse_word | sparse_doc
    sparse_init_degree: float = 0.1
    # -- execution plan ---------------------------------------------------
    mesh_shape: Optional[Tuple[int, int]] = None  # None = single-box
    delta_dtype: str = "int32"
    kd_dtype: str = "int32"
    # -- run length + schedule cadences -----------------------------------
    num_iterations: int = 100
    eval_every: int = 0
    target_perplexity: Optional[float] = None
    exclusion_start: int = 0
    exclusion_min_prob: float = 0.0
    rebuild_every: int = 0
    merge_every: int = 0
    merge_threshold: float = 0.05
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    train_checkpoint_dir: Optional[str] = None
    train_checkpoint_every: int = 0
    # -- streaming --------------------------------------------------------
    window_docs: int = 0
    window_sweeps: int = 1
    decay: float = 0.0
    stream_source: Optional[str] = None
    # -- observability + autopilot ----------------------------------------
    metrics_out: Optional[str] = None
    metrics_every: int = 1
    autopilot: bool = False
    autopilot_every: int = 0
    # -- model-quality evaluation -----------------------------------------
    quality_every: int = 0
    quality_top_n: int = 10
    quality_npmi_window: int = 10
    quality_l2r_docs: int = 0
    quality_l2r_particles: int = 20
    # -- Alg. 5 hyper-parameter optimization -------------------------------
    hyper_every: int = 0
    hyper_alpha: bool = True
    hyper_beta_anneal: float = 1.0
    hyper_beta_floor: float = 1e-4

    def knobs(self) -> SamplerKnobs:
        return knobs_from(self)

    def exclusion(self) -> ExclusionConfig:
        return ExclusionConfig(
            enabled=self.exclusion_start > 0,
            start_iteration=self.exclusion_start,
            min_sample_prob=self.exclusion_min_prob,
        )

    def to_json(self, indent: Optional[int] = 2) -> str:
        d = dataclasses.asdict(self)
        if d["mesh_shape"] is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        return json.dumps(d, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown RunConfig fields: {', '.join(unknown)}")
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(int(x) for x in d["mesh_shape"])
        return cls(**d)


# the single box's exclusion statistics, beside the reference's tree
EXCLUSION_CKPT_DIR = "exclusion"


def refuse_unported(cfg: RunConfig) -> None:
    """Raise a ``ValueError`` when ``cfg`` names a backend the port does
    not have (every RunConfig field of the reference is ported)."""
    try:
        algorithms.get(cfg.algorithm)
    except ValueError:
        raise ValueError(
            f"RunConfig asks for what is not in the PyTorch port: "
            f"algorithm={cfg.algorithm!r} (no such backend; ported: "
            f"{', '.join(algorithms.registered())})") from None


class ExecutionPlan:
    """The base of the two plans (the reference's; a type, no code): what
    a ``TrainSession`` calls on its plan is what ``SingleBoxPlan`` and
    ``MeshPlan`` both define. The backend is only the per-token draw; the
    plan owns masking, the delta merge and the state update."""

    backend: algorithms.SamplerBackend


class SingleBoxPlan(ExecutionPlan):
    """The whole corpus as one cell on one device: the paper's training
    loop. The backend is only the per-token draw; the plan owns the
    exclusion mask, the delta merge and the state update."""

    def __init__(self, corpus: Corpus, hyper: LDAHyperParams,
                 cfg: RunConfig, device=None):
        self.device = resolve_device(device)
        self.corpus = corpus.to(self.device)
        self.hyper = hyper
        self.cfg = cfg
        self.backend = algorithms.get(cfg.algorithm)
        self._knobs = cfg.knobs()
        self._aux = self.backend.prepare(self.corpus, hyper, self._knobs)
        # warm-up is handled by ``active_mask`` (start_iteration), so the
        # schedule's "exclusion_on" firing is a recorded no-op here
        self._excl = cfg.exclusion()
        # the (word, doc) walks of the delta merge's kernel: the corpus's
        # tokens never change, so they are built once, at first use
        self._row_orders: Optional[Tuple[RowOrder, RowOrder]] = None

    # -- lifecycle ---------------------------------------------------------
    def init(self, rng, init_topics=None) -> CGSState:
        c, h, cfg = self.corpus, self.hyper, self.cfg
        key = as_key(rng)
        if init_topics is not None:
            topic = torch.from_numpy(np.array(init_topics, np.int32))
            topic = topic.reshape(-1).to(self.device)
            if topic.shape[0] != c.num_tokens:
                raise ValueError(f"init_topics holds {topic.shape[0]} "
                                 f"topics for {c.num_tokens} tokens")
            if topic.numel() and (int(topic.min()) < 0
                                  or int(topic.max()) >= h.num_topics):
                raise ValueError(f"init_topics outside [0, {h.num_topics})")
            return init_lib.make_state(topic, c, h, key)
        if cfg.init == "random":
            return init_lib.random_init(key, c, h)
        if cfg.init == "sparse_word":
            return init_lib.sparse_word_init(key, c, h,
                                             cfg.sparse_init_degree)
        if cfg.init == "sparse_doc":
            return init_lib.sparse_doc_init(key, c, h,
                                            cfg.sparse_init_degree)
        raise ValueError(f"unknown init {cfg.init!r}")

    def sweep(self, state: CGSState) -> torch.Tensor:
        knobs = self._knobs
        if self.backend.needs_row_pads:
            # auto pads (0) from the current counts before every sweep, so
            # a row that grows is never truncated on the single box
            knobs = algorithms.resolve_row_pads(state, knobs)
        return self.backend.sweep(state, self.corpus, self.hyper, knobs,
                                  self._aux)

    def step(self, state: CGSState) -> CGSState:
        c, h = self.corpus, self.hyper
        key = fold_in(state.rng, 2**20 + state.iteration)
        mask = active_mask(state, self._excl, key)
        z_new = torch.where(mask, self.sweep(state), state.topic)
        use_kernel = algorithms.kernel_dispatch(self._knobs.kernels,
                                                self.device)
        d_wk, d_kd, d_k = counts_lib.delta_counts(
            c.word, c.doc, state.topic, z_new, c.num_words, c.num_docs,
            h.num_topics, use_kernel=use_kernel,
            orders=self.row_orders() if use_kernel else None,
        )
        i_new, t_new = update_exclusion_stats(state, z_new, mask)
        return CGSState(
            topic=z_new, prev_topic=state.topic,
            n_wk=state.n_wk + d_wk, n_kd=state.n_kd + d_kd,
            n_k=state.n_k + d_k, rng=state.rng,
            iteration=state.iteration + 1,
            stale_iters=i_new, same_count=t_new,
        )

    def row_orders(self) -> Tuple[RowOrder, RowOrder]:
        """The word-major and doc-major walks of the corpus's tokens for
        kernel 5 (``row_order``: the tokens' own order where it is sorted,
        as doc rows are; else a stable sort and the gathered rows, 8 bytes
        per token)."""
        if self._row_orders is None:
            self._row_orders = (row_order(self.corpus.word),
                                row_order(self.corpus.doc))
        return self._row_orders

    # -- metrics -----------------------------------------------------------
    def llh(self, state: CGSState) -> float:
        return float(predictive_llh(state, self.corpus, self.hyper,
                                    token_chunk=self._knobs.chunk_or_none()))

    def llh_split(self, state: CGSState):
        """The collapsed joint log p(w, z) split into its word and doc
        parts (``core.likelihood.joint_llh``)."""
        return joint_llh(state, self.corpus, self.hyper)

    def change_rate(self, state: CGSState) -> float:
        changed = int((state.topic != state.prev_topic).sum())
        return changed / max(1, self.corpus.num_tokens)

    @property
    def num_tokens(self) -> int:
        return self.corpus.num_tokens

    # -- structural events -------------------------------------------------
    def enable_exclusion(self) -> None:
        self._excl = self.cfg.exclusion()

    def rebuild(self, state: CGSState) -> CGSState:
        c, h = self.corpus, self.hyper
        n_wk, n_kd, n_k = counts_lib.build_counts(
            c.word, c.doc, state.topic, c.num_words, c.num_docs,
            h.num_topics,
        )
        return dataclasses.replace(state, n_wk=n_wk, n_kd=n_kd, n_k=n_k)

    def repad(self, state: CGSState) -> bool:
        """Re-resolve padded-row capacities; the single box resolves them
        before every sweep already, so nothing is ever rebuilt here."""
        return False

    @property
    def row_pads(self) -> Tuple[int, int]:
        """(max_kw, max_kd) in effect (0 = auto, resolved per sweep)."""
        return (self._knobs.max_kw, self._knobs.max_kd)

    def apply_row_pads(self, max_kw: int, max_kd: int) -> bool:
        """Set explicit padded-row widths; True when they changed. Explicit
        widths stick: the per-sweep resolution keeps nonzero values."""
        if (self._knobs.max_kw, self._knobs.max_kd) == (max_kw, max_kd):
            return False
        self._knobs = dataclasses.replace(
            self._knobs, max_kw=int(max_kw), max_kd=int(max_kd))
        return True

    def set_backend(self, name: str, state: CGSState) -> bool:
        """Switch the sweep to backend ``name`` (its tables prepared on the
        card); True when it changed. The corpus's row orders for kernel 5
        do not depend on the backend and stay."""
        if name == self.backend.name:
            return False
        self.backend = algorithms.get(name)
        self._aux = self.backend.prepare(self.corpus, self.hyper,
                                         self._knobs)
        return True

    def set_hyper(self, hyper: LDAHyperParams) -> None:
        self.hyper = hyper
        self._aux = self.backend.prepare(self.corpus, hyper, self._knobs)

    def merge(self, state: CGSState, topic_map) -> CGSState:
        tm = torch.as_tensor(np.asarray(topic_map, np.int32)).to(
            self.device).long()
        new_topic, n_wk, n_kd, n_k = merge_topics(
            state.topic, state.n_wk, state.n_kd, state.n_k, tm)
        return dataclasses.replace(
            state, topic=new_topic,
            prev_topic=tm[state.prev_topic.long()].to(torch.int32),
            n_wk=n_wk, n_kd=n_kd, n_k=n_k,
        )

    def host_n_wk(self, state: CGSState) -> np.ndarray:
        """N_w|k on the host: the reference's plan surface, kept under
        its name for code written against it. The port's own telemetry
        counts the rows on the card and does not call it."""
        return state.n_wk.cpu().numpy()

    # -- checkpoint surfaces -----------------------------------------------
    def model_arrays(self, state: CGSState
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(n_wk, n_k) on the host — the serving artifact."""
        return state.n_wk.cpu().numpy(), state.n_k.cpu().numpy()

    def checkpoint_tree(self, state: CGSState) -> Dict[str, Any]:
        """Elastic training checkpoint: assignments only; the counts
        rebuild. The reference's tree, byte for byte."""
        return {"topic": state.topic,
                "iteration": np.asarray(state.iteration, np.int32)}

    def exclusion_tree(self, state: CGSState) -> Dict[str, Any]:
        """The exclusion statistics, which the reference's tree does not
        hold: a resume that reads them back samples the tokens the
        straight run samples."""
        return {"same_count": state.same_count,
                "stale_iters": state.stale_iters}

    def restore_exclusion(self, state: CGSState, tree) -> CGSState:
        stats = {k: torch.as_tensor(np.asarray(tree[k], np.int32)).to(
            self.device) for k in ("same_count", "stale_iters")}
        if any(v.shape != state.topic.shape for v in stats.values()):
            raise ValueError("exclusion statistics of another corpus")
        return dataclasses.replace(state, **stats)

    def restore(self, state: CGSState, tree) -> CGSState:
        topic = torch.as_tensor(np.asarray(tree["topic"], np.int32)).to(
            self.device)
        if topic.shape != state.topic.shape:
            raise ValueError(f"training checkpoint holds {topic.shape[0]} "
                             f"topics for {state.topic.shape[0]} tokens")
        zeros = torch.zeros_like(topic)
        restored = dataclasses.replace(
            state, topic=topic, prev_topic=topic,
            iteration=int(np.asarray(tree["iteration"])),
            stale_iters=zeros, same_count=zeros.clone(),
        )
        return self.rebuild(restored)


def mesh_rows_cols(mesh_shape) -> Tuple[int, int]:
    """(rows, cols) of a mesh shape: ``(rows, cols)``, or ``(pod, data,
    model)`` with pod and data folded into the row, as the reference's
    step folds them."""
    shape = tuple(int(x) for x in mesh_shape)
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"mesh_shape must be (rows, cols) or (pod, data, "
                         f"model) of positive sizes, got {mesh_shape!r}")
    return int(np.prod(shape[:-1])), shape[-1]


class MeshPlan(ExecutionPlan):
    """One rank of the mesh plan: ``grid_partition`` lays the corpus out
    on a (rows x cols) grid, this rank trains cell ``rank``
    (``core.distributed``), and structural events (exclusion, row-pad
    re-resolution, a backend switch) change the step in place.

    ``grid`` may be given (built once by a parent process and, for a
    large corpus, memory-mapped: a rank reads only its cell's rows); then
    ``corpus`` may be None unless a sparse init or quality evaluation
    needs the token lists. ``comm`` defaults to the process group's
    :class:`~repro_torch.core.distributed.MeshComm`."""

    def __init__(self, corpus: Optional[Corpus], hyper: LDAHyperParams,
                 cfg: RunConfig, device=None, grid=None, comm=None):
        from repro_torch.core.distributed import (
            DistConfig,
            MeshComm,
            cell_data,
        )
        from repro_torch.core.graph import grid_partition

        self.device = resolve_device(device)
        self.hyper = hyper
        self.cfg = cfg
        self.backend = algorithms.get(cfg.algorithm)
        _check_mesh_backend(self.backend, cfg.algorithm)
        rows, cols = mesh_rows_cols(cfg.mesh_shape)
        self.comm = comm if comm is not None else MeshComm(rows, cols)
        if (self.comm.rows, self.comm.cols) != (rows, cols):
            raise ValueError(f"mesh_shape {cfg.mesh_shape} is a {rows}x{cols}"
                             f" grid; the process groups are "
                             f"{self.comm.rows}x{self.comm.cols}")
        self.grid = grid if grid is not None else grid_partition(
            corpus, rows, cols)
        if (self.grid.data_parallel, self.grid.model_parallel) != (rows,
                                                                   cols):
            raise ValueError("the grid was partitioned for another mesh")
        # kept where the caller put it: the cells carry their own tokens
        self.corpus = corpus
        self.data = cell_data(self.grid, self.comm.rank, self.device)
        self.num_words_pad = self.grid.num_words_padded
        # the user's explicit widths; 0 stays "auto" across re-resolutions
        self._user_kw, self._user_kd = cfg.max_kw, cfg.max_kd
        self.dcfg = DistConfig(
            algorithm=cfg.algorithm, sampling_method=cfg.sampling_method,
            max_kd=cfg.max_kd, max_kw=cfg.max_kw, num_mh=cfg.num_mh,
            delta_dtype=cfg.delta_dtype, rebuild_every=cfg.rebuild_every,
            exclusion_start=cfg.exclusion_start,
            token_chunk=cfg.token_chunk, kd_dtype=cfg.kd_dtype, bt=cfg.bt,
            bk=cfg.bk, bs=cfg.bs, kernels=cfg.kernels)
        self._kd_dtype = torch.int16 if cfg.kd_dtype == "int16" \
            else torch.int32
        # warm-up is handled by ``active_mask`` (start_iteration), as on
        # the single box, so that the two plans draw alike
        self._excl = cfg.exclusion()
        self._orders = None
        real = torch.tensor(self.data.num_real, dtype=torch.int64,
                            device=self.device)
        self._num_tokens = int(self.comm.all_reduce(real, "all"))

    @property
    def _knobs(self) -> SamplerKnobs:
        """The backend's cell workspace at the current widths."""
        return self.backend.resolve_cell_knobs(self.dcfg.knobs(), self.hyper)

    # -- lifecycle ---------------------------------------------------------
    def init(self, rng, init_topics=None):
        """This rank's initial state. ``init_topics``: the grid layout
        ``(cells, e_cell)`` (the reference's) or the corpus order ``(E,)``
        (the single box's); default the session's init, drawn in corpus
        order as the single box draws it and laid out by token."""
        from repro_torch.core.distributed import (
            init_dist_state,
            resolve_dist_row_pads,
        )

        grid, cell = self.grid, self.comm.rank
        key = as_key(rng)
        if init_topics is not None:
            cell_topics = self._cell_topics(init_topics)
            state_key = key
        elif self.cfg.init == "random":
            k_init, state_key = split(key)
            tok = torch.from_numpy(np.array(grid.token[cell]))
            cell_topics = uniform_ints_at(k_init, tok,
                                          self.hyper.num_topics).numpy()
        else:
            if self.corpus is None:
                raise ValueError(f"init {self.cfg.init!r} needs the corpus")
            c = self.corpus.to("cpu")
            init_fn = {"sparse_word": init_lib.sparse_word_init,
                       "sparse_doc": init_lib.sparse_doc_init}.get(
                self.cfg.init)
            if init_fn is None:
                raise ValueError(f"unknown init {self.cfg.init!r}")
            st = init_fn(key, c, self.hyper, self.cfg.sparse_init_degree)
            cell_topics = st.topic.numpy()[np.asarray(grid.token[cell])]
            state_key = st.rng
        state = init_dist_state(state_key, self.data, self.comm, grid,
                                self.hyper, cell_topics, self._kd_dtype)
        # shard capacities from the init counts; repad re-resolves them
        self.dcfg = resolve_dist_row_pads(state, self.dcfg, self.comm)
        return state

    def _cell_topics(self, topics) -> np.ndarray:
        """This cell's slots of a grid-layout ``(cells, e_cell)`` or a
        corpus-order ``(E,)`` topic array."""
        grid, cell = self.grid, self.comm.rank
        a = topics.cpu().numpy() if isinstance(topics, torch.Tensor) \
            else np.asarray(topics)
        if a.shape == tuple(grid.word.shape):
            out = np.array(a[cell], np.int32)
        elif a.shape == (self._num_tokens,):
            out = a[np.asarray(grid.token[cell])].astype(np.int32)
        else:
            raise ValueError(
                f"topics of shape {a.shape}: expected the grid's "
                f"{tuple(grid.word.shape)} or the corpus's "
                f"({self._num_tokens},)")
        real = out[:self.data.num_real]
        if real.size and (real.min() < 0
                          or real.max() >= self.hyper.num_topics):
            raise ValueError(f"topics outside [0, {self.hyper.num_topics})")
        return out

    def step(self, state, timer=None):
        from repro_torch.core.distributed import cell_orders, dist_step

        if self._orders is None and algorithms.kernel_dispatch(
                self.dcfg.kernels, self.device):
            self._orders = cell_orders(self.data)
        return dist_step(state, self.data, self.comm, self.hyper, self.dcfg,
                         self._knobs, self.num_words_pad, self._excl,
                         orders=self._orders, timer=timer)

    # -- metrics -----------------------------------------------------------
    def llh(self, state) -> float:
        from repro_torch.core.distributed import dist_llh

        return dist_llh(state, self.data, self.comm, self.hyper,
                        self.num_words_pad,
                        token_chunk=self.cfg.token_chunk or None)

    def change_rate(self, state) -> float:
        n = self.data.num_real
        changed = (state.topic[:n] != state.prev_topic[:n]).sum(
            dtype=torch.int64)
        return int(self.comm.all_reduce(changed, "all")) / max(
            1, self._num_tokens)

    @property
    def num_tokens(self) -> int:
        return self._num_tokens

    def check_invariants(self, state) -> None:
        """Count conservation over the mesh (int64 sums, all-reduced).
        Raises ``AssertionError`` on every rank alike."""
        i64 = torch.int64
        comm = self.comm
        col_wk = comm.all_reduce(state.n_wk.sum(0, dtype=i64), "model")
        col_kd = comm.all_reduce(state.n_kd.sum(0, dtype=i64), "data")
        neg = torch.tensor(int((state.n_wk < 0).any() or
                               (state.n_kd < 0).any() or
                               (state.n_k < 0).any()),
                           dtype=i64, device=self.device)
        neg = int(comm.all_reduce(neg, "all"))
        n_k = state.n_k.to(i64)
        checks = (
            ("sum n_k == E", int(n_k.sum()) == self._num_tokens),
            ("n_wk column sums == n_k", bool(torch.equal(col_wk, n_k))),
            ("n_kd column sums == n_k", bool(torch.equal(col_kd, n_k))),
            ("counts >= 0", neg == 0),
        )
        failed = [name for name, ok in checks if not ok]
        if failed:
            raise AssertionError(f"count invariants violated at iteration "
                                 f"{state.iteration}: {', '.join(failed)}")

    # -- structural events -------------------------------------------------
    def enable_exclusion(self) -> None:
        self._excl = self.cfg.exclusion()

    def rebuild(self, state):
        from repro_torch.core.distributed import rebuild_counts

        return rebuild_counts(state, self.data, self.comm,
                              self.hyper.num_topics)

    def repad(self, state) -> bool:
        """Re-resolve the shard row capacities against the current counts
        (auto widths only); True when they changed."""
        from repro_torch.core.distributed import resolve_dist_row_pads

        if not self.backend.needs_row_pads or (self._user_kw
                                               and self._user_kd):
            return False
        probe = dataclasses.replace(self.dcfg, max_kw=self._user_kw,
                                    max_kd=self._user_kd)
        probe = resolve_dist_row_pads(state, probe, self.comm)
        if (probe.max_kw, probe.max_kd) == (self.dcfg.max_kw,
                                            self.dcfg.max_kd):
            return False
        self.dcfg = probe
        return True

    @property
    def row_pads(self) -> Tuple[int, int]:
        return (self.dcfg.max_kw, self.dcfg.max_kd)

    def apply_row_pads(self, max_kw: int, max_kd: int) -> bool:
        if (self.dcfg.max_kw, self.dcfg.max_kd) == (max_kw, max_kd):
            return False
        self.dcfg = dataclasses.replace(self.dcfg, max_kw=int(max_kw),
                                        max_kd=int(max_kd))
        return True

    def set_backend(self, name: str, state) -> bool:
        if name == self.dcfg.algorithm:
            return False
        backend = algorithms.get(name)
        _check_mesh_backend(backend, name)
        self.backend = backend
        self.dcfg = dataclasses.replace(self.dcfg, algorithm=name)
        if backend.needs_row_pads and not (self.dcfg.max_kw
                                           and self.dcfg.max_kd):
            from repro_torch.core.distributed import resolve_dist_row_pads

            self.dcfg = resolve_dist_row_pads(state, self.dcfg, self.comm)
        return True

    def set_hyper(self, hyper: LDAHyperParams) -> None:
        self.hyper = hyper

    def merge(self, state, topic_map):
        tm = torch.as_tensor(np.asarray(topic_map, np.int64)).to(
            self.device)
        state = state._replace(
            topic=tm[state.topic.long()].to(torch.int32),
            prev_topic=tm[state.prev_topic.long()].to(torch.int32))
        # the counts follow the assignments exactly
        return self.rebuild(state)

    def _all_n_wk(self, state) -> torch.Tensor:
        """The whole padded N_w|k (W_pad, K) on every rank (the blocks of
        this rank's row), in the grid's relabeled order."""
        return self.comm.gather(state.n_wk, "model", self.comm.col,
                                self.comm.cols)

    def _all_n_kd(self, state) -> torch.Tensor:
        """The whole padded N_k|d (D_pad, K) int32 on every rank."""
        return self.comm.gather(state.n_kd.to(torch.int32), "data",
                                self.comm.row, self.comm.rows)

    def global_counts(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        """The reference's global view: (N_w|k (W_pad, K), N_k|d (D_pad,
        K)) on every rank, relabeled as the grid lays them out."""
        return self._all_n_wk(state), self._all_n_kd(state)

    def host_n_wk(self, state) -> np.ndarray:
        """N_w|k (W, K) on the host, in the corpus's word ids."""
        return self._all_n_wk(state).cpu().numpy()[self.grid.word_perm]

    def host_n_kd(self, state) -> np.ndarray:
        """N_k|d (D, K) on the host, in the corpus's doc ids."""
        return self._all_n_kd(state).cpu().numpy()[self.grid.doc_perm]

    # -- checkpoint surfaces -----------------------------------------------
    def model_arrays(self, state) -> Tuple[np.ndarray, np.ndarray]:
        return self.host_n_wk(state), state.n_k.cpu().numpy()

    def checkpoint_tree(self, state) -> Dict[str, Any]:
        """The reference's tree: the global ``(cells, e_cell)`` topics of
        the grid layout and the iteration."""
        topic = self.comm.gather(state.topic[None, :], "all",
                                 self.comm.rank, self.comm.size("all"))
        return {"topic": topic.cpu().numpy(),
                "iteration": np.asarray(state.iteration, np.int32)}

    def restore(self, state, tree):
        """Assignments from a checkpoint tree (grid layout of this mesh,
        or corpus order), counts rebuilt, exclusion counters reset."""
        topic = torch.from_numpy(self._cell_topics(tree["topic"])).to(
            self.device)
        topic[self.data.num_real:] = 0
        zeros = torch.zeros_like(topic)
        state = state._replace(
            topic=topic, prev_topic=topic.clone(),
            iteration=int(np.asarray(tree["iteration"])),
            stale_iters=zeros, same_count=zeros.clone())
        return self.rebuild(state)

    def corpus_topics(self, state) -> np.ndarray:
        """The assignments in corpus order, (E,) int32 on every rank."""
        tree = self.checkpoint_tree(state)["topic"]
        out = np.zeros(self._num_tokens, np.int32)
        mask = np.asarray(self.grid.mask)
        out[np.asarray(self.grid.token)[mask]] = tree[mask]
        return out


def _check_mesh_backend(backend, name: str) -> None:
    from repro_torch.launch.mesh import mesh_backends

    if not backend.supports_shard_map:
        raise ValueError(
            f"backend {name!r} does not support shard_map cells; "
            f"mesh-capable backends: {', '.join(mesh_backends())}")


class TrainSession:
    """One training run behind the reference's interface: resolves the
    backend once, builds the plan ``cfg.mesh_shape`` selects on ``device``
    and fires the event schedule after every step. On a mesh every rank
    builds the same session (``grid``/``comm``: see :class:`MeshPlan`)."""

    def __init__(self, corpus: Optional[Corpus], hyper: LDAHyperParams,
                 cfg: RunConfig, device=None, grid=None, comm=None,
                 plan: Optional[ExecutionPlan] = None):
        refuse_unported(cfg)
        if cfg.sampling_method is None:
            cfg = dataclasses.replace(
                cfg, sampling_method="cdf" if cfg.mesh_shape is None
                else "gumbel")
        self.hyper = hyper
        self.cfg = cfg
        self.backend = algorithms.get(cfg.algorithm)
        if plan is not None:
            # an already-prepared plan (``with_run_params``), shared: the
            # caller guarantees it was built from the same non-run fields
            self.plan = plan
        elif cfg.mesh_shape is None:
            self.plan = SingleBoxPlan(corpus, hyper, cfg, device=device)
        else:
            self.plan = MeshPlan(corpus, hyper, cfg, device=device,
                                 grid=grid, comm=comm)
        self.corpus = self.plan.corpus
        # telemetry, the autopilot and the quality evaluator exist only
        # when enabled: off, the schedule is the plain one
        self.telemetry = None
        self._autopilot_policy = None
        if cfg.metrics_out or cfg.autopilot:
            from repro_torch.observe import (
                JsonlSink,
                MetricsRegistry,
                TrainTelemetry,
            )

            sink = JsonlSink(cfg.metrics_out) if cfg.metrics_out else None
            self.telemetry = TrainTelemetry(MetricsRegistry(sink))
        if cfg.autopilot:
            from repro_torch.autotune import TrainAutopilot

            self._autopilot_policy = TrainAutopilot(
                self._autopilot_candidates())
        self._quality = None
        if cfg.quality_every > 0:
            from repro_torch.eval import QualityEval

            # corpus statistics counted once, on the plan's device
            self._quality = QualityEval.from_run_config(self.corpus, hyper,
                                                        cfg)
        self.schedule = self._build_schedule()
        self._last_model_save: Optional[int] = None
        self._train_ckpt = self._excl_ckpt = None
        if cfg.train_checkpoint_dir:
            from repro_torch.train.checkpoint import CheckpointManager

            self._train_ckpt = CheckpointManager(cfg.train_checkpoint_dir)
            if cfg.exclusion_start > 0 and isinstance(self.plan,
                                                      SingleBoxPlan):
                self._excl_ckpt = CheckpointManager(os.path.join(
                    cfg.train_checkpoint_dir, EXCLUSION_CKPT_DIR))

    def with_run_params(self, num_iterations: Optional[int] = None,
                        eval_every: Optional[int] = None,
                        target_perplexity: Optional[float] = None
                        ) -> "TrainSession":
        """A session sharing this one's prepared plan (backend aux, row
        walks, the mesh's cell) with only the run-length and eval fields
        replaced, none of which the plan depends on. ``LDATrainer.train``
        re-parameterises per call this way without preparing again."""
        cfg = dataclasses.replace(
            self.cfg,
            num_iterations=self.cfg.num_iterations if num_iterations is None
            else num_iterations,
            eval_every=self.cfg.eval_every if eval_every is None
            else eval_every,
            target_perplexity=target_perplexity,
        )
        return TrainSession(self.corpus, self.hyper, cfg, plan=self.plan)

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints: the single box, or a
        mesh's rank 0."""
        return not isinstance(self.plan, MeshPlan) or self.plan.comm.rank == 0

    @property
    def row_pads(self) -> Tuple[int, int]:
        """(max_kw, max_kd) currently in effect (0 = per-sweep auto)."""
        return self.plan.row_pads

    # -- the session surface -----------------------------------------------
    def init(self, rng, init_topics=None) -> CGSState:
        """The initial state: ``rng`` is an int seed or two uint32 words
        (e.g. a reference key's ``key_data``); ``init_topics`` an optional
        (E,) array of initial topics, e.g. a reference state's."""
        return self.plan.init(rng, init_topics=init_topics)

    def step(self, state: CGSState) -> CGSState:
        """Exactly one CGS iteration; no schedule action fires."""
        return self.plan.step(state)

    def llh(self, state: CGSState) -> float:
        """Predictive log-likelihood of the current counts (one pass)."""
        return self.plan.llh(state)

    def perplexity(self, state: CGSState) -> float:
        return math.exp(-self.plan.llh(state) / self.plan.num_tokens)

    def metrics(self, state: CGSState) -> Dict[str, float]:
        """``{"llh", "perplexity", "change_rate"}`` from one llh pass."""
        llh = self.plan.llh(state)
        return {
            "llh": llh,
            "perplexity": math.exp(-llh / self.plan.num_tokens),
            "change_rate": self.plan.change_rate(state),
        }

    def save_model(self, state: CGSState,
                   directory: Optional[str] = None) -> str:
        """Checkpoint the trained model (N_wk/N_k + hyper) for serving, in
        the reference's format: either package's ``serve_lda`` loads it."""
        from repro_torch.train.checkpoint import save_lda_model

        directory = directory or self.cfg.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        n_wk, n_k = self.plan.model_arrays(state)  # a collective on a mesh
        extra = {"algorithm": self.cfg.algorithm}
        if self.cfg.mesh_shape is not None:
            extra["mesh"] = list(self.cfg.mesh_shape)
        step = int(state.iteration)
        path = os.path.join(directory, f"step_{step:08d}")
        if self.is_writer:
            path = save_lda_model(directory, n_wk, n_k, self.hyper,
                                  step=step, extra_metadata=extra)
        self._last_model_save = step
        return path

    def merge_duplicates(self, state: CGSState) -> CGSState:
        """Detect and merge duplicate topics (paper §4.3); a trivial map
        is a no-op."""
        n_wk = self.plan.host_n_wk(state) if isinstance(
            self.plan, MeshPlan) else state.n_wk
        topic_map = duplicate_topic_map(n_wk, self.cfg.merge_threshold)
        if (topic_map == np.arange(topic_map.shape[0])).all():
            return state
        return self.plan.merge(state, topic_map)

    # -- schedule ----------------------------------------------------------
    def _build_schedule(self) -> Schedule:
        cfg = self.cfg
        sched = Schedule()
        # structural events first, so evals/checkpoints on the same
        # iteration observe post-event state
        if cfg.exclusion_start > 0:
            sched.add(ScheduledAction(
                "exclusion_on",
                lambda ctx, st: (self.plan.enable_exclusion(), st)[1],
                at=cfg.exclusion_start,
            ))
        if cfg.rebuild_every > 0:
            sched.add(ScheduledAction(
                "rebuild", lambda ctx, st: self.plan.rebuild(st),
                every=cfg.rebuild_every,
            ))
            # with the autopilot on, row widths belong to its RowRepad
            # decisions: two owners would fight over one knob
            if (self.backend.needs_row_pads
                    and not (cfg.max_kw and cfg.max_kd)
                    and not cfg.autopilot):
                def _repad(ctx, st):
                    if self.plan.repad(st):
                        ctx.metrics["row_pads"] = self.plan.row_pads
                    return st

                sched.add(ScheduledAction(
                    "repad", _repad, every=cfg.rebuild_every,
                ))
        if cfg.autopilot:
            sched.add(ScheduledAction(
                "autopilot", self._autopilot_action,
                every=cfg.autopilot_every or cfg.rebuild_every or 10,
            ))
        if cfg.hyper_every > 0:
            sched.add(ScheduledAction(
                "hyper", self._hyper_action, every=cfg.hyper_every,
            ))
        if cfg.merge_every > 0:
            sched.add(ScheduledAction(
                "merge", lambda ctx, st: self.merge_duplicates(st),
                every=cfg.merge_every,
            ))
        if cfg.eval_every > 0:
            def _eval(ctx, st):
                ctx.metrics.update(self.metrics(st))
                if (cfg.target_perplexity is not None
                        and ctx.metrics["perplexity"]
                        <= cfg.target_perplexity):
                    ctx.stop = True
                return st

            sched.add(ScheduledAction("eval", _eval, every=cfg.eval_every))
        if cfg.quality_every > 0:
            sched.add(ScheduledAction(
                "quality", self._quality_action, every=cfg.quality_every,
            ))
        if cfg.checkpoint_dir and cfg.checkpoint_every > 0:
            sched.add(ScheduledAction(
                "model_checkpoint",
                lambda ctx, st: (self.save_model(st), st)[1],
                every=cfg.checkpoint_every,
            ))
        if cfg.train_checkpoint_dir and cfg.train_checkpoint_every > 0:
            sched.add(ScheduledAction(
                "train_checkpoint",
                lambda ctx, st: (self.save_train_checkpoint(st), st)[1],
                every=cfg.train_checkpoint_every,
            ))
        if self.telemetry is not None:
            # last, so the record carries what the earlier actions added
            sched.add(ScheduledAction(
                "telemetry", self._telemetry_action,
                every=max(1, cfg.metrics_every),
            ))
        return sched

    # -- the autopilot, quality and telemetry actions ------------------------
    def _autopilot_candidates(self) -> Tuple[str, ...]:
        """The configured backend plus the three decomposition
        representatives (doc-side, word-side, hybrid), restricted to
        mesh-capable ones on a mesh plan."""
        cands = [self.cfg.algorithm]
        for name in ("zen_sparse", "sparselda", "zen_hybrid"):
            if name in cands or name not in algorithms.registered():
                continue
            if (self.cfg.mesh_shape is not None
                    and not algorithms.get(name).supports_shard_map):
                continue
            cands.append(name)
        return tuple(cands)

    def _autopilot_action(self, ctx: ActionContext, state: CGSState):
        """Measure, decide, act at a rebuild point: the counts are rebuilt
        from the assignments first, so a switch bakes in no drift."""
        from repro_torch.autotune.policy import BackendSwitch, RowRepad

        state = self.plan.rebuild(state)
        plan = self.plan
        if isinstance(plan, MeshPlan):
            # mesh widths are fixed between re-resolutions: policy-owned
            # whenever the backend uses padded rows
            pads_tunable = plan.backend.needs_row_pads
        else:
            # the single box resolves auto pads (0) every sweep already:
            # only explicit widths are worth tuning
            pads_tunable = (plan.backend.needs_row_pads
                            and all(p > 0 for p in plan.row_pads))
        decisions = self._autopilot_policy.decide(
            self.telemetry.window(),
            current_backend=plan.backend.name,
            current_pads=plan.row_pads,
            num_topics=self.hyper.num_topics,
            pads_tunable=pads_tunable,
        )
        for d in decisions:
            if isinstance(d, BackendSwitch):
                applied = plan.set_backend(d.backend, state)
                if applied:
                    self.backend = plan.backend
            elif isinstance(d, RowRepad):
                applied = plan.apply_row_pads(d.max_kw, d.max_kd)
            else:  # pragma: no cover - no other training decision types
                applied = False
            rec = d.to_record()
            rec.update(iteration=int(state.iteration), applied=applied)
            self.telemetry.emit_decision(rec)
            ctx.metrics.setdefault("autopilot", []).append(rec)
        return state

    def _quality_action(self, ctx: ActionContext, state: CGSState):
        """Score the model snapshot (coherence, left-to-right) into the
        iteration's metrics; reads the counts on the card, changes
        nothing."""
        n_wk = state.n_wk
        if isinstance(self.plan, MeshPlan):
            n_wk = torch.from_numpy(self.plan.host_n_wk(state)).to(
                self.device)
        ctx.metrics.update(self._quality.evaluate(
            n_wk, state.n_k, int(state.iteration)))
        return state

    def _telemetry_action(self, ctx: ActionContext, state: CGSState):
        view = state
        if isinstance(self.plan, MeshPlan):
            # the record reads the whole padded matrices, as the
            # reference's global arrays, alike on every rank
            n_wk, n_kd = self.plan.global_counts(state)
            view = state._replace(n_wk=n_wk, n_kd=n_kd)
        self.telemetry.record_iteration(self.plan, view,
                                        int(state.iteration), ctx.metrics)
        return state

    def _hyper_action(self, ctx: ActionContext, state: CGSState):
        """One Alg. 5 hyper move against the current doc-topic counts."""
        from repro_torch.core.hyper import optimize_hyper

        cfg = self.cfg
        n_kd = self.plan.host_n_kd(state) if isinstance(
            self.plan, MeshPlan) else state.n_kd.cpu().numpy()
        new_hyper = optimize_hyper(
            self.hyper, n_kd,
            update_alpha=cfg.hyper_alpha,
            beta_anneal=cfg.hyper_beta_anneal,
            beta_floor=cfg.hyper_beta_floor,
        )
        if new_hyper is not self.hyper:
            self.hyper = new_hyper
            self.plan.set_hyper(new_hyper)
            if self._quality is not None:
                self._quality.hyper = new_hyper  # l2r alpha_k follows
            ctx.metrics["hyper"] = {"alpha": new_hyper.alpha,
                                    "beta": new_hyper.beta}
        return state

    # -- elastic training checkpoints ---------------------------------------
    def save_train_checkpoint(self, state: CGSState) -> None:
        """Write the elastic training checkpoint of ``state`` (the
        ``train_checkpoint`` action's save) under
        ``cfg.train_checkpoint_dir``; the exclusion statistics first,
        where they are kept, so a committed tree always has them."""
        if self._train_ckpt is None:
            raise ValueError("no training checkpoint directory configured")
        tree = self.plan.checkpoint_tree(state)  # a collective on a mesh
        if self.is_writer:
            step = int(state.iteration)
            if self._excl_ckpt is not None:
                self._excl_ckpt.save(step, self.plan.exclusion_tree(state),
                                     {})
            self._train_ckpt.save(step, tree, {})

    def _maybe_restore(self, state: CGSState) -> CGSState:
        if self._train_ckpt is None:
            return state
        got = self._train_ckpt.restore_latest()
        if got is None:
            return state
        tree, _meta, step = got
        state = self.plan.restore(state, tree)
        stats = (self._excl_ckpt.restore_step(step)
                 if self._excl_ckpt is not None else None)
        if stats is not None:
            state = self.plan.restore_exclusion(state, stats)
        return state

    # -- the loop ------------------------------------------------------------
    def run(self, rng=None, state: Optional[CGSState] = None,
            callback: Optional[Callable[[Any, Dict], None]] = None,
            init_topics=None) -> CGSState:
        """Run to ``cfg.num_iterations`` (absolute), firing the schedule
        after every step; ``callback(state, metrics)`` each iteration.
        Returns the final state."""
        cfg = self.cfg
        if state is None:
            if rng is None:
                raise ValueError("run() needs an rng or an initial state")
            state = self.init(rng, init_topics=init_topics)
        state = self._maybe_restore(state)
        if cfg.exclusion_start and int(state.iteration) >= cfg.exclusion_start:
            self.plan.enable_exclusion()
        ctx = ActionContext(session=self)
        restore_signals = self._install_signals(ctx)
        try:
            while int(state.iteration) < cfg.num_iterations and not ctx.stop:
                state = self.plan.step(state)
                ctx.metrics = {}
                state = self.schedule.fire(ctx, state, int(state.iteration))
                if callback is not None:
                    callback(state, ctx.metrics)
        finally:
            restore_signals()
        if cfg.checkpoint_dir and self._last_model_save != int(state.iteration):
            self.save_model(state)
        if self._train_ckpt is not None and ctx.stop:
            self.save_train_checkpoint(state)
        return state

    def _install_signals(self, ctx: ActionContext):
        """SIGTERM/SIGINT -> finish the current iteration, checkpoint and
        return. Returns a callback that restores the previous handlers."""

        def handler(signum, frame):
            ctx.stop = True

        try:
            prev = {sig: signal.signal(sig, handler)
                    for sig in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:
            return lambda: None  # not in the main thread

        def restore():
            for sig, old in prev.items():
                try:
                    signal.signal(sig, old)
                except (ValueError, TypeError):
                    pass

        return restore
