"""Training sessions (``repro/train/session.py``), single-box plan.

* ``RunConfig`` — the declarative run description, with the reference's
  fields, defaults and JSON, so one run file means the same run in both
  packages (``launch/train.py --config run.json``). The mesh plan
  (``mesh_shape``) is not ported yet and is refused when a session is
  built, naming its ROADMAP item. The streaming fields (``window_docs``,
  ``stream_source``) drive ``train.online.StreamingSession``;
  ``TrainSession`` ignores them, as the reference's does.
* ``SingleBoxPlan`` — the whole corpus as one cell on one device: sweep
  (the registry backend), exclusion mask, delta merge and exclusion
  statistics, as the reference's single-box plan does them.
* ``TrainSession`` — ``init() / step() / run() / llh() / perplexity() /
  metrics() / save_model() / merge_duplicates()``, with the reference's
  schedule actions: ``exclusion_on``, ``rebuild``, ``repad``,
  ``autopilot``, ``hyper``, ``merge``, ``eval``, ``quality``,
  ``model_checkpoint``, ``train_checkpoint`` and ``telemetry``; ``run()``
  resumes from the newest elastic training checkpoint, the reference's
  ``{"topic", "iteration"}`` tree included. Telemetry
  (``metrics_out``), the autopilot (``autopilot``) and quality evaluation
  (``quality_every``) are built only when enabled, and read the counts on
  the card; they change no draw.

Sessions and plans run on ``device`` (default ``cuda``) and raise rather
than fall back when no card is present. The run key is an int seed or two
uint32 words (``core.keys``), not a ``jax.random`` key; a reference
state's initial topics pass in as ``init(seed, init_topics=...)``.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
from repro_torch.core.keys import as_key, fold_in
from repro_torch.core.likelihood import predictive_llh
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams
from repro_torch.device import resolve_device
from repro_torch.kernels.topic_histogram import RowOrder, row_order
from repro_torch.train.schedule import ActionContext, Schedule, ScheduledAction


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Declarative description of one training run; the reference's
    fields and defaults (see ``repro/train/session.py`` for each one).

    ``mesh_shape=None`` selects the single-box plan, the only one ported.
    Cadences count post-step iterations (the first step is iteration 1);
    0 disables. ``num_iterations`` is the absolute target iteration.
    ``sampling_method=None`` resolves to ``cdf`` on the single box.
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


# field -> (is it set?, what waits for it); the ROADMAP's queue-1 items
UNPORTED_FIELDS = {
    "mesh_shape": (lambda v: v is not None,
                   "the mesh plan, ROADMAP queue 1 item 7"),
}


def refuse_unported(cfg: RunConfig) -> None:
    """Raise a ``ValueError`` naming every field of ``cfg`` whose value
    asks for a feature the port does not have yet."""
    bad = [f"{name}={getattr(cfg, name)!r} ({why})"
           for name, (is_set, why) in UNPORTED_FIELDS.items()
           if is_set(getattr(cfg, name))]
    try:
        algorithms.get(cfg.algorithm)
    except ValueError:
        bad.append(f"algorithm={cfg.algorithm!r} (no such backend; ported: "
                   f"{', '.join(algorithms.registered())})")
    if bad:
        raise ValueError("RunConfig asks for what is not ported to the "
                         "PyTorch port yet: " + "; ".join(bad))


class SingleBoxPlan:
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


class TrainSession:
    """One training run behind the reference's interface: resolves the
    backend once, builds the single-box plan on ``device`` and fires the
    event schedule after every step."""

    def __init__(self, corpus: Corpus, hyper: LDAHyperParams, cfg: RunConfig,
                 device=None):
        refuse_unported(cfg)
        if cfg.sampling_method is None:
            cfg = dataclasses.replace(cfg, sampling_method="cdf")
        self.hyper = hyper
        self.cfg = cfg
        self.backend = algorithms.get(cfg.algorithm)
        self.plan = SingleBoxPlan(corpus, hyper, cfg, device=device)
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
        self._train_ckpt = None
        if cfg.train_checkpoint_dir:
            from repro_torch.train.checkpoint import CheckpointManager

            self._train_ckpt = CheckpointManager(cfg.train_checkpoint_dir)

    @property
    def device(self) -> torch.device:
        return self.plan.device

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
        n_wk, n_k = self.plan.model_arrays(state)
        path = save_lda_model(directory, n_wk, n_k, self.hyper,
                              step=int(state.iteration),
                              extra_metadata={"algorithm":
                                              self.cfg.algorithm})
        self._last_model_save = int(state.iteration)
        return path

    def merge_duplicates(self, state: CGSState) -> CGSState:
        """Detect and merge duplicate topics (paper §4.3); a trivial map
        is a no-op."""
        topic_map = duplicate_topic_map(state.n_wk, self.cfg.merge_threshold)
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
                lambda ctx, st: (self._save_train_ckpt(st), st)[1],
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
        representatives (doc-side, word-side, hybrid)."""
        cands = [self.cfg.algorithm]
        for name in ("zen_sparse", "sparselda", "zen_hybrid"):
            if name not in cands and name in algorithms.registered():
                cands.append(name)
        return tuple(cands)

    def _autopilot_action(self, ctx: ActionContext, state: CGSState):
        """Measure, decide, act at a rebuild point: the counts are rebuilt
        from the assignments first, so a switch bakes in no drift."""
        from repro_torch.autotune.policy import BackendSwitch, RowRepad

        state = self.plan.rebuild(state)
        plan = self.plan
        # the single box resolves auto pads (0) every sweep already: only
        # explicit widths are worth tuning
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
        ctx.metrics.update(self._quality.evaluate(
            state.n_wk, state.n_k, int(state.iteration)))
        return state

    def _telemetry_action(self, ctx: ActionContext, state: CGSState):
        self.telemetry.record_iteration(self.plan, state,
                                        int(state.iteration), ctx.metrics)
        return state

    def _hyper_action(self, ctx: ActionContext, state: CGSState):
        """One Alg. 5 hyper move against the current doc-topic counts."""
        from repro_torch.core.hyper import optimize_hyper

        cfg = self.cfg
        new_hyper = optimize_hyper(
            self.hyper, state.n_kd.cpu().numpy(),
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
    def _save_train_ckpt(self, state: CGSState) -> None:
        self._train_ckpt.save(int(state.iteration),
                              self.plan.checkpoint_tree(state), {})

    def _maybe_restore(self, state: CGSState) -> CGSState:
        if self._train_ckpt is None:
            return state
        got = self._train_ckpt.restore_latest()
        if got is None:
            return state
        tree, _meta, _step = got
        return self.plan.restore(state, tree)

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
            self._save_train_ckpt(state)
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
