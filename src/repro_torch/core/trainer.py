"""Deprecated single-box driver shims: ``LDATrainer`` / ``TrainConfig``
(``repro/core/trainer.py``).

The driver is ``repro_torch.train.session.TrainSession`` with a
declarative ``RunConfig``. These shims keep the historical single-box
surface (``LDATrainer(corpus, hyper, TrainConfig(...))`` with
``init_state/sweep/step/llh/train``) by delegating every call to a
single-box session, so a shim run draws exactly what the session draws
from the same key. A key is an int seed or two uint32 words
(``core.keys``), not a ``jax.random`` key. New code should build the
session directly:

    from repro_torch.train.session import RunConfig, TrainSession
    session = TrainSession(corpus, hyper, RunConfig(algorithm="zen", ...))
    final = session.run(0)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.algorithms.knobs import SamplerKnobs, knobs_from
from repro_torch.core.exclusion import ExclusionConfig
from repro_torch.core.types import CGSState, Corpus, LDAHyperParams

# NOTE: repro_torch.train.session is imported inside the shims: it imports
# repro_torch.algorithms, whose backend modules import repro_torch.core,
# whose __init__ imports this module; a top-level import here would close
# that cycle on a partially initialised module. (algorithms.knobs imports
# no repro_torch.core, so it is safe here.)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Deprecated: the single-box slice of ``RunConfig`` (every field maps
    1:1 through ``to_run_config``)."""

    algorithm: str = "zen"  # any algorithms.registered() name
    init: str = "random"  # random | sparse_word | sparse_doc
    sparse_init_degree: float = 0.1
    sampling_method: str = "cdf"  # cdf | gumbel  (dense paths)
    exclusion: ExclusionConfig = ExclusionConfig()
    max_kw: int = 0  # 0 -> auto from data (padded-sparse paths)
    max_kd: int = 0
    num_mh: int = 8  # LightLDA MH steps (paper uses 8)
    token_chunk: int = 0  # 0 = whole sweep at once (memory knob)
    # the reference's tiles: validated, no launch counterpart (kernels.ops)
    bt: int = 256  # token tile
    bk: int = 512  # topic tile
    bs: int = 128  # sparse-row lane tile
    kernels: str = "auto"  # kernel dispatch: auto | on | off
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0

    def knobs(self) -> SamplerKnobs:
        return knobs_from(self)  # the one shared derivation

    def to_run_config(self, num_iterations: int = 0, eval_every: int = 0,
                      target_perplexity: Optional[float] = None):
        from repro_torch.train.session import RunConfig

        # legacy (enabled=True, start_iteration=0) means "on from the
        # start"; RunConfig's 0 means disabled, and enabling at iteration
        # 1 is bit-identical (fresh stats give resample probability 1)
        excl_start = 0
        if self.exclusion.enabled:
            excl_start = max(int(self.exclusion.start_iteration), 1)
        return RunConfig(
            algorithm=self.algorithm,
            sampling_method=self.sampling_method,
            max_kw=self.max_kw, max_kd=self.max_kd, num_mh=self.num_mh,
            token_chunk=self.token_chunk, bt=self.bt, bk=self.bk,
            bs=self.bs, kernels=self.kernels,
            init=self.init, sparse_init_degree=self.sparse_init_degree,
            mesh_shape=None,
            num_iterations=num_iterations,
            eval_every=eval_every,
            target_perplexity=target_perplexity,
            exclusion_start=excl_start,
            exclusion_min_prob=self.exclusion.min_sample_prob,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
        )


class LDATrainer:
    """Deprecated: a thin veneer over a single-box ``TrainSession`` on
    ``device`` (default ``cuda``; raises without a card, never falls
    back)."""

    def __init__(self, corpus: Corpus, hyper: LDAHyperParams,
                 cfg: TrainConfig, device=None):
        from repro_torch.train.session import TrainSession

        self.cfg = cfg
        self._session = TrainSession(corpus, hyper, cfg.to_run_config(),
                                     device=device)
        self.corpus = self._session.corpus  # on the session's device
        self.hyper = hyper
        self.backend = self._session.backend

    # -- initialization ----------------------------------------------------
    def init_state(self, rng, init_topics=None) -> CGSState:
        """``rng``: an int seed or two uint32 words; ``init_topics`` an
        optional (E,) array of initial topics (e.g. a reference state's)."""
        return self._session.init(rng, init_topics=init_topics)

    # -- one iteration -----------------------------------------------------
    def sweep(self, state: CGSState):
        return self._session.plan.sweep(state)

    def step(self, state: CGSState) -> CGSState:
        return self._session.step(state)

    # -- metrics -----------------------------------------------------------
    def llh(self, state: CGSState) -> float:
        return self._session.llh(state)

    def llh_split(self, state: CGSState):
        return self._session.plan.llh_split(state)

    def perplexity(self, state: CGSState) -> float:
        return self._session.perplexity(state)

    def change_rate(self, state: CGSState) -> float:
        """Fraction of tokens whose topic changed last iteration (Fig. 9a)."""
        return self._session.plan.change_rate(state)

    # -- model checkpointing (serving handoff) ------------------------------
    def save_model(self, state: CGSState,
                   directory: Optional[str] = None) -> str:
        return self._session.save_model(state, directory)

    # -- training loop ------------------------------------------------------
    def train(self, rng, num_iterations: int,
              state: Optional[CGSState] = None,
              llh_every: int = 0,
              callback: Optional[Callable[[CGSState, dict], None]] = None,
              target_perplexity: Optional[float] = None) -> CGSState:
        """Delegates to ``TrainSession.run`` (sharing the prepared plan).
        ``num_iterations`` counts *additional* steps from the given state;
        the session's own config counts absolute iterations.
        ``target_perplexity`` is checked on every eval tick from that
        tick's llh (no second likelihood pass). Eval and checkpoint ticks
        fall on *absolute*-iteration multiples of the cadence, so a
        resumed run ticks on the grid of an uninterrupted one."""
        start = 0 if state is None else int(state.iteration)
        session = self._session.with_run_params(
            num_iterations=start + num_iterations,
            eval_every=llh_every,
            target_perplexity=target_perplexity,
        )
        return session.run(rng=rng, state=state, callback=callback)
