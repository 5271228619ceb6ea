"""One quality evaluator for sessions (``repro/eval/quality.py``).

``QualityEval`` owns the corpus-side statistics (built once, on the
corpus's device) and turns a frozen model snapshot ``(n_wk, n_k)`` —
tensors on the card, or numpy arrays — into the reference's record::

    {"coherence_umass", "coherence_npmi", "l2r_llh", "l2r_per_token"}

(the left-to-right keys only when ``l2r_docs > 0``). ``TrainSession`` fires
it as the "quality" schedule action on the ``quality_every`` cadence.

Determinism: the coherence statistics are a pure function of the corpus,
and the left-to-right particles draw from a numpy generator seeded from
``(seed, iteration, doc)``, as the reference's do, so two identical runs
give identical records. The evaluation documents are the reference's:
evenly spaced doc ids, empty ones skipped, truncated to ``l2r_max_len``;
all of them are swept together (``left_to_right_llh_batch``), and the
number of draws taken at a cumulative-sum near-tie is kept on
``last_near_ties``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.eval.coherence import (
    CoherenceStats,
    npmi_coherence,
    top_topic_words,
    umass_coherence,
)
from repro_torch.eval.left_to_right import (  # noqa: F401
    left_to_right_llh,  # the reference's module surface
    left_to_right_llh_batch,
)


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Knobs of one quality evaluation (see ``RunConfig`` mirrors)."""

    top_n: int = 10  # words per topic entering the coherence pairs
    npmi_window: int = 10  # sliding-window size (<=0 skips NPMI)
    l2r_docs: int = 0  # held-out docs for left-to-right (0 = skip)
    l2r_particles: int = 20  # particles per document
    l2r_max_len: int = 32  # truncate eval docs to this many tokens
    l2r_seed: int = 0  # base seed of the particle streams


class QualityEval:
    """Reusable evaluator: corpus stats built once, queried per tick."""

    def __init__(self, corpus, hyper, cfg: QualityConfig):
        self.hyper = hyper
        self.cfg = cfg
        self.stats = CoherenceStats.from_corpus(
            corpus, window=max(1, cfg.npmi_window))
        self.device = self.stats.device
        self.last_near_ties = 0
        self._l2r_docs: List[np.ndarray] = []
        if cfg.l2r_docs > 0:
            n = min(cfg.l2r_docs, corpus.num_docs)
            ids = np.linspace(0, corpus.num_docs - 1, n).astype(int)
            for d in ids:
                toks = self.stats.docs[int(d)]
                if len(toks) == 0:
                    continue
                self._l2r_docs.append(toks[: cfg.l2r_max_len])

    def evaluate(self, n_wk, n_k, iteration: int = 0) -> Dict[str, float]:
        """Score one frozen model snapshot; returns the quality record."""
        cfg = self.cfg
        n_wk = torch.as_tensor(n_wk).to(self.device)
        n_k = torch.as_tensor(n_k).to(self.device)
        top = top_topic_words(n_wk, cfg.top_n).cpu().numpy()
        out: Dict[str, float] = {}
        out["coherence_umass"], _ = umass_coherence(self.stats, top)
        if cfg.npmi_window > 0:
            out["coherence_npmi"], _ = npmi_coherence(self.stats, top)
        if self._l2r_docs:
            rngs = [np.random.default_rng((cfg.l2r_seed, int(iteration), i))
                    for i in range(len(self._l2r_docs))]
            llh, near = left_to_right_llh_batch(
                n_wk, n_k, self._l2r_docs, self.hyper,
                num_particles=cfg.l2r_particles, rngs=rngs)
            self.last_near_ties = int(near.sum())
            total = 0.0
            for v in llh:  # the reference's order of addition
                total += float(v)
            tokens = sum(len(toks) for toks in self._l2r_docs)
            out["l2r_llh"] = total
            out["l2r_per_token"] = total / max(1, tokens)
        return out

    @classmethod
    def from_run_config(cls, corpus, hyper, run_cfg,
                        ) -> Optional["QualityEval"]:
        """Build from ``RunConfig`` quality fields; None when disabled."""
        if run_cfg.quality_every <= 0:
            return None
        return cls(corpus, hyper, QualityConfig(
            top_n=run_cfg.quality_top_n,
            npmi_window=run_cfg.quality_npmi_window,
            l2r_docs=run_cfg.quality_l2r_docs,
            l2r_particles=run_cfg.quality_l2r_particles,
        ))
