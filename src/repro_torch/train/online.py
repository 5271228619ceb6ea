"""Windowed online training (``repro/train/online.py``): a
``TrainSession``-shaped loop over a
:class:`~repro_torch.data.stream.CorpusSource`.

The resident model is ``n_wk`` (W, K) / ``n_k`` (K,) on the session's
device (default ``cuda``); doc-side state exists only for the window being
swept. Per window:

1. **decay** — from the second window on, with ``cfg.decay > 0``, the
   counts become ``round(n_wk * (1 - decay))`` in float64 on the device
   (``torch.round`` rounds half to even, as the reference's ``np.rint``),
   and ``n_k`` is re-derived, so ``n_k == n_wk.sum(0)`` stays exact;
2. **plan** — the unchanged :class:`~repro_torch.train.session.SingleBoxPlan`
   over the window's corpus (copied to the device here). On a replaying
   source with ``decay == 0`` plans are cached per uid, each holding its
   window's corpus and kernel-5 row orders on the device;
3. **compose** — the window's tokens take fresh topics
   (:func:`window_topics`) or, on a revisit in the rotation regime, the
   assignments retained from their last visit; the state holds the
   resident counts (plus the window's own on a first visit) and the
   window's ``n_kd``;
4. **sweeps** — ``window_sweeps`` plan steps, with ``exclusion_start=0``;
5. **eval** — the window's predictive llh under the swept counts;
6. **retire** — the swept ``n_wk``/``n_k`` become the model; the
   rotation regime keeps the window's assignments on the host (numpy).

Randomness: window ``i``'s key is ``fold_in(base key, i)`` (the stream
index, never the wall-clock position), split into the key of its fresh
topics and the state key its sweeps draw from, so a resumed run is
bit-identical to an uninterrupted one. ``docs_per_sec`` is timed after
the window's one ``torch.cuda.synchronize``, so it is the card's.
``timings`` holds the last window's milliseconds by phase: decay, plan,
compose and sweeps between CUDA events on the card (the host clock on
the CPU), read after that synchronize, so the marks never stall the
host; eval and retire on the host clock, as each ends in a host read.

Checkpoints are the reference's: ``save_model`` writes the serving
artifact (step = window cursor) that ``LDAEngine.watch_checkpoint_dir``
hot-reloads; ``save_stream_checkpoint`` writes the counts, the window and
document cursors and every retained assignment, and ``run()`` resumes
from the newest one, whichever package wrote it.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import counts as counts_lib
from repro_torch.core.keys import as_key, fold_in, init_topics, split
from repro_torch.core.likelihood import predictive_llh
from repro_torch.core.types import CGSState, LDAHyperParams
from repro_torch.data.stream import CorpusSource, ReplaySource, Window
from repro_torch.device import resolve_device
from repro_torch.train.session import (
    RunConfig,
    SingleBoxPlan,
    refuse_unported,
)

_STREAM_KIND = "lda_stream"


def window_topics(key: torch.Tensor, window: Window, num_topics: int,
                  device: torch.device) -> torch.Tensor:
    """A window's fresh assignments, (T,) int32 on ``device``: uniform over
    K, each token's draw a hash of (``key``, its position in the window)."""
    return init_topics(key, window.corpus.num_tokens, num_topics,
                       device=device)


class _PhaseClock:
    """A window's phase boundaries: CUDA events on the card, read only
    after the window's synchronize; the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._marks = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self._stream is None:
            self._marks.append((name, time.perf_counter()))
            return
        event = torch.cuda.Event(enable_timing=True)
        event.record(self._stream)
        self._marks.append((name, event))

    def ms(self) -> Dict[str, float]:
        """Milliseconds from each mark to the next, by the later name."""
        return {name: (a.elapsed_time(b) if self._stream is not None
                       else (b - a) * 1e3)
                for (_, a), (name, b) in zip(self._marks, self._marks[1:])}


class StreamingSession:
    """Drive windowed online training from a :class:`CorpusSource`.

    ``run(rng, callback)``, ``save_model()`` and a metrics dict per window
    (the reference's keys), with ``cfg.num_iterations`` bounding the
    absolute window cursor (0 = until the source ends). ``rng`` is an int
    seed or two uint32 words (``core.keys``). The telemetry, autopilot
    and quality fields of ``cfg`` are accepted and ignored, as the
    reference's ``StreamingSession`` does."""

    def __init__(self, source: CorpusSource, hyper: LDAHyperParams,
                 cfg: RunConfig, device=None):
        if cfg.mesh_shape is not None:
            raise ValueError(
                "StreamingSession is single-box; windowed mesh execution "
                "is a roadmap follow-up (shard the window, not the corpus)"
            )
        if not 0.0 <= cfg.decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {cfg.decay}")
        if cfg.window_sweeps <= 0:
            raise ValueError(
                f"window_sweeps must be > 0, got {cfg.window_sweeps}"
            )
        refuse_unported(cfg)
        self.device = resolve_device(device)
        self.source = source
        self.hyper = hyper
        self.cfg = cfg
        # windows never run the batch-iteration exclusion warm-up, and
        # sample as the single-box plan does by default
        self._window_cfg = dataclasses.replace(
            cfg, exclusion_start=0, mesh_shape=None,
            sampling_method=cfg.sampling_method or "cdf",
        )
        k = hyper.num_topics
        self.n_wk = torch.zeros((source.num_words, k), dtype=torch.int32,
                                device=self.device)
        self.n_k = torch.zeros((k,), dtype=torch.int32, device=self.device)
        self.windows_done = 0
        # exact documents consumed: the resume cursor of a source whose
        # last window may be cut short at EOF (supports_doc_resume)
        self.docs_consumed = 0
        # rotation regime: assignments retained on the host, by uid
        self._retain = bool(source.replays) and cfg.decay == 0.0
        self._retained: Dict[str, np.ndarray] = {}
        self._plans: Dict[str, SingleBoxPlan] = {}
        self._base_key: Optional[torch.Tensor] = None
        self._last_model_save: Optional[int] = None
        self.timings: Dict[str, float] = {}
        self._ckpt = None
        if cfg.train_checkpoint_dir:
            from repro_torch.train.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(cfg.train_checkpoint_dir)

    # -- per-window machinery ----------------------------------------------
    def _plan_for(self, window: Window) -> SingleBoxPlan:
        """The window's ``SingleBoxPlan`` (its corpus on the device), from
        the per-uid cache in the rotation regime."""
        if self._retain and window.uid in self._plans:
            return self._plans[window.uid]
        plan = SingleBoxPlan(window.corpus, self.hyper, self._window_cfg,
                             device=self.device)
        if self._retain:
            self._plans[window.uid] = plan
        return plan

    def _apply_decay(self) -> None:
        """Scale the counts by ``(1 - decay)``, rounded half to even in
        float64 on the device, and re-derive ``n_k``."""
        if self.cfg.decay <= 0.0:
            return
        scaled = self.n_wk.to(torch.float64)
        scaled.mul_(1.0 - self.cfg.decay).round_()
        self.n_wk = scaled.to(torch.int32)
        del scaled
        self.n_k = self.n_wk.sum(0).to(torch.int32)

    def _compose(self, window: Window, plan: SingleBoxPlan,
                 key: torch.Tensor) -> CGSState:
        """The window's transient state: its topics (fresh or retained),
        its ``n_kd`` block and the resident counts, which gain the
        window's own tokens on a first visit only (on a revisit they hold
        its last visit's, and the step's delta merge keeps them exact)."""
        cw = plan.corpus
        k = self.hyper.num_topics
        z_key, state_key = split(key)
        retained = self._retained.get(window.uid) if self._retain else None
        if retained is None:
            z0 = window_topics(z_key, window, k, self.device)
        else:
            z0 = torch.from_numpy(np.asarray(retained, np.int32)).to(
                self.device)
        w, d, z = cw.word.long(), cw.doc.long(), z0.long()
        ones = torch.ones(cw.num_tokens, dtype=torch.int32,
                          device=self.device)
        n_kd = torch.zeros((cw.num_docs, k), dtype=torch.int32,
                           device=self.device).index_put_(
            (d, z), ones, accumulate=True)
        if retained is None:
            n_wk = self.n_wk.index_put((w, z), ones, accumulate=True)
            n_k = self.n_k.index_put((z,), ones, accumulate=True)
        else:
            n_wk, n_k = self.n_wk, self.n_k
        zeros = torch.zeros_like(z0)
        return CGSState(topic=z0, prev_topic=z0, n_wk=n_wk, n_kd=n_kd,
                        n_k=n_k, rng=state_key, iteration=0,
                        stale_iters=zeros, same_count=zeros.clone())

    def run_window(self, window: Window) -> Dict[str, Any]:
        """Sweep one window against the resident model, fold it in and
        retire its doc-side state. Returns the reference's metrics: the
        window's ``llh``/``perplexity`` under the swept counts,
        ``docs_per_sec`` over plan, compose and sweeps, and
        ``resident_kd_bytes`` (the window's doc-side counts)."""
        if self._base_key is None:
            self._base_key = as_key(0)
        cw = window.corpus
        k = self.hyper.num_topics
        key = fold_in(self._base_key, window.index)
        clock = _PhaseClock(self.device)
        if self.windows_done > 0:
            self._apply_decay()
        clock.mark("decay")
        t0 = time.perf_counter()
        plan = self._plan_for(window)
        clock.mark("plan")
        state = self._compose(window, plan, key)
        clock.mark("compose")
        for _ in range(self.cfg.window_sweeps):
            state = plan.step(state)
        clock.mark("sweeps")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        dt = t - t0
        ms = clock.ms()
        llh = plan.llh(state)
        t1 = time.perf_counter()
        ms["eval"] = (t1 - t) * 1e3
        change_rate = plan.change_rate(state)
        # retire: the model keeps only n_wk/n_k; doc-side state rolls
        self.n_wk, self.n_k = state.n_wk, state.n_k
        if self._retain:
            self._retained[window.uid] = state.topic.cpu().numpy()
        self.windows_done = window.index + 1
        self.docs_consumed += cw.num_docs
        ms["retire"] = (time.perf_counter() - t1) * 1e3
        self.timings = ms
        return {
            "window": window.index,
            "uid": window.uid,
            "docs": cw.num_docs,
            "tokens": cw.num_tokens,
            "llh": llh,
            "perplexity": math.exp(-llh / max(1, cw.num_tokens)),
            "change_rate": change_rate,
            "docs_per_sec": cw.num_docs / dt if dt > 0 else float("inf"),
            "resident_kd_bytes": int(cw.num_docs) * int(k) * 4,
        }

    # -- the loop ------------------------------------------------------------
    def run(self, rng=None,
            callback: Optional[Callable[["StreamingSession", Dict], None]]
            = None) -> CGSState:
        """Consume the source from the (possibly restored) cursor up to
        ``cfg.num_iterations`` windows (0 = until it ends), calling
        ``callback(session, metrics)`` after each. Returns
        :meth:`model_state`."""
        cfg = self.cfg
        if rng is not None:
            self._base_key = as_key(rng)
        elif self._base_key is None:
            self._base_key = as_key(0)
        self._maybe_restore()
        limit = cfg.num_iterations
        src_kwargs = {}
        if getattr(self.source, "supports_doc_resume", False):
            src_kwargs["start_docs"] = self.docs_consumed
        for window in self.source.windows(start=self.windows_done,
                                          **src_kwargs):
            if limit and window.index >= limit:
                break
            metrics = self.run_window(window)
            if callback is not None:
                callback(self, metrics)
            if self._ckpt is not None and cfg.train_checkpoint_every > 0 \
                    and self.windows_done % cfg.train_checkpoint_every == 0:
                self.save_stream_checkpoint()
            if cfg.checkpoint_dir and cfg.checkpoint_every > 0 \
                    and self.windows_done % cfg.checkpoint_every == 0:
                self.save_model()
        if cfg.checkpoint_dir and self._last_model_save != self.windows_done:
            self.save_model()
        if self._ckpt is not None:
            self.save_stream_checkpoint()
        return self.model_state()

    # -- model surfaces ------------------------------------------------------
    def model_state(self) -> CGSState:
        """The resident model as a state with ``n_wk``/``n_k`` and empty
        doc-side fields."""
        empty = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return CGSState(
            topic=empty, prev_topic=empty, n_wk=self.n_wk,
            n_kd=torch.zeros((0, self.hyper.num_topics), dtype=torch.int32,
                             device=self.device),
            n_k=self.n_k,
            rng=self._base_key if self._base_key is not None
            else as_key(0),
            iteration=self.windows_done,
        )

    def save_model(self, directory: Optional[str] = None) -> str:
        """Write the model for serving, stamped with the window cursor as
        its step, in the reference's format."""
        from repro_torch.train.checkpoint import save_lda_model

        directory = directory or self.cfg.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory configured")
        path = save_lda_model(
            directory, self.n_wk.cpu().numpy(), self.n_k.cpu().numpy(),
            self.hyper, step=self.windows_done,
            extra_metadata={
                "algorithm": self.cfg.algorithm,
                "stream": True,
                "windows_done": self.windows_done,
                "decay": self.cfg.decay,
            },
        )
        self._last_model_save = self.windows_done
        return path

    # -- stream checkpoints --------------------------------------------------
    def save_stream_checkpoint(self) -> str:
        """Atomic mid-stream checkpoint: the counts, the window and
        document cursors, and every retained assignment array."""
        tree: Dict[str, Any] = {
            "n_wk": self.n_wk.cpu().numpy(),
            "n_k": self.n_k.cpu().numpy(),
            "cursor": np.asarray(self.windows_done, np.int64),
            "doc_cursor": np.asarray(self.docs_consumed, np.int64),
        }
        for uid, z in self._retained.items():
            tree[f"z:{uid}"] = z
        return self._ckpt.save(
            self.windows_done, tree,
            {"kind": _STREAM_KIND, "cursor": self.windows_done,
             "decay": self.cfg.decay},
        )

    def _maybe_restore(self) -> bool:
        if self._ckpt is None:
            return False
        got = self._ckpt.restore_latest_named()
        if got is None:
            return False
        named, meta, _step = got
        if meta.get("kind") != _STREAM_KIND:
            return False
        self.n_wk = torch.from_numpy(
            np.asarray(named["n_wk"], np.int32)).to(self.device)
        self.n_k = torch.from_numpy(
            np.asarray(named["n_k"], np.int32)).to(self.device)
        self.windows_done = int(named["cursor"])
        # a checkpoint without a document cursor: every window was full
        self.docs_consumed = int(named.get(
            "doc_cursor", self.windows_done * self.source.window_docs
        ))
        self._retained = {
            name[2:]: np.asarray(arr, np.int32)
            for name, arr in named.items() if name.startswith("z:")
        }
        return True

    # -- rotation-regime evaluation -------------------------------------------
    def assembled_state(self) -> CGSState:
        """The full-corpus state the retained per-window assignments make
        (rotation regime over a :class:`ReplaySource` only), counts built
        on the session's device."""
        if not isinstance(self.source, ReplaySource) or not self._retain:
            raise ValueError(
                "assembled_state() needs decay=0 over a ReplaySource "
                "(the rotation regime retains assignments)"
            )
        corpus = self.source.corpus
        z = np.zeros(corpus.num_tokens, np.int32)
        for s in range(self.source.windows_per_epoch):
            w = self.source.window_slice(s)
            if w.uid not in self._retained:
                raise ValueError(
                    f"window {w.uid} has no retained assignments yet "
                    f"(cursor {self.windows_done})"
                )
            z[w.token_index] = self._retained[w.uid]
        zt = torch.from_numpy(z).to(self.device)
        c = corpus.to(self.device)
        n_wk, n_kd, n_k = counts_lib.build_counts(
            c.word, c.doc, zt, c.num_words, c.num_docs,
            self.hyper.num_topics,
        )
        zeros = torch.zeros_like(zt)
        return CGSState(
            topic=zt, prev_topic=zt, n_wk=n_wk, n_kd=n_kd, n_k=n_k,
            rng=self._base_key if self._base_key is not None
            else as_key(0),
            iteration=self.windows_done,
            stale_iters=zeros, same_count=zeros.clone(),
        )

    def full_perplexity(self) -> float:
        """Whole-corpus perplexity of :meth:`assembled_state`."""
        state = self.assembled_state()
        corpus = self.source.corpus.to(self.device)
        llh = float(predictive_llh(state, corpus, self.hyper))
        return math.exp(-llh / corpus.num_tokens)
