"""Fault-tolerant training loop (``repro/train/loop.py``), for LM and LDA
training alike.

Production behaviors implemented:
  * periodic checksummed checkpoints + resume-from-latest on start
  * SIGTERM/SIGINT -> checkpoint-then-exit (preemption handling)
  * per-step retry with exponential backoff (transient failures); after
    ``max_retries`` the loop restores the last checkpoint and continues
    (node-failure path: a re-scheduled job does exactly this)
  * straggler mitigation hook: step-time EWMA + slow-step log

Checkpoints are the reference's format (``train.checkpoint``). A restore
hands ``restore_fn`` the tree ``checkpoint_tree_fn`` gives for the
current state, its leaves replaced by those of the newest valid
checkpoint as host (numpy) arrays, in the order the tree flattens.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.train.checkpoint import (
    CheckpointManager,
    _flatten,
    _unflatten,
)

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    num_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    max_retries: int = 3
    log_every: int = 10
    slow_step_factor: float = 2.0  # straggler flag: step > factor * ewma


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable[[Any], Any],  # state -> (state, metrics)
        loop_cfg: LoopConfig,
        checkpoint_tree_fn: Callable[[Any], Any] = lambda s: s,
        restore_fn: Optional[Callable[[Any, Any], Any]] = None,
        metadata_fn: Callable[[Any], Dict] = lambda s: {},
    ):
        self.step_fn = step_fn
        self.cfg = loop_cfg
        self.checkpoint_tree_fn = checkpoint_tree_fn
        self.restore_fn = restore_fn
        self.metadata_fn = metadata_fn
        self.manager = None
        if loop_cfg.checkpoint_dir:
            self.manager = CheckpointManager(loop_cfg.checkpoint_dir)
        self._stop = False

    def _install_signals(self):
        def handler(signum, frame):
            log.warning("signal %s: checkpoint-and-stop requested", signum)
            self._stop = True

        try:
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        except ValueError:
            pass  # not in main thread (tests)

    def _restore(self, state: Any) -> Optional[Tuple[Any, Dict, int]]:
        """(the state's checkpoint tree holding the newest valid
        checkpoint's leaves, its metadata, its step), or None."""
        got = self.manager.restore_latest()
        if got is None:
            return None
        named, meta, step = got
        target = self.checkpoint_tree_fn(state)
        n_target = len(_flatten(target)[0])
        if len(named) != n_target:
            raise ValueError(f"checkpoint step {step} holds {len(named)} "
                             f"leaves, the state's tree {n_target}")
        return _unflatten(target, list(named.values())), meta, step

    def maybe_restore(self, state: Any) -> tuple:
        """(state, start_step) — resume from the newest valid checkpoint."""
        if self.manager is None or self.restore_fn is None:
            return state, 0
        got = self._restore(state)
        if got is None:
            return state, 0
        restored_tree, meta, step = got
        log.info("resuming from checkpoint step %d", step)
        return self.restore_fn(state, restored_tree), step

    def run(self, state: Any) -> Any:
        self._install_signals()
        state, start = self.maybe_restore(state)
        ewma = None
        step = start
        while step < self.cfg.num_steps and not self._stop:
            t0 = time.time()
            retries = 0
            while True:
                try:
                    state, metrics = self.step_fn(state)
                    break
                except Exception as e:  # transient failure path
                    retries += 1
                    if retries > self.cfg.max_retries:
                        if self.manager is not None and self.restore_fn:
                            log.error(
                                "step %d failed %d times (%s); restoring "
                                "last checkpoint", step, retries, e,
                            )
                            got = self._restore(state)
                            if got is not None:
                                state = self.restore_fn(state, got[0])
                                step = got[2]
                                retries = 0
                                continue
                        raise
                    log.warning("step %d retry %d after %s", step, retries, e)
                    time.sleep(min(2.0 ** retries, 30.0))
            dt = time.time() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.cfg.slow_step_factor * ewma and step > start + 3:
                log.warning(
                    "straggling step %d: %.2fs vs ewma %.2fs", step, dt, ewma
                )
            step += 1
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                log.info("step %d metrics %s (%.3fs)", step, metrics, dt)
            if (
                self.manager is not None
                and self.cfg.checkpoint_every
                and step % self.cfg.checkpoint_every == 0
            ):
                self.manager.save(
                    step, self.checkpoint_tree_fn(state),
                    self.metadata_fn(state),
                )
        if self._stop and self.manager is not None:
            self.manager.save(
                step, self.checkpoint_tree_fn(state), self.metadata_fn(state)
            )
        return state
