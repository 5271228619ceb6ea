"""Multi-engine serving router (``repro/serving/router.py``): N
:class:`~repro_torch.serving.lda_engine.LDAEngine` replicas behind one
ticket namespace.

Sharding (``LDAServeConfig.mesh_shape``) spreads a single decode over
shards; the router spreads throughput over independent replicas, and
the two compose: each replica may be a sharded engine. The replicas share
one process (and, on one card, the card). The router owns

* **load-aware admission** — every submit goes to the replica with the
  least queued + in-flight work (``LDAEngine.load``), ties to the lowest
  replica, so routing is deterministic under equal load;
* **one ticket namespace** — router tickets are engine-agnostic ints; the
  ticket lifecycle (``poll``/``result``/``cancel``/``request``)
  delegates to the owning replica;
* **broadcast reload** — :meth:`reload` pushes a new model to every
  replica under one version tag, so ``model_version`` is coherent across
  the fleet, and each replica keeps its reload invariants (in-flight
  requests finish on their admitted version, nothing dropped);
  :meth:`watch_checkpoint_dir` drives it from one
  :class:`~repro_torch.serving.lda_engine.CheckpointWatcher`.

Replicas get distinct engine seeds, so auto-derived request keys differ
across replicas: two submits of one document may draw different chains
(same distribution). Callers that need routing-independent results pass
explicit per-request ``key``\\ s, as with a single engine.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.lda_engine import (
    CheckpointWatcher,
    FrozenLDAModel,
    InferRequest,
    LDAEngine,
    LDAServeConfig,
)


class LDARouter:
    """N engine replicas, one serving front (same call surface as
    :class:`LDAEngine`'s async API, plus the blocking ``infer_batch``)."""

    def __init__(self, model: FrozenLDAModel, cfg: LDAServeConfig,
                 replicas: int = 1, seed: int = 0):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        # distinct seeds: auto-derived request keys must differ between
        # replicas, or co-submitted identical docs would draw identical
        # chains and the fleet would under-sample the posterior
        self.engines: List[LDAEngine] = [
            LDAEngine(model, cfg, seed=seed + 1000 * i)
            for i in range(replicas)
        ]
        self.cfg = cfg
        self._lock = threading.RLock()
        self._tickets: Dict[int, Tuple[LDAEngine, int]] = {}
        self._next_ticket = 0
        self._watcher: Optional[CheckpointWatcher] = None
        # per-replica load records ride on replica 0's telemetry sink
        # (all replicas share one cfg, so one JSONL per fleet, not N);
        # None when observability is off — zero work on the submit path
        self._fleet_telemetry = self.engines[0]._telemetry
        self._load_emit_every = max(1, (cfg.autopilot_window or 64) // 2)
        self._submits = 0

    # -- fleet state -------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.engines)

    @property
    def model(self):
        """The model new admissions decode under (coherent across the
        fleet after any :meth:`reload`)."""
        return self.engines[0].model

    @property
    def model_version(self) -> int:
        return self.engines[0].model_version

    @property
    def docs_done(self) -> int:
        return sum(e.docs_done for e in self.engines)

    @property
    def sweeps_run(self) -> int:
        return sum(e.sweeps_run for e in self.engines)

    @property
    def loads(self) -> List[int]:
        """Per-replica queued + in-flight counts (admission snapshot)."""
        return [e.load for e in self.engines]

    def _least_loaded(self) -> LDAEngine:
        return min(self.engines, key=lambda e: e.load)

    # -- ticket lifecycle --------------------------------------------------
    def submit_async(self, words, **submit_kw) -> int:
        """Queue one document on the least-loaded replica; returns a
        router ticket (fleet-unique, engine-agnostic)."""
        with self._lock:
            engine = self._least_loaded()
            inner = engine.submit_async(words, **submit_kw)
            self._next_ticket += 1
            self._tickets[self._next_ticket] = (engine, inner)
            if self._fleet_telemetry is not None:
                self._submits += 1
                if self._submits % self._load_emit_every == 0:
                    self._fleet_telemetry.emit_router_loads(self.loads)
            return self._next_ticket

    def _route(self, ticket: int) -> Tuple[LDAEngine, int]:
        entry = self._tickets.get(ticket)
        if entry is None:
            raise KeyError(f"unknown or reaped router ticket {ticket}")
        return entry

    def poll(self, ticket: int) -> str:
        with self._lock:
            engine, inner = self._route(ticket)
        return engine.poll(inner)

    def result(self, ticket: int, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block on the owning replica's result; reaps the router ticket
        on success (a ``TimeoutError`` leaves it claimable, same contract
        as :meth:`LDAEngine.result`)."""
        with self._lock:
            engine, inner = self._route(ticket)
        theta = engine.result(inner, timeout=timeout)
        with self._lock:
            self._tickets.pop(ticket, None)
        return theta

    def cancel(self, ticket: int) -> bool:
        with self._lock:
            entry = self._tickets.pop(ticket, None)
        if entry is None:
            return False
        engine, inner = entry
        return engine.cancel(inner)

    def request(self, ticket: int) -> InferRequest:
        with self._lock:
            engine, inner = self._route(ticket)
        return engine.request(inner)

    def infer_batch(self, docs: Sequence, **submit_kw) -> np.ndarray:
        """Submit many documents across the fleet, return (N, K) thetas
        in submission order. Without background tickers each ``result``
        drives its owning replica's ticks itself."""
        tickets = [self.submit_async(d, **submit_kw) for d in docs]
        return np.stack([self.result(t) for t in tickets])

    # -- fleet control -----------------------------------------------------
    def reload(self, model: FrozenLDAModel,
               version: Optional[int] = None) -> int:
        """Broadcast a hot reload to every replica under one version tag.

        Each replica applies its own atomic swap (in-flight requests
        finish on the version their bucket pinned); the shared tag keeps
        ``model_version`` coherent fleet-wide even if replicas were
        constructed at different versions.
        """
        with self._lock:
            target = (max(e.model_version for e in self.engines) + 1
                      if version is None else int(version))
            for engine in self.engines:
                engine.reload(model, version=target)
            return target

    def start(self, tick_period: Optional[float] = None) -> None:
        for engine in self.engines:
            engine.start(tick_period)

    def stop(self) -> None:
        for engine in self.engines:
            engine.stop()

    def warm(self) -> None:
        """Warm every replica (one minimal document per bucket width)
        before traffic."""
        for engine in self.engines:
            engine.warm()

    def watch_checkpoint_dir(
        self,
        directory: str,
        period: float = 1.0,
        initial_step: Optional[int] = None,
        max_failures: int = 8,
    ) -> None:
        """One :class:`CheckpointWatcher` for the whole fleet: every new
        committed step broadcasts through :meth:`reload` (same failure
        policy as the engine's watcher)."""
        with self._lock:
            if self._watcher is not None and self._watcher.is_alive():
                return
            self._watcher = CheckpointWatcher(
                self.reload, directory, period=period,
                initial_step=initial_step, max_failures=max_failures,
                device=self.engines[0].device,
            ).start()

    @property
    def watch_error(self) -> Optional[Exception]:
        watcher = self._watcher
        return None if watcher is None else watcher.error

    def stop_watching(self) -> Optional[Exception]:
        watcher = self._watcher
        if watcher is None:
            return None
        err = watcher.stop()
        self._watcher = None
        return err
