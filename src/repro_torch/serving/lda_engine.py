"""Batched topic-inference serving over a frozen trained model
(``repro/serving/lda_engine.py``).

The engine packs incoming documents into length-bucketed padded slot
batches (one fixed-shape batch per bucket width, on the model's device)
and decodes them in one of two plans:

* ``mode="throughput"`` — continuously admitting chain CGS sweeps through
  the registry backend's ``infer_sweep``: one sweep per non-empty bucket
  per step; finished slots refill from the queue every step;
* ``mode="latency"`` — RT-LDA: one deterministic decode
  (``core.inference.rtlda_assign`` over the bucket's slots) per non-empty
  bucket per tick; every admitted request finishes in that tick.

Both are fronted by the async ticket API (:meth:`LDAEngine.submit_async`,
:meth:`~LDAEngine.poll`, :meth:`~LDAEngine.result`) and an optional
background ticker (:meth:`~LDAEngine.start`).

Hot reload: :meth:`LDAEngine.reload` swaps in a new model between ticks.
Each model version is a slot (the model, its backend tables, its alpha_k
and its version tag); a bucket pins the slot current when a request lands
in it empty, admits only requests of that version while occupied, and
decodes (counts, tables, alpha_k) on the pinned slot until it drains, so
every request finishes on the model it was admitted under
(``InferRequest.model_version``) and nothing is dropped. Versions strictly
increase. :meth:`LDAEngine.watch_checkpoint_dir` runs a
:class:`CheckpointWatcher` thread that polls a model checkpoint directory
and reloads every newer committed step: it builds the new
:class:`FrozenLDAModel` on the engine's device and the slot (for
``zen_cdf`` a (W, K) CDF) before it takes the engine lock, so the ticker
keeps sweeping meanwhile; the version check and the swap happen under
the lock. A directory with nothing committed is waited on; a committed
checkpoint that fails to load is retried ``max_failures`` times and then
surfaced on :attr:`LDAEngine.watch_error`.

Randomness (throughput mode) is counter-based (``core.keys``): a request's
key is derived from the engine seed and its uid unless the caller passes
one, its initial topics and each sweep's draws hash from that key and the
token position. A slot's draws therefore depend only on its own key, are
prefix-stable in the bucket width and independent of batch composition;
with the default dense backend and cdf sampling a served theta is
bit-equal to ``core.inference.cgs_infer`` under the same key. Latency mode
is deterministic and gives the reference's assignments.

Telemetry and the autopilot (``metrics_out``, ``autopilot``,
``autopilot_window``) exist only when a config enables them. A
``ServeTelemetry`` then stamps every submission and admission tick and
closes a ``serve_window`` record every ``autopilot_window`` arrivals (or
4x as many ticks); a ``ServeAutopilot`` turns each closed window into new
knobs under the engine lock: ``tick_period`` and ``max_slot_wait`` apply
from the next tick, a new bucket grid only once every bucket has drained,
so no bucket is reshaped while it decodes, for a reload or otherwise; new
buckets pin the current model slot at their first admission.

Sharded serving: ``mesh_shape = (1, m)`` lays the frozen word rows over
m shards (``serving.sharded``: one process, the blocks on the engine's
device) and runs every bucket sweep as m per-shard sweeps whose owned
draws are summed; thetas equal the unsharded engine's bit for bit.
Latency mode does not shard, and a data dimension other than 1 is
refused: replicas come from the router (``serving.router.LDARouter``).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import algorithms
from repro_torch.algorithms import SamplerKnobs
from repro_torch.core.inference import rtlda_assign
from repro_torch.core.keys import as_key, fold_in, init_topics, key_from_seed
from repro_torch.core.types import LDAHyperParams
from repro_torch.device import resolve_device
from repro_torch.observe.metrics import latency_percentile  # noqa: F401
from repro_torch.serving.sharded import (
    ShardedFrozenLDAModel,
    layout_key,
    make_sharded_sweep_fn,
    sharded_prepare_infer,
)

logger = logging.getLogger(__name__)


def _hyper(hyper) -> LDAHyperParams:
    """The port's hyper-parameters from either package's dataclass or the
    dict a checkpoint stores."""
    if isinstance(hyper, LDAHyperParams):
        return hyper
    if dataclasses.is_dataclass(hyper):
        hyper = dataclasses.asdict(hyper)
    return LDAHyperParams(**hyper)


@dataclasses.dataclass(frozen=True)
class FrozenLDAModel:
    """A trained LDA model frozen for serving: ``n_wk`` (W, K) and ``n_k``
    (K,) int32 tensors on one device, plus the training hyper-parameters.
    Build one with :meth:`from_numpy` or :meth:`from_checkpoint`."""

    n_wk: torch.Tensor
    n_k: torch.Tensor
    hyper: LDAHyperParams

    @property
    def num_words(self) -> int:
        return int(self.n_wk.shape[0])

    @property
    def num_topics(self) -> int:
        return int(self.n_wk.shape[1])

    @property
    def device(self) -> torch.device:
        return self.n_wk.device

    def phi(self) -> torch.Tensor:
        """Smoothed topic-word distributions, (W, K) column-normalised."""
        w_beta = self.num_words * self.hyper.beta
        return (self.n_wk.to(torch.float32) + self.hyper.beta) / (
            self.n_k.to(torch.float32) + w_beta
        )[None, :]

    @classmethod
    def from_numpy(cls, n_wk, n_k, hyper, device=None) -> "FrozenLDAModel":
        """A model from host count arrays. ``hyper`` is an
        ``LDAHyperParams`` of either package or the dict a checkpoint
        stores; ``device`` defaults to ``cuda``."""
        dev = resolve_device(device)
        return cls(
            n_wk=torch.as_tensor(np.asarray(n_wk, np.int32)).to(dev),
            n_k=torch.as_tensor(np.asarray(n_k, np.int32)).to(dev),
            hyper=_hyper(hyper),
        )

    @classmethod
    def from_checkpoint(cls, directory: str,
                        device=None) -> "FrozenLDAModel":
        """The newest committed model checkpoint under ``directory``,
        written by either package's ``save_lda_model``."""
        from repro_torch.train.checkpoint import load_lda_model

        n_wk, n_k, hyper, _meta, _step = load_lda_model(directory)
        return cls.from_numpy(n_wk, n_k, hyper, device=device)


@dataclasses.dataclass(frozen=True)
class LDAServeConfig:
    """Engine knobs; the same fields and JSON as the reference's, so one
    file configures both packages. ``mesh_shape`` ``(1, m)`` shards the
    word rows (throughput mode only). ``metrics_out`` (telemetry JSONL path),
    ``autopilot`` and ``autopilot_window`` (arrivals per decision window,
    0 = 64) are inert at their defaults."""

    buckets: Tuple[int, ...] = (32, 64, 128, 256)
    max_batch: int = 32  # slots per bucket
    num_sweeps: int = 10
    burn_in: int = -1  # < 0 => final-sweep theta (oracle-compatible)
    thin: int = 1
    algorithm: str = "zen"  # any algorithms.registered() name
    sampling_method: str = "cdf"  # cdf | gumbel (dense default path)
    max_kd: int = 0
    mode: str = "throughput"  # throughput | latency (RT-LDA)
    rtlda_sweeps: int = 2
    tick_period: float = 0.0  # background ticker cadence, s (0 = 1 ms)
    max_slot_wait: int = 0  # ticks before bucket spill (0 = never spill)
    kernels: str = "auto"  # kernel policy: auto | on | off
    mesh_shape: Optional[Tuple[int, int]] = None
    metrics_out: Optional[str] = None
    autopilot: bool = False
    autopilot_window: int = 0

    def knobs(self) -> SamplerKnobs:
        return SamplerKnobs(
            sampling_method=self.sampling_method, max_kd=self.max_kd,
            kernels=self.kernels,
        )

    def to_json(self, indent: Optional[int] = 2) -> str:
        d = dataclasses.asdict(self)
        d["buckets"] = list(d["buckets"])
        if d["mesh_shape"] is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        return json.dumps(d, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "LDAServeConfig":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown LDAServeConfig fields: {', '.join(unknown)}"
            )
        if d.get("buckets") is not None:
            d["buckets"] = tuple(int(x) for x in d["buckets"])
        if d.get("mesh_shape") is not None:
            d["mesh_shape"] = tuple(int(x) for x in d["mesh_shape"])
        return cls(**d)


@dataclasses.dataclass
class InferRequest:
    """One in-flight (or finished) serving request; ``theta`` (K,) once
    ``done``, ``z`` the final assignments in latency mode, ``t_submit`` /
    ``t_done`` ``time.monotonic`` stamps, ``model_version`` the version of
    the model it decoded under (stamped at admission, or at submit for an
    instant completion; -1 until then)."""

    uid: int
    words: np.ndarray
    key: Optional[torch.Tensor]  # (2,) key words (throughput mode)
    num_sweeps: int
    burn_in: int
    thin: int
    orig_len: int = 0
    truncated: bool = False
    dropped_unknown: int = 0
    theta: Optional[np.ndarray] = None
    done: bool = False
    admitted: bool = False
    ticks_waited: int = 0
    model_version: int = -1
    t_submit: float = 0.0
    t_done: float = 0.0
    sweeps_done: int = 0
    theta_sum: Optional[np.ndarray] = None
    theta_samples: int = 0
    z: Optional[np.ndarray] = None


@dataclasses.dataclass
class _ModelSlot:
    """One servable model version: the frozen model, the backend's tables
    (``aux``), its alpha_k on the host and its version tag. A bucket
    holds the slot it was pinned to until it drains, so an old version
    lives exactly as long as its in-flight requests."""

    model: FrozenLDAModel
    aux: Any
    alpha_k: np.ndarray
    version: int
    # a sharded slot's sweep function (every bucket width), built at first
    # use; shared across reloads that keep the hyper-parameters and the
    # layout (``layout_key``)
    sweep_fn: Optional[Callable[..., torch.Tensor]] = None


class _Bucket:
    """One fixed-shape slot batch: the device state for bucket width L.
    ``slot_model`` is the model slot its occupants decode under: set when
    a request is placed into the empty bucket, fixed while any slot is
    active."""

    def __init__(self, length: int, slots: int, num_topics: int,
                 device: torch.device):
        self.length = length
        i32 = torch.int32
        self.words = torch.zeros((slots, length), dtype=i32, device=device)
        self.mask = torch.zeros((slots, length), dtype=torch.bool,
                                device=device)
        self.z = torch.zeros((slots, length), dtype=i32, device=device)
        self.n_kd = torch.zeros((slots, num_topics), dtype=i32,
                                device=device)
        self.active: List[Optional[InferRequest]] = [None] * slots
        self.slot_model: Optional[_ModelSlot] = None

    def free_slot(self) -> Optional[int]:
        for s, r in enumerate(self.active):
            if r is None:
                return s
        return None

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.active)


class CheckpointWatcher:
    """Poll a model checkpoint directory and pass every newer committed
    step to ``reload_fn`` as a :class:`FrozenLDAModel` built on ``device``
    (default ``cuda``).

    Failure policy: a load failure is benign only while nothing is
    committed (``FileNotFoundError`` and no committed step: the trainer
    has not written one yet). Any other failure, such as a committed step
    that does not load, counts against ``max_failures`` consecutive
    attempts, each logged; then the watcher stops. The last error stays
    on :attr:`error` and :meth:`stop` returns it; a good load clears it."""

    def __init__(self, reload_fn: Callable[[FrozenLDAModel], Any],
                 directory: str, period: float = 1.0,
                 initial_step: Optional[int] = None, max_failures: int = 8,
                 device=None):
        self.reload_fn = reload_fn
        self.directory = directory
        self.period = period
        self.max_failures = max_failures
        self.device = resolve_device(device)
        self.error: Optional[Exception] = None
        self.failures = 0  # consecutive
        self.last_step = initial_step
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="lda-ckpt-watcher", daemon=True
        )

    def start(self) -> "CheckpointWatcher":
        self._thread.start()
        return self

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> Optional[Exception]:
        """Stop polling; returns the last load error (None = healthy)."""
        self._stop.set()
        self._thread.join()
        return self.error

    def _loop(self) -> None:
        from repro_torch.train.checkpoint import (
            committed_steps,
            load_lda_model,
        )

        while not self._stop.is_set():
            try:
                n_wk, n_k, hyper, _meta, step = load_lda_model(
                    self.directory)
            except (OSError, ValueError, KeyError) as exc:
                if (isinstance(exc, FileNotFoundError)
                        and not committed_steps(self.directory)):
                    self.failures = 0  # nothing committed yet: wait
                else:
                    self.failures += 1
                    self.error = exc
                    logger.warning(
                        "checkpoint watch of %r: load failed (%d/%d): %s",
                        self.directory, self.failures, self.max_failures,
                        exc,
                    )
                    if self.failures >= self.max_failures:
                        logger.warning(
                            "checkpoint watch of %r: giving up after %d "
                            "consecutive failures",
                            self.directory, self.failures,
                        )
                        return
                self._stop.wait(self.period)
                continue
            self.failures = 0
            self.error = None
            if self.last_step is None or step > self.last_step:
                self.reload_fn(FrozenLDAModel.from_numpy(
                    n_wk, n_k, hyper, device=self.device))
                self.last_step = step
            self._stop.wait(self.period)


class LDAEngine:
    """Continuously admitting batched frozen-model inference.

    Blocking batches (:meth:`infer_batch`) and async tickets
    (:meth:`submit_async` / :meth:`poll` / :meth:`result`) share one
    bucketed packer. All public methods are thread-safe (one lock)."""

    def __init__(self, model: FrozenLDAModel, cfg: LDAServeConfig,
                 seed: int = 0):
        if not cfg.buckets:
            raise ValueError("need at least one bucket length")
        if cfg.mode not in ("throughput", "latency"):
            raise ValueError(f"unknown serve mode {cfg.mode!r}")
        self.cfg = cfg
        self.device = model.device
        self._mesh = None
        if cfg.mesh_shape is not None:
            if cfg.mode == "latency":
                raise ValueError(
                    "latency mode (RT-LDA) does not shard: drop "
                    "mesh_shape or serve mode='throughput'")
            if len(cfg.mesh_shape) != 2 or cfg.mesh_shape[0] != 1:
                raise ValueError(
                    f"serving mesh_shape must be (1, m) — word rows shard "
                    f"over the model axis, replicas come from the router "
                    f"— got {cfg.mesh_shape!r}")
            from repro_torch.launch.mesh import make_mesh

            m = int(cfg.mesh_shape[1])
            self._mesh = make_mesh((1, m), ("data", "model"),
                                   devices=[self.device] * m)
        self.backend = algorithms.get(cfg.algorithm)
        self._knobs = cfg.knobs()
        self._current = self._build_slot(model, version=0)
        self._buckets = {
            length: _Bucket(length, cfg.max_batch, model.num_topics,
                            self.device)
            for length in sorted(cfg.buckets)
        }
        self._base_key = key_from_seed(seed)
        self.queue: List[InferRequest] = []
        self._instant: List[InferRequest] = []  # done at submit
        self._uid = 0
        self.docs_done = 0
        self.sweeps_run = 0  # bucket sweeps/decodes executed
        self.spills = 0  # max_slot_wait admissions into wider buckets
        self.reloads = 0
        # runtime knobs: seeded from cfg (the requested setup), retuned in
        # place by the autopilot
        self._tick_period = cfg.tick_period or 0.001
        self._max_slot_wait = cfg.max_slot_wait
        self._pending_buckets: Optional[Tuple[int, ...]] = None
        self._telemetry = None
        self._autopilot = None
        if cfg.metrics_out or cfg.autopilot:
            from repro_torch.observe import (
                JsonlSink,
                MetricsRegistry,
                ServeTelemetry,
            )

            sink = JsonlSink(cfg.metrics_out) if cfg.metrics_out else None
            arrivals = cfg.autopilot_window or 64
            self._telemetry = ServeTelemetry(
                MetricsRegistry(sink),
                window_ticks=max(8, 4 * arrivals),
                window_arrivals=arrivals,
            )
        if cfg.autopilot:
            from repro_torch.autotune import ServeAutopilot

            self._autopilot = ServeAutopilot()
        self._tickets: Dict[int, InferRequest] = {}
        self._cv = threading.Condition(threading.RLock())
        self._ticker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._watcher: Optional[CheckpointWatcher] = None

    # -- model slots and hot reload ----------------------------------------
    @property
    def model(self) -> FrozenLDAModel:
        """The model new admissions decode under (in-flight buckets may
        still be finishing an older version)."""
        return self._current.model

    @property
    def model_version(self) -> int:
        """Version of the current slot: 0 at construction, raised by every
        :meth:`reload`."""
        return self._current.version

    @property
    def _alpha_k(self) -> np.ndarray:
        return self._current.alpha_k

    def _build_slot(self, model: FrozenLDAModel,
                    version: int = -1) -> _ModelSlot:
        if model.device != self.device:
            model = FrozenLDAModel(n_wk=model.n_wk.to(self.device),
                                   n_k=model.n_k.to(self.device),
                                   hyper=model.hyper)
        if self._mesh is not None and not isinstance(
                model, ShardedFrozenLDAModel):
            model = ShardedFrozenLDAModel.shard(model, self._mesh)
        # latency mode never runs backend sweeps: no tables
        if self.cfg.mode == "latency":
            aux = None
        elif isinstance(model, ShardedFrozenLDAModel):
            aux = sharded_prepare_infer(self.backend, model, self._knobs)
        else:
            aux = self.backend.prepare_infer(model.n_wk, model.n_k,
                                             model.hyper, self._knobs)
        return _ModelSlot(
            model=model, aux=aux,
            alpha_k=model.hyper.alpha_k(model.n_k).cpu().numpy(),
            version=version,
        )

    def _sweep_fn(self, slot: _ModelSlot):
        """A sharded slot's sweep function."""
        if slot.sweep_fn is None:
            slot.sweep_fn = make_sharded_sweep_fn(self.backend, self._knobs,
                                                  slot.model)
        return slot.sweep_fn

    def _next_version(self, version: Optional[int]) -> int:
        new_version = (self._current.version + 1 if version is None
                       else int(version))
        if new_version <= self._current.version:
            raise ValueError(f"model version must increase: {new_version} "
                             f"<= {self._current.version}")
        return new_version

    def reload(self, model: FrozenLDAModel,
               version: Optional[int] = None) -> int:
        """Swap in ``model`` for new admissions; returns its version
        (``version``, which must exceed the current one, or current + 1).

        In-flight requests finish on the slot their bucket pinned; a
        bucket serves the new version once it drains. The new slot (the
        backend's tables) is built before the engine lock is taken, so a
        running ticker is not held up by it; the version check and the
        swap happen under the lock."""
        with self._cv:
            self._next_version(version)  # refuse early, before the build
        slot = self._build_slot(model)
        with self._cv:
            slot.version = self._next_version(version)
            cur = self._current
            if (cur.model.hyper == slot.model.hyper
                    and layout_key(cur.model) == layout_key(slot.model)):
                slot.sweep_fn = cur.sweep_fn
            self._current = slot
            self.reloads += 1
            return slot.version

    def watch_checkpoint_dir(self, directory: str, period: float = 1.0,
                             initial_step: Optional[int] = None,
                             max_failures: int = 8) -> None:
        """Poll ``directory`` every ``period`` seconds and :meth:`reload`
        every committed model checkpoint newer than the last one seen
        (``initial_step``: the step already served). See
        :class:`CheckpointWatcher` for the failure policy. Idempotent
        while a watcher runs; stop it with :meth:`stop_watching`."""
        with self._cv:
            if self._watcher is not None and self._watcher.is_alive():
                return
            self._watcher = CheckpointWatcher(
                self.reload, directory, period=period,
                initial_step=initial_step, max_failures=max_failures,
                device=self.device,
            ).start()

    @property
    def watch_error(self) -> Optional[Exception]:
        """The watcher's last load error (None: healthy, or no watcher).
        With a dead watcher it means the watcher gave up; the engine keeps
        serving its current model."""
        watcher = self._watcher
        return None if watcher is None else watcher.error

    def stop_watching(self) -> Optional[Exception]:
        """Stop the checkpoint watcher (no-op without one); returns its
        last load error."""
        watcher = self._watcher
        if watcher is None:
            return None
        err = watcher.stop()
        self._watcher = None
        return err

    # -- request intake ----------------------------------------------------
    def submit(self, words, key=None, num_sweeps: Optional[int] = None,
               burn_in: Optional[int] = None,
               thin: Optional[int] = None) -> int:
        """Queue one document; returns its uid.

        Unknown ids (outside ``[0, W)``) are dropped, documents longer than
        the widest bucket truncated, and an empty document completes at
        once with the normalised prior. ``key`` (an int seed or two uint32
        words) fixes the request's chain; by default it derives from the
        engine seed and the uid. Latency mode ignores ``key``,
        ``num_sweeps``, ``burn_in`` and ``thin``. Results go to whoever
        calls :meth:`step`; use :meth:`submit_async` when a ticker runs.
        """
        with self._cv:
            return self._submit(words, key, num_sweeps, burn_in, thin).uid

    def submit_async(self, words, key=None, num_sweeps: Optional[int] = None,
                     burn_in: Optional[int] = None,
                     thin: Optional[int] = None) -> int:
        """Queue one document and return a ticket for :meth:`poll` /
        :meth:`result` at once; same arguments as :meth:`submit`."""
        with self._cv:
            req = self._submit(words, key, num_sweeps, burn_in, thin)
            self._tickets[req.uid] = req
            return req.uid

    def _submit(self, words, key, num_sweeps, burn_in, thin) -> InferRequest:
        self._uid += 1
        raw = np.asarray(words, np.int32).ravel()
        known = raw[(raw >= 0) & (raw < self.model.num_words)]
        max_len = max(self._buckets)
        latency = self.cfg.mode == "latency"
        req = InferRequest(
            uid=self._uid,
            words=known[:max_len],
            key=None if latency else (
                as_key(key) if key is not None
                else fold_in(self._base_key, self._uid)
            ),
            num_sweeps=self.cfg.rtlda_sweeps if latency
            else (self.cfg.num_sweeps if num_sweeps is None else num_sweeps),
            burn_in=-1 if latency
            else (self.cfg.burn_in if burn_in is None else burn_in),
            thin=1 if latency
            else max(1, self.cfg.thin if thin is None else thin),
            orig_len=int(raw.shape[0]),
            truncated=known.shape[0] > max_len,
            dropped_unknown=int(raw.shape[0] - known.shape[0]),
            t_submit=time.monotonic(),
        )
        k = self.model.num_topics
        if req.words.shape[0] == 0:
            req.model_version = self._current.version
            req.theta = self._alpha_k / self._alpha_k.sum()
            self._complete(req)
            self._instant.append(req)
        elif not latency and req.num_sweeps <= 0:
            # zero sweeps: theta straight from the initial assignment
            req.model_version = self._current.version
            z0 = init_topics(req.key, req.words.shape[0], k).numpy()
            req.theta = self._theta(
                req, np.bincount(z0, minlength=k).astype(np.int32),
                self._alpha_k)
            self._complete(req)
            self._instant.append(req)
        else:
            self.queue.append(req)
        if self._telemetry is not None:
            self._telemetry.record_submit(req.t_submit,
                                          int(req.words.shape[0]))
        return req

    def _complete(self, req: InferRequest) -> None:
        req.done = True
        req.t_done = time.monotonic()
        self.docs_done += 1

    # -- the async ticket lifecycle ----------------------------------------
    def poll(self, ticket: int) -> str:
        """``"queued"``, ``"admitted"`` or ``"done"``; ``KeyError`` for an
        unknown or reaped ticket."""
        with self._cv:
            req = self._tickets.get(ticket)
            if req is None:
                raise KeyError(f"unknown or reaped ticket {ticket}")
            if req.done:
                return "done"
            return "admitted" if req.admitted else "queued"

    def result(self, ticket: int,
               timeout: Optional[float] = None) -> np.ndarray:
        """Block until a ticket's theta is ready, return it and reap the
        ticket. Without a running ticker the caller drives the ticks.
        Raises ``KeyError`` (unknown/reaped) or ``TimeoutError`` (the
        ticket stays claimable)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            req = self._tickets.get(ticket)
            if req is None:
                raise KeyError(f"unknown or reaped ticket {ticket}")
            while not req.done:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"ticket {ticket} not done within {timeout}s"
                    )
                if self._ticker is not None and self._ticker.is_alive():
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    self._cv.wait(0.05 if remaining is None
                                  else min(remaining, 0.05))
                else:
                    self.step()
            del self._tickets[ticket]
            return req.theta

    def cancel(self, ticket: int) -> bool:
        """Abandon a ticket: drop it from the queue or evacuate its slot.
        True if the ticket existed; never raises."""
        with self._cv:
            req = self._tickets.pop(ticket, None)
            if req is None:
                return False
            if req.done:
                return True
            if req.admitted:
                for bucket in self._buckets.values():
                    for slot, r in enumerate(bucket.active):
                        if r is req:
                            bucket.active[slot] = None
                            bucket.mask[slot] = False
                            return True
            else:
                self.queue = [r for r in self.queue if r.uid != ticket]
            return True

    def request(self, ticket: int) -> InferRequest:
        """The live :class:`InferRequest` behind an un-reaped ticket."""
        with self._cv:
            req = self._tickets.get(ticket)
            if req is None:
                raise KeyError(f"unknown or reaped ticket {ticket}")
            return req

    # -- background ticker -------------------------------------------------
    def start(self, tick_period: Optional[float] = None) -> None:
        """Start the background admission ticker (idempotent)."""
        with self._cv:
            if self._ticker is not None and self._ticker.is_alive():
                return
            if tick_period is not None:
                self._tick_period = tick_period
            self._stop_evt = threading.Event()

            def loop():
                # the period is re-read every iteration: the autopilot
                # retunes it in place
                while not self._stop_evt.is_set():
                    with self._cv:
                        if self._pending():
                            self.step()
                    self._stop_evt.wait(self._tick_period)

            self._ticker = threading.Thread(
                target=loop, name="lda-engine-ticker", daemon=True
            )
            self._ticker.start()

    def stop(self) -> None:
        """Stop the background ticker (no-op if it is not running)."""
        ticker = self._ticker
        if ticker is None:
            return
        self._stop_evt.set()
        ticker.join()
        self._ticker = None

    def _pending(self) -> bool:
        return bool(
            self.queue or self._instant
            or any(b.num_active for b in self._buckets.values())
        )

    @property
    def load(self) -> int:
        """Queued plus in-flight requests: the admission pressure
        ``serving.router.LDARouter`` balances replicas on."""
        with self._cv:
            return len(self.queue) + sum(
                b.num_active for b in self._buckets.values())

    def warm(self) -> None:
        """Run one minimal document per bucket width before traffic, so
        first requests pay no kernel build or allocator warm-up."""
        self.infer_batch([np.zeros(bl, np.int32) for bl in self.bucket_widths])

    # -- runtime SLA knobs (autopilot-visible) --------------------------------
    @property
    def tick_period(self) -> float:
        """The current ticker cadence (cfg seed, autopilot-retuned)."""
        return self._tick_period

    @property
    def max_slot_wait(self) -> int:
        """The current bucket-spill knob (cfg seed, autopilot-retuned)."""
        return self._max_slot_wait

    @property
    def bucket_widths(self) -> Tuple[int, ...]:
        """The current bucket lengths, ascending."""
        return tuple(sorted(self._buckets))

    def _apply_pending_buckets(self) -> None:
        """Swap in an autopilot-proposed bucket grid once every bucket has
        drained, so no slot state is reshaped under a running decode (nor
        under a bucket still finishing a reloaded-away model). Queued
        requests survive: they re-bucket at the next admission, and
        over-long ones truncate to the new widest."""
        if self._pending_buckets is None:
            return
        if any(b.num_active for b in self._buckets.values()):
            return
        widths = self._pending_buckets
        self._pending_buckets = None
        k = self._current.model.num_topics
        self._buckets = {
            length: _Bucket(length, self.cfg.max_batch, k, self.device)
            for length in sorted(widths)
        }
        max_len = max(self._buckets)
        for req in self.queue:
            if req.words.shape[0] > max_len:
                req.words = req.words[:max_len]
                req.truncated = True

    def _observe_tick(self, finished: List[InferRequest]) -> None:
        """Measure this tick; when it closes a telemetry window, let the
        autopilot derive new knobs from the window's summary (period and
        spill at once, buckets at the next full drain). Under the lock,
        from :meth:`step`."""
        summary = self._telemetry.record_tick(
            queue_depth=len(self.queue),
            occupancy=sum(b.num_active for b in self._buckets.values()),
            finished=finished,
            spills_total=self.spills,
            tick_period=self._tick_period,
            max_slot_wait=self._max_slot_wait,
            bucket_widths=self.bucket_widths,
            model_version=self._current.version,
        )
        if summary is None or self._autopilot is None:
            return
        decision = self._autopilot.decide(
            summary,
            tick_period=self._tick_period,
            max_slot_wait=self._max_slot_wait,
            buckets=self.bucket_widths,
        )
        if decision is None:
            return
        applied = False
        if decision.tick_period is not None:
            self._tick_period = float(decision.tick_period)
            applied = True
        if decision.max_slot_wait is not None:
            self._max_slot_wait = int(decision.max_slot_wait)
            applied = True
        if (decision.buckets is not None
                and tuple(sorted(decision.buckets)) != self.bucket_widths):
            self._pending_buckets = tuple(sorted(decision.buckets))
            applied = True
        rec = decision.to_record()
        rec["applied"] = applied
        self._telemetry.emit_decision(rec)

    # -- admission ---------------------------------------------------------
    def _bucket_for(self, length: int) -> _Bucket:
        for bl in sorted(self._buckets):
            if length <= bl:
                return self._buckets[bl]
        return self._buckets[max(self._buckets)]

    def _admittable(self, bucket: _Bucket) -> Optional[int]:
        """A free slot of ``bucket`` a request may take now: a drained
        bucket always (it pins the current model at placement), an
        occupied one only while it decodes the current version. The
        identity test comes first: it is all a step pays between reloads
        (``num_active`` walks every slot)."""
        if bucket.slot_model is not self._current and bucket.num_active:
            return None
        return bucket.free_slot()

    def _admit(self) -> None:
        still_queued = []
        for req in self.queue:
            bucket = self._bucket_for(req.words.shape[0])
            slot = self._admittable(bucket)
            if slot is None and self._max_slot_wait > 0 \
                    and req.ticks_waited >= self._max_slot_wait:
                # SLA spill: take any wider free slot
                for bl in sorted(self._buckets):
                    wider = self._buckets[bl]
                    if bl <= bucket.length or bl < req.words.shape[0]:
                        continue
                    s = self._admittable(wider)
                    if s is not None:
                        bucket, slot = wider, s
                        self.spills += 1
                        break
            if slot is None:
                req.ticks_waited += 1
                still_queued.append(req)
                continue
            self._place(req, bucket, slot)
        self.queue = still_queued

    def _place(self, req: InferRequest, bucket: _Bucket, slot: int) -> None:
        if bucket.slot_model is not self._current:
            # only a drained bucket gets here (``_admittable``): it pins
            # the current model; if K changed across a reload, its
            # doc-topic state takes the new shape
            bucket.slot_model = self._current
            k_now = self._current.model.num_topics
            if bucket.n_kd.shape[1] != k_now:
                bucket.n_kd = torch.zeros(
                    (bucket.n_kd.shape[0], k_now), dtype=torch.int32,
                    device=self.device)
        l, k = bucket.length, bucket.slot_model.model.num_topics
        n = req.words.shape[0]
        words = torch.zeros(l, dtype=torch.int32)
        placed = bucket.slot_model.model
        if isinstance(placed, ShardedFrozenLDAModel):
            # shard-space rows, mapped at placement: a request admitted
            # after a reload relabels through the new model's permutation
            words[:n] = torch.from_numpy(placed.relabel(req.words))
        else:
            words[:n] = torch.from_numpy(req.words)
        bucket.words[slot] = words.to(self.device)
        bucket.mask[slot] = False
        bucket.mask[slot, :n] = True
        bucket.active[slot] = req
        req.admitted = True
        req.model_version = bucket.slot_model.version
        if self.cfg.mode == "latency":
            return  # RT-LDA keeps no chain state
        z0 = init_topics(req.key, l, k)  # prefix-stable in l
        bucket.z[slot] = z0.to(self.device)
        bucket.n_kd[slot] = torch.bincount(
            z0[:n].long(), minlength=k).to(torch.int32).to(self.device)

    # -- stepping ----------------------------------------------------------
    def step(self) -> List[InferRequest]:
        """Run one admission tick; return the requests it finished."""
        with self._cv:
            self._apply_pending_buckets()
            finished = (self._latency_step() if self.cfg.mode == "latency"
                        else self._throughput_step())
            if self._telemetry is not None:
                self._observe_tick(finished)
            if finished and self._tickets:
                self._cv.notify_all()
            return finished

    def _latency_step(self) -> List[InferRequest]:
        self._admit()
        finished, self._instant = self._instant, []
        for bucket in self._buckets.values():
            if bucket.num_active == 0:
                continue
            m = bucket.slot_model.model  # pinned: the admitted model
            z, n_kd = rtlda_assign(m.n_wk, m.n_k, bucket.words, bucket.mask,
                                   m.hyper, self.cfg.rtlda_sweeps)
            self.sweeps_run += 1
            z_host, n_kd_host = z.cpu().numpy(), n_kd.cpu().numpy()
            for slot, req in enumerate(bucket.active):
                if req is None:
                    continue
                req.sweeps_done = req.num_sweeps
                req.z = z_host[slot, : req.words.shape[0]].copy()
                self._finish(req, bucket, slot, n_kd_host[slot])
                finished.append(req)
            bucket.mask.zero_()
        return finished

    def _sweep_keys(self, bucket: _Bucket) -> torch.Tensor:
        """Per-slot keys (B, 2) for this sweep: request key folded with the
        sweep counter; vacant or finished slots get a constant dummy."""
        base = torch.zeros((len(bucket.active), 2), dtype=torch.int64)
        counter = torch.zeros(len(bucket.active), dtype=torch.int64)
        for s, req in enumerate(bucket.active):
            if req is not None and req.sweeps_done < req.num_sweeps:
                base[s] = req.key
                counter[s] = req.sweeps_done + 1
        return fold_in(base, counter).to(self.device)

    def _throughput_step(self) -> List[InferRequest]:
        self._admit()
        finished, self._instant = self._instant, []
        for bucket in self._buckets.values():
            if bucket.num_active == 0:
                continue
            sm = bucket.slot_model  # pinned: the admitted model
            m = sm.model
            if isinstance(m, ShardedFrozenLDAModel):
                z_new = self._sweep_fn(sm)(
                    self._sweep_keys(bucket), bucket.words, bucket.mask,
                    bucket.z, bucket.n_kd, m.blocks, m.n_k_blocks, sm.aux)
            else:
                z_new = self.backend.infer_sweep(
                    self._sweep_keys(bucket), bucket.words, bucket.mask,
                    bucket.z, bucket.n_kd, m.n_wk, m.n_k, m.hyper,
                    self._knobs, sm.aux,
                )
            bucket.z = torch.where(bucket.mask, z_new, bucket.z)
            bucket.n_kd = torch.zeros_like(bucket.n_kd).scatter_add_(
                1, bucket.z.long(), bucket.mask.to(torch.int32))
            self.sweeps_run += 1
            n_kd_host = None
            for slot, req in enumerate(bucket.active):
                if req is None:
                    continue
                req.sweeps_done += 1
                want_sample = (
                    req.burn_in >= 0
                    and req.sweeps_done > req.burn_in
                    and (req.sweeps_done - req.burn_in) % req.thin == 0
                )
                ripe = req.sweeps_done >= req.num_sweeps
                if want_sample or ripe:
                    if n_kd_host is None:
                        n_kd_host = bucket.n_kd.cpu().numpy()
                    if want_sample:
                        if req.theta_sum is None:
                            req.theta_sum = np.zeros(m.num_topics,
                                                     np.float32)
                        req.theta_sum += self._theta(req, n_kd_host[slot],
                                                     sm.alpha_k)
                        req.theta_samples += 1
                if ripe:
                    self._finish(req, bucket, slot, n_kd_host[slot])
                    bucket.mask[slot] = False
                    finished.append(req)
        return finished

    def _theta(self, req: InferRequest, n_kd_row: np.ndarray,
               alpha_k: np.ndarray) -> np.ndarray:
        l = req.words.shape[0]
        return (n_kd_row.astype(np.float32) + alpha_k) / (l + alpha_k.sum())

    def _finish(self, req: InferRequest, bucket: _Bucket, slot: int,
                n_kd_row: np.ndarray) -> None:
        if req.theta_samples:
            req.theta = req.theta_sum / req.theta_samples
        else:
            # prior smoothing from the model the request decoded under
            req.theta = self._theta(req, n_kd_row, bucket.slot_model.alpha_k)
        bucket.active[slot] = None
        self._complete(req)

    def run_until_done(self, max_steps: int = 100_000) -> List[InferRequest]:
        """Drive ticks until the queue and every bucket drain; return all
        requests finished along the way."""
        with self._cv:
            done: List[InferRequest] = list(self._instant)
            self._instant = []
            for _ in range(max_steps):
                done.extend(self.step())
                if not self.queue and all(
                    b.num_active == 0 for b in self._buckets.values()
                ):
                    break
            return done

    def infer_batch(self, docs: Sequence, **submit_kw) -> np.ndarray:
        """Submit many documents, drain the engine, return their (N, K)
        float32 thetas in submission order."""
        with self._cv:
            uids = [self.submit(d, **submit_kw) for d in docs]
            by_uid = {r.uid: r for r in self.run_until_done()}
            missing = [u for u in uids if u not in by_uid]
            if missing:
                raise RuntimeError(f"engine did not finish requests {missing}")
            return np.stack([by_uid[u].theta for u in uids])


def doc_completion_perplexity(engine: LDAEngine,
                              docs: Sequence[np.ndarray]) -> float:
    """Doc-completion held-out perplexity: theta is inferred on the even
    tokens of each document, the odd tokens are scored as
    ``p(w | theta, phi)``. Lower is better."""
    observed, heldout = [], []
    for d in docs:
        d = np.asarray(d, np.int32)
        observed.append(d[0::2])
        heldout.append(d[1::2])
    thetas = engine.infer_batch(observed)
    phi = engine.model.phi().cpu().numpy()
    total_ll, total_tokens = 0.0, 0
    for theta, held in zip(thetas, heldout):
        held = held[(held >= 0) & (held < engine.model.num_words)]
        if held.shape[0] == 0:
            continue
        p = phi[held] @ theta
        total_ll += float(np.sum(np.log(np.maximum(p, 1e-30))))
        total_tokens += int(held.shape[0])
    if total_tokens == 0:
        return float("nan")
    return float(np.exp(-total_ll / total_tokens))


def docs_from_corpus(corpus) -> List[np.ndarray]:
    """Split an edge-list ``Corpus`` into per-document token arrays."""
    words = np.asarray(corpus.word)
    docs = np.asarray(corpus.doc)
    order = np.argsort(docs, kind="stable")
    words, docs = words[order], docs[order]
    bounds = np.searchsorted(docs, np.arange(corpus.num_docs + 1))
    return [words[bounds[d]:bounds[d + 1]] for d in range(corpus.num_docs)]
