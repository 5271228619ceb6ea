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

Randomness (throughput mode) is counter-based (``core.keys``): a request's
key is derived from the engine seed and its uid unless the caller passes
one, its initial topics and each sweep's draws hash from that key and the
token position. A slot's draws therefore depend only on its own key, are
prefix-stable in the bucket width and independent of batch composition;
with the default dense backend and cdf sampling a served theta is
bit-equal to ``core.inference.cgs_infer`` under the same key. Latency mode
is deterministic and gives the reference's assignments.

Not ported yet, and refused with a ``ValueError`` when a config sets them:
sharded serving (``mesh_shape``), telemetry and the autopilot
(``metrics_out``, ``autopilot``, ``autopilot_window``). Hot reload
(``reload``, ``watch_checkpoint_dir``) and the replica router are not part
of this engine yet either.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import algorithms
from repro_torch.algorithms import SamplerKnobs
from repro_torch.core.inference import rtlda_assign
from repro_torch.core.keys import as_key, fold_in, init_topics, key_from_seed
from repro_torch.core.types import LDAHyperParams
from repro_torch.device import resolve_device
from repro_torch.observe.metrics import latency_percentile  # noqa: F401


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
    file configures both packages (see the module docstring for the
    fields this engine refuses)."""

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


# config fields whose features this engine does not have yet
_NOT_PORTED = {
    "mesh_shape": "sharded serving",
    "metrics_out": "serving telemetry",
    "autopilot": "the serving autopilot",
    "autopilot_window": "the serving autopilot",
}


@dataclasses.dataclass
class InferRequest:
    """One in-flight (or finished) serving request; ``theta`` (K,) once
    ``done``, ``z`` the final assignments in latency mode, ``t_submit`` /
    ``t_done`` ``time.monotonic`` stamps."""

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
    t_submit: float = 0.0
    t_done: float = 0.0
    sweeps_done: int = 0
    theta_sum: Optional[np.ndarray] = None
    theta_samples: int = 0
    z: Optional[np.ndarray] = None


class _Bucket:
    """One fixed-shape slot batch: the device state for bucket width L."""

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

    def free_slot(self) -> Optional[int]:
        for s, r in enumerate(self.active):
            if r is None:
                return s
        return None

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.active)


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
        defaults = LDAServeConfig()
        for name, what in _NOT_PORTED.items():
            if getattr(cfg, name) != getattr(defaults, name):
                raise ValueError(
                    f"LDAServeConfig.{name}={getattr(cfg, name)!r}: {what} "
                    f"is not ported to the PyTorch engine yet"
                )
        self.cfg = cfg
        self.model = model
        self.device = model.device
        self.backend = algorithms.get(cfg.algorithm)
        self._knobs = cfg.knobs()
        # latency mode never runs backend sweeps: no tables
        self._aux = None if cfg.mode == "latency" else \
            self.backend.prepare_infer(model.n_wk, model.n_k, model.hyper,
                                       self._knobs)
        self._alpha_k = model.hyper.alpha_k(model.n_k).cpu().numpy()
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
        self._tick_period = cfg.tick_period or 0.001
        self._max_slot_wait = cfg.max_slot_wait
        self._tickets: Dict[int, InferRequest] = {}
        self._cv = threading.Condition(threading.RLock())
        self._ticker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

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
            req.theta = self._alpha_k / self._alpha_k.sum()
            self._complete(req)
            self._instant.append(req)
        elif not latency and req.num_sweeps <= 0:
            # zero sweeps: theta straight from the initial assignment
            z0 = init_topics(req.key, req.words.shape[0], k).numpy()
            req.theta = self._theta(
                req, np.bincount(z0, minlength=k).astype(np.int32))
            self._complete(req)
            self._instant.append(req)
        else:
            self.queue.append(req)
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

    def warm(self) -> None:
        """Run one minimal document per bucket width before traffic, so
        first requests pay no kernel build or allocator warm-up."""
        self.infer_batch([np.zeros(bl, np.int32) for bl in self.bucket_widths])

    @property
    def bucket_widths(self) -> Tuple[int, ...]:
        return tuple(sorted(self._buckets))

    # -- admission ---------------------------------------------------------
    def _bucket_for(self, length: int) -> _Bucket:
        for bl in sorted(self._buckets):
            if length <= bl:
                return self._buckets[bl]
        return self._buckets[max(self._buckets)]

    def _admit(self) -> None:
        still_queued = []
        for req in self.queue:
            bucket = self._bucket_for(req.words.shape[0])
            slot = bucket.free_slot()
            if slot is None and self._max_slot_wait > 0 \
                    and req.ticks_waited >= self._max_slot_wait:
                # SLA spill: take any wider free slot
                for bl in sorted(self._buckets):
                    wider = self._buckets[bl]
                    if bl <= bucket.length or bl < req.words.shape[0]:
                        continue
                    s = wider.free_slot()
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
        l, k = bucket.length, self.model.num_topics
        n = req.words.shape[0]
        words = torch.zeros(l, dtype=torch.int32)
        words[:n] = torch.from_numpy(req.words)
        bucket.words[slot] = words.to(self.device)
        bucket.mask[slot] = False
        bucket.mask[slot, :n] = True
        bucket.active[slot] = req
        req.admitted = True
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
            finished = (self._latency_step() if self.cfg.mode == "latency"
                        else self._throughput_step())
            if finished and self._tickets:
                self._cv.notify_all()
            return finished

    def _latency_step(self) -> List[InferRequest]:
        self._admit()
        finished, self._instant = self._instant, []
        m = self.model
        for bucket in self._buckets.values():
            if bucket.num_active == 0:
                continue
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
        m = self.model
        for bucket in self._buckets.values():
            if bucket.num_active == 0:
                continue
            z_new = self.backend.infer_sweep(
                self._sweep_keys(bucket), bucket.words, bucket.mask,
                bucket.z, bucket.n_kd, m.n_wk, m.n_k, m.hyper, self._knobs,
                self._aux,
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
                        req.theta_sum += self._theta(req, n_kd_host[slot])
                        req.theta_samples += 1
                if ripe:
                    self._finish(req, bucket, slot, n_kd_host[slot])
                    bucket.mask[slot] = False
                    finished.append(req)
        return finished

    def _theta(self, req: InferRequest, n_kd_row: np.ndarray) -> np.ndarray:
        l = req.words.shape[0]
        return (n_kd_row.astype(np.float32) + self._alpha_k) / (
            l + self._alpha_k.sum()
        )

    def _finish(self, req: InferRequest, bucket: _Bucket, slot: int,
                n_kd_row: np.ndarray) -> None:
        if req.theta_samples:
            req.theta = req.theta_sum / req.theta_samples
        else:
            req.theta = self._theta(req, n_kd_row)
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
