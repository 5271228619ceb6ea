"""Batched LM serving engine (``repro/serving/engine.py``):
continuous-batching-lite over cached decode.

Requests queue up; the engine packs up to ``max_batch`` active sequences
into one fixed-shape decode batch, and finished slots are refilled from
the queue. It keeps the reference's semantics exactly, including three
properties of its simple cache layout:

- a prompt is admitted token by token through ``decode_step`` over the
  whole batch, so the other active slots re-feed their pending token;
- the cache length is one value for all slots, and the cache is reset
  only when every slot is empty;
- a position past ``max_len`` is written to the last slot (the clamped
  write of ``models.attention``), so the caller keeps prompts plus
  outputs of one round of admissions within ``max_len``.

Greedy decode is the argmax of the float32 logits; with ``temperature >
0`` tokens are drawn from the engine's own ``np.random.RandomState``
(``RandomState(s).choice`` gives the stream the reference draws from the
global ``np.random`` after ``np.random.seed(s)``).

The LM-serving analogue of the paper's RT-LDA path (``core.inference``);
``examples/serve_lm_torch.py`` serves both from one process.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (  # noqa: F401
    LM,
    decode_step,
    init_cache,
    prefill_with_cache,  # the reference's module surface
)


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => never stop early


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Serves ``params`` (an ``LM``) on ``device``: the card unless the
    caller asks for the CPU."""

    def __init__(self, params: LM, cfg: ArchConfig, serve_cfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 rng: Optional[np.random.RandomState] = None):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.rng = rng if rng is not None else np.random.RandomState(0)
        b, s = serve_cfg.max_batch, serve_cfg.max_len
        self.caches = init_cache(cfg, b, s, device=self.device)
        self.tokens = np.zeros((b,), np.int32)
        self.active: List[Optional[Request]] = [None] * b
        self.queue: List[Request] = []
        self._uid = 0
        self._decode = lambda p, t, c: decode_step(p, self.cfg, t, c)

    def submit(self, prompt: List[int], max_new: int = 32) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, list(prompt), max_new))
        return self._uid

    def _feed(self):
        """One decode call over the whole batch's pending tokens."""
        with torch.no_grad():
            logits, self.caches = self._decode(
                self.params, torch.tensor(self.tokens, device=self.device),
                self.caches)
        return logits

    def _admit(self) -> None:
        """Fill empty slots: the prompt token by token through the whole
        batch's decode step (every family supported; the logits of these
        calls are unused)."""
        for slot in range(self.scfg.max_batch):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self._reset_if_idle()
            for t in req.prompt[:-1]:
                self.tokens[slot] = t
                self._feed()
            self.tokens[slot] = req.prompt[-1]
            self.active[slot] = req

    def _reset_if_idle(self) -> None:
        """The cache length is shared by all slots, so the cache restarts
        only when no slot is active (the reference's ``_reset_slot``)."""
        if all(a is None for a in self.active):
            self.caches = init_cache(self.cfg, self.scfg.max_batch,
                                     self.scfg.max_len, device=self.device)

    def _choose(self, logits: np.ndarray) -> int:
        if self.scfg.temperature > 0:
            p = np.exp((logits - logits.max()) / self.scfg.temperature)
            p /= p.sum()
            return int(self.rng.choice(p.shape[0], p=p))
        return int(np.argmax(logits))

    def step(self) -> List[Request]:
        """One decode step for all active slots; returns finished
        requests."""
        self._admit()
        if all(a is None for a in self.active):
            return []
        logits = self._feed().to(torch.float32).cpu().numpy()
        finished = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            nxt = self._choose(logits[slot])
            req.out.append(nxt)
            self.tokens[slot] = nxt
            if len(req.out) >= req.max_new or nxt == self.scfg.eos_id:
                req.done = True
                finished.append(req)
                self.active[slot] = None
        return finished

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        done: List[Request] = []
        for _ in range(max_steps):
            done.extend(self.step())
            if not self.queue and all(a is None for a in self.active):
                break
        return done
