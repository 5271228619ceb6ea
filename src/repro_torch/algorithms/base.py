"""The sampler-backend contract, serving half (``repro/algorithms/base.py``).

A backend serves a frozen model through

* ``prepare_infer(n_wk, n_k, hyper, knobs) -> aux`` — one-time tables,
  called when an engine is built;
* ``infer_sweep(keys, words, mask, z_old, n_kd, n_wk, n_k, hyper, knobs,
  aux) -> (B, L)`` — one frozen-model CGS sweep over a padded slot batch.
  ``keys`` is a (B, 2) integer tensor of per-slot key words
  (``core.keys``; the reference's ``jax.random.key_data(keys)``).

The base class derives ``infer_sweep`` for every backend: the dense
frozen-phi sweep (:func:`_dense_infer_sweep`), in lockstep with
``core.inference.cgs_infer``. The training half (``sweep``,
``cell_sweep``) belongs to the training slice, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from repro_torch.core.inference import chain_sweep, frozen_phi_rows

# SamplerKnobs.kernels policy: "auto" = kernels when the tensors lie on
# CUDA; "on"/"off" pick the fused or the gathered kernel there
VALID_KERNEL_MODES = ("auto", "on", "off")

# the reference's tile floors, kept so that one config validates alike in
# both packages (the CUDA kernels take any bt/bk)
_MIN_BT = 8
_LANE = 128

TRAINING_NOT_PORTED = (
    "training sweeps belong to the training slice of the port, which is "
    "not ported yet; train with the JAX package (python -m "
    "repro.launch.train --checkpoint-dir ...) and serve its checkpoint here"
)


@dataclasses.dataclass(frozen=True)
class SamplerKnobs:
    """Algorithm knobs shared by every backend; same fields and the same
    validation as the reference's."""

    sampling_method: str = "cdf"  # dense paths: cdf | gumbel
    max_kw: int = 0
    max_kd: int = 0
    num_mh: int = 8
    token_chunk: int = 0
    bt: int = 256
    bk: int = 512
    bs: int = 128
    kernels: str = "auto"  # auto | on | off

    def __post_init__(self):
        if self.bt < _MIN_BT:
            raise ValueError(
                f"SamplerKnobs.bt={self.bt}: token tiles need at least "
                f"{_MIN_BT} rows"
            )
        for name, v in (("bk", self.bk), ("bs", self.bs)):
            if v < _LANE or v % _LANE:
                raise ValueError(
                    f"SamplerKnobs.{name}={v}: topic/lane tiles must be "
                    f"positive multiples of {_LANE}"
                )
        if self.kernels not in VALID_KERNEL_MODES:
            raise ValueError(
                f"SamplerKnobs.kernels={self.kernels!r}: expected one of "
                f"{VALID_KERNEL_MODES}"
            )


def kernel_dispatch(mode: str, device: torch.device) -> bool:
    """Resolve a ``kernels`` policy: True picks the fused kernel path.

    ``auto`` means "the tensors are on CUDA". The ``REPRO_KERNELS``
    environment variable overrides the knob when set (read at call time).
    """
    mode = os.environ.get("REPRO_KERNELS", mode)
    if mode not in VALID_KERNEL_MODES:
        raise ValueError(
            f"kernel mode {mode!r}: expected one of {VALID_KERNEL_MODES}"
        )
    if mode == "auto":
        return torch.device(device).type == "cuda"
    return mode == "on"


class SamplerBackend:
    """Base class: the serving contract plus a default derivation."""

    name: str = "?"
    native_infer: bool = False

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs,
              aux: Any = None):
        raise NotImplementedError(f"backend {self.name!r}: "
                                  + TRAINING_NOT_PORTED)

    def cell_sweep(self, key, word, doc, z_old, mask, n_wk, n_kd, n_k,
                   hyper, num_words_pad: int, knobs: SamplerKnobs):
        raise NotImplementedError(f"backend {self.name!r}: "
                                  + TRAINING_NOT_PORTED)

    def prepare_infer(self, n_wk, n_k, hyper, knobs: SamplerKnobs,
                      num_words_total: Optional[int] = None) -> Any:
        """Freeze the model into a sampling-ready aux (default: none)."""
        return None

    def infer_sweep(self, keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
                    knobs: SamplerKnobs, aux: Any = None,
                    num_words_total: Optional[int] = None) -> torch.Tensor:
        """One frozen-model sweep over a padded slot batch; slot b draws
        only from ``keys[b]`` and the token position, so results are
        independent of batch composition and prefix-stable in L."""
        return _dense_infer_sweep(
            keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
            knobs.sampling_method, num_words_total=num_words_total,
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name!r}>"


def _dense_infer_sweep(keys, words, mask, z_old, n_kd, n_wk, n_k, hyper,
                       method: str,
                       num_words_total: Optional[int] = None
                       ) -> torch.Tensor:
    """Default frozen-model sweep: dense phi rows, doc-side exclusion.
    Runs the same :func:`chain_sweep` as ``cgs_infer``, so a served theta
    is bit-equal to the single-document oracle's."""
    phi = frozen_phi_rows(n_wk, n_k, words, hyper, num_words_total)
    return chain_sweep(phi, hyper.alpha_k(n_k), keys, z_old, mask, n_kd,
                       method)
