"""The sampler-backend contract (``repro/algorithms/base.py``).

A backend trains through

* ``prepare(corpus, hyper, knobs) -> aux`` — per-run precompute, passed
  back into every ``sweep`` (default: none);
* ``sweep(state, corpus, hyper, knobs, aux) -> (E,)`` — one pass over
  all tokens against iteration-start counts; the training plan owns masking,
  the delta merge and the state update;
* ``cell_sweep(seed, word, doc, z_old, mask, n_wk, n_kd, n_k, hyper,
  num_words_pad, knobs, token_index=None) -> (T,)`` — the per-cell form.
  ``seed`` is the sweep's int31 seed (``core.keys.key_seed``), where the
  reference passes a ``jax.random`` key; every draw hashes it with the
  global token index: ``token_index[t]`` (a mesh cell passes its tokens'
  corpus indices), else t. ``CellBackend`` derives the single-box
  ``sweep`` from it, treating the whole corpus as one cell.

and serves a frozen model through

* ``prepare_infer(n_wk, n_k, hyper, knobs) -> aux`` — one-time tables,
  called when an engine is built;
* ``infer_sweep(keys, words, mask, z_old, n_kd, n_wk, n_k, hyper, knobs,
  aux) -> (B, L)`` — one frozen-model CGS sweep over a padded slot batch.
  ``keys`` is a (B, 2) integer tensor of per-slot key words
  (``core.keys``; the reference's ``jax.random.key_data(keys)``).

The base class derives ``infer_sweep`` for every backend: the dense
frozen-phi sweep (:func:`_dense_infer_sweep`), in lockstep with
``core.inference.cgs_infer``.

Capability flags let drivers adapt instead of naming backends:

* ``supports_shard_map`` — has a ``cell_sweep`` the mesh plan can call
  (the reference's name for it; every ``CellBackend``).
* ``needs_row_pads`` — the training plan resolves ``max_kw``/``max_kd``
  (0 = auto from the counts, :func:`resolve_row_pads`) before every sweep;
  these are the padded-sparse backends' row widths.
* ``needs_doc_index`` — ``prepare`` returns a corpus-sized doc -> token
  index that ``sweep`` requires.

A backend declares the static per-cell workspace its ``cell_sweep`` uses
through ``resolve_cell_knobs`` (auto widths become concrete,
:func:`fill_cell_row_pads`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from repro_torch.core.inference import chain_sweep, frozen_phi_rows
from repro_torch.core.keys import fold_in, key_seed
from repro_torch.core.sampler import chunked_token_map  # noqa: F401

# SamplerKnobs.kernels policy: "auto" = kernels when the tensors lie on
# CUDA; "on"/"off" pick the fused or the gathered kernel there
VALID_KERNEL_MODES = ("auto", "on", "off")

# the reference's tile floors, kept so that one config validates alike in
# both packages (the CUDA kernels take any bt/bk)
_MIN_BT = 8
_LANE = 128


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

    def chunk_or_none(self) -> Optional[int]:
        return self.token_chunk or None


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


_KNOB_FIELDS = tuple(f.name for f in dataclasses.fields(SamplerKnobs))


def knobs_from(cfg) -> SamplerKnobs:
    """THE SamplerKnobs derivation: every training config builds its knobs
    here, from the fields it shares with :class:`SamplerKnobs`."""
    return SamplerKnobs(**{f: getattr(cfg, f) for f in _KNOB_FIELDS})


class SamplerBackend:
    """Base class: the training and serving contracts, with a default
    serving derivation."""

    name: str = "?"
    supports_shard_map: bool = False
    native_infer: bool = False
    needs_doc_index: bool = False
    needs_row_pads: bool = False
    # fields of ``prepare_infer``'s aux indexed by word row (dim 0): built
    # per shard by sharded serving (``serving.sharded``)
    infer_aux_word_fields: tuple = ()

    def prepare(self, corpus, hyper, knobs: SamplerKnobs) -> Any:
        """Per-run precompute; returns the aux threaded into ``sweep``."""
        return None

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs,
              aux: Any = None) -> torch.Tensor:
        raise NotImplementedError(
            f"backend {self.name!r} has no single-box sweep")

    def cell_sweep(self, seed: int, word, doc, z_old, mask, n_wk, n_kd,
                   n_k, hyper, num_words_pad: int, knobs: SamplerKnobs,
                   token_index=None) -> torch.Tensor:
        raise NotImplementedError(
            f"backend {self.name!r} has no cell sweep")

    def resolve_cell_knobs(self, knobs: SamplerKnobs,
                           hyper) -> SamplerKnobs:
        """The static per-cell workspace the backend uses: every knob that
        sizes a ``cell_sweep`` workspace comes back concrete. The default
        declares none."""
        return knobs

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
        flags = [f for f in ("supports_shard_map", "needs_doc_index",
                             "needs_row_pads", "native_infer")
                 if getattr(self, f)]
        return f"<{type(self).__name__} {self.name!r} {' '.join(flags)}>"


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


class CellBackend(SamplerBackend):
    """Single-box sweep derived from the cell sweep: the whole corpus is
    one cell, every id is already local, every token is live."""

    supports_shard_map = True

    def resolve_cell_knobs(self, knobs: SamplerKnobs,
                           hyper) -> SamplerKnobs:
        """Padded-row backends share one workspace declaration: auto widths
        become the static defaults, clamped to K (idempotent)."""
        if self.needs_row_pads:
            return fill_cell_row_pads(knobs, hyper.num_topics)
        return knobs

    def sweep(self, state, corpus, hyper, knobs: SamplerKnobs, aux=None):
        seed = key_seed(fold_in(state.rng, state.iteration))
        return self.cell_sweep(
            seed, corpus.word, corpus.doc, state.topic, None,
            state.n_wk, state.n_kd, state.n_k, hyper, corpus.num_words,
            knobs,
        )


def auto_pad(n, multiple: int = 8) -> int:
    """Round a max row nnz up to a lane-friendly multiple."""
    m = int(n)
    return max(multiple, ((m + multiple - 1) // multiple) * multiple)


def resolve_row_pads(state, knobs: SamplerKnobs) -> SamplerKnobs:
    """Fill ``max_kw``/``max_kd`` = 0 from the current counts (host-side);
    explicit widths are kept."""
    if knobs.max_kw and knobs.max_kd:
        return knobs
    from repro_torch.core.zen_sparse import max_row_nnz

    max_kw = knobs.max_kw or auto_pad(max_row_nnz(state.n_wk))
    max_kd = knobs.max_kd or auto_pad(max_row_nnz(state.n_kd))
    return dataclasses.replace(knobs, max_kw=max_kw, max_kd=max_kd)


# static row widths of a padded-sparse cell when nothing data-driven was
# resolved: the paper's row-sparsity regime (K_d below K_w), clamped to K
DEFAULT_CELL_MAX_KW = 128
DEFAULT_CELL_MAX_KD = 64


def fill_cell_row_pads(knobs: SamplerKnobs, num_topics: int,
                       default_kw: int = DEFAULT_CELL_MAX_KW,
                       default_kd: int = DEFAULT_CELL_MAX_KD
                       ) -> SamplerKnobs:
    """Concrete padded-row widths for a cell workspace: 0/auto becomes the
    static default clamped to K; explicit widths are kept."""
    return dataclasses.replace(
        knobs,
        max_kw=knobs.max_kw or min(default_kw, num_topics),
        max_kd=knobs.max_kd or min(default_kd, num_topics),
    )
