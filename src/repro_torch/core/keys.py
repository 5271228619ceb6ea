"""Counter-based request keys for serving.

The reference draws its serving randomness from ``jax.random`` keys,
whose threefry streams torch cannot reproduce. Here a key is two uint32
words (held in int64, as everywhere in the port's hash), the same shape as
``jax.random.key_data`` of a reference key, and every draw is a hash of
(key, counter) through the kernels' ``mix32``:

* engine seed -> base key (:func:`key_from_seed`); request ``uid`` ->
  ``fold_in(base, uid)``;
* a request's initial topics come from ``fold_in(key, 0)`` hashed with
  the token position (:func:`init_topics`), and sweep ``j`` (0-based) uses
  ``fold_in(key, j + 1)``;
* inside a sweep, a slot's per-token seeds are
  ``golden_seed(key words, position)``, exactly the reference kernel
  path's derivation.

Each draw therefore depends only on its own request's key and token
position: results are independent of batch composition and prefix-stable
in the bucket width, the contract the reference engine's tests pin.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zen_sampler import (
    MASK32,
    _GOLD,
    golden_seed,
    hash_uniform,
    mix32,
    u32,
)


def key_from_seed(seed: int) -> torch.Tensor:
    """A (2,) key from an integer seed (any width)."""
    lo32, hi32 = seed & MASK32, (seed >> 32) & MASK32
    hi = mix32(torch.tensor(lo32 ^ _GOLD, dtype=torch.int64))
    lo = mix32(torch.tensor(hi32, dtype=torch.int64) ^ mix32(lo32))
    return torch.stack([hi, lo])


def as_key(key) -> torch.Tensor:
    """A caller's key: an int seed, or two uint32 words (e.g. the
    ``key_data`` of a reference key)."""
    if isinstance(key, int):
        return key_from_seed(key)
    words = u32(torch.as_tensor(key).cpu())
    if words.shape != (2,):
        raise ValueError(f"a key is an int seed or two uint32 words, got "
                         f"shape {tuple(words.shape)}")
    return words


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Derive a key from ``key`` (..., 2) and an integer counter (...)."""
    hi, lo = key[..., 0], key[..., 1]
    d = u32(data).to(key.device)
    new_hi = mix32(hi ^ mix32(d ^ lo))
    new_lo = mix32(lo ^ mix32(new_hi ^ ((d * _GOLD) & MASK32)))
    return torch.stack([new_hi, new_lo], dim=-1)


def init_topics(key: torch.Tensor, length: int, num_topics: int,
                device=None) -> torch.Tensor:
    """A request's initial topics, (length,) int32, uniform over K and
    prefix-stable in ``length``."""
    k0 = fold_in(key, 0).to(device)
    pos = torch.arange(length, device=device)
    seeds = golden_seed(k0[0], k0[1], pos)
    return (mix32(seeds) % num_topics).to(torch.int32)


def token_seeds(keys: torch.Tensor, length: int) -> torch.Tensor:
    """Per-token int32 seeds (B, L) from per-slot keys (B, 2)."""
    pos = torch.arange(length, device=keys.device)[None, :]
    return golden_seed(keys[:, :1], keys[:, 1:], pos)


def token_uniforms(keys: torch.Tensor, length: int) -> torch.Tensor:
    """Per-token U(0, 1] (B, L) float32 for inverse-CDF draws, on a hash
    row (1) the Gumbel noise (row 0) never uses."""
    return hash_uniform(token_seeds(keys, length), 1, 0)
