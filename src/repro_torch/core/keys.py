"""Counter-based keys for serving and training.

The reference draws its randomness from ``jax.random`` keys, whose
threefry streams torch cannot reproduce. Here a key is two uint32
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

Training (``core.init``, ``core.sampler``, ``algorithms``) uses the same
words: a run key comes from :func:`as_key`, :func:`split` derives the
init and state keys as the reference's ``jax.random.split`` does, and
sweep ``i`` draws from the int31 :func:`key_seed` of ``fold_in(state
key, i)``, hashed with the global token index (and topic). A training
draw therefore depends only on (run key, iteration, token index). The
token index is the token's position in the corpus: a mesh cell, whose
tokens are a reordered subset, passes its tokens' corpus indices
(:func:`token_rows`), so a mesh draws what the single box draws. The
padded-sparse samplers take several uniforms per token, one stream each
(:func:`stream_uniforms`), where the reference splits its key.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zen_sampler import (
    MASK32,
    _GOLD,
    golden_seed,
    hash_bits,
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


# split() counters sit above every iteration counter fold_in sees
_SPLIT_BASE = 1 << 31


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` keys (num, 2) from ``key``, on counters of their own."""
    return fold_in(key, torch.arange(num, dtype=torch.int64) + _SPLIT_BASE)


def key_seed(key: torch.Tensor) -> int:
    """One non-negative int31 seed from a (2,) key (the kernels' seed)."""
    return int(golden_seed(key[0], key[1], 0))


def uniform_ints(key: torch.Tensor, n: int, high: int,
                 device=None) -> torch.Tensor:
    """(n,) int64 draws in [0, high): entry ``i`` hashes (key, i) only."""
    return uniform_ints_at(key, torch.arange(n, device=device), high)


def uniform_ints_at(key: torch.Tensor, positions: torch.Tensor,
                    high: int) -> torch.Tensor:
    """``uniform_ints(key, n, high)[positions]`` without the other draws
    (a mesh cell's initial topics at its tokens' corpus indices)."""
    k = key.to(positions.device)
    return mix32(golden_seed(k[0], k[1], positions)) % high


def init_topics(key: torch.Tensor, length: int, num_topics: int,
                device=None) -> torch.Tensor:
    """A request's initial topics, (length,) int32, uniform over K and
    prefix-stable in ``length``."""
    return uniform_ints(fold_in(key, 0), length, num_topics,
                        device=device).to(torch.int32)


def token_seeds(keys: torch.Tensor, length: int) -> torch.Tensor:
    """Per-token int32 seeds (B, L) from per-slot keys (B, 2)."""
    pos = torch.arange(length, device=keys.device)[None, :]
    return golden_seed(keys[:, :1], keys[:, 1:], pos)


def token_uniforms(keys: torch.Tensor, length: int) -> torch.Tensor:
    """Per-token U(0, 1] (B, L) float32 for inverse-CDF draws, on a hash
    row (1) the Gumbel noise (row 0) never uses."""
    return hash_uniform(token_seeds(keys, length), 1, 0)


def token_rows(start, n: int, device=None) -> torch.Tensor:
    """The global token indices of a chunk of ``n`` tokens: ``start`` is
    the chunk's first index (the tokens are consecutive) or a (n,) tensor
    of each token's own index (a mesh cell's corpus indices)."""
    if isinstance(start, torch.Tensor):
        return start.to(device=device, dtype=torch.int64)
    return torch.arange(start, start + n, device=device)


def stream_uniforms(seed: int, start, n: int, streams: int,
                    device=None) -> torch.Tensor:
    """(streams, n) float32 U[0, 1), as ``jax.random.uniform`` gives: entry
    (s, i) is the top 24 bits of ``hash(seed, row_i, s)`` times 2^-24,
    where ``row_i`` is the token's global index (:func:`token_rows` of
    ``start``), so a draw depends on (sweep seed, global token index,
    stream) only and no chunking changes it."""
    rows = token_rows(start, n, device)[None, :]
    cols = torch.arange(streams, device=device)[:, None]
    h = hash_bits(seed, rows, cols)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
