"""The counter hash that defines a training run's random draws, frozen.

A run's draws are functions of (run seed, sweep, token index, topic or
stream), fixed by this Murmur3-style finalizer and the key derivation
below. Both are part of what a run computes, like the corpus, so the
reference holds its own copy and never reads the program's. Every hash
value is an int64 tensor holding a uint32, masked after each multiply.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
GOLD = 0x9E3779B9
# split() counters sit above every sweep counter
SPLIT_BASE = 1 << 31


def u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & MASK32


def mix(x: torch.Tensor) -> torch.Tensor:
    x = u32(x)
    x = ((x ^ (x >> 16)) * M1) & MASK32
    x = ((x ^ (x >> 13)) * M2) & MASK32
    return x ^ (x >> 16)


def hash_bits(seed, row, col) -> torch.Tensor:
    """32 hash bits of (seed, row, col), broadcast."""
    return mix(u32(seed) ^ ((u32(row) * GOLD) & MASK32) ^ mix(col))


def hash_uniform(seed, row, col) -> torch.Tensor:
    """U(0, 1] in float32: 24 hash bits plus half a step, rounded to
    float32 (the top value rounds to 1.0). Float32 is part of the
    definition of the draw, not of the model's arithmetic."""
    h = hash_bits(seed, row, col)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24)) \
        + (0.5 / (1 << 24))


def golden_seed(hi, lo, pos) -> torch.Tensor:
    h = mix(u32(hi) ^ mix(lo) ^ ((u32(pos) * GOLD) & MASK32))
    return h & 0x7FFFFFFF


def key_from_seed(seed: int) -> torch.Tensor:
    """(2,) key words of an integer run seed of any width."""
    lo32, hi32 = seed & MASK32, (seed >> 32) & MASK32
    hi = mix(torch.tensor(lo32 ^ GOLD, dtype=torch.int64))
    lo = mix(torch.tensor(hi32, dtype=torch.int64) ^ mix(lo32))
    return torch.stack([hi, lo])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    hi, lo = key[..., 0], key[..., 1]
    d = u32(data)
    new_hi = mix(hi ^ mix(d ^ lo))
    new_lo = mix(lo ^ mix(new_hi ^ ((d * GOLD) & MASK32)))
    return torch.stack([new_hi, new_lo], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    return fold_in(key, torch.arange(num, dtype=torch.int64) + SPLIT_BASE)


def key_seed(key: torch.Tensor) -> int:
    """The int31 seed of a (2,) key."""
    return int(golden_seed(key[0], key[1], 0))


def run_keys(seed: int):
    """(init key, state key) of a run seeded with ``seed``."""
    init_key, state_key = split(key_from_seed(seed))
    return init_key, state_key


def sweep_seed(seed: int, iteration: int) -> int:
    """The int31 seed of sweep ``iteration`` (0-based) of a run."""
    return key_seed(fold_in(run_keys(seed)[1], iteration))


def initial_topics(seed: int, tokens: torch.Tensor, num_topics: int
                   ) -> torch.Tensor:
    """Random initial topics of the given token indices, int64."""
    k = run_keys(seed)[0].to(tokens.device)
    return mix(golden_seed(k[0], k[1], tokens)) % num_topics


def stream_uniforms(seed: int, tokens: torch.Tensor, streams: int
                    ) -> torch.Tensor:
    """(streams, n) U[0, 1) in float32 of the given token indices: the top
    24 bits of hash(seed, token, stream) times 2^-24."""
    cols = torch.arange(streams, device=tokens.device)[:, None]
    h = hash_bits(seed, tokens[None, :], cols)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
