"""Key helpers (``repro/utils/prng.py``) over the port's counter-based keys
(``core.keys``: two uint32 words, not a ``jax.random`` key).

* :func:`fold_in_str` folds the reference's integer for a name, the first
  4 bytes of its SHA-256 read little-endian (:func:`name_hash`), into a
  key with ``core.keys.fold_in``.
* :func:`split_like` splits a key into a tree of keys shaped like a given
  tree: dicts (by sorted key), lists and tuples (``NamedTuple`` too) in the
  leaf order of ``jax.tree_util``, ``None`` holding no leaf.

The key values differ from threefry's; the integer and the tree's
structure and leaf order are the reference's.
"""
from __future__ import annotations

import hashlib
from typing import Any, List

import torch

from repro_torch.core.keys import fold_in, split


def name_hash(name: str) -> int:
    """The integer the reference folds in for ``name``."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                          "little")


def fold_in_str(key: torch.Tensor, name: str) -> torch.Tensor:
    """Deterministically fold a string into a key."""
    return fold_in(key, name_hash(name))


def _count_leaves(tree: Any) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def _rebuild(tree: Any, keys: List[torch.Tensor]) -> Any:
    """``tree`` with its leaves replaced, in leaf order, by ``keys``
    (consumed from the front)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], keys) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, keys) for v in tree]
        if isinstance(tree, list):
            return items
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*items)
        return tuple(items)
    return keys.pop(0)


def split_like(key: torch.Tensor, tree: Any) -> Any:
    """Split a key into a tree of keys with the same structure as
    ``tree``: leaf i (in ``jax.tree_util``'s order) gets ``split(key,
    n)[i]``."""
    n = _count_leaves(tree)
    keys = list(split(key, n)) if n else []
    return _rebuild(tree, keys)
