"""Tree helpers (``repro/utils/treeutil.py``) over the port's trees: nests
of dicts, lists and tuples (``NamedTuple`` states too) whose leaves are
tensors or numpy arrays, and ``nn.Module``s (their parameters)."""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn


def tree_leaves(tree: Any) -> Iterator[Any]:
    """The array leaves of ``tree`` (``None`` entries skipped, as a jax
    pytree skips them)."""
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    elif tree is not None:
        yield tree


def tree_param_count(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def _itemsize(x: Any) -> int:
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    return np.dtype(dt if dt is not None else np.float32).itemsize


def tree_bytes(tree: Any) -> int:
    return sum(int(np.prod(x.shape)) * _itemsize(x)
               for x in tree_leaves(tree))
