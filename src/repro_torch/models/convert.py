"""The reference's parameter tree <-> the port's ``LM``.

The tree is the JAX package's ``init_params`` output as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``): layer stacks carry a
leading layer axis. Port parameter ``layers.3.attn.wq`` is the tree's
``["layers"]["attn"]["wq"][3]``. bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses: they
cross as their 16-bit patterns, so nothing here imports ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import ParamMaker
from repro_torch.models.model import LM


def _tree_path(name: str) -> Tuple[List[str], Optional[int]]:
    """``layers.3.attn.wq`` -> (["layers", "attn", "wq"], 3)."""
    keys, index = [], None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            keys.append(part)
    return keys, index


def to_torch(a: Any) -> torch.Tensor:
    """A numpy leaf as a tensor; a bfloat16 leaf through its bits (also as
    ``np.load`` returns a saved one: a 2-byte void)."""
    a = np.array(a, copy=True)  # writable and contiguous
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; a bfloat16 tensor as a ``bfloat16`` array where
    numpy knows the type (``ml_dtypes`` loaded by the caller, as JAX
    loads it), else as its 16-bit patterns (``uint16``)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        return bits


def load_into(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Copy ``tree``'s leaves into ``module``'s parameters, by name (the
    module's parameter names are the tree's paths)."""
    for name, p in module.named_parameters():
        keys, index = _tree_path(name)
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        t = to_torch(leaf if index is None else np.asarray(leaf)[index])
        if p.dtype == torch.bfloat16 and t.dtype == torch.uint16:
            t = t.view(torch.bfloat16)  # the bits ``to_numpy`` writes
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: tree leaf {tuple(t.shape)} {t.dtype}, "
                             f"parameter {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> LM:
    """An ``LM`` holding the reference tree's values, on the card unless
    ``device`` says otherwise."""
    lm = LM(cfg, ParamMaker(resolve_device(device)))
    load_into(lm, tree)
    return lm


def params_to_reference(lm: torch.nn.Module) -> Dict[str, Any]:
    """The inverse: nested dicts of numpy arrays, stacks restacked along a
    leading layer axis."""
    stacks: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    tree: Dict[str, Any] = {}
    for name, p in lm.named_parameters():
        keys, index = _tree_path(name)
        if index is None:
            _put(tree, keys, to_numpy(p))
        else:
            stacks.setdefault(tuple(keys), {})[index] = to_numpy(p)
    for keys, layers in stacks.items():
        _put(tree, list(keys), np.stack([layers[i] for i in sorted(layers)]))
    return tree


def _put(tree: Dict[str, Any], keys: List[str], value: np.ndarray) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value
