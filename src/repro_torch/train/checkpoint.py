"""Checkpoints in the reference's on-disk format (``repro/train/checkpoint.py``).

One directory per step, ``step_%08d/``, holding

  manifest.json   — step, tree description, metadata, and per leaf its
                    name, file, shape, dtype and sha256
  leaf_%05d.npy   — the leaves in sorted-name order (dict keys sorted, as
                    a jax pytree flattens them)
  COMMITTED       — written last; restores ignore directories without it

so a model checkpoint written by either package loads in the other. No
pytree library is needed: a tree is a nest of dicts, lists and tuples
whose leaves are tensors, arrays or numbers.

Sharded state (the reference's elastic path): a tree may hold DTensors
(``sharding.partition``). Saving gathers each to its full tensor, every
rank taking part in the gathers and rank 0 writing, so a checkpoint
written at one mesh shape restores at any other;
``restore_checkpoint(..., shardings=...)`` places each leaf by its
sharding. :func:`shard_state` places a ``TrainState`` (or an ``LM``) on a
``DeviceMesh`` by ``param_specs`` and the optimizer-state rules of
``launch.specs``; :func:`full_state` gathers it back.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.dtensor import is_dtensor

_LDA_MODEL_KIND = "lda_model"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer(flat) -> bool:
    """False on ranks other than 0 of a live process group when the tree
    holds DTensors (each rank gathered them; rank 0 writes)."""
    if not any(is_dtensor(leaf) for _, leaf in flat):
        return True
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree: Any, prefix: str = "", is_leaf=None
             ) -> Tuple[List[Tuple[str, Any]], str]:
    """(name, leaf) pairs in jax's flattening order, and the tree's
    description in the form ``str(jax treedef)`` gives it."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix.rstrip("/") or "leaf", tree)], "*"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, desc = _flatten(tree[key], f"{prefix}{key}/", is_leaf)
            leaves += sub
            parts.append(f"{key!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for i, item in enumerate(tree):
            sub, desc = _flatten(item, f"{prefix}{i}/", is_leaf)
            leaves += sub
            parts.append(desc)
        inner = ", ".join(parts)
        if isinstance(tree, list):
            return leaves, f"[{inner}]"
        return leaves, f"({inner}{',' if len(parts) == 1 else ''})"
    return [(prefix.rstrip("/") or "leaf", tree)], "*"


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Atomic, checksummed save of a tree of tensors/arrays. DTensor
    leaves are written whole: every rank must call this (the gathers are
    collectives), and rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    flat, desc = _flatten(tree)
    if not _writer(flat):
        for _, leaf in flat:
            _as_numpy(leaf)  # take part in the gathers
        return final
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({desc})",
        "metadata": metadata or {},
        "leaves": [],
    }
    for i, (name, leaf) in enumerate(flat):
        arr = _as_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "name": name,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _verify_and_load(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for entry in manifest["leaves"]:
        arr = np.load(os.path.join(path, entry["file"]))
        if hashlib.sha256(arr.tobytes()).hexdigest() != entry["sha256"]:
            raise IOError(f"checksum mismatch in {path}/{entry['file']}")
        leaves[entry["name"]] = arr
    return leaves, manifest


def _unflatten(target: Any, leaves: List[Any]) -> Any:
    """``target``'s structure with its leaves replaced, in the order
    :func:`_flatten` walks them (``leaves`` is consumed from the front)."""
    if isinstance(target, dict):
        return {key: _unflatten(target[key], leaves)
                for key in sorted(target)}
    if isinstance(target, (list, tuple)):
        items = [_unflatten(item, leaves) for item in target]
        return items if isinstance(target, list) else tuple(items)
    return leaves.pop(0)


def restore_checkpoint(path: str, target: Any, device=None,
                       shardings: Optional[Any] = None) -> Tuple[Any, Dict]:
    """The checkpoint at ``path`` in the structure of ``target``, its
    leaves as torch tensors on ``device`` (default ``cuda``; raises
    without a card), and its metadata. The leaves fill ``target`` in
    flattening order, as the reference's ``restore_checkpoint`` does.
    ``shardings`` (a tree matching ``target`` of
    ``sharding.partition.NamedSharding`` on a ``DeviceMesh``, or None for
    a plain leaf) places each leaf as a DTensor; every rank reads the
    files and keeps its shard."""
    from repro_torch.device import resolve_device
    from repro_torch.sharding.partition import distribute

    dev = resolve_device(device)
    named, manifest = _verify_and_load(path)
    flat, _desc = _flatten(target)
    if len(flat) != len(named):
        raise ValueError(f"checkpoint {path} holds {len(named)} leaves, "
                         f"the target {len(flat)}")
    leaves = [torch.from_numpy(np.array(named[entry["name"]])).to(dev)
              for entry in manifest["leaves"]]
    if shardings is not None:
        sh, _ = _flatten(shardings, is_leaf=_is_sharding)
        if len(sh) != len(leaves):
            raise ValueError(f"{len(sh)} shardings for {len(leaves)} leaves")
        leaves = [t if s is None else distribute(t, s)
                  for t, (_, s) in zip(leaves, sh)]
    return _unflatten(target, leaves), manifest["metadata"]


def _is_sharding(x) -> bool:
    from repro_torch.sharding.partition import NamedSharding

    return x is None or isinstance(x, NamedSharding)


# ---------------------------------------------------------------------------
# placing a train state on a mesh and gathering it back
# ---------------------------------------------------------------------------

def _set_params(lm: torch.nn.Module, fn) -> None:
    """Replace every parameter ``p`` of ``lm`` by ``fn(name, p)`` (kept
    trainable as it was)."""
    for name, p in list(lm.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = lm.get_submodule(owner) if owner else lm
        setattr(mod, attr, torch.nn.Parameter(fn(name, p.detach()),
                                              requires_grad=p.requires_grad))


def shard_state(state: Any, cfg, mesh) -> Any:
    """A ``TrainState`` (or an ``LM``) placed on ``mesh`` (a
    ``DeviceMesh``): each parameter by ``param_specs``, the optimizer
    state by ``opt_shardings``, the step counters as they are. Every rank
    holds the same full state (the same seed, or the same checkpoint) and
    keeps its shards; nothing is communicated. The module and the
    state's dicts are changed in place, leaf by leaf."""
    from repro_torch.sharding.partition import (
        distribute,
        opt_shardings,
        param_shardings,
    )

    lm = state if isinstance(state, torch.nn.Module) else state.params
    p_sh = param_shardings(lm, cfg, mesh)
    _set_params(lm, lambda n, p: distribute(p, p_sh[n]))
    if isinstance(state, torch.nn.Module):
        return lm
    opt_sh = opt_shardings(state.opt_state, lm, cfg, mesh)
    # scalars (the step counters) stay plain tensors, the same on every
    # rank
    opt = _map2(lambda t, s: t if s is None or t.dim() == 0 else
                distribute(t, s),
                state.opt_state, opt_sh)
    return state._replace(params=lm, opt_state=opt)


def full_state(state: Any) -> Any:
    """The inverse of :func:`shard_state`: every DTensor gathered to its
    full tensor (a collective: every rank calls it)."""
    def full(t):
        return t.full_tensor() if is_dtensor(t) else t

    lm = state if isinstance(state, torch.nn.Module) else state.params
    _set_params(lm, lambda n, p: full(p))
    if isinstance(state, torch.nn.Module):
        return lm
    return state._replace(params=lm,
                          opt_state=_map2(lambda t, s: full(t),
                                          state.opt_state, state.opt_state))


def _map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over a nest of dicts and (named)
    tuples, ``other`` matching ``tree``'s structure. Dicts are updated in
    place, entry by entry, so each old leaf can go before the next is
    made (a full-width optimizer state has no room for two copies)."""
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _map2(fn, tree[k], other[k])
        return tree
    if isinstance(tree, tuple):
        items = [_map2(fn, a, b) for a, b in zip(tree, other)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return fn(tree, other)


def _parse_step(dirname: str) -> Optional[int]:
    if not dirname.startswith("step_") or dirname.endswith(".tmp"):
        return None
    try:
        return int(dirname[5:])
    except ValueError:
        return None


def committed_steps(directory: str) -> List[Tuple[int, str]]:
    """Committed ``(step, path)`` pairs, sorted numerically by step; []
    for a missing directory."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for d in names:
        step = _parse_step(d)
        full = os.path.join(directory, d)
        if step is not None and os.path.exists(
            os.path.join(full, "COMMITTED")
        ):
            out.append((step, full))
    return sorted(out, key=lambda sp: sp[0])


class CheckpointManager:
    """Step checkpoints under one directory, keeping the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, metadata)
        for _, old in committed_steps(self.directory)[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)
        return path

    def restore_latest(
        self,
    ) -> Optional[Tuple[Dict[str, np.ndarray], Dict, int]]:
        """Newest committed, checksum-valid checkpoint as
        ``({leaf name: array}, metadata, step)``, or None. A torn or
        corrupt step is skipped for the one before it."""
        for step, path in reversed(committed_steps(self.directory)):
            try:
                leaves, manifest = _verify_and_load(path)
            except (IOError, ValueError, KeyError):
                continue
            return leaves, manifest["metadata"], step
        return None

    def restore_step(self, step: int) -> Optional[Dict[str, np.ndarray]]:
        """The named host leaves of committed step ``step``, or None when
        that step is missing, torn or corrupt."""
        for s, path in committed_steps(self.directory):
            if s == step:
                try:
                    return _verify_and_load(path)[0]
                except (IOError, ValueError, KeyError):
                    return None
        return None

    def restore_latest_named(
        self,
    ) -> Optional[Tuple[Dict[str, np.ndarray], Dict, int]]:
        """The reference's name for :meth:`restore_latest`, which already
        returns named host leaves (a stream checkpoint's tree varies with
        the windows it retains)."""
        return self.restore_latest()


def save_lda_model(directory: str, n_wk, n_k, hyper, step: int = 0,
                   extra_metadata: Optional[Dict] = None,
                   keep: int = 3) -> str:
    """Checkpoint a trained model for serving (N_wk, N_k, hyper)."""
    meta = {
        "kind": _LDA_MODEL_KIND,
        "hyper": dataclasses.asdict(hyper),
        **(extra_metadata or {}),
    }
    manager = CheckpointManager(directory, keep=keep)
    return manager.save(step, {"n_k": n_k, "n_wk": n_wk}, meta)


def load_lda_model(directory: str):
    """Newest committed model checkpoint -> (n_wk, n_k, hyper, meta, step)
    with numpy count arrays. Raises ``FileNotFoundError`` when the
    directory holds no valid model checkpoint."""
    from repro_torch.core.types import LDAHyperParams

    got = CheckpointManager(directory).restore_latest()
    if got is None:
        raise FileNotFoundError(
            f"no committed LDA model checkpoint under {directory!r}"
        )
    leaves, meta, step = got
    if meta.get("kind") != _LDA_MODEL_KIND:
        raise FileNotFoundError(
            f"checkpoint under {directory!r} is not an LDA model "
            f"(kind={meta.get('kind')!r}); train with --checkpoint-dir"
        )
    hyper = LDAHyperParams(**meta["hyper"])
    return leaves["n_wk"], leaves["n_k"], hyper, meta, step
