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

_LDA_MODEL_KIND = "lda_model"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, prefix: str = "") -> Tuple[List[Tuple[str, Any]],
                                                    str]:
    """(name, leaf) pairs in jax's flattening order, and the tree's
    description in the form ``str(jax treedef)`` gives it."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, desc = _flatten(tree[key], f"{prefix}{key}/")
            leaves += sub
            parts.append(f"{key!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for i, item in enumerate(tree):
            sub, desc = _flatten(item, f"{prefix}{i}/")
            leaves += sub
            parts.append(desc)
        inner = ", ".join(parts)
        if isinstance(tree, list):
            return leaves, f"[{inner}]"
        return leaves, f"({inner}{',' if len(parts) == 1 else ''})"
    return [(prefix.rstrip("/") or "leaf", tree)], "*"


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Atomic, checksummed save of a tree of tensors/arrays."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat, desc = _flatten(tree)
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


def restore_checkpoint(path: str, target: Any,
                       device=None) -> Tuple[Any, Dict]:
    """The checkpoint at ``path`` in the structure of ``target``, its
    leaves as torch tensors on ``device`` (default ``cuda``; raises
    without a card), and its metadata. The leaves fill ``target`` in
    flattening order, as the reference's ``restore_checkpoint`` does."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    named, manifest = _verify_and_load(path)
    flat, _desc = _flatten(target)
    if len(flat) != len(named):
        raise ValueError(f"checkpoint {path} holds {len(named)} leaves, "
                         f"the target {len(flat)}")
    leaves = [torch.from_numpy(np.array(named[entry["name"]])).to(dev)
              for entry in manifest["leaves"]]
    return _unflatten(target, leaves), manifest["metadata"]


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
