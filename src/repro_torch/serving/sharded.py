"""Sharded serving: the frozen model's word rows over a ``(1, m)`` mesh
(``repro/serving/sharded.py``).

Training shards ``N_w|k`` by word rows (``core.graph`` grid partition);
this module gives serving the same layout. A
:class:`ShardedFrozenLDAModel` lays the frozen rows over the mesh's
``model`` axis, LPT-balanced by row token mass and relabeled contiguous
per shard (``sharding.shard_rows_balanced``), and
:func:`make_sharded_sweep_fn` turns any backend's ``infer_sweep`` into a
per-shard dispatch over that layout.

It stays in one process, as the reference's single-controller
``shard_map`` does: the m row blocks lie on the mesh's list of local
devices (on one card every block is on ``cuda:0``), each block's sweep
is launched on its device, and the owned assignments are summed on the
first device. The engine, its ticker, its reload and the router are one
process too, in both packages.

Correctness rests on the ``infer_sweep`` contract (``algorithms/base``):
every per-slot key is consumed at the full (B, L) layout and every draw
is per token, so a shard that computes the whole batch and keeps only
the tokens whose word rows it owns draws bit for bit what the unsharded
sweep draws. Each shard maps the batch's word ids to its local rows,
masks down to its owned tokens, and runs the unmodified ``infer_sweep``
on its ``(W_pad / m, K)`` block with ``num_words_total`` the true W
(``W·β`` must not see the block shape); every real token is owned by
exactly one shard, so the sum is the combined sweep. Backend tables
follow the split: ``prepare_infer`` runs per block, so the fields a
backend declares word-indexed (``infer_aux_word_fields``, e.g.
``zen_cdf``'s per-word CDFs) come out per shard and the topic-indexed
ones alike on every shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import LDAHyperParams


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedFrozenLDAModel:
    """A frozen model laid out over a mesh: word rows LPT-balanced over
    the ``model`` axis, padded to equal blocks, ``n_k`` on every shard's
    device.

    It stands in for ``FrozenLDAModel`` wherever the engine reads one
    (``num_words``/``num_topics``/``hyper``/``phi()``/``device``), but its
    ``n_wk`` is the relabeled padded ``(words_per_shard * m, K)`` layout;
    the engine relabels request ids at slot placement (:meth:`relabel`).
    ``eq=False``: slots compare by identity."""

    n_wk: torch.Tensor  # (W_pad, K) int32 on the first device
    n_k: torch.Tensor  # (K,) int32 on the first device
    hyper: LDAHyperParams
    mesh: Any  # launch.mesh.LocalMesh
    word_perm: np.ndarray  # (W,) original row -> padded shard-space row
    words_per_shard: int
    num_words_unsharded: int  # the true W
    blocks: Tuple[torch.Tensor, ...]  # (words_per_shard, K) per shard
    n_k_blocks: Tuple[torch.Tensor, ...]  # n_k on each shard's device

    @property
    def num_words(self) -> int:
        """The original vocabulary size W: ids and ``phi()`` speak it."""
        return self.num_words_unsharded

    @property
    def num_topics(self) -> int:
        return int(self.n_wk.shape[1])

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape["model"])

    @property
    def device(self) -> torch.device:
        return self.n_wk.device

    def relabel(self, words: np.ndarray) -> np.ndarray:
        """Original token ids -> shard-space rows (host, at placement);
        ids must already lie in ``[0, W)``."""
        return self.word_perm[np.asarray(words, np.int64)].astype(np.int32)

    def phi(self) -> torch.Tensor:
        """Smoothed topic-word distributions (W, K) in the original word
        order: the relabeling inverted."""
        perm = torch.from_numpy(self.word_perm).to(self.device)
        n_wk = self.n_wk[perm].to(torch.float32)
        w_beta = self.num_words * self.hyper.beta
        return (n_wk + self.hyper.beta) / (
            self.n_k.to(torch.float32) + w_beta)[None, :]

    @classmethod
    def shard(cls, model, mesh) -> "ShardedFrozenLDAModel":
        """Lay ``model`` out over ``mesh``'s ``model`` axis: rows assigned
        by token mass (hot words spread first), relabeled contiguous per
        shard, zero-padded to the largest bin; block j on the mesh's j-th
        ``model`` device (a view where it is the first device)."""
        from repro_torch.sharding.partition import shard_rows_balanced

        devices = mesh.axis_devices("model")
        n_wk = model.n_wk.to(torch.int32)
        w, k = n_wk.shape
        m = len(devices)
        loads = n_wk.sum(1, dtype=torch.int64).cpu().numpy()
        perm, per = shard_rows_balanced(loads, m)
        dev0 = devices[0]
        padded = torch.zeros((per * m, k), dtype=torch.int32, device=dev0)
        padded[torch.from_numpy(perm).to(dev0)] = n_wk.to(dev0)
        n_k = model.n_k.to(torch.int32).to(dev0)
        return cls(
            n_wk=padded, n_k=n_k, hyper=model.hyper, mesh=mesh,
            word_perm=perm, words_per_shard=per, num_words_unsharded=w,
            blocks=tuple(padded[j * per:(j + 1) * per].to(d)
                         for j, d in enumerate(devices)),
            n_k_blocks=tuple(n_k.to(d) for d in devices),
        )


def layout_key(model) -> Optional[Tuple[int, int, int]]:
    """The static layout a sharded sweep function closes over: two model
    slots share those functions only when these match (a plain frozen
    model has none: None)."""
    if isinstance(model, ShardedFrozenLDAModel):
        return (model.words_per_shard, model.num_words_unsharded,
                model.num_shards)
    return None


def sharded_prepare_infer(backend, smodel: ShardedFrozenLDAModel,
                          knobs) -> Tuple[Any, ...]:
    """The backend's frozen tables, one per shard: the unmodified
    ``prepare_infer`` on each ``(words_per_shard, K)`` block with
    ``num_words_total`` the true W, so each table row is a function of its
    own count row and the topic vectors (bit-equal rows to an unsharded
    build). The fields named in ``infer_aux_word_fields`` hold the block's
    rows; the others are the same on every shard."""
    out = []
    word_fields = backend.infer_aux_word_fields
    for blk, n_k in zip(smodel.blocks, smodel.n_k_blocks):
        aux = backend.prepare_infer(blk, n_k, smodel.hyper, knobs,
                                    num_words_total=smodel.num_words)
        for name in word_fields:
            rows = getattr(aux, name).shape[0]
            if rows != smodel.words_per_shard:
                raise ValueError(f"{backend.name}: word field {name} has "
                                 f"{rows} rows for a block of "
                                 f"{smodel.words_per_shard}")
        out.append(aux)
    return tuple(out)


def make_sharded_sweep_fn(backend, knobs, smodel: ShardedFrozenLDAModel
                          ) -> Callable[..., torch.Tensor]:
    """The sharded counterpart of one bucket sweep:
    ``fn(keys, words, mask, z, n_kd, blocks, n_k_blocks, aux) -> (B, L)``
    with ``words`` in shard space (:meth:`ShardedFrozenLDAModel.relabel`)
    and the model's blocks, ``n_k`` copies and per-shard tables passed in,
    so one function serves every bucket width and every slot of the same
    :func:`layout_key` and hyper-parameters. Returns the proposed topics, 0 where ``mask`` is
    False; each shard keeps the tokens it owns and the parts are summed on
    the first shard's device."""
    hyper = smodel.hyper
    wps, w_total = smodel.words_per_shard, smodel.num_words

    def fn(keys, words, mask, z, n_kd, blocks, n_k_blocks, aux):
        out = None
        for j, blk in enumerate(blocks):
            dev = blk.device
            wl = words.to(dev) - j * wps
            owned = mask.to(dev) & (wl >= 0) & (wl < wps)
            wl = torch.clamp(wl, 0, wps - 1).to(torch.int32)
            z_prop = backend.infer_sweep(
                keys.to(dev), wl, owned, z.to(dev), n_kd.to(dev), blk,
                n_k_blocks[j], hyper, knobs, aux[j],
                num_words_total=w_total)
            part = torch.where(owned, z_prop.to(torch.int32), 0)
            part = part.to(blocks[0].device)
            out = part if out is None else out + part
        return out

    return fn
