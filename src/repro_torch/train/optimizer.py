"""Optimizers built from scratch (``repro/train/optimizer.py``): AdamW and
Adafactor.

Parameters are an ``nn.Module`` (an ``LM``) or a dict of tensors, named as
the module names them (``layers.3.attn.wq``, nested dicts joined by
dots); gradients are a dict under the same names. Updates are applied in
place, under ``torch.no_grad()``, and return ``(params, state, {"grad_norm":
...})`` as the reference's do (it donates its state; at full width a
second copy of the parameters does not fit). Every step of the
arithmetic is float32 in the reference's order, the step counter an int32
tensor, so nothing syncs with the host.

AdamW keeps float32 ``m`` and ``v``, one per parameter, and updates leaf
by leaf (in slices of a large leaf). Adafactor works on the reference's leaves: the L per-layer
parameters of one tree path (``layers.*.attn.wq``) are one stacked
(L, ...) leaf there, and both its factoring (``_factorable`` of the stacked
shape) and its RMS-1 update clip are taken over that stack. So its
statistics are kept per tree path in the reference's stacked layout, and
each path's update is computed on the stacked gradients and written back
into every layer's parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple, Union

import torch
from torch import nn

from repro_torch.models.convert import _tree_path
from repro_torch.sharding.dtensor import local, reduce_partials

Params = Union[nn.Module, Dict[str, Any]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    min_dim_size_to_factor: int = 128


def named_leaves(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for every leaf: a module's named parameters, or a
    dict's leaves under their dotted paths."""
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], f"{prefix}{key}.")
        else:
            out.append((prefix[:-1], tree))

    walk(params, "")
    return out


def _device(leaves) -> torch.device:
    return leaves[0][1].device if leaves else torch.device("cpu")


# AdamW updates a leaf in flat slices of this many elements: the update is
# elementwise, so slicing changes no value, and it bounds the float32
# temporaries (a full-width embedding table is 623M elements)
_CHUNK = 1 << 26


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Dict[str, torch.Tensor]  # float32, one per parameter
    v: Dict[str, torch.Tensor]


def _moment(p: torch.Tensor) -> torch.Tensor:
    """A float32 zero moment of ``p``'s shape (a DTensor parameter's in
    its placements)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def adamw_init(params: Params) -> AdamWState:
    leaves = named_leaves(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(leaves)),
        m={n: _moment(p) for n, p in leaves},
        v={n: _moment(p) for n, p in leaves})


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(local(reduce_partials(torch.sum(torch.square(
        g.to(torch.float32))))) for g in grads))


def _clip(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm before clipping). The reference returns ``g *
    scale`` for every leaf, which promotes a bf16 gradient to float32; the
    updates form that product leaf by leaf (``g.float() * scale``), so no
    float32 copy of every gradient is held at once. A DTensor gradient's
    square sum is reduced over its shards first, so both are plain
    tensors, the same on every rank."""
    gn = _global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return scale, gn


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState,
                 cfg: OptConfig) -> Tuple[Params, AdamWState, dict]:
    g_by = dict(named_leaves(grads))
    scale, gn = _clip(g_by.values(), cfg.grad_clip)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.beta1 ** t
    bc2 = 1.0 - cfg.beta2 ** t
    for name, p in named_leaves(params):
        # a DTensor's update runs on this rank's shard: the parameter, its
        # gradient and moments share placements, and the update is
        # elementwise
        for pc, gc, m, v in zip(*(local(x).view(-1).split(_CHUNK) for x in (
                p, g_by[name], state.m[name], state.v[name]))):
            g = gc.to(torch.float32) * scale
            m.mul_(cfg.beta1).add_(g * (1 - cfg.beta1))
            v.mul_(cfg.beta2).add_((g * (1 - cfg.beta2)).mul_(g))
            del g
            pf = pc.to(torch.float32)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            delta.add_(cfg.weight_decay * pf)
            pc.copy_(pf - cfg.learning_rate * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gn}


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

class FactoredStat(NamedTuple):
    row: torch.Tensor  # (..., n) mean over last dim
    col: torch.Tensor  # (..., m) mean over second-to-last dim


class AdafactorState(NamedTuple):
    step: torch.Tensor  # () int32
    # per tree path (``layers.attn.wq``), in the reference's stacked
    # layout: a FactoredStat for factored leaves, the full v otherwise
    stats: Dict[str, Any]


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def tree_paths(params: Params
               ) -> List[Tuple[str, List[Tuple[str, torch.Tensor]], bool]]:
    """The reference's leaves: ``(tree path, the port's named parameters
    of that path in layer order, stacked?)``. A stacked path's parameter
    names carry a layer index; a path outside any stack has one
    parameter."""
    paths: Dict[str, List[Tuple[int, str, torch.Tensor]]] = {}
    for name, p in named_leaves(params):
        keys, index = _tree_path(name)
        paths.setdefault(".".join(keys), []).append(
            (-1 if index is None else index, name, p))
    return [(k, [(n, p) for _, n, p in sorted(v, key=lambda e: e[0])],
             v[0][0] >= 0) for k, v in paths.items()]


def _stack_shape(leaves, stacked: bool):
    shape = tuple(leaves[0][1].shape)
    return ((len(leaves),) + shape) if stacked else shape


def adafactor_init(params: Params) -> AdafactorState:
    stats = {}
    for path, leaves, stacked in tree_paths(params):
        shape = _stack_shape(leaves, stacked)
        dev = leaves[0][1].device
        if _factorable(shape):
            stats[path] = FactoredStat(row=_zeros(shape[:-1], dev),
                                       col=_zeros(shape[:-2] + shape[-1:],
                                                  dev))
        else:
            stats[path] = _zeros(shape, dev)
    leaves = named_leaves(params)
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_device(leaves)),
        stats=stats)


@torch.no_grad()
def adafactor_update(params: Params, grads: Params, state: AdafactorState,
                     cfg: OptConfig) -> Tuple[Params, AdafactorState, dict]:
    g_by = dict(named_leaves(grads))
    scale, gn = _clip(g_by.values(), cfg.grad_clip)
    step = state.step + 1
    t = step.to(torch.float32)
    beta2t = 1.0 - t ** (-cfg.decay_rate)
    for path, leaves, stacked in tree_paths(params):
        gs = [g_by[n].to(torch.float32) for n, _ in leaves]
        g = (torch.stack(gs) if stacked else gs[0]) * scale
        del gs
        g2 = g * g + 1e-30
        s = state.stats[path]
        if isinstance(s, FactoredStat):
            s.row.copy_(beta2t * s.row + (1 - beta2t) * torch.mean(g2, -1))
            s.col.copy_(beta2t * s.col + (1 - beta2t) * torch.mean(g2, -2))
            row_mean = torch.mean(s.row, dim=-1, keepdim=True)
            vhat = (s.row[..., :, None]
                    / torch.clamp_min(row_mean[..., None], 1e-30)) \
                * s.col[..., None, :]
            update = g * torch.rsqrt(torch.clamp_min(vhat, 1e-30))
        else:
            s.copy_(beta2t * s + (1 - beta2t) * g2)
            update = g * torch.rsqrt(torch.clamp_min(s, 1e-30))
        del g, g2
        # update clipping (Adafactor's RMS-1 rule), over the whole stack
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        ps = [p.to(torch.float32) for _, p in leaves]
        pf = torch.stack(ps) if stacked else ps[0]
        del ps
        new = pf - cfg.learning_rate * update \
            - cfg.learning_rate * cfg.weight_decay * pf
        for i, (_, p) in enumerate(leaves):
            p.copy_(new[i] if stacked else new)
    return params, AdafactorState(step=step, stats=state.stats), {
        "grad_norm": gn}


def make_optimizer(kind: str, cfg: OptConfig):
    """(init_fn, update_fn) pair."""
    if kind == "adamw":
        return adamw_init, lambda p, g, s: adamw_update(p, g, s, cfg)
    if kind == "adafactor":
        return adafactor_init, lambda p, g, s: adafactor_update(p, g, s, cfg)
    raise ValueError(kind)
