"""Sharding rules (``repro/sharding/partition.py``): the LM's parameters,
batches and decode caches -> specs and DTensor placements, and the
load-balanced row layout of the serving tables.

The mesh is ``(pod?, data, model)``. Policy (the reference's):

* tensor parallelism over ``model``: vocab rows, attention head-flat
  columns, MLP hidden, MoE experts (when divisible), mamba inner channels;
* FSDP over the data axes (``pod`` + ``data``): the *other* big dim of
  every matrix;
* batch over the data axes; decode caches shard batch over data and the
  KV sequence over ``model`` (for batch 1 the sequence takes every axis).

A spec is a tuple with one entry per tensor dim (or fewer: missing
trailing entries are replicated), each ``None``, an axis name, or a tuple
of axis names, as a ``PartitionSpec`` holds them; ``()`` replicates.
:class:`NamedSharding` pairs a spec with a mesh and gives its DTensor
placements: a dim split over several axes is ``Shard(d)`` on each of
those mesh dims, in mesh order, which is JAX's major-to-minor order
(the first axis splits the dim into the outer blocks).

The reference's leaves are layer-stacked (a leading layer axis); the
port's ``LM`` holds one parameter per layer (``layers.3.attn.wq``). A
stacked path's rule is matched on the stacked shape, as the reference
matches it, and the layer axis's entry (always ``None``) is dropped.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import _balanced_ranges

Spec = Tuple[Any, ...]


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh order, for a ``DeviceMesh`` or any mesh
    with ``axis_names`` and a ``shape`` dict (``launch.mesh.AbstractMesh``,
    ``LocalMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes_of(mesh: Any) -> Tuple[str, ...]:
    return tuple(n for n in mesh_sizes(mesh) if n != "model")


def _axes_size(mesh: Any, axes) -> int:
    sizes = mesh_sizes(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([sizes[a] for a in axes]))


def _divides(n: int, mesh: Any, axes) -> bool:
    if axes is None:
        return True
    return n % _axes_size(mesh, axes) == 0


# trailing-dim rules per leaf name: tokens are resolved against the mesh,
# 'tp' -> model axis, 'fsdp' -> data axes, None -> replicated.
_RULES = {
    # embeddings: vocab x d_model, vocab over `model` only (no FSDP on
    # d_model: it would shard a contraction's reduced dim over the batch
    # axes)
    "embed": ("tp", None),
    "lm_head": ("tp", None),
    # attention (flat layouts): d_model x (heads*hd)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",),
    "bk": ("tp",),
    "bv": ("tp",),
    # MLA
    "wq_a": ("fsdp", "tp"),
    "wq_b": ("fsdp", "tp"),
    "wkv_a": ("fsdp", "tp"),
    "wkv_b": ("fsdp", "tp"),
    # MLP
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # MoE (3D: experts x in x out) — expert dim preferred on `model`
    "router": ("fsdp", None),
    # SSM
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "x_proj": ("tp", None),
    "dt_proj": (None, "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "a_log": ("tp", None),
    "dt_bias": ("tp",),
    "d": ("tp",),
    # mamba2 per-head vectors (H,)
    "a_log_h": ("tp",),
    "dt_bias_h": ("tp",),
    "d_h": ("tp",),
}

_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _spec_for(path_names: Tuple[str, ...], shape: Tuple[int, ...],
              cfg: ArchConfig, mesh: Any) -> Spec:
    """The reference's rule for a leaf of ``shape`` (stacked where the
    reference stacks it) at tree path ``path_names``."""
    data_axes = data_axes_of(mesh)
    name = path_names[-1] if path_names else ""
    is_moe = cfg.moe is not None and "moe" in path_names \
        and name in _MOE_LEAVES

    def resolve(token, dim):
        if token == "tp":
            return "model" if _divides(dim, mesh, "model") else None
        if token == "fsdp":
            return data_axes if _divides(dim, mesh, data_axes) else None
        return None

    if is_moe:
        ep = _divides(cfg.moe.num_experts, mesh, "model")
        if name in ("w_gate", "w_up"):  # (E, D, F)
            rule = (("tp" if ep else None), "fsdp", (None if ep else "tp"))
        else:  # w_down (E, F, D)
            rule = (("tp" if ep else None), (None if ep else "tp"), "fsdp")
        trailing = 3
    else:
        rule = _RULES.get(name)
        if rule is None:
            return ()  # replicate small leaves (norm scales, lengths, ...)
        trailing = len(rule)
    if len(shape) < trailing:
        return ()
    dims = shape[-trailing:]
    resolved = tuple(resolve(tok, d) for tok, d in zip(rule, dims))
    # avoid double-assigning the same mesh axis to two dims of one leaf
    seen = set()
    final = []
    for r in resolved:
        key = tuple(r) if isinstance(r, tuple) else (r,)
        if r is not None and any(k in seen for k in key):
            final.append(None)
        else:
            final.append(r)
            seen.update(k for k in key if k is not None)
    return (None,) * (len(shape) - trailing) + tuple(final)


def _leaf_shapes(params: Any) -> Dict[str, Tuple[int, ...]]:
    """{parameter name: shape} of an ``LM`` (``named_parameters``) or of a
    dict of tensors / shapes keyed by parameter name."""
    if hasattr(params, "named_parameters"):
        items = params.named_parameters()
    else:
        items = params.items()
    return {n: tuple(getattr(p, "shape", p)) for n, p in items}


def param_specs(params: Any, cfg: ArchConfig, mesh: Any
                ) -> Dict[str, Spec]:
    """{parameter name: spec} for every parameter of ``params`` (an ``LM``,
    or {name: tensor or shape}). A per-layer parameter takes the rule of
    its stacked leaf, as the reference gives it, without the layer axis's
    entry."""
    from repro_torch.models.convert import _tree_path

    shapes = _leaf_shapes(params)
    stack_len: Dict[Tuple[str, ...], int] = {}
    for name in shapes:
        keys, index = _tree_path(name)
        if index is not None:
            k = tuple(keys)
            stack_len[k] = max(stack_len.get(k, 0), index + 1)
    out = {}
    for name, shape in shapes.items():
        keys, index = _tree_path(name)
        if index is None:
            out[name] = _spec_for(tuple(keys), shape, cfg, mesh)
            continue
        stacked = (stack_len[tuple(keys)],) + shape
        spec = _spec_for(tuple(keys), stacked, cfg, mesh)
        if spec and spec[0] is not None:
            raise ValueError(f"{name}: the stacked rule {spec} shards the "
                             f"layer axis, which a per-layer leaf lacks")
        out[name] = spec[1:]
    return out


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``); on a
    ``DeviceMesh`` its :attr:`placements` are DTensor's."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh)


def placements_of(spec: Spec, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim d's entry names that axis and the axis
    has more than one device, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if any(a not in names for a in axes):
            raise ValueError(f"spec {spec} names axes the mesh {names} "
                             f"lacks")
        if list(axes) != sorted(axes, key=names.index):
            # DTensor nests a dim's shards in mesh order
            raise ValueError(f"spec entry {axes} is not in mesh order")
        for axis in axes:
            if axis in owner:
                raise ValueError(f"spec {spec} names axis {axis!r} twice")
            owner[axis] = d
    sizes = mesh_sizes(mesh)
    # a dim split one way is whole: DTensor is given Replicate there
    return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                 else Replicate() for a in names)


def param_shardings(params: Any, cfg: ArchConfig, mesh: Any
                    ) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(params, cfg, mesh).items()}


def opt_shardings(opt_state: Any, params: Any, cfg: ArchConfig,
                  mesh: Any) -> Any:
    """Optimizer-state shardings (the reference's ``_opt_shardings``):
    AdamW's moments follow their parameter's rule; Adafactor's statistics
    (per tree path, stacked) take the stacked leaf's rule, a factored one
    with the reduced dim dropped; scalars replicate."""
    from repro_torch.models.convert import _tree_path
    from repro_torch.train.optimizer import (
        AdafactorState,
        AdamWState,
        FactoredStat,
    )

    specs = param_specs(params, cfg, mesh)
    rep = NamedSharding(mesh, ())
    if isinstance(opt_state, AdamWState):
        return AdamWState(
            step=rep,
            m={n: NamedSharding(mesh, specs[n]) for n in opt_state.m},
            v={n: NamedSharding(mesh, specs[n]) for n in opt_state.v})
    assert isinstance(opt_state, AdafactorState)
    stacked: Dict[str, Spec] = {}
    for name, spec in specs.items():
        keys, index = _tree_path(name)
        stacked[".".join(keys)] = spec if index is None else (None,) + spec

    def stat_sh(path, stat):
        spec = stacked[path]
        if isinstance(stat, FactoredStat):
            row = spec[:-1]
            col = spec[:-2] + spec[-1:] if len(spec) >= 2 else ()
            return FactoredStat(row=NamedSharding(mesh, row),
                                col=NamedSharding(mesh, col))
        return NamedSharding(mesh, spec)

    return AdafactorState(step=rep, stats={
        p: stat_sh(p, s) for p, s in opt_state.stats.items()})


# ---------------------------------------------------------------------------
# row sharding for serving tables (LDA word-topic counts)
# ---------------------------------------------------------------------------

def shard_rows_balanced(
    loads: np.ndarray, shards: int
) -> Tuple[np.ndarray, int]:
    """Assign rows to ``shards`` bins by greedy LPT on ``loads`` (the
    heuristic ``core.graph.grid_partition`` uses for word columns), then
    relabel so each bin's rows are contiguous and every bin is padded to
    the largest bin.

    Returns ``(perm, rows_per_shard)``: ``perm[old_row]`` is the row in the
    padded ``(shards * rows_per_shard, ...)`` layout, in bin
    ``perm[r] // rows_per_shard``; pad rows (outside ``perm``'s image) are
    the caller's to zero-fill.
    """
    loads = np.asarray(loads, dtype=np.float64).reshape(-1)
    assign = _balanced_ranges(loads, shards)
    counts = np.bincount(assign, minlength=shards)
    per = max(int(counts.max()), 1)
    perm = np.empty(loads.shape[0], dtype=np.int64)
    for b in range(shards):
        ids = np.where(assign == b)[0]
        perm[ids] = b * per + np.arange(ids.size)
    return perm, per


# ---------------------------------------------------------------------------
# batch + cache shardings
# ---------------------------------------------------------------------------

def batch_spec(mesh: Any, ndim: int, batch_divisible: bool = True) -> Spec:
    lead = data_axes_of(mesh) if batch_divisible else None
    return (lead,) + (None,) * (ndim - 1)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", leaf))


def _tree_map(fn, tree):
    """``fn`` over a nest of dicts, lists and tuples (NamedTuples kept);
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def batch_sharding(batch: Any, mesh: Any) -> Any:
    """Shard dim 0 (the global batch) over the data axes when divisible."""
    dp = _axes_size(mesh, data_axes_of(mesh))

    def one(leaf):
        shape = _shape(leaf)
        ok = bool(shape) and shape[0] % dp == 0
        return NamedSharding(mesh, batch_spec(mesh, len(shape), ok))

    return _tree_map(one, batch)


def cache_sharding(caches: Any, mesh: Any) -> Any:
    """Decode caches: (L, B, S, H?, D?) -> batch over the data axes if it
    divides, else the KV sequence over them; the sequence over ``model``
    (flash-decode layout)."""
    data_axes = data_axes_of(mesh)
    dp = _axes_size(mesh, data_axes)
    mp = mesh_sizes(mesh)["model"]

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) < 3:
            return NamedSharding(mesh, ())
        b, s = shape[1], shape[2]
        b_ax = data_axes if b % dp == 0 else None
        s_ax = "model" if s % mp == 0 and s > 1 else None
        if b_ax is None and s % (dp * mp) == 0 and s > 1:
            # batch=1 long-context: the sequence takes every axis
            spec = [None, None, data_axes + ("model",)]
        else:
            spec = [None, b_ax, s_ax]
        spec += [None] * (len(shape) - 3)
        return NamedSharding(mesh, tuple(spec))

    return _tree_map(one, caches)


def distribute(t, sharding: NamedSharding):
    """``t`` (the global tensor, the same on every rank: the same seed or
    the same checkpoint) as a DTensor on ``sharding.mesh`` (a
    ``DeviceMesh``): each rank keeps its shard of its own copy, with no
    communication. On a mesh of one device the DTensor wraps ``t`` itself
    (no copy)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if sharding.mesh.size() == 1:
        return DTensor.from_local(t, sharding.mesh, sharding.placements,
                                  run_check=False)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)
