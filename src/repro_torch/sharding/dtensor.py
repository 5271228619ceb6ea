"""The few places where the LM's code meets DTensor parameters.

The model, the train step and the optimizers run unchanged on
``torch.distributed.tensor.DTensor`` parameters (``sharding.partition``
places them) wherever DTensor's sharding propagation has a rule. What is
here covers the rest, and each helper is the identity on plain tensors,
so the one-card path keeps its exact values:

* :func:`dtensor_scope` lets plain tensors the model builds on the fly
  (position ids, ``arange``\\ s, zero carries) enter DTensor ops as
  replicated values;
* :func:`like_batch` shards such a tensor's batch dim as an activation's,
  so a per-sequence mask is built per device and not for the global batch;
* :func:`reduce_partials` carries out a pending (partial) sum at once,
  where a value is needed whole (a gradient's square sum for the clip, a
  gathered logit, an embedded row);
* :func:`as_activation` lays an activation out batch-sharded and
  replicated over every other mesh dim (the layout a vocab-sharded
  product needs, where DTensor would otherwise gather the table);
* :func:`split_dim` reshapes one dim into several (head-flat columns into
  (heads, dim), heads into (kv heads, groups)) after replicating it when
  the mesh cannot split the leading size, and :func:`merge_dims` the
  inverse, its gradient laid out as its output was (the backward split
  would meet the same refusal);
* :func:`gather_last` is ``torch.gather`` along a vocab-sharded last dim
  as each shard's local gather, summed over the shards (DTensor's rule
  builds its backward in a zero tensor of the global shape), and
  :func:`embed_rows` the embedding lookup in a vocab-sharded table the
  same way (DTensor's rule leaves a masked partial sum that its
  redistribution cannot carry through every version's backward);
* :func:`write_slot` is a decode cache's in-place slot write on a
  sequence-sharded cache: the rank whose shard holds the slot writes it
  (DTensor has no rule for ``index_copy_`` along a sharded dim);
* :func:`run_local` runs a per-sequence function (the SSM scans) on each
  device's batch shard;
* :func:`local` is a DTensor's shard on this rank (a plain tensor as it
  is).
"""
from __future__ import annotations

import contextlib

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def is_split(t) -> bool:
    """A DTensor with a dim sharded (or a sum pending) over a mesh dim of
    more than one device: on a mesh of one device every helper here takes
    the plain ops, so its values are the plain path's."""
    return is_dtensor(t) and any(
        not p.is_replicate() and n > 1
        for p, n in zip(t.placements, t.device_mesh.shape))


@contextlib.contextmanager
def _implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``,
    nestable: the flag is restored on exit, not cleared."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def dtensor_scope(t):
    """A context in which plain tensors meeting DTensors are taken as
    replicated, when ``t`` is a DTensor; else a no-op."""
    if not is_dtensor(t):
        return contextlib.nullcontext()
    return _implicit_replication()


def local(t):
    return t.to_local() if is_dtensor(t) else t


def like_batch(t: torch.Tensor, x) -> torch.Tensor:
    """``t`` (the same on every rank, batch-major) sharded along dim 0 as
    DTensor ``x``'s dim 0 is, replicated over every other mesh dim; ``t``
    itself when ``x`` is plain. No communication: each rank keeps its
    chunk of ``t``."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, x.device_mesh, _batch_placements(x),
                             src_data_rank=None)


def reduce_partials(t):
    """A DTensor with every ``Partial`` placement reduced (to
    ``Replicate``); a plain tensor as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def _batch_placements(x) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]


def _activation_placements(x) -> list:
    from torch.distributed.tensor import Replicate

    names = x.device_mesh.mesh_dim_names or ()
    return [Replicate() if i < len(names) and names[i] == "model" else p
            for i, p in enumerate(_batch_placements(x))]


def as_activation(x):
    """DTensor ``x`` sharded along dim 0 (the batch) over the data axes
    where it already is, replicated over ``model`` and every other mesh
    dim; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    pl = _activation_placements(x)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_dim(t, dim: int, sizes):
    """``t`` with dim ``dim`` reshaped into ``sizes`` (leading size
    first). A DTensor sharded along ``dim`` over mesh dims that do not
    divide ``sizes[0]`` is replicated along it first (DTensor refuses such
    a view)."""
    dim = dim % t.ndim
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        t = reduce_partials(t)
        ways = 1
        for p, n in zip(t.placements, t.device_mesh.shape):
            if isinstance(p, Shard) and p.dim == dim:
                ways *= n
        if sizes[0] % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in t.placements])
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def gather_last(x, index):
    """``torch.gather(x, -1, index)``; for a DTensor ``x`` sharded along
    its last dim, each rank gathers the indices its shard holds (0
    elsewhere) and the shards' results are summed, so only one shard adds
    a non-zero value and the sum is exact."""
    if not is_dtensor(x):
        return torch.gather(x, -1, index)
    from torch.distributed.tensor import DTensor, Partial, Shard

    last = x.ndim - 1
    x = reduce_partials(x)
    mesh = x.device_mesh
    lo, n = _shard_box(x, last)
    # the index follows x's batch sharding, replicated elsewhere
    if not is_dtensor(index):
        index = like_batch(index, x)
    index = index.redistribute(mesh, _batch_placements(x))
    xl, il = x.to_local(), index.to_local()
    rel = il - lo
    inside = (rel >= 0) & (rel < n)
    got = torch.gather(xl, -1, rel.clamp(0, n - 1))
    got = torch.where(inside, got, torch.zeros_like(got))
    out_pl = [Partial("sum") if isinstance(p, Shard) and p.dim == last
              else p for p in x.placements]
    out = DTensor.from_local(got, mesh, out_pl, run_check=False,
                             shape=index.shape,
                             stride=_contiguous(index.shape))
    return reduce_partials(out)


class _GradAsOutput(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the forward value
    was laid out."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = reduce_partials(g).redistribute(ctx.mesh, ctx.placements)
        return g


def merge_dims(t, dim: int, count: int):
    """``t`` with dims ``dim .. dim + count - 1`` merged into one."""
    dim = dim % t.ndim
    size = 1
    for n in t.shape[dim:dim + count]:
        size *= n
    out = t.reshape(*t.shape[:dim], size, *t.shape[dim + count:])
    return _GradAsOutput.apply(out) if is_dtensor(out) else out


def write_slot(cache, new, idx, dim: int = 1) -> None:
    """``cache.index_copy_(dim, idx, new)`` for a DTensor ``cache`` (the
    index a replicated or plain (1,) tensor, ``new`` of size 1 along
    ``dim``): ``new`` is laid out as the cache is but replicated along
    ``dim``, and each rank writes the slot into its shard when the shard
    holds it (a write of the value already there otherwise), in place."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in cache.placements]
    if not is_dtensor(new):
        new = like_batch(new, cache)
    new = reduce_partials(new).redistribute(mesh, pl).to_local()
    lo, n = _shard_box(cache, dim)
    loc = cache.to_local()
    rel = local(reduce_partials(idx)) - lo
    inside = ((rel >= 0) & (rel < n)).reshape([1] * loc.ndim)
    rel = rel.clamp(0, n - 1)
    old = loc.index_select(dim, rel)
    loc.index_copy_(dim, rel, torch.where(inside, new.to(loc.dtype), old))


def run_local(fn, *args):
    """``fn(*args)`` for a function that treats each sequence (dim 0) on
    its own. With DTensor arguments, each is laid out batch-sharded as
    :func:`as_activation` lays out the first, ``fn`` runs on this rank's
    shards, and its result is that batch shard of the output."""
    first = next((a for a in args if is_dtensor(a)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor

    pl = _activation_placements(first)
    mesh = first.device_mesh
    out = fn(*(reduce_partials(a).redistribute(mesh, pl).to_local()
               if is_dtensor(a) else a for a in args))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _shard_box(t, dim: int):
    """(offset, length) of this rank's shard of DTensor ``t`` along
    ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return offset[dim], shape[dim]


def embed_rows(table, ids):
    """``table[ids]`` for a DTensor ``table`` sharded along its rows (or
    replicated): each rank looks up the ids its rows hold (zeros for the
    rest) and the shards' results are summed, exactly (one shard adds a
    non-zero row). ``ids`` follow their batch sharding, replicated over
    the mesh dims that shard the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if any(isinstance(p, Shard) and p.dim != 0 for p in table.placements):
        raise ValueError(f"embedding table placements {table.placements}")
    if not is_dtensor(ids):
        ids = like_batch(ids, table)
    id_pl = [Replicate() if isinstance(tp, Shard) else
             (ip if isinstance(ip, Shard) and ip.dim == 0 else Replicate())
             for tp, ip in zip(table.placements, ids.placements)]
    ids = ids.redistribute(mesh, id_pl)
    lo, n = _shard_box(table, 0)
    rel = ids.to_local().long() - lo
    inside = ((rel >= 0) & (rel < n))[..., None]
    # the table's gradient from this rank's ids is a partial sum over the
    # mesh dims that shard the ids and replicate the table
    grad_pl = [Partial("sum") if isinstance(ip, Shard)
               and not isinstance(tp, Shard) else tp
               for tp, ip in zip(table.placements, id_pl)]
    rows = torch.nn.functional.embedding(
        rel.clamp(0, n - 1), table.to_local(grad_placements=grad_pl))
    rows = torch.where(inside, rows, torch.zeros_like(rows))
    out_pl = [Partial("sum") if isinstance(tp, Shard) else ip
              for tp, ip in zip(table.placements, id_pl)]
    shape = tuple(ids.shape) + (table.shape[1],)
    out = DTensor.from_local(rows, mesh, out_pl, run_check=False,
                             shape=shape, stride=_contiguous(shape))
    return reduce_partials(out)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
