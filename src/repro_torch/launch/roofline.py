"""Roofline terms of a dry-run record (``repro/launch/roofline.py``),
with one NVIDIA H100 SXM5's constants:

  compute    = flops_per_device / 989e12             (dense BF16 tensor-core
                                                      peak, NVIDIA's data sheet)
  memory     = bytes_per_device / 3.35e12            (HBM3, the data sheet;
                                                      the rate PERF.md's kernel
                                                      bounds use)
  collective = collective_bytes_per_device / 450e9   (NVLink 4: 900 GB/s per
                                                      GPU, 450 GB/s each way)

The peaks assume the card's full 700 W power limit. A record's counts are
per device, so each term divides by one card's peak.

:func:`roofline_terms` (which ``launch.compare`` reads) and
:func:`model_flops` (the 6·N·T convention, counted on a ``meta``-device
``LM``) are here, and the counterparts of the reference's HLO readers.
The reference reads a step's per-device costs from XLA's partitioned,
compiled program; here :class:`StepTrace` watches one rank run the step
(``launch.dryrun``: DTensor parameters on a fake process group, ``meta``
tensors) and records every op that rank's own tensors go through, below
DTensor's sharding propagation:

* ``flops``: each local op's flops by ``torch.utils.flop_counter``'s
  formulas on the local shapes (matrix products and convolutions:
  ``FlopCounterMode``'s convention, which counts no elementwise flops);
* ``bytes``: each local op's input plus output bytes (views move none),
  the eager counterpart of ``cost_analysis``' "bytes accessed";
* :func:`collective_bytes`: the local result bytes of every collective
  the rank issues (all-gather, all-reduce, reduce-scatter, all-to-all,
  permute, broadcast), DTensor's functional collectives and in-place
  ``c10d`` ones (an LDA mesh step's ``MeshComm`` all-reduces) alike;
* :func:`memory_summary`: argument, output, temp and peak bytes of the
  rank, from the live storages (the step's inputs, then every op's
  outputs, each until it is freed).

Eager torch runs every layer of a stack, so no count needs weighting by
a loop's trip count (the reference's ``_while_trip_counts``).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12  # dense BF16 tensor cores, per card
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction, per card
# the reference's name for the chip-to-chip link rate: here the card's
# NVLink
ICI_BW = NVLINK_BW


def roofline_terms(record: Dict[str, Any]) -> Dict[str, float]:
    """The three seconds-valued terms + bottleneck for one dry-run record."""
    compute = record.get("flops_per_device", 0.0) / PEAK_FLOPS
    memory = record.get("bytes_per_device", 0.0) / HBM_BW
    coll = record.get("collective_bytes_per_device", 0.0) / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])[: -2]
    terms["step_lower_bound_s"] = max(compute, memory, coll)
    return terms


def model_flops(cfg: Any, shape: Any) -> float:
    """MODEL_FLOPS: 6*N*D (dense) / 6*N_active*D (MoE) / sampler-work (LDA).

    N counts the parameters of ``cfg``'s ``LM`` built on the ``meta``
    device (no memory). For MoE, N_active is the non-expert parameters
    plus top_k/E of the expert ones; a leaf is an expert one when its
    tree path holds ``moe`` and the reference's stacked leaf has 3 or more
    dimensions (the layer axis counted), as the reference sorts them."""
    from repro_torch.configs.base import ArchConfig, LDAArchConfig

    if isinstance(cfg, LDAArchConfig):
        # dense fused sampler: ~4 flops per (token, topic) + O(max_kd) terms
        return cfg.tokens_per_step * (4.0 * cfg.num_topics)
    assert isinstance(cfg, ArchConfig)
    from repro_torch.models.convert import _tree_path
    from repro_torch.models.model import init_params

    expert, other = 0, 0
    for name, p in init_params(0, cfg, device="meta").named_parameters():
        keys, index = _tree_path(name)
        ndim = p.dim() + (index is not None)
        if "moe" in keys and ndim >= 3:
            expert += p.numel()
        else:
            other += p.numel()
    n = other + expert
    if cfg.moe is not None:
        n = other + expert * cfg.moe.top_k / cfg.moe.num_experts
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token per sequence
        return 2.0 * n * tokens  # forward only
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 6.0 * n * tokens  # fwd + bwd


# ---------------------------------------------------------------------------
# the trace: one rank's ops, flops, bytes, collectives and memory
# ---------------------------------------------------------------------------

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_NOT_COLLECTIVES = {"barrier", "monitored_barrier_",
                    "new_process_group", "register_process_group"}
# functional collectives' bookkeeping: a wait or an autograd wrap hands
# the collective's result on and moves nothing
_PASS_THROUGH = {"wait_tensor", "_wrap_tensor_autograd"}


class Op(NamedTuple):
    """One local op: its name, flops, bytes in + out, result bytes and
    result shapes, and whether it is a collective."""

    name: str
    flops: int
    bytes: int
    result_bytes: int
    shapes: tuple
    collective: bool


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (lists, tuples, dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_collective(func) -> bool:
    ns = getattr(func, "namespace", "")
    name = func._schema.name.split("::")[-1]
    return ns in _COLLECTIVE_NAMESPACES and name not in _NOT_COLLECTIVES


class StepTrace(TorchDispatchMode):
    """Records the local ops of one rank while it is entered.

    ``inputs`` (any nest of tensors, DTensors, modules' parameters) are the
    step's arguments: their storages open the live set. DTensor ops are
    left to DTensor (``NotImplemented``) and counted as the local ops and
    collectives they become. Only ops on tensors of the inputs' device
    type (``meta`` in the dry-run) are the rank's work: DTensor's own
    index bookkeeping on the host and its shape propagation on fake
    tensors are skipped."""

    def __init__(self, inputs: Any = None):
        super().__init__()
        local = _local_tensors(inputs)
        self.device = local[0].device.type if local else "cpu"
        self.ops: List[Op] = []
        self.flops = 0
        self.bytes = 0
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, Any] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        for t in local:
            self._track(t)
        self.argument_bytes = self.live_bytes
        self.peak_bytes = self.live_bytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        def freed(_ref, key=key):
            self.live_bytes -= self._live.pop(key, 0)
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False) \
                or func._schema.name.split("::")[-1] in _PASS_THROUGH:
            return out
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        outs = _tensors(out)
        if not any(t.device.type == self.device and type(t) is torch.Tensor
                   for t in ins + outs):
            return out
        flops = 0
        packet = getattr(func, "_overloadpacket", None)
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        res = sum(_nbytes(t) for t in outs)
        nbytes = sum(_nbytes(t) for t in ins) + res
        coll = _is_collective(func)
        self.ops.append(Op(func._schema.name.split("::")[-1], flops, nbytes,
                           res, tuple(tuple(t.shape) for t in outs), coll))
        self.flops += flops
        self.bytes += nbytes
        for t in outs:
            self._track(t)
        return out

    def set_outputs(self, outputs: Any) -> None:
        """Record the bytes of the step's results (their storages)."""
        seen = set()
        total = 0
        for t in _local_tensors(outputs):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        self.output_bytes = total


def _local_tensors(tree) -> List[torch.Tensor]:
    """Plain tensors of a nest of tensors, DTensors (their local shards),
    modules (their parameters), NamedTuples, dicts and lists."""
    from torch.distributed.tensor import DTensor

    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


def collective_bytes(trace: StepTrace) -> float:
    """Per-device bytes the traced step's collectives return (the sum of
    their local result bytes)."""
    return float(sum(o.result_bytes for o in trace.ops if o.collective))


def memory_summary(trace: Optional[StepTrace]) -> Optional[Dict[str, float]]:
    """The reference's ``memory_analysis`` fields, per device: the step's
    arguments, its outputs, the most it held beyond its arguments, and its
    peak of live bytes."""
    if trace is None:
        return None
    return {
        "argument_size_in_bytes": float(trace.argument_bytes),
        "output_size_in_bytes": float(trace.output_bytes),
        "temp_size_in_bytes": float(trace.peak_bytes - trace.argument_bytes),
        "peak_memory_in_bytes": float(trace.peak_bytes),
    }
