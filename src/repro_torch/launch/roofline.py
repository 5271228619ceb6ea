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
``LM``) are here. The reference's HLO readers (``collective_bytes``,
``_while_trip_counts``, ``memory_summary``) parse XLA's compiled
artifacts: they wait for a GPU-side redesign of the dry-run.
"""
from __future__ import annotations

from typing import Any, Dict

PEAK_FLOPS = 989e12  # dense BF16 tensor cores, per card
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction, per card


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
