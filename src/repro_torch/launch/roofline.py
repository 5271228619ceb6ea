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

Only :func:`roofline_terms` is here, which ``launch.compare`` reads. The
reference's HLO readers (``collective_bytes``, ``_while_trip_counts``,
``memory_summary``) parse XLA's compiled artifacts, and ``model_flops``
needs the LM models' abstract parameters: they wait for a GPU-side
redesign of the dry-run together with the LM models.
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
