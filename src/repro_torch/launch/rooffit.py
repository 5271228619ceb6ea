"""Depth-fit roofline costs (``repro/launch/rooffit.py``).

The reference compiles shallow unrolled variants because XLA's
``cost_analysis`` counts a scanned layer stack's body once. Eager torch
runs every layer, so a traced count is already the full depth's; the fit
is kept so both packages' stores carry the same ``fit`` records and so a
long stack can be priced from two shallow traces. Trace 2 and 4 layers
(or, for a patterned / hybrid stack, one group, two groups and one group
plus a unit) at the same widths and batch and fit

    cost(L) = fixed + L * per_layer            (uniform stacks)
    cost    = fixed + G * per_group + R * per_unit   (patterned/hybrid)

at the production depth. Per-device flops, bytes and collective bytes
are affine in depth (the layers repeat; the optimizer's elementwise work
and per-layer collectives grow with them), so the fit equals a trace at
full depth exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch.configs import SHAPES, get_config  # noqa: F401
from repro_torch.configs.base import ArchConfig


def _cell_costs(cfg: ArchConfig, shape_name: str, mesh_shape: Sequence[int],
                axes: Sequence[str], device: str) -> Dict[str, float]:
    """Trace one (possibly shallow) variant: its raw per-device costs."""
    from repro_torch.launch.dryrun import trace_cell

    rec = trace_cell(cfg, shape_name, mesh_shape, axes, device)
    return {"flops": rec["flops_per_device"],
            "bytes": rec["bytes_per_device"],
            "coll": rec["collective_bytes_per_device"],
            "trace_s": rec["trace_s"]}


def _depth_variant(cfg: ArchConfig, num_layers: int) -> ArchConfig:
    changes: Dict[str, Any] = {"num_layers": num_layers}
    if cfg.family == "encdec":
        changes["num_encoder_layers"] = num_layers
    return dataclasses.replace(cfg, **changes)


def fit_cell(arch: Union[str, ArchConfig], shape_name: str,
             mesh_shape: Optional[Sequence[int]] = None,
             axes: Optional[Sequence[str]] = None,
             device: str = "cuda") -> Dict[str, Any]:
    """Fitted per-device costs at ``arch``'s depth (default: the
    single-pod production mesh, traced as ``dryrun.traced_mesh``)."""
    from repro_torch.launch.dryrun import traced_mesh
    from repro_torch.launch.mesh import production_shape

    cfg = get_config(arch) if isinstance(arch, str) else arch
    assert isinstance(cfg, ArchConfig)
    if mesh_shape is None:
        mesh_shape, axes = traced_mesh(*production_shape(False))
    out: Dict[str, Any] = {"arch": cfg.name, "shape": shape_name,
                           "torch": torch.__version__, "points": {}}

    def cost(layers):
        c = _cell_costs(_depth_variant(cfg, layers), shape_name, mesh_shape,
                        axes, device)
        out["points"][f"L{layers}"] = c
        return c

    fitted = {}
    if cfg.local_global_pattern or cfg.hybrid_attn_every:
        group = (cfg.local_global_pattern + 1 if cfg.local_global_pattern
                 else cfg.hybrid_attn_every)
        c1, c2, c3 = cost(group), cost(2 * group), cost(group + 1)
        n_groups = cfg.num_layers // group
        rem = cfg.num_layers - n_groups * group
        for key in ("flops", "bytes", "coll"):
            per_group = c2[key] - c1[key]
            per_unit = c3[key] - c1[key]  # one trailing local/mamba layer
            fixed = c1[key] - per_group
            fitted[key] = fixed + n_groups * per_group + rem * per_unit
    else:
        c1, c2 = cost(2), cost(4)
        for key in ("flops", "bytes", "coll"):
            per_layer = (c2[key] - c1[key]) / 2.0
            fixed = c1[key] - 2.0 * per_layer
            fitted[key] = fixed + cfg.num_layers * per_layer
    out["fitted"] = fitted
    out["flops_per_device"] = fitted["flops"]
    out["bytes_per_device"] = fitted["bytes"]
    out["collective_bytes_per_device"] = fitted["coll"]
    return out
