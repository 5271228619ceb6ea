"""Render the roofline table from the torch dry-run's store
(``repro/launch/table.py``).

    PYTHONPATH=src python -m repro_torch.launch.table [--results results/dryrun_torch.json]

Per (arch x shape), single-pod mesh: the three roofline terms (seconds)
at one H100's peaks (``launch.roofline``: 989 TFLOP/s dense BF16,
3.35 TB/s HBM3, and collectives over NVLink at 450 GB/s each way), the
dominant bottleneck, MODEL_FLOPS, the useful-compute fraction, and the
roofline fraction (model flops per device / (peak * step lower bound)).
The counts depend on the torch version that traced them, so a store that
mixes versions is refused.
A 16 x 16 mesh of H100s spans 32 eight-card nodes, so most of its
collectives would cross InfiniBand, slower than the NVLink rate the
collective term divides by: that term is a lower bound. LM rows use the
depth-fitted costs where the store has them (``rooffit.py``).
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

from repro_torch.configs import SHAPES, get_config, list_archs, shapes_for
from repro_torch.configs.base import LDAArchConfig
from repro_torch.launch.roofline import (  # noqa: F401
    HBM_BW,  # HBM_BW and ICI_BW: the reference's module surface
    ICI_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    model_flops,
    roofline_terms,
)

CHIPS = 256  # single-pod roofline table (16 x 16)

LINK_NOTE = (f"collective term: bytes / {NVLINK_BW / 1e9:.0f} GB/s (NVLink, "
             f"one direction); a 16 x 16 H100 mesh spans 32 eight-card "
             f"nodes, so most collectives would cross InfiniBand: a lower "
             f"bound")


def _advice(bottleneck: str, arch: str, shape: str, ratio: float) -> str:
    if bottleneck == "collective":
        return ("shrink collective payload: delta/grad compression, "
                "overlap collectives with compute, rebalance TP vs DP")
    if bottleneck == "memory":
        if "decode" in shape or "long" in shape:
            return ("KV/cache traffic bound: shrink cache dtype (int8/fp8), "
                    "latent KV (MLA-style), or raise batch to amortize "
                    "weight reads")
        return ("fuse elementwise chains; avoid remat over matmul-heavy "
                "blocks; bf16 activations end-to-end")
    if ratio < 0.5:
        return ("compute-bound but <50% useful: reduce remat recompute "
                "and one-hot/capacity MoE overhead")
    return "compute-bound and mostly useful work: near roofline for this mix"


def torch_version(results: Dict) -> str:
    """The one torch version that traced every record of ``results``
    (the counts depend on it); a store that mixes versions is refused."""
    versions = {str(r.get("torch")) for r in results.values()}
    if len(versions) > 1:
        raise ValueError(f"the store mixes records of torch "
                         f"{', '.join(sorted(versions))}: trace it again "
                         f"with one (dryrun --force)")
    return versions.pop() if versions else "None"


def build_rows(results: Dict) -> list:
    torch_version(results)
    rows = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg):
            rec = results.get(f"{arch}|{shape_name}|single")
            if rec is None or not rec.get("ok"):
                continue
            fit = results.get(f"{arch}|{shape_name}|fit")
            use = dict(rec)
            fitted = False
            if fit is not None and fit.get("ok"):
                use.update({k: fit[k] for k in (
                    "flops_per_device", "bytes_per_device",
                    "collective_bytes_per_device")})
                fitted = True
            terms = roofline_terms(use)
            if isinstance(cfg, LDAArchConfig):
                mf = model_flops(cfg, None)
            else:
                mf = model_flops(cfg, SHAPES[shape_name])
            mf_dev = mf / CHIPS
            counted = use["flops_per_device"]
            useful = mf_dev / counted if counted else 0.0
            bound = terms["step_lower_bound_s"]
            roofline_frac = (mf_dev / PEAK_FLOPS) / bound if bound else 0.0
            rows.append({
                "arch": arch,
                "shape": shape_name,
                "fitted": fitted,
                "compute_s": terms["compute_s"],
                "memory_s": terms["memory_s"],
                "collective_s": terms["collective_s"],
                "bottleneck": terms["bottleneck"],
                "model_flops_dev": mf_dev,
                "useful_frac": useful,
                "roofline_frac": roofline_frac,
                "advice": _advice(terms["bottleneck"], arch, shape_name,
                                  useful),
                "mem_analysis": rec.get("memory_analysis") or {},
            })
    return rows


def render(rows: list) -> str:
    out = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
           "bottleneck | MODEL_FLOPs/dev | useful | roofline |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['bottleneck']}** | {r['model_flops_dev']:.2e} | "
            f"{r['useful_frac']:.2f} | {r['roofline_frac']:.2f} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch.json")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    rows = build_rows(results)
    print(f"H100 peaks: {PEAK_FLOPS / 1e12:.0f} TFLOP/s, {LINK_NOTE}; "
          f"counts traced by torch {torch_version(results)}")
    print(render(rows))
    print()
    for r in rows:
        print(f"- {r['arch']} x {r['shape']}: {r['bottleneck']}-bound -> "
              f"{r['advice']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
