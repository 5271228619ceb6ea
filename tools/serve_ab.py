"""Serving throughput of two checkouts of this repository on one card.

Each round runs one process per checkout, in the order A B B A, so that
drift of the card or the host between processes falls on both sides
alike. A process puts its checkout's ``src/`` first on the path, builds
that checkout's kernels, and serves as the serving phase of
``chip_smoke.py`` does (the planted NYTIMES-width model, buckets (128,
256, 512), 32 slots, 10 sweeps): 256 documents at once on the fused
kernel 4, and 64 on the gathered kernel 3, ``--reps`` times each after
one warm-up serve. It prints one JSON line per process, then one summary
line with the median docs/sec of each checkout and run.

    python3 tools/serve_ab.py PARENT_CHECKOUT CHANGED_CHECKOUT [--rounds 1]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def child(root: str, reps: int, seed: int) -> dict:
    sys.path.insert(0, str(pathlib.Path(root).resolve() / "src"))
    sys.path.insert(1, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import _build
    from repro_torch.serving import FrozenLDAModel, LDAServeConfig

    import repro_torch
    assert pathlib.Path(repro_torch.__file__).resolve().is_relative_to(
        pathlib.Path(root).resolve()), repro_torch.__file__
    _build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_wk, n_k, dom = cs.planted_model(gen, dev)
    model = FrozenLDAModel(n_wk, n_k.to(torch.int32), LDAHyperParams(
        num_topics=cs.K_NYT, alpha=0.01, beta=0.01))
    docs, _ = cs.planted_docs(np.random.default_rng(seed), dom, cs.N_DOCS)
    base = dict(buckets=(128, 256, 512), max_batch=cs.SLOTS, num_sweeps=10,
                algorithm="zen_pallas")
    out = {"root": root}
    for name, cfg, ds in (
            ("throughput_fused", LDAServeConfig(**base), docs),
            ("throughput_gathered", LDAServeConfig(kernels="off", **base),
             docs[:64])):
        cs.serve(model, cfg, ds, seed)  # warm-up
        rates, p50, p99 = [], [], []
        for _ in range(reps):
            _, reqs, secs, _ = cs.serve(model, cfg, ds, seed)
            lat = [(r.t_done - r.t_submit) * 1e3 for r in reqs]
            rates.append(len(ds) / secs)
            p50.append(float(np.percentile(lat, 50)))
            p99.append(float(np.percentile(lat, 99)))
        out[name] = {"docs": len(ds), "docs_per_sec": rates,
                     "p50_ms": p50, "p99_ms": p99}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.reps, args.seed)),
              flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts: A (parent) and B (change)")
    a, b = args.roots
    results = []
    for root in [a, b, b, a] * args.rounds:
        line = subprocess.run(
            [sys.executable, __file__, "--child", root, "--reps",
             str(args.reps), "--seed", str(args.seed)],
            check=True, capture_output=True, text=True).stdout.splitlines()
        results.append(json.loads(line[-1]))
        print(line[-1], flush=True)
    summary = {}
    for root in (a, b):
        for run in ("throughput_fused", "throughput_gathered"):
            rates = [x for r in results if r["root"] == root
                     for x in r[run]["docs_per_sec"]]
            summary[f"{root}:{run}"] = statistics.median(rates)
    print(json.dumps({"median_docs_per_sec": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
