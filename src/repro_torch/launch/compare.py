"""Before/after comparison (``repro/launch/compare.py``): dry-run result
stores, or live training runs. The reference's flags and printed tables,
line for line.

* store diff (default): compare two dry-run JSON stores through
  :func:`repro_torch.launch.roofline.roofline_terms` (one H100's peaks;
  the ``x`` ratios do not depend on them)

      PYTHONPATH=src python -m repro_torch.launch.compare \\
          results/dryrun_baseline.json results/dryrun_opt.json

* session compare (``--sessions``): the positional arguments are
  ``RunConfig`` JSON files (``launch/train.py --dump-config``, of either
  package); each runs on a shared synthetic corpus through
  ``TrainSession.run()`` on ``--device`` (default ``cuda``), and the eval
  trajectories print side by side

      PYTHONPATH=src python -m repro_torch.launch.compare --sessions \\
          run_baseline.json run_opt.json [--topics 32] [--eval-every 5] \\
          [--quality-every 5] [--device cpu]

  ``--quality-every`` (or ``quality_every`` in either config) adds the
  model-quality columns: UMass/NPMI coherence and left-to-right held-out
  llh per token (``repro_torch.eval``). ``--seed`` is the int seed both
  sessions start from.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.launch.roofline import roofline_terms


def compare_sessions(args) -> Dict[str, List[Dict]]:
    """Run two RunConfigs via TrainSession on one corpus; print the eval
    trajectories side by side — llh/perplexity always, plus the quality
    columns (UMass/NPMI coherence, left-to-right llh) whenever either
    config runs the quality action. Returns each config path's
    trajectory (one metrics dict per evaluated iteration)."""
    import dataclasses

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_corpus(
        0, num_docs=args.synthetic_docs, num_words=args.synthetic_words,
        avg_doc_len=args.synthetic_len, zipf_a=1.2,
    )
    hyper = LDAHyperParams(num_topics=args.topics)
    runs = {}
    for path in (args.baseline, args.optimized):
        with open(path) as f:
            cfg = RunConfig.from_json(f.read())
        if args.eval_every:
            cfg = dataclasses.replace(cfg, eval_every=args.eval_every)
        if args.quality_every:
            cfg = dataclasses.replace(cfg, quality_every=args.quality_every)
        session = TrainSession(corpus, hyper, cfg, device=args.device)
        traj = []
        session.run(
            args.seed,
            callback=lambda st, m: traj.append(
                dict(m, iteration=int(st.iteration))
            ) if ("llh" in m or "coherence_umass" in m) else None,
        )
        runs[path] = traj
        plan = "single-box" if cfg.mesh_shape is None else \
            f"mesh {cfg.mesh_shape[0]}x{cfg.mesh_shape[1]}"
        print(f"# {path}: algorithm={cfg.algorithm} plan={plan}")
        del session  # its device memory, before the next one is built
    a, b = runs[args.baseline], runs[args.optimized]
    # quality columns appear when any tick of either run carried them
    cols = [("llh", "llh", "{:.1f}"), ("perplexity", "ppl", "{:.2f}")]
    for key, label, fmt in (
        ("coherence_umass", "umass", "{:.3f}"),
        ("coherence_npmi", "npmi", "{:.3f}"),
        ("l2r_per_token", "l2r/tok", "{:.3f}"),
    ):
        if any(key in m for m in a + b):
            cols.append((key, label, fmt))
    header = "| iter |" + "".join(
        f" baseline {label} | optimized {label} |" for _, label, _ in cols
    )
    print(header)
    print("|---|" + "---|" * (2 * len(cols)))
    for ma, mb in zip(a, b):
        ia, ib = ma["iteration"], mb["iteration"]
        it = ia if ia == ib else f"{ia}/{ib}"
        cells = []
        for key, _, fmt in cols:
            for m in (ma, mb):
                cells.append(fmt.format(m[key]) if key in m else "-")
        print(f"| {it} | " + " | ".join(cells) + " |")
    return runs


def _legend(base: Dict) -> None:
    """Resolve each LDA arch's sampler through the port's backend
    registry. Best-effort: a failure prints a note and never blocks the
    diff."""
    try:
        from repro_torch import algorithms
        from repro_torch.configs import get_config
        from repro_torch.configs.base import LDAArchConfig
        from repro_torch.launch.mesh import mesh_backends
    except Exception as e:  # pragma: no cover - a broken install
        print(f"# (algorithm legend unavailable: {e})")
        return
    print(f"# mesh-capable backends: {', '.join(mesh_backends())}")
    for arch in sorted({k.split("|")[0] for k in base if "|" in k}):
        try:
            cfg = get_config(arch)
            if isinstance(cfg, LDAArchConfig):
                backend = algorithms.get(cfg.algorithm)
                print(f"# {arch}: sampler backend {backend.name!r} "
                      f"(shard_map={backend.supports_shard_map})")
        except Exception as e:  # best-effort; never block the diff
            print(f"# {arch}: (algorithm legend unavailable: {e})")


def _effective(store: Dict, key: str) -> Optional[Dict]:
    """The fitted record if present, else the raw cell record."""
    arch, shape, mesh = key.split("|")
    rec = store.get(key)
    fit = store.get(f"{arch}|{shape}|fit")
    if rec is None or not rec.get("ok"):
        return None
    if mesh == "single" and fit is not None and fit.get("ok"):
        rec = dict(rec)
        for k in ("flops_per_device", "bytes_per_device",
                  "collective_bytes_per_device"):
            rec[k] = fit[k]
    return rec


def store_diff(args) -> None:
    """The roofline-term table of two dry-run stores: one row per cell
    and term that moved by ``--min-ratio`` either way."""
    with open(args.baseline) as f:
        base = json.load(f)
    with open(args.optimized) as f:
        opt = json.load(f)
    _legend(base)
    print("| cell | term | baseline (s) | optimized (s) | x |")
    print("|---|---|---|---|---|")
    keys = sorted(k for k in base if k.count("|") == 2
                  and not k.endswith("|fit"))
    for key in keys:
        b = _effective(base, key)
        o = _effective(opt, key)
        if b is None or o is None:
            continue
        tb = roofline_terms(b)
        to = roofline_terms(o)
        for term in ("compute_s", "memory_s", "collective_s"):
            if to[term] <= 0:
                continue
            ratio = tb[term] / max(to[term], 1e-12)
            if ratio >= args.min_ratio or ratio <= 1 / args.min_ratio:
                print(f"| {key} | {term[:-2]} | {tb[term]:.3e} | "
                      f"{to[term]:.3e} | {ratio:5.2f} |")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("optimized")
    ap.add_argument("--min-ratio", type=float, default=1.05,
                    help="only print cells that moved by this factor")
    ap.add_argument("--sessions", action="store_true",
                    help="treat the positionals as RunConfig JSONs and "
                         "compare live TrainSession runs")
    ap.add_argument("--topics", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="override both configs' eval cadence")
    ap.add_argument("--quality-every", type=int, default=0,
                    help="override both configs' quality-eval cadence "
                         "(coherence + left-to-right columns)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic-docs", type=int, default=400)
    ap.add_argument("--synthetic-words", type=int, default=800)
    ap.add_argument("--synthetic-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="where --sessions trains (cuda, or cpu for the "
                         "plain torch versions); no fallback")
    args = ap.parse_args(argv)
    if args.sessions:
        return compare_sessions(args)
    store_diff(args)
    return None


if __name__ == "__main__":
    main()
