"""LDA serving entry point: restore a trained model and serve documents.

Loads a model checkpoint written by either package (``python -m
repro.launch.train --checkpoint-dir``, or ``save_lda_model``), builds
``--replicas`` bucketed :class:`~repro_torch.serving.LDAEngine` replicas
behind an :class:`~repro_torch.serving.LDARouter` in either mode on
``--device`` (default ``cuda``), and pushes a libsvm corpus or a synthetic
load through the async ticket front:

    PYTHONPATH=src python -m repro_torch.launch.serve_lda \\
        --checkpoint-dir /tmp/lda_ckpt [--device cuda|cpu] \\
        [--mode throughput|latency] [--corpus path.libsvm |
        --synthetic-docs 64] [--algorithm zen_pallas] \\
        [--buckets 32,64,128,256] [--max-batch 32] [--sweeps 10] \\
        [--rtlda-sweeps 2] [--tick-period 0] [--max-slot-wait 0] \\
        [--rounds 1] [--pace 0] [--eval] [--follow [--watch-period 0.5]]
        [--mesh-shape 1,2] [--replicas 2]

It prints the reference's ``docs/sec`` (with the model versions the
round's requests decoded under) and ``latency ms: p50=`` lines, with the
device they were measured on. ``--follow`` makes it the consuming half of
the live pipeline: a checkpoint watcher polls ``--checkpoint-dir`` every
``--watch-period`` seconds and hot-reloads each newer model the trainer
(``launch.train --stream``) commits, while the load replays for
``--rounds`` rounds. ``--metrics-out PATH`` writes windowed
``serve_window`` telemetry JSONL; ``--autopilot`` derives the tick period,
the bucket-spill wait and the bucket grid from the measured arrivals
(``--autopilot-window`` arrivals per window; ``--pace`` makes an arrival
process to measure) and prints where they settled. ``--mesh-shape 1,m``
shards the model's word rows over m shards in this process (throughput
mode; on one card all on it) and prints a ``sharded:`` line;
``--replicas n`` serves through n engines behind the router.
"""
import argparse
import sys
import time


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint-dir", required=True,
                    help="model checkpoint dir from train --checkpoint-dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--mode", default="throughput",
                    choices=["throughput", "latency"])
    ap.add_argument("--corpus", default=None,
                    help="libsvm documents to serve (docs are the queries)")
    ap.add_argument("--synthetic-docs", type=int, default=64)
    ap.add_argument("--synthetic-len", type=int, default=60)
    ap.add_argument("--algorithm", default="zen",
                    help="registered backend (throughput mode)")
    ap.add_argument("--buckets", default="32,64,128,256")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--rtlda-sweeps", type=int, default=2)
    ap.add_argument("--burn-in", type=int, default=-1)
    ap.add_argument("--thin", type=int, default=1)
    ap.add_argument("--sampling-method", default="cdf",
                    choices=["cdf", "gumbel"])
    ap.add_argument("--tick-period", type=float, default=0.0)
    ap.add_argument("--max-slot-wait", type=int, default=0)
    ap.add_argument("--eval", action="store_true",
                    help="doc-completion held-out perplexity")
    ap.add_argument("--show", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="serve the query load this many rounds")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="> 0: sleep this many seconds between submits")
    ap.add_argument("--follow", action="store_true",
                    help="watch --checkpoint-dir and hot-reload every new "
                         "model checkpoint while serving (live pipeline)")
    ap.add_argument("--watch-period", type=float, default=0.5,
                    help="checkpoint poll cadence in seconds (--follow)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write windowed serving telemetry JSONL here")
    ap.add_argument("--autopilot", action="store_true",
                    help="derive tick_period / max_slot_wait / buckets "
                         "from the observed arrival process")
    ap.add_argument("--autopilot-window", type=int, default=0,
                    help="arrivals per telemetry window (0 = default 64)")
    ap.add_argument("--mesh-shape", default=None,
                    help="serve the model sharded over word rows, e.g. 1,2 "
                         "(data dim must be 1; throughput mode)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the serving router")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)  # no card: raise before any IO

    from repro_torch.data.corpus import load_libsvm, synthetic_corpus
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.serving import (
        FrozenLDAModel,
        LDAEngine,
        LDARouter,
        LDAServeConfig,
        doc_completion_perplexity,
        docs_from_corpus,
    )
    from repro_torch.train.checkpoint import load_lda_model

    n_wk, n_k, hyper, _meta, step0 = load_lda_model(args.checkpoint_dir)
    model = FrozenLDAModel.from_numpy(n_wk, n_k, hyper, device=dev)
    card = _device_name(model.device)
    print(f"model: W={model.num_words} K={model.num_topics} "
          f"tokens={int(np.asarray(n_k).sum())} step={step0} from "
          f"{args.checkpoint_dir} on {card}")

    if args.corpus:
        corpus = load_libsvm(args.corpus)
    else:
        corpus = synthetic_corpus(args.seed + 1,
                                  num_docs=args.synthetic_docs,
                                  num_words=model.num_words,
                                  avg_doc_len=args.synthetic_len, zipf_a=1.2)
    docs = docs_from_corpus(corpus)

    cfg = LDAServeConfig(
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_batch=args.max_batch,
        num_sweeps=args.sweeps,
        burn_in=args.burn_in,
        thin=args.thin,
        algorithm=args.algorithm,
        sampling_method=args.sampling_method,
        mode=args.mode,
        rtlda_sweeps=args.rtlda_sweeps,
        tick_period=args.tick_period,
        max_slot_wait=args.max_slot_wait,
        mesh_shape=(tuple(int(d) for d in args.mesh_shape.split(","))
                    if args.mesh_shape else None),
        metrics_out=args.metrics_out,
        autopilot=args.autopilot,
        autopilot_window=args.autopilot_window,
    )
    engine = LDARouter(model, cfg, replicas=args.replicas, seed=args.seed)
    plan = (f"rtlda_sweeps={cfg.rtlda_sweeps} (deterministic)"
            if args.mode == "latency" else
            f"algorithm={args.algorithm} sweeps={cfg.num_sweeps}")
    print(f"engine: mode={args.mode} {plan} buckets={cfg.buckets} "
          f"max_batch={cfg.max_batch} replicas={args.replicas} "
          f"device={card}")
    if cfg.mesh_shape is not None:
        sharded = engine.model
        print(f"sharded: {sharded.num_shards} word shards x "
              f"{sharded.words_per_shard} rows (W={sharded.num_words} "
              f"padded to {sharded.num_shards * sharded.words_per_shard})")

    # one doc per bucket width first: kernel build and allocator warm-up
    # stay out of the latency distribution
    engine.warm()
    if args.tick_period > 0:
        engine.start(args.tick_period)
    if args.follow:
        engine.watch_checkpoint_dir(args.checkpoint_dir,
                                    period=args.watch_period,
                                    initial_step=step0)

    thetas = []
    for rnd in range(max(1, args.rounds)):
        sweeps0 = engine.sweeps_run
        t0 = time.perf_counter()
        tickets = []
        for d in docs:
            tickets.append(engine.submit_async(d))
            if args.pace > 0:
                time.sleep(args.pace)
        reqs = [engine.request(t) for t in tickets]
        thetas = [engine.result(t) for t in tickets]
        dt = time.perf_counter() - t0
        stats = summarize_latencies((r.t_done - r.t_submit) * 1e3
                                    for r in reqs)
        versions = sorted({r.model_version for r in reqs})
        tag = f"round {rnd}  " if args.rounds > 1 else ""
        print(f"{tag}served {len(docs)} docs in {dt:.3f}s "
              f"({len(docs) / dt:.1f} docs/sec, "
              f"{engine.sweeps_run - sweeps0} bucket dispatches)  "
              f"model versions {versions} on {card}")
        print(f"latency ms: p50={stats['p50']:.2f} p99={stats['p99']:.2f} "
              f"max={stats['max']:.2f} on {card}")
        if args.follow and rnd < args.rounds - 1:
            time.sleep(args.watch_period)
    if args.autopilot:
        # where the measured knobs settled (replica 0 speaks for a
        # homogeneous fleet)
        e0 = engine.engines[0]
        print(f"autopilot: tick_period={e0.tick_period * 1e3:.2f}ms "
              f"max_slot_wait={e0.max_slot_wait} "
              f"buckets={e0.bucket_widths} spills={e0.spills}")
    if args.metrics_out:
        print(f"telemetry: {args.metrics_out}")
    if args.follow:
        err = engine.stop_watching()
        if err is not None:
            print(f"serve_lda: checkpoint watcher: {err}", file=sys.stderr)
    if args.tick_period > 0:
        engine.stop()

    for i in range(min(args.show, len(docs))):
        top = np.argsort(-thetas[i])[:3]
        pretty = " ".join(f"k{t}:{thetas[i][t]:.3f}" for t in top)
        print(f"doc {i:4d} len {len(docs[i]):4d}  {pretty}")

    if args.eval:
        ppl = doc_completion_perplexity(
            LDAEngine(model, cfg, seed=args.seed + 7), docs
        )
        print(f"doc-completion perplexity: {ppl:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
