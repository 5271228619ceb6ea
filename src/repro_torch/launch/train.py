"""LDA training entry point: one ``TrainSession``, on the mesh plan or
the single box.

Takes the reference's flags and defaults (``repro/launch/train.py``), so
one command line means the same run in both packages, plus ``--device``
(default ``cuda``, never a silent fallback):

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --rows 2 --cols 2 --host-devices 4 --iters 50 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --single-box \\
        --algorithm zen_pallas --topics 1000 --iters 50 \\
        [--corpus path.libsvm | --synthetic-docs N --synthetic-words W
         --synthetic-len L] [--checkpoint-dir DIR] [--ckpt DIR]
        [--exclusion-start 30] [--rebuild-every 10] [--merge-every 10]
        [--hyper-every 5] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --config run.json
    PYTHONPATH=src python -m repro_torch.launch.train --list-algorithms
    PYTHONPATH=src python -m repro_torch.launch.train --stream \
        --window-docs 64 --decay 0.02 --checkpoint-dir /tmp/lda_live \
        [--stream-source replay|libsvm:<path>|drift[:<seed>]] \
        [--window-sweeps 2] [--epochs 1] [--num-windows 8]

It prints the reference's progress lines (``iter N  llh ...  ppl ...
change ...``, ``finished at iteration N; final llh ...``).
``--checkpoint-dir`` writes model checkpoints that either package's
``serve_lda`` serves; ``--ckpt`` holds elastic training checkpoints
(assignments; a rerun resumes from the newest). ``--max-kw``/``--max-kd``
fix the padded-sparse backends' row widths (default: resolved from the
counts before every sweep); for those backends the widths the first
sweep uses are printed as ``padded-row widths: ...``. ``--max-kd`` is also
``zen_cdf``'s sparse doc-row width (default 64, clamped to K). Every
backend of the reference is ported; the default is ``zen_cdf``, as there.

``--stream`` trains window by window (``train.online.StreamingSession``)
over a ``CorpusSource`` (``--stream-source``; default a replay of
``--corpus``, else the drift source), with ``--iters`` the absolute
window budget (0 = until the source ends), and writes a model checkpoint
every ``--checkpoint-every`` windows that ``serve_lda --follow``
hot-reloads: the live pipeline. It prints the reference's lines
(``window N (wN)  docs ..  ppl ..  .. docs/s  resident kd .. KiB``,
``stream finished at window N``); the single-box plan needs no
``--single-box`` there, and ``--rows``/``--cols`` are ignored.

``--quality-every N`` scores the model every N iterations on the card
(UMass and NPMI coherence over ``--quality-top-n`` words per topic with
``--npmi-window``, and with ``--l2r-docs`` the left-to-right held-out
llh); the progress line gains the reference's ``umass``, ``npmi`` and
``l2r/tok`` fields. ``--metrics-out PATH`` writes one ``train_iter`` JSONL
record per iteration (tokens/sec, row non-zeros counted on the card, the
eval metrics); ``--autopilot`` re-picks the backend and row widths from
those measurements every ``--autopilot-every`` iterations (default: the
``--rebuild-every`` cadence, else 10) and prints each decision under its
iteration's line, then a final ``autopilot:`` line.

Without ``--single-box`` the run is the mesh plan (``--rows`` x
``--cols``, default 2 x 2: one ``torch.distributed`` rank per cell),
except for backends without a cell sweep (``std``), which fall back to
the single box as in the reference. ``--host-devices N`` starts the N
ranks here (``launch.mesh.spawn_local``: gloo, on ``--device``: the CPU,
or all on one card); without it the ranks come from torchrun (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; NCCL, one card each). A world whose size
is not rows x cols exits 2, as a mismatched mesh fails in the reference.
Rank 0 prints (``mesh RxC  tokens=..  pad=..``, then the progress lines)
and writes the checkpoints.
"""
import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="load a RunConfig JSON (overrides per-field flags)")
    ap.add_argument("--dump-config", default=None, metavar="PATH",
                    help="write the resolved RunConfig JSON and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels; cpu their plain versions")
    ap.add_argument("--rows", type=int, default=2,
                    help="data-parallel rows (mesh plan)")
    ap.add_argument("--cols", type=int, default=2,
                    help="model-parallel cols (mesh plan)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="start this many local ranks (gloo on --device)")
    ap.add_argument("--corpus", default=None, help="libsvm corpus path")
    ap.add_argument("--topics", type=int, default=64)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--algorithm", default="zen_cdf",
                    help="any name from --list-algorithms")
    ap.add_argument("--list-algorithms", action="store_true",
                    help="print the registered sampler backends and exit")
    ap.add_argument("--single-box", action="store_true",
                    help="force the single-box plan")
    ap.add_argument("--max-kd", type=int, default=None,
                    help="sparse doc-row width (padded-sparse backends, "
                         "zen_cdf)")
    ap.add_argument("--max-kw", type=int, default=None,
                    help="sparse word-row width (padded-sparse backends)")
    ap.add_argument("--delta-dtype", default="int32",
                    choices=["int32", "int16", "int8"])
    ap.add_argument("--exclusion-start", type=int, default=0)
    ap.add_argument("--rebuild-every", type=int, default=0,
                    help="exact count rebuild cadence (0 = never)")
    ap.add_argument("--merge-every", type=int, default=0,
                    help="duplicate-topic merge cadence (0 = never)")
    ap.add_argument("--merge-threshold", type=float, default=0.05)
    ap.add_argument("--ckpt", default=None,
                    help="elastic training checkpoints (assignments)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="model checkpoints (N_wk/N_k + hyper) for serving")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="model-checkpoint cadence (0 = final only)")
    ap.add_argument("--llh-every", type=int, default=10,
                    help="eval cadence (llh/perplexity)")
    ap.add_argument("--target-perplexity", type=float, default=None,
                    help="stop once eval perplexity reaches this")
    ap.add_argument("--quality-every", type=int, default=0,
                    help="model-quality eval cadence: UMass/NPMI "
                         "coherence (+ left-to-right with --l2r-docs)")
    ap.add_argument("--quality-top-n", type=int, default=10,
                    help="top words per topic entering coherence")
    ap.add_argument("--npmi-window", type=int, default=10,
                    help="NPMI sliding-window size (0 = UMass only)")
    ap.add_argument("--l2r-docs", type=int, default=0,
                    help="held-out docs for left-to-right eval (0 = skip)")
    ap.add_argument("--l2r-particles", type=int, default=20,
                    help="particles per left-to-right document")
    ap.add_argument("--hyper-every", type=int, default=0,
                    help="Alg. 5 hyper-opt cadence: Minka fixed-point "
                         "alpha + beta annealing (0 = off)")
    ap.add_argument("--beta-anneal", type=float, default=1.0,
                    help="beta *= this per hyper firing (1.0 = no anneal)")
    ap.add_argument("--synthetic-docs", type=int, default=1000,
                    help="synthetic corpus size (when --corpus is not given)")
    ap.add_argument("--synthetic-words", type=int, default=2000)
    ap.add_argument("--synthetic-len", type=int, default=80)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write per-iteration telemetry JSONL here")
    ap.add_argument("--autopilot", action="store_true",
                    help="re-pick backend + row widths from measured "
                         "sparsity on the --autopilot-every cadence")
    ap.add_argument("--autopilot-every", type=int, default=0,
                    help="autopilot decision cadence "
                         "(0 = --rebuild-every, else every 10)")
    ap.add_argument("--stream", action="store_true",
                    help="windowed online training (StreamingSession); "
                         "--iters becomes the absolute window budget "
                         "(0 = run to source exhaustion)")
    ap.add_argument("--stream-source", default=None,
                    help="replay | libsvm:<path> | drift[:<seed>] "
                         "(default: replay of --corpus, else drift)")
    ap.add_argument("--window-docs", type=int, default=64,
                    help="documents per stream window")
    ap.add_argument("--window-sweeps", type=int, default=2,
                    help="CGS sweeps per window visit")
    ap.add_argument("--decay", type=float, default=0.0,
                    help="forgetting factor: counts *= (1-decay) per "
                         "window transition (0 = never forget)")
    ap.add_argument("--epochs", type=int, default=1,
                    help="replay source: passes over the corpus")
    ap.add_argument("--num-windows", type=int, default=8,
                    help="drift source: stream length in windows")
    return ap


def _rank_main(argv) -> None:
    """One local rank of ``--host-devices``: the same command line in a
    world of N (``launch.mesh.spawn_local``)."""
    code = main(argv)
    if code:
        raise SystemExit(code)


def run_stream(args, cfg) -> int:
    """The ``--stream`` path: a ``CorpusSource`` from the config's spec
    and a ``StreamingSession`` over it on ``--device``."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import load_libsvm, synthetic_corpus
    from repro_torch.data.stream import make_source
    from repro_torch.device import resolve_device
    from repro_torch.train.online import StreamingSession

    dev = resolve_device(args.device)
    spec = cfg.stream_source or ("replay" if args.corpus else "drift")
    corpus = None
    if spec == "replay":
        corpus = (load_libsvm(args.corpus) if args.corpus
                  else synthetic_corpus(0, num_docs=args.synthetic_docs,
                                        num_words=args.synthetic_words,
                                        avg_doc_len=args.synthetic_len,
                                        zipf_a=1.2))
    source = make_source(
        spec, cfg.window_docs, corpus=corpus,
        # a chunked source cannot tell the global vocabulary: it is
        # --synthetic-words (the stable-vocabulary contract)
        num_words=args.synthetic_words, epochs=args.epochs,
        num_windows=args.num_windows,
    )
    hyper = LDAHyperParams(num_topics=args.topics)
    session = StreamingSession(source, hyper, cfg, device=dev)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"stream  source={spec}  window_docs={cfg.window_docs}  "
          f"sweeps/window={cfg.window_sweeps}  decay={cfg.decay}  "
          f"algorithm={cfg.algorithm}  device={card}")

    def cb(sess, m):
        print(f"window {m['window']:4d} ({m['uid']})  docs {m['docs']:5d}  "
              f"ppl {m['perplexity']:.1f}  {m['docs_per_sec']:.0f} docs/s  "
              f"resident kd {m['resident_kd_bytes'] / 1024:.1f} KiB",
              flush=True)

    session.run(0, callback=cb)
    print(f"stream finished at window {session.windows_done}")
    if cfg.checkpoint_dir:
        print(f"model checkpoints: {cfg.checkpoint_dir} "
              f"(follow with: python -m repro_torch.launch.serve_lda "
              f"--checkpoint-dir {cfg.checkpoint_dir} --follow)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from repro_torch import algorithms
    from repro_torch.train.session import (
        RunConfig,
        TrainSession,
        mesh_rows_cols,
        refuse_unported,
    )

    if args.list_algorithms:
        for name, backend, aliases in algorithms.describe():
            mesh = "mesh+single-box" if backend.supports_shard_map \
                else "single-box"
            alias_s = f" (aliases: {', '.join(aliases)})" if aliases else ""
            print(f"{name:12s} {mesh}{alias_s}")
        return 0

    import torch.distributed as dist

    if args.host_devices and not dist.is_initialized():
        import torch.multiprocessing as mp

        from repro_torch.launch.mesh import spawn_local

        try:
            spawn_local("repro_torch.launch.train:_rank_main",
                        args.host_devices,
                        args=(list(sys.argv[1:] if argv is None else argv),))
        except mp.ProcessExitedException as e:
            print(f"train: a rank failed: {e}", file=sys.stderr)
            return e.exit_code or 1
        return 0
    rank_dev = None
    if not args.host_devices:
        from repro_torch.launch.mesh import init_from_env

        rank_dev = init_from_env(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())
    else:
        try:
            backend = algorithms.get(args.algorithm)
        except ValueError as e:
            print(f"train: {e}", file=sys.stderr)
            return 2
        mesh_shape = None
        if backend.supports_shard_map and not args.single_box:
            mesh_shape = (args.rows, args.cols)
        elif not backend.supports_shard_map and not args.single_box:
            say(f"note: backend {args.algorithm!r} has no shard_map cell "
                f"sweep; running the single-box plan")
        if args.stream and mesh_shape is not None:
            say("note: --stream runs the single-box windowed plan; "
                "ignoring the mesh shape")
            mesh_shape = None
        if mesh_shape is None and args.delta_dtype != "int32":
            say("note: single-box plan ignores --delta-dtype")
        cfg = RunConfig(
            algorithm=args.algorithm,
            max_kd=args.max_kd or 0,
            max_kw=args.max_kw or 0,
            mesh_shape=mesh_shape,
            delta_dtype=args.delta_dtype,
            num_iterations=args.iters,
            eval_every=args.llh_every,
            target_perplexity=args.target_perplexity,
            exclusion_start=args.exclusion_start,
            rebuild_every=args.rebuild_every,
            merge_every=args.merge_every,
            merge_threshold=args.merge_threshold,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            train_checkpoint_dir=args.ckpt,
            train_checkpoint_every=(
                (1 if args.stream else 25) if args.ckpt else 0
            ),
            window_docs=args.window_docs if args.stream else 0,
            window_sweeps=args.window_sweeps,
            decay=args.decay if args.stream else 0.0,
            stream_source=(
                (args.stream_source
                 or ("replay" if args.corpus else "drift"))
                if args.stream else None
            ),
            metrics_out=args.metrics_out,
            autopilot=args.autopilot,
            autopilot_every=args.autopilot_every,
            quality_every=args.quality_every,
            quality_top_n=args.quality_top_n,
            quality_npmi_window=args.npmi_window,
            quality_l2r_docs=args.l2r_docs,
            quality_l2r_particles=args.l2r_particles,
            hyper_every=args.hyper_every,
            hyper_beta_anneal=args.beta_anneal,
        )
    try:
        refuse_unported(cfg)
    except ValueError as e:
        print(f"train: {e}", file=sys.stderr)
        return 2

    if args.dump_config:
        if rank == 0:
            with open(args.dump_config, "w") as f:
                f.write(cfg.to_json() + "\n")
        say(f"wrote {args.dump_config}")
        return 0

    if args.stream or cfg.stream_source:
        return run_stream(args, cfg)

    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import load_libsvm, synthetic_corpus

    if args.corpus:
        corpus = load_libsvm(args.corpus)
    else:
        corpus = synthetic_corpus(0, num_docs=args.synthetic_docs,
                                  num_words=args.synthetic_words,
                                  avg_doc_len=args.synthetic_len, zipf_a=1.2)
    hyper = LDAHyperParams(num_topics=args.topics)

    try:
        session = TrainSession(corpus, hyper, cfg,
                               device=rank_dev or args.device)
    except RuntimeError as e:
        if cfg.mesh_shape is None:
            raise
        print(f"train: {e}", file=sys.stderr)  # the world does not fit
        return 2
    dev = session.device
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if cfg.mesh_shape is None:
        say(f"single-box  algorithm={cfg.algorithm}  "
            f"tokens={corpus.num_tokens}  device={card}")
    else:
        grid = session.plan.grid
        rows, cols = mesh_rows_cols(cfg.mesh_shape)
        say(f"mesh {rows}x{cols}  tokens={session.plan.num_tokens}  "
            f"pad={grid.padding_overhead:.2%}  algorithm={cfg.algorithm}  "
            f"ranks={session.plan.comm.size('all')} "
            f"({session.plan.comm.backend or 'one process'})  "
            f"device={card}")
    state = session.init(0)
    if session.backend.needs_row_pads:
        if cfg.mesh_shape is not None:
            kw, kd = session.row_pads
        else:
            # the single box resolves its widths per sweep: these are the
            # first sweep's
            pads = algorithms.resolve_row_pads(state, cfg.knobs())
            kw, kd = pads.max_kw, pads.max_kd
        say(f"padded-row widths: max_kw={kw} max_kd={kd}")

    t_last = [time.perf_counter()]

    def cb(st, metrics):
        if not metrics:
            return
        line = f"iter {int(st.iteration):4d}"
        if "llh" in metrics:
            line += (f"  llh {metrics['llh']:.1f}"
                     f"  ppl {metrics['perplexity']:.1f}"
                     f"  change {metrics['change_rate']:.3f}")
        if "coherence_umass" in metrics:
            line += f"  umass {metrics['coherence_umass']:.3f}"
        if "coherence_npmi" in metrics:
            line += f"  npmi {metrics['coherence_npmi']:.3f}"
        if "l2r_per_token" in metrics:
            line += f"  l2r/tok {metrics['l2r_per_token']:.3f}"
        if "hyper" in metrics:
            line += (f"  hyper a={metrics['hyper']['alpha']:.4f}"
                     f" b={metrics['hyper']['beta']:.4f}")
        if "row_pads" in metrics:
            kw, kd = metrics["row_pads"]
            line += f"  repad kw={kw} kd={kd}"
        now = time.perf_counter()
        line += f"  ({now - t_last[0]:.3f}s on {card})"
        t_last[0] = now
        for rec in metrics.get("autopilot", ()):
            line += (f"\n  autopilot {rec['decision']}"
                     f"{' applied' if rec['applied'] else ' (no-op)'}: "
                     f"{rec['reason']}")
        say(line, flush=True)

    final = session.run(state=state, callback=cb)
    final_llh = session.llh(final)  # a collective on a mesh
    say(f"finished at iteration {int(final.iteration)}; "
        f"final llh {final_llh:.1f}")
    if cfg.autopilot:
        say(f"autopilot: final backend={session.plan.backend.name} "
            f"row_pads={session.row_pads}")
    if cfg.metrics_out:
        say(f"telemetry: {cfg.metrics_out}")
    if cfg.checkpoint_dir:
        say(f"model checkpoint: {cfg.checkpoint_dir} "
            f"(serve with: python -m repro_torch.launch.serve_lda "
            f"--checkpoint-dir {cfg.checkpoint_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
