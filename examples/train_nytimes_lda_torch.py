"""End-to-end LDA training on the PyTorch port (the paper's NYTimes
experiment, scaled down; ``examples/train_nytimes_lda.py``): sparse word
initialization, converged-token exclusion after iteration 30, asymmetric
prior, a training checkpoint every 50 iterations and at the end, llh
logging — 200 iterations by default, on the card unless ``--device cpu``.

It runs on ``TrainSession``: a second run with the same ``--ckpt`` and
more ``--iters`` resumes from the newest training checkpoint (topics and
exclusion statistics; the counts rebuild), and since every draw is
counter-based it ends where one straight run ends.

    PYTHONPATH=src python examples/train_nytimes_lda_torch.py \\
        [--iters 200] [--quick] [--ckpt DIR] [--device cpu]
"""
import argparse
import os
import tempfile
import time

from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.train.checkpoint import committed_steps
from repro_torch.train.session import RunConfig, TrainSession


def main(argv=None):
    """Returns ``(session, final state)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--quick", action="store_true",
                    help="small corpus + 40 iterations (CI-sized)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "zenlda_nytimes_ckpt"))
    ap.add_argument("--topics", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)

    if args.quick:
        corpus = synthetic_corpus(0, num_docs=300, num_words=500,
                                  avg_doc_len=60, zipf_a=1.2)
        k = args.topics or 32
        iters = min(args.iters, 40)
        excl_start = 10
    else:
        # NYTimes-shaped (scaled ~300x down): the paper's corpus is 300k
        # docs x 102k words x 100M tokens, K=1000
        corpus = synthetic_corpus(0, num_docs=3000, num_words=5000,
                                  avg_doc_len=120, zipf_a=1.15)
        k = args.topics or 100
        iters = args.iters
        excl_start = 30  # the paper enables exclusion after iteration 30
    hyper = LDAHyperParams(num_topics=k, alpha=0.05, beta=0.01,
                           asymmetric_alpha=True)
    session = TrainSession(
        corpus, hyper,
        RunConfig(
            algorithm="zen",
            init="sparse_word", sparse_init_degree=0.2,
            exclusion_start=excl_start,
            token_chunk=0,  # 0 = whole sweep
            num_iterations=iters,
            train_checkpoint_dir=args.ckpt, train_checkpoint_every=50,
        ),
        device=args.device,
    )
    sync = (lambda: None)
    if session.device.type == "cuda":
        import torch

        sync = lambda: torch.cuda.synchronize(session.device)  # noqa: E731

    saved = committed_steps(args.ckpt)
    if saved:
        print(f"resumed from iteration {saved[-1][0]}")
    print(f"tokens={corpus.num_tokens} K={k} iterations={iters}")
    t_start = time.time()
    t_prev = [time.time()]

    def report(st, _metrics):
        sync()
        dt = time.time() - t_prev[0]
        it = int(st.iteration)
        if it % 10 == 0 or it == 1:
            m = session.metrics(st)
            print(f"iter {it:4d}  {dt*1e3:7.1f} ms  llh {m['llh']:14.1f}  "
                  f"ppl {m['perplexity']:9.2f}  "
                  f"change {m['change_rate']:.3f}", flush=True)
        t_prev[0] = time.time()

    state = session.run(0, callback=report)
    if int(state.iteration) not in dict(committed_steps(args.ckpt)):
        session.save_train_checkpoint(state)
    print(f"done in {time.time()-t_start:.1f}s; checkpoints in {args.ckpt}")
    return session, state


if __name__ == "__main__":
    main()
