"""Quickstart on the PyTorch port (``examples/quickstart.py``): train
ZenLDA on a synthetic corpus and print topics.

One declarative ``RunConfig`` describes the whole run (algorithm,
iteration count, eval cadence) and ``session.run`` drives it, on the card
unless ``--device cpu`` asks for the plain torch versions on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_lda_corpus
from repro_torch.train.session import RunConfig, TrainSession


def main(argv=None):
    """Returns ``(session, final state, [metrics of each eval])``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's key (the corpus is always seed 0)")
    args = ap.parse_args(argv)

    corpus, true_phi = synthetic_lda_corpus(
        seed=0, num_docs=200, num_words=300, num_topics=10, avg_doc_len=50
    )
    hyper = LDAHyperParams(num_topics=10, alpha=0.1, beta=0.01)
    session = TrainSession(
        corpus, hyper,
        RunConfig(algorithm="zen", num_iterations=30, eval_every=10),
        device=args.device,
    )

    state = session.init(args.seed)
    print(f"corpus: {corpus.num_tokens} tokens, llh0 = {session.llh(state):.1f}")
    evals = []

    def report(st, metrics):
        if metrics:
            evals.append(dict(metrics))
            print(f"iter {int(st.iteration):3d}  llh {metrics['llh']:12.1f}  "
                  f"perplexity {metrics['perplexity']:8.2f}  "
                  f"change_rate {metrics['change_rate']:.3f}")

    state = session.run(state=state, callback=report)

    # top words per learned topic
    n_wk = state.n_wk.cpu().numpy()
    print("\ntop words per topic:")
    for k in range(hyper.num_topics):
        top = (-n_wk[:, k]).argsort(kind="stable")[:8]
        print(f"  topic {k:2d}: {top.tolist()}")
    return session, state, evals


if __name__ == "__main__":
    main()
