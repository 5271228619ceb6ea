"""Distributed ZenLDA on the PyTorch port (the Fig. 2 workflow of
``examples/distributed_lda.py``): ``--devices N`` local ranks of one
``torch.distributed`` world (gloo), one per cell of a rows x cols grid,
started by ``repro_torch.launch.mesh.spawn_local``. On ``--device cuda``
(the default) the ranks share the card; ``--device cpu`` keeps them on
the host.

    PYTHONPATH=src python examples/distributed_lda_torch.py \\
        [--devices 4] [--device cpu]
"""
import argparse
import os
import time


def rank_main(rows: int, cols: int, device: str) -> None:
    """One rank: the same session as every other rank, its own cell;
    rank 0 prints."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.data.corpus import synthetic_lda_corpus
    from repro_torch.train.session import RunConfig, TrainSession

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    corpus, _ = synthetic_lda_corpus(0, num_docs=400, num_words=600,
                                     num_topics=16, avg_doc_len=60)
    hyper = LDAHyperParams(num_topics=16, alpha=0.05, beta=0.01)
    cfg = RunConfig(algorithm="zen_cdf", mesh_shape=(rows, cols), max_kd=24,
                    delta_dtype="int16", num_iterations=20, eval_every=5)
    session = TrainSession(corpus, hyper, cfg, device=dev)
    grid = session.plan.grid
    say(f"ranks={dist.get_world_size()} ({dist.get_backend()}, {dev.type}) "
        f"mesh={rows}x{cols} tokens={int(grid.mask.sum())} "
        f"pad_overhead={grid.padding_overhead:.2%}", flush=True)
    state = session.init(0)
    say(f"llh0 = {session.llh(state):.1f}", flush=True)
    t0 = [time.time()]

    def cb(st, metrics):
        if metrics:
            say(f"iter {int(st.iteration):2d}  "
                f"{(time.time() - t0[0]) * 1e3:6.1f} ms  "
                f"llh {metrics['llh']:12.1f}", flush=True)
        t0[0] = time.time()

    state = session.run(state=state, callback=cb)
    say("count conservation:",
        int(state.n_k.sum()) == int(grid.mask.sum()), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks: one per cell of the grid")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the ranks share the card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import spawn_local

    device = str(resolve_device(args.device))
    rows = max(1, args.devices // 2)
    cols = args.devices // rows
    spawn_local(f"{os.path.abspath(__file__)}:rank_main", rows * cols,
                args=(rows, cols, device))


if __name__ == "__main__":
    main()
