"""Serve a small LM with batched requests beside RT-LDA topic inference
on the PyTorch port (``examples/serve_lm.py``; the paper's online
inference story, §4.3), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.inference import rtlda_infer
from repro_torch.core.types import LDAHyperParams
from repro_torch.data.corpus import synthetic_lda_corpus
from repro_torch.models.model import init_params
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.train.session import RunConfig, TrainSession


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(device):
    """qwen2-vl's smoke config cut to 2 layers (the M-RoPE path), four
    prompts, 8 new tokens each. Returns the finished requests."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b-smoke"), num_layers=2)
    params = init_params(0, cfg, device=device)
    engine = ServingEngine(params, cfg, ServeConfig(max_batch=4, max_len=64),
                           device=device)
    prompts = [[1, 2, 3], [9, 8], [100, 50, 25, 12], [7]]
    t0 = time.time()
    for p in prompts:
        engine.submit(p, max_new=8)
    done = engine.run_until_done()
    _sync(engine.device)
    dt = time.time() - t0
    print(f"LM serving: {len(done)} requests, "
          f"{sum(len(r.out) for r in done)} tokens in {dt:.2f}s "
          f"on {engine.device}")
    for r in sorted(done, key=lambda r: r.uid):
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.out}")
    return done


def serve_rtlda(device):
    """20 ``zen`` iterations through ``TrainSession``, then RT-LDA theta
    for a 12-word query, timed over 50 calls. Returns the theta."""
    corpus, _ = synthetic_lda_corpus(0, num_docs=150, num_words=200,
                                     num_topics=8, avg_doc_len=40)
    hyper = LDAHyperParams(num_topics=8, alpha=0.1, beta=0.01)
    session = TrainSession(corpus, hyper,
                           RunConfig(algorithm="zen", num_iterations=20),
                           device=device)
    st = session.run(0)
    query = torch.as_tensor(
        np.random.default_rng(1).integers(0, 200, 12), dtype=torch.int32,
        device=session.device)
    theta = rtlda_infer(st.n_wk, st.n_k, query, hyper)  # warm-up
    _sync(session.device)
    t0 = time.time()
    for _ in range(50):
        theta = rtlda_infer(st.n_wk, st.n_k, query, hyper)
    _sync(session.device)
    dt = (time.time() - t0) / 50
    print(f"RT-LDA inference: {dt * 1e3:.2f} ms/query, "
          f"theta argmax topic {int(torch.argmax(theta))}")
    return theta


def main(argv=None):
    """Returns ``(finished LM requests, RT-LDA theta)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    return serve_lm(device), serve_rtlda(device)


if __name__ == "__main__":
    main()
