"""Host and device milliseconds by phase for the first windows of the
``stream`` phase's leg 1 (``chip_smoke.py``: the NYTIMES-shaped corpus
replayed in 32,768-document windows, ``zen_pallas``, 2 sweeps), in a
fresh process. The device times are the session's own ``timings`` (CUDA
events); the host times are taken at the same phase marks. A phase whose
host time is close to its device time kept the card waiting on the host.

    python3 tools/stream_first_window.py [--windows 3] [--reps 1]

Run it under ``CUDA_MODULE_LOADING=EAGER`` and under the default to see
what the first window pays for loading the kernels it is the first to
use. One JSON line per window.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    import repro_torch.train.online as online
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import _build
    from repro_torch.train.session import RunConfig

    _build.build()
    host = []
    mark, ms = online._PhaseClock.mark, online._PhaseClock.ms

    def host_mark(clock, name):
        mark(clock, name)
        clock.__dict__.setdefault("host", []).append(
            (name, time.perf_counter()))

    def host_ms(clock):
        h = clock.__dict__["host"]
        host.append({n: (b - a) * 1e3
                     for (_, a), (n, b) in zip(h, h[1:])})
        return ms(clock)

    online._PhaseClock.mark, online._PhaseClock.ms = host_mark, host_ms
    dev = torch.device("cuda", 0)
    corpus = cs.synthetic_nytimes(cs.D_NYT)
    hyper = LDAHyperParams(num_topics=cs.K_NYT)
    for rep in range(args.reps):
        sess = online.StreamingSession(
            cs.stream_source(corpus, cs.STREAM_WINDOW_DOCS, 1), hyper,
            RunConfig(algorithm="zen_pallas", kernels="auto",
                      num_iterations=args.windows,
                      window_docs=cs.STREAM_WINDOW_DOCS,
                      window_sweeps=cs.STREAM_SWEEPS), device=dev)
        sess.run(0, callback=lambda s, m: print(json.dumps({
            "rep": rep, "window": m["window"],
            "docs_per_sec": m["docs_per_sec"], "device_ms": s.timings,
            "host_ms": host[-1]}), flush=True))
        del sess
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
