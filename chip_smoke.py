#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds ``src/repro_torch/kernels/csrc/zen_infer.cu``,
   ``zen_train.cu``, ``sparse_row.cu``, ``cdf_search.cu`` and
   ``topic_histogram.cu`` for sm_90a, one nvcc each, in parallel (prints
   the ``-Xptxas -v`` summary);
3. kernels — both serving kernels at NYTIMES width (W = 101,636,
   K = 1000) on one full bucket sweep (32 slots x 512 = 16,384 tokens):
   the fused kernel must be bit-equal to the gathered one, and both may
   differ from the plain torch version on the card only at counted
   near-ties (top two scores within 1e-4) on at most 1e-4 of tokens;
   CUDA-event times of kernels and plain version, and the bound;
4. serving — a planted NYTIMES-width model (each word one dominant topic,
   ~12M tokens of counts) saved with ``save_lda_model``, loaded back with
   ``FrozenLDAModel.from_checkpoint``, and 256 documents of Poisson(332)
   tokens served through ``LDAEngine`` with ``zen_pallas``: throughput mode
   on the fused kernel, throughput mode on the gathered kernel
   (``kernels="off"``), latency mode (RT-LDA), then 64 documents through
   ``zen_cdf``'s frozen CDF tables. Every theta must be
   finite and sum to 1, the top topic must match the planted one on at
   least 90% of single-topic documents, and latency-mode assignments must
   equal those of the same engine on the CPU for a sample of documents.
   Each run's launch counts are zeroed after its warm-up and read right
   after its serving window: a throughput run must launch its own kernel
   and no other, and the latency and zen_cdf runs (no kernel) none.
5. train_kernels — both training kernels at NYTIMES width on the first
   1,048,576 tokens of the corpus below after init (the gathered rows are
   8.4 GB): fused bit-equal to gathered, each bit-equal to its plain
   version (0 mismatches); CUDA-event times, the bytes, the MUFU and hash
   operations, the fast loop's instructions per (t, k) read from
   ``cuobjdump -sass``, the share of (t, k) scored exactly (the kernel's
   stats output), and the bounds. Then the adversarial grid
   (``ADVERSARIAL``: +inf noise, the forced top bucket, equal-count rows
   with exact ties, p at the 1e-30 clamp, K = 37, 36 and 10,000, inputs
   outside the estimate's premise, and K = 14,464, 16,384 and 16,385
   about where the per-topic table moves from shared to global memory),
   each at 0 mismatches with fused == gathered; the estimate's margin
   premises checked by exhaustion; and the fused kernel timed on both
   sides of that placement boundary (K = 14,464 and 14,592);
6. train   — ``TrainSession`` with ``zen_pallas`` (``kernels="auto"``) on
   the corpus ``launch.train --topics 1000 --synthetic-docs 299752
   --synthetic-words 101636 --synthetic-len 332`` builds (~99.5M tokens):
   random init, 5 iterations with an eval at init and after each one;
   count invariants after every step, predictive llh rising at every eval,
   change rate in (0, 1), the llh and change-rate lists equal to
   ``RECORD`` (no redesign may change a draw), exactly 5 fused launches
   and 10 of kernel 5 (the delta merge: word and doc rows per step) and
   no other, then ``save_model`` read back bit-equal; one more step
   profiled;
7. train_small — the same recipe at 4,096 documents (~1.36M tokens) and
   the same initial topics, 3 iterations of ``zen`` (plain torch, cdf),
   ``std``, ``zen_pallas`` fused and ``zen_pallas`` gathered
   (``kernels="off"``): fused and gathered topics bit-identical after every
   iteration, each run launching only its own kernel (``zen`` and ``std``
   none) and, under ``kernels="auto"``, kernel 5 twice per step, the fused
   run's per-token llh equal to ``TRAIN_SMALL_LLH``, ``zen``'s within 1%
   of it and ``std``'s within 1% of ``zen``'s;
8. train_sparse — this slice's path at full width: ``TrainSession`` with
   ``zen_sparse`` and the paper's sparse word initialisation (degree 0.1)
   on the same NYTIMES corpus: 3 iterations, an eval at init and after
   each; count invariants after every step, llh rising at every eval, the
   lists equal to ``RECORD``, and launches of the sparse-row kernel (> 0)
   and of kernel 5 (2 per step) only. Reports the row widths of
   every sweep, seconds per step and the table build within it (timed
   apart on the same state), peak memory, and one more step profiled;
9. sparse_kernels — kernel 6 against its plain version on the first
   1,048,576 tokens of that state, on the term-3 rows (J = max_kd) and on
   SparseLDA's q rows (J = max_kw): topics equal with 0 mismatches, CUDA-
   event times and the bytes bound;
10. train_cdf — ``TrainSession`` with ``zen_cdf`` (``kernels="auto"``,
   max_kd 64) on the same NYTIMES corpus from a random init: 3 iterations,
   an eval at init and after each; count invariants after every step, llh
   rising at every eval, the lists equal to ``RECORD``, and launches of
   the CDF row search (kernel 7, two per token chunk) and of kernel 5 (2
   per step) only. Reports seconds per step, peak memory and one more
   step profiled;
11. histogram — kernel 5 on that run's last step as the delta merge of
   every backend runs it under ``kernels="auto"``: doc rows in the corpus
   order (checked sorted), R = 299,752, and word rows along the session's
   word-major walk, R = 101,636. ``delta_counts`` on the kernel equals
   ``delta_counts`` under ``kernels="off"`` (the plain version), and each
   side is bit-equal to the plain version, also walked without its order;
   CUDA-event times of the kernel, the plain version (two ``index_put_``)
   and both ``delta_counts`` routes, the bytes bound, the SASS loop and
   ``-res-usage`` figures;
12. cdf_kernels — kernel 7 on the first 1,048,576 tokens of the zen_cdf
   state, on the path's term-2 targets of draw a and on targets uniform
   over each word's row: bit-equal to its plain version (0 mismatches),
   CUDA-event times of the kernel, the plain version and the
   ``kernels="off"`` route (the ``w_cdf`` build and its ``log K`` search),
   the bytes, operation and instruction-issue bounds, the SASS loop and
   ``-res-usage`` figures;
13. train_sparse_small — the train_small corpus and one set of initial
   topics, 3 iterations each of ``zen_sparse``, ``sparselda``,
   ``zen_hybrid``, ``lightlda`` (kernel) and ``lightlda`` with
   ``kernels="off"`` (per-word alias tables), ``zen_cdf`` (kernel 7) and
   ``zen_cdf`` with ``kernels="off"``, and ``zen``: invariants after every
   step, each run's per-token llh within 8% of ``zen``'s, every run
   launching only its own kernel (``lightlda`` off, ``zen_cdf`` off and
   ``zen`` none) and, under ``kernels="auto"``, kernel 5 twice per step.

The serving phase also serves 64 documents with ``zen_cdf`` (throughput
mode on its frozen per-word CDFs: no kernel), and train_small also runs
``std`` (Eq. 3 as written, plain torch) within 1% of ``zen``.

Then it prints the ``{"kernels": [...]}`` line (all seven kernels), the
``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``. It exits
non-zero, before any result, when no CUDA device is present, when the
repository's ``src/`` is missing, or when any check fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

W_NYT, K_NYT = 101_636, 1000  # src/repro/configs/zenlda.py NYTIMES
D_NYT, LEN_NYT = 299_752, 332  # NYTIMES documents, mean tokens per doc
SLOTS, BUCKET = 32, 512
N_DOCS = 256
TRAIN_ITERS, SMALL_DOCS, SMALL_ITERS = 5, 4096, 3
SPARSE_ITERS = 3  # train_sparse: iterations of zen_sparse at full width
SPARSE_LLH_BAND = 0.08  # train_sparse_small: llh/token vs zen's
CDF_ITERS, CDF_MAX_KD = 3, 64  # train_cdf: zen_cdf iterations, doc rows
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_TOKENS = 1 << 20  # training-kernel phase: first 1,048,576 tokens
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SFU_PER_SM_PER_CLK = 16  # special-function unit results per SM per clock
INSTR_PER_SM_PER_CLK = 4 * 32  # 4 warp schedulers x 32 lanes
INT_PER_SM_PER_CLK = 64  # 32-bit integer operations per SM per clock
HASH_INT_OPS = 9  # integer operations of the counter hash per (t, k)
NEAR_TIE = 1e-4
# kernel 5 (csrc/topic_histogram.cu) and kernel 7 (csrc/cdf_search.cu)
# as the profiler names their device functions
HIST_KERNELS = ("hist_sorted_kernel", "zero_cut_rows_kernel",
                "zero_fill_kernel")
CDF_KERNELS = ("cdf_compact_kernel", "cdf_walk_kernel")
CDF_STRIPS = 4  # strips per pass of the walk's loop (kStrips)
# The training phases' records, as this script measured them before
# kernels 5 and 7 were redesigned (NVIDIA H100 80GB HBM3, 700 W; equal in
# four runs of that tree): no kernel redesign may change them, since every
# draw is counter-based and every count an integer
RECORD = {
    "train": {
        "llh": [-553201183.023535, -552858789.5727848, -552430974.6499592,
                -551982301.1272973, -551533959.0934076,
                -551100162.7035435],
        "change_rate": [0.9989971068767338, 0.9942934639652927,
                        0.9886557953084262, 0.9828150417487752,
                        0.977131860126165],
    },
    "train_sparse": {
        "llh": [-551683197.7157105, -550211639.0543504, -548992734.4532295,
                -547991388.1614581],
        "change_rate": [0.9941575079234416, 0.9755162955561146,
                        0.9533872665494625],
    },
    "train_cdf": {
        "llh": [-553201183.023535, -552490201.228704, -551752980.2351285,
                -551185658.4481958],
        "change_rate": [0.9983710900516083, 0.9782291959193491,
                        0.9693572627624099],
    },
}
TRAIN_SMALL_LLH = -5.84568195283306  # fused and gathered, per token


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_record(phase: str, llh, change_rate) -> None:
    """The phase's llh and change-rate lists must equal :data:`RECORD`."""
    want = RECORD[phase]
    check(llh == want["llh"] and change_rate == want["change_rate"],
          f"{phase}: llh {llh} / change rate {change_rate} differ from "
          f"the record {want}")


def check_launches(phase: str, counts, want) -> None:
    """``counts`` must be ``want`` (kernel -> launches) and 0 elsewhere."""
    got = {n: v for n, v in counts.items() if v or n in want}
    check(got == want, f"{phase}: expected launches {want}, got {counts}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, gate: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events. With
    ``gate`` the card first sleeps ~15 ms, so that all ``reps`` launches
    are queued before the first event: a call shorter than its host-side
    launch cost is then timed back to back, not at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if gate:
        torch.cuda._sleep(30_000_000)  # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(gen, dev, sm_count: int, sm_clock_hz: float):
    """Both kernels against each other and the plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gather import zen_fused_infer_sample_plain
    from repro_torch.kernels.zen_sampler import gumbel_noise

    w, k, b, t = W_NYT, K_NYT, SLOTS, SLOTS * BUCKET
    i32 = torch.int32
    n_wk = torch.randint(0, 64, (w, k), generator=gen, device=dev, dtype=i32)
    n_kd = torch.randint(0, 12, (b, k), generator=gen, device=dev, dtype=i32)
    word = torch.randint(0, w, (t,), generator=gen, device=dev, dtype=i32)
    slot = torch.arange(b, device=dev, dtype=i32).repeat_interleave(BUCKET)
    z = torch.randint(0, k, (t,), generator=gen, device=dev, dtype=i32)
    seeds = torch.randint(0, 2**31 - 1, (t,), generator=gen, device=dev,
                          dtype=i32)
    n_k = n_wk.sum(0).to(torch.float32)
    alpha = torch.rand(k, generator=gen, device=dev) * 0.1
    beta, w_beta = 0.01, w * 0.01
    nwk_rows = n_wk[word.long()].contiguous()
    nkd_rows = n_kd[slot.long()].contiguous()

    def fused():
        return ops.zen_fused_infer_sample(n_wk, n_kd, word, slot, z, seeds,
                                          alpha, n_k, beta=beta,
                                          w_beta=w_beta)

    def gathered():
        return ops.zen_infer_sample(nwk_rows, nkd_rows, z, seeds, alpha,
                                    n_k, beta=beta, w_beta=w_beta)

    def plain():
        return zen_fused_infer_sample_plain(n_wk, n_kd, word, slot, z, seeds,
                                            alpha, n_k, beta=beta,
                                            w_beta=w_beta)

    out_f, out_g, out_p = fused(), gathered(), plain()
    torch.cuda.synchronize()
    check(bool(torch.equal(out_f, out_g)),
          "fused and gathered kernels disagree")
    mism = (out_f != out_p).nonzero().flatten()
    gaps = []
    if mism.numel():
        # recompute both candidates' scores in plain torch at the
        # mismatched tokens: a legitimate mismatch is a near-tie
        m = mism.long()
        cand = torch.stack([out_f[m], out_p[m]], 1).long()
        nw = n_wk[word[m].long()].gather(1, cand).to(torch.float32)
        nd = n_kd[slot[m].long()].gather(1, cand).to(torch.float32) \
            - (cand == z[m, None].long()).to(torch.float32)
        p = (nd + alpha[cand]) * (nw + beta) / (n_k[cand] + w_beta)
        s = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(seeds[m, None], 0, cand)
        gaps = (s[:, 0] - s[:, 1]).abs().tolist()
    check(all(g <= NEAR_TIE for g in gaps),
          f"kernel-vs-plain mismatches that are no near-tie: {gaps}")
    check(len(gaps) <= NEAR_TIE * t,
          f"{len(gaps)} kernel-vs-plain mismatches over {t} tokens")

    ms_f = cuda_ms(fused, reps=20)
    ms_g = cuda_ms(gathered, reps=20)
    ms_p = cuda_ms(plain, reps=5)

    uniq = int(torch.unique(word).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    tok = t * 4 * 4 + t * 4  # word/slot or z/seeds in, topics out
    bytes_f = uniq * k * 4 + b * k * 4 + vec + tok
    bytes_g = 2 * t * k * 4 + vec + t * 4 * 2 + t * 4
    logf = 3 * t * k
    sfu_rate = sm_count * SFU_PER_SM_PER_CLK * sm_clock_hz
    logf_ms = logf / sfu_rate * 1e3

    def row(name, replaces, ms, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_infer.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps, "tokens": t,
            "ms": ms, "plain_ms": ms_p,
            "bound_ms": max(bytes_ms, logf_ms),
            "bound_by": "bytes" if bytes_ms >= logf_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "logf": logf, "logf_ms": logf_ms, "library_ms": None,
        }

    rows = [
        row("zen_fused_infer_sample",
            "src/repro/kernels/fused_gather.py:166", ms_f, bytes_f),
        row("zen_infer_sample",
            "src/repro/kernels/zen_sampler.py:218", ms_g, bytes_g),
    ]
    emit({"phase": "kernels", "W": w, "K": k, "T": t, "unique_words": uniq,
          "fused_equals_gathered": True, "mismatches_vs_plain": len(gaps),
          "ms": {"fused": ms_f, "gathered": ms_g, "plain": ms_p}})
    del n_wk, nwk_rows, nkd_rows
    torch.cuda.empty_cache()
    return rows


def planted_model(gen, dev):
    """Each word one dominant topic (100 counts) plus 20 background counts
    on random topics: 12.2M tokens, below the 2^24 where a float32 N_k sum
    turns order-dependent."""
    import torch

    w, k = W_NYT, K_NYT
    dom = torch.randperm(w, generator=gen, device=dev) % k
    n_wk = torch.zeros((w, k), dtype=torch.int32, device=dev)
    n_wk[torch.arange(w, device=dev), dom] = 100
    bg = torch.randint(0, k, (w, 20), generator=gen, device=dev)
    n_wk.scatter_add_(1, bg, torch.ones_like(bg, dtype=torch.int32))
    return n_wk, n_wk.sum(0), dom.cpu().numpy()


def planted_docs(rng, dom, n_docs: int):
    """Poisson(332) documents on 1-2 planted topics; 90% of tokens from
    the topics' dominant words, 10% uniform noise."""
    import numpy as np

    by_topic = [np.flatnonzero(dom == t) for t in range(K_NYT)]
    docs, topics = [], []
    for _ in range(n_docs):
        n = max(1, int(rng.poisson(332)))
        ts = rng.choice(K_NYT, size=int(rng.integers(1, 3)), replace=False)
        pick = rng.choice(ts, size=n)
        words = np.array([rng.choice(by_topic[t]) for t in pick], np.int32)
        noise = rng.random(n) < 0.1
        words[noise] = rng.integers(0, W_NYT, int(noise.sum()))
        docs.append(words)
        topics.append([int(t) for t in ts])
    return docs, topics


def serve(model, cfg, docs, seed: int):
    """Warm, then serve every doc through the ticket front; returns
    (thetas, requests, seconds, kernel launches of the serving window)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=seed)
    engine.warm()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [engine.submit_async(d) for d in docs]
    reqs = [engine.request(t) for t in tickets]
    thetas = np.stack([engine.result(t) for t in tickets])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return thetas, reqs, secs, ops.launch_counts()


def check_thetas(name, thetas, topics, n_docs):
    import numpy as np

    check(thetas.shape == (n_docs, K_NYT), f"{name}: theta shape")
    check(bool(np.isfinite(thetas).all()), f"{name}: non-finite theta")
    check(bool(np.allclose(thetas.sum(1), 1.0, atol=1e-4)),
          f"{name}: theta rows do not sum to 1")
    single = [i for i, ts in enumerate(topics) if len(ts) == 1]
    hit = np.mean([int(np.argmax(thetas[i])) == topics[i][0]
                   for i in single])
    pair = [i for i, ts in enumerate(topics) if len(ts) == 2]
    pair_hit = np.mean([int(np.argmax(thetas[i])) in topics[i]
                        for i in pair]) if pair else float("nan")
    check(hit >= 0.9, f"{name}: planted topic recovered on {hit:.3f} of "
          f"single-topic docs (< 0.9)")
    return float(hit), float(pair_hit)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import _build
    from repro_torch.serving import FrozenLDAModel, LDAServeConfig
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.train.checkpoint import save_lda_model

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(dev)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    emit({"phase": "device", "name": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "sm_count": props.multi_processor_count,
          "max_sm_clock_hz": sm_clock_hz, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = _build.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if ("ptxas" in ln and ("registers" in ln or "Compiling" in ln))
             or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(src.relative_to(ROOT)) for src in _build.SOURCES],
          "ptxas": ptxas})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = phase_kernels(gen, dev, props.multi_processor_count, sm_clock_hz)

    # -- serving: planted model through a checkpoint round trip ----------
    hyper = LDAHyperParams(num_topics=K_NYT, alpha=0.01, beta=0.01)
    n_wk, n_k, dom = planted_model(gen, dev)
    ckpt = ROOT / "build" / "chip_smoke_model"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    save_lda_model(str(ckpt), n_wk, n_k, hyper, step=0)
    model = FrozenLDAModel.from_checkpoint(str(ckpt), device=dev)
    t_ckpt = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    check(bool(torch.equal(model.n_wk, n_wk)) and model.hyper == hyper,
          "checkpoint round trip changed the model")
    del n_wk
    rng = np.random.default_rng(args.seed)
    docs, topics = planted_docs(rng, dom, N_DOCS)
    base = dict(buckets=(128, 256, 512), max_batch=SLOTS, num_sweeps=10,
                algorithm="zen_pallas")
    # (run, config, docs, planted topics, the kernel the run must launch)
    runs = [
        ("throughput_fused", LDAServeConfig(**base), docs, topics,
         "zen_fused_infer_sample"),
        ("throughput_gathered", LDAServeConfig(kernels="off", **base),
         docs[:64], topics[:64], "zen_infer_sample"),
        ("latency", LDAServeConfig(mode="latency", **base), docs, topics,
         None),
        ("throughput_cdf", LDAServeConfig(**{**base,
                                             "algorithm": "zen_cdf"}),
         docs[:64], topics[:64], None),
    ]
    results, launches = {}, {}
    for name, cfg, ds, ts, kernel in runs:
        thetas, reqs, secs, counts = serve(model, cfg, ds, args.seed)
        hit, pair_hit = check_thetas(name, thetas, ts, len(ds))
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3 for r in reqs)
        results[name] = (thetas, reqs)
        emit({"phase": "serving", "run": name, "docs": len(ds),
              "tokens": int(sum(len(d) for d in ds)), "seconds": secs,
              "docs_per_sec": len(ds) / secs, "p50_ms": lat["p50"],
              "p99_ms": lat["p99"], "max_ms": lat["max"],
              "planted_top1_single": hit, "planted_top1_pair": pair_hit,
              "launches": counts, "card": smi, "checkpoint_seconds": t_ckpt})
        check(all((v > 0) == (k == kernel) for k, v in counts.items()),
              f"{name}: expected launches of {kernel} only, got {counts}")
        if kernel is not None:
            launches[kernel] = counts[kernel]

    # latency mode is deterministic: the CPU engine must agree exactly
    sample = list(range(16))
    cpu_model = FrozenLDAModel(model.n_wk.cpu(), model.n_k.cpu(), hyper)
    cpu_reqs = serve_cpu(cpu_model, runs[2][1], [docs[i] for i in sample])
    gpu_reqs = results["latency"][1]
    same = all(np.array_equal(cpu_reqs[j].z, gpu_reqs[i].z)
               for j, i in enumerate(sample))
    check(same, "latency-mode assignments differ between card and CPU")
    emit({"phase": "reference", "latency_docs_equal_on_cpu": len(sample)})
    for name, cfg, ds, _, _ in runs:
        emit({"phase": "profile", "run": name, "docs": len(ds[:64]),
              **profile_serving(model, cfg, ds[:64], args.seed)})

    # -- training: kernels, the full NYTIMES run, the three backends ------
    train_rows, train_launches = run_training(args.seed, dev, props, smi,
                                              sm_clock_hz)
    launches.update(train_launches)
    rows = train_rows + rows
    for r in rows:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0,
              f"{r['name']} was not launched on its path")
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def sass_function(kernel: str, source: str):
    """``(address, instruction)`` pairs of the first function whose
    mangled name holds ``kernel``, from ``cuobjdump -sass`` of the library
    built from ``source``, and the branch targets of each branch (label or
    address resolved). None when the tool or the function is missing."""
    import re

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = [_build.target(s) for s in _build.SOURCES
           if s.name == source][0]
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=120).stdout
    except OSError:
        return None
    funcs = re.split(r"\n\s*Function : ", out)
    body = next((f for f in funcs[1:] if kernel in f.splitlines()[0]), None)
    if body is None:
        return None
    instr, labels = [], {}
    pending = []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            instr.append((addr, m.group(2)))
    branches = []  # (address, target, instruction)
    for addr, text in instr:
        if "BRA" not in text.split() and "CALL.REL.NOINC" not in text:
            continue
        m = re.search(r"\(\s*(\.L_x_\d+)\s*\)|(?:BRA|NOINC)\s+(?:!?P\d+,\s*)?"
                      r"(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                               16)
        if target is not None:
            branches.append((addr, target, text))
    return instr, branches


def sass_loop_stats(kernel: str, source: str = "zen_train.cu",
                    holding: str = None):
    """Instructions in a loop of ``kernel``, from ``cuobjdump -sass`` of
    the library built from ``source``: the span of the function's widest
    backward branch (the K loop, kept rolled, of one (t, k) per lane per
    pass), or with ``holding`` the narrowest one whose span holds that
    opcode (an inner loop). None when the tool or the pattern is
    missing."""
    parsed = sass_function(kernel, source)
    if parsed is None:
        return None
    instr, branches = parsed
    best = None
    for addr, target, text in branches:
        if "BRA" not in text.split() or target >= addr:
            continue
        if holding is not None:
            if not any(holding in t for a, t in instr
                       if target <= a <= addr):
                continue
            if best is None or addr - target < best[1] - best[0]:
                best = (target, addr)
        elif best is None or addr - target > best[1] - best[0]:
            best = (target, addr)
    if best is None:
        return None
    loop = [t for a, t in instr if best[0] <= a <= best[1]]
    return {"loop_instructions": len(loop),
            "loop_mufu": sum("MUFU" in t for t in loop),
            "function_instructions": len(instr)}


def fast_loop_stats(kernel: str, topics_per_pass: int,
                    source: str = "zen_train.cu"):
    """The verified training sampler's fast loop in ``kernel``'s SASS: the
    smallest backward-branch loop that holds the estimate's MUFU.LG2 (3
    per topic); its instructions less those that a forward branch skips
    over an exact-path CALL (the rare top-bucket block), per pass and per
    (t, k); and the out-of-line exact_score's length (the CALL target up to
    its RET), which each exact topic costs. None when the tool or the
    pattern is missing."""
    parsed = sass_function(kernel, source)
    if parsed is None:
        return None
    instr, branches = parsed
    addrs = [a for a, _ in instr]

    def span(lo, hi):  # instructions with lo <= address <= hi
        return [(a, t) for a, t in instr if lo <= a <= hi]

    loops = [(target, addr) for addr, target, text in branches
             if "BRA" in text.split() and target < addr
             and sum("MUFU.LG2" in t for _, t in span(target, addr))
             >= 3 * topics_per_pass]
    if not loops:
        return None
    lo, hi = min(loops, key=lambda l: l[1] - l[0])
    body = span(lo, hi)
    skipped = set()
    for addr, target, text in branches:
        if "BRA" in text.split() and lo <= addr < target <= hi:
            region = [a for a, t in body if addr < a < target]
            if any("CALL" in t for a, t in body if a in region):
                skipped.update(region)
    fast = len(body) - len(skipped)
    calls = [target for addr, target, text in branches
             if "CALL.REL.NOINC" in text and lo <= addr <= hi]
    exact = None
    if calls:
        start = addrs.index(calls[0]) if calls[0] in addrs else None
        if start is not None:
            n = 0
            for _, t in instr[start:]:
                n += 1
                if any(w.startswith("RET") for w in t.split()):
                    break
            exact = n
    return {"loop_instructions": len(body),
            "fast_loop_instructions": fast,
            "topics_per_pass": topics_per_pass,
            "fast_instructions_per_tk": fast / topics_per_pass,
            "loop_mufu": sum("MUFU" in t for _, t in body),
            "exact_score_instructions": exact,
            "function_instructions": len(instr)}


def res_usage(source: str, kernel: str):
    """``cuobjdump -res-usage`` of ``kernel`` in the library built from
    ``source``: registers, stack, shared and local (spill) bytes. None
    when the tool or the function is missing."""
    import re

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = [_build.target(s) for s in _build.SOURCES if s.name == source][0]
    try:
        out = subprocess.run([tool, "-res-usage", str(lib)],
                             capture_output=True, text=True,
                             timeout=120).stdout
    except OSError:
        return None
    lines = out.splitlines()
    for i, line in enumerate(lines):
        if "Function" in line and kernel in line and i + 1 < len(lines):
            return dict(re.findall(r"(\w+):(\d+)", lines[i + 1]))
    return None


def synthetic_nytimes(num_docs: int):
    """The corpus ``launch.train --synthetic-docs num_docs
    --synthetic-words 101636 --synthetic-len 332`` builds."""
    from repro_torch.data.corpus import synthetic_corpus

    return synthetic_corpus(0, num_docs=num_docs, num_words=W_NYT,
                            avg_doc_len=LEN_NYT, zipf_a=1.2)


# The training kernels' adversarial grid: (name, seed, T, K, W, D, counts,
# pinned {token: topic}). The pins are the plain version's own draws at
# hash coordinates chosen for them (tests/test_torch_train_kernels.py
# holds them against the JAX package's hash and oracle):
# - inf_noise: (seed 1857, row 118, topic 230) has m = 2^24 - 1, noise
#   +inf: that topic wins whatever its probability;
# - *_tie: rows of equal counts, where the noise alone decides, and rows
#   whose two largest noises are equal (m 2j, 2j + 1 round to one u), so
#   the exact scores tie and the lower topic must win: in the forced top
#   bucket (seed 88, row 642: 26 and 336), in two lanes' candidates (seed
#   2, row 760: 147 and 808) and in one lane, which sends the token to the
#   exact loop (seed 458, row 104: 254 and 893);
# - p_clamp: alpha_k from 1e-33 to 1e-23 and empty counts, so p lies on
#   both sides of the 1e-30 clamp;
# - odd_k (K = 37, one topic per lane), k_36 (a partial 128-topic pass),
#   k_10000 (the K = 10,000 configuration), premise_off (one N_k + W b
#   above 2^100: the block samples with the exact loop alone);
# - k_14464 (the largest table that fits in an H100's shared memory),
#   k_16384 and k_16385 (tables the launcher puts in global memory, with
#   4 and 1 topics per lane).
ADVERSARIAL = (
    ("inf_noise", 1857, 4096, 256, 40, 6, "random", {118: 230}),
    ("top_bucket_tie", 88, 1024, 1000, 8, 4, "equal", {642: 26}),
    ("candidates_tie", 2, 1024, 1000, 8, 4, "equal", {760: 147}),
    ("same_lane_tie", 458, 1024, 1000, 8, 4, "equal", {104: 254}),
    ("p_clamp", 7, 4096, 1000, 100, 10, "clamp", {}),
    ("odd_k", 11, 4096, 37, 50, 3, "random", {}),
    ("k_36", 12, 4096, 36, 50, 3, "random", {}),
    ("k_10000", 13, 4096, 10000, 3000, 20, "random", {}),
    ("premise_off", 14, 4096, 1000, 100, 10, "premise_off", {}),
    ("k_14464", 16, 512, 14464, 60, 8, "random", {}),
    ("k_16384", 17, 512, 16384, 60, 8, "random", {}),
    ("k_16385", 18, 512, 16385, 60, 8, "random", {}),
)


def adversarial_case(spec, dev):
    """The inputs of one :data:`ADVERSARIAL` case on ``dev``."""
    import torch

    name, seed, t, k, w, d, kind, _ = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    doc = torch.randint(0, d, (t,), generator=g, device=dev, dtype=i32)
    if kind == "equal":  # z_old = 0 is none of the pinned topics
        return dict(n_wk=torch.full((w, k), 5, dtype=i32, device=dev),
                    n_kd=torch.full((d, k), 2, dtype=i32, device=dev),
                    word=word, doc=doc,
                    z=torch.zeros(t, dtype=i32, device=dev),
                    alpha=torch.full((k,), 0.05, device=dev),
                    n_k=torch.full((k,), 1000.0, device=dev), seed=seed)
    z = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    if kind == "clamp":
        n_wk = torch.zeros((w, k), dtype=i32, device=dev)
        n_kd = torch.zeros((d, k), dtype=i32, device=dev)
    else:
        n_wk = torch.randint(0, 40, (w, k), generator=g, device=dev,
                             dtype=i32)
        n_kd = torch.randint(0, 8, (d, k), generator=g, device=dev,
                             dtype=i32)
    ones = torch.ones(t, dtype=i32, device=dev)
    n_wk.index_put_((word.long(), z.long()), ones, accumulate=True)
    n_kd.index_put_((doc.long(), z.long()), ones, accumulate=True)
    if kind == "clamp":
        alpha = 10.0 ** (torch.rand(k, generator=g, device=dev) * 10 - 33)
        n_k = torch.full((k,), 1000.0, device=dev)
    else:
        alpha = torch.rand(k, generator=g, device=dev) * 0.2 + 0.001
        n_k = n_wk.sum(0).to(torch.float32)
    if kind == "premise_off":
        n_k[5] = 1e35
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, doc=doc, z=z, alpha=alpha,
                n_k=n_k, seed=seed)


def adversarial_check(spec, dev):
    """Both training kernels on one :data:`ADVERSARIAL` case against the
    plain version: 0 mismatches, fused == gathered, the pinned draws.
    Direct launches with the stats output, outside the launch counts.
    Returns the case's summary, with where the launcher put the table."""
    import torch

    from repro_torch.kernels.fused_gather import (
        zen_fused_sample_cuda,
        zen_fused_sample_plain,
    )
    from repro_torch.kernels.zen_sampler import (
        train_global_table_entries,
        zen_sample_cuda,
    )

    name, _, t, k, w, _, _, pins = spec
    a = adversarial_case(spec, dev)
    args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"], a["alpha"],
            a["n_k"], a["seed"])
    kw = dict(beta=0.01, w_beta=w * 0.01)
    plain = zen_fused_sample_plain(*args, **kw)
    rows = (a["n_wk"][a["word"].long()].contiguous(),
            a["n_kd"][a["doc"].long()].contiguous())
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    fused = zen_fused_sample_cuda(*args, stats=stats, **kw)
    gathered = zen_sample_cuda(*rows, a["z"], a["alpha"], a["n_k"],
                               a["seed"], **kw)
    torch.cuda.synchronize()
    mism = int((fused != plain).sum())
    check(bool(torch.equal(fused, gathered)),
          f"adversarial {name}: fused != gathered")
    check(mism == 0, f"adversarial {name}: {mism} kernel-vs-plain "
          "mismatches")
    exact, cands, exact_loop = stats.tolist()
    # premise_off: every token takes the exact loop; elsewhere the exact
    # chain runs for a few topics of some tokens
    check(exact_loop == t if name == "premise_off" else
          exact_loop < t and exact + cands < t * k,
          f"adversarial {name}: exact work {stats.tolist()}")
    for tok, topic in pins.items():
        check(int(plain[tok]) == topic,
              f"adversarial {name}: token {tok} drew {int(plain[tok])}, "
              f"pinned {topic}")
    table = "global" if train_global_table_entries(k, dev) else "shared"
    return {"case": name, "T": t, "K": k, "table": table,
            "stats": stats.tolist(),
            "pins": {str(tok): topic for tok, topic in pins.items()},
            "mismatches": mism}


def margin_premises(dev):
    """The fast estimate's margin premises by exhaustion on the card:
    E1 over every float in [1e-30, FLT_MAX], E2 over every m below the
    forced bucket (and below other widths, for the record)."""
    from repro_torch.kernels.zen_sampler import fast_score_errors

    r = fast_score_errors(dev)
    noise = r["noise_err"]
    below = {f"2^{j}": float(noise[:(1 << 24) - (1 << j)].max())
             for j in range(8, 15)}
    e2 = float(noise[:r["top_bucket"]].max())
    slack = 2.0 ** -14
    out = {"margin": r["margin"], "top_bucket": r["top_bucket"],
           "E1_log": r["log_err"], "E2_noise": e2, "slack": slack,
           "sum": r["log_err"] + e2 + slack,
           "E2_below_top_minus": below}
    check(out["sum"] <= r["margin"],
          f"margin premise broken: E1 + E2 + 2^-14 = {out['sum']} > "
          f"{r['margin']}")
    return out


def placement_boundary_ms(dev):
    """The fused kernel on both sides of the table's placement boundary
    (T = 65,536): K = 14,464, the largest table an H100 block keeps in
    shared memory, and K = 14,592, the smallest it reads from global
    memory through L1; ms per 10^9 (t, k) and where the table went."""
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda
    from repro_torch.kernels.zen_sampler import train_global_table_entries

    out = {}
    for k in (14464, 14592):
        a = adversarial_case(("boundary", 15, 1 << 16, k, 3000, 20,
                              "random", {}), dev)
        args = (a["n_wk"], a["n_kd"], a["word"], a["doc"], a["z"],
                a["alpha"], a["n_k"], a["seed"])
        ms = cuda_ms(lambda: zen_fused_sample_cuda(*args, beta=0.01,
                                                   w_beta=30.0), reps=5)
        out[str(k)] = {
            "table": ("global" if train_global_table_entries(k, dev)
                      else "shared"),
            "ms": ms, "ms_per_1e9_tk": ms * 1e9 / ((1 << 16) * k)}
        del a, args
    return out


def phase_train_kernels(sess, st, seed: int, sm_count: int,
                        sm_clock_hz: float):
    """Both training kernels on the first KERNEL_TOKENS tokens of the
    initialised NYTIMES state, against each other and the plain version."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gather import zen_fused_sample_plain
    from repro_torch.kernels.zen_sampler import gumbel_noise

    c, h = sess.corpus, sess.hyper
    t, k = KERNEL_TOKENS, K_NYT
    word, doc, z = c.word[:t], c.doc[:t], st.topic[:t]
    alpha = h.alpha_k(st.n_k).contiguous()
    n_k = st.n_k.to(torch.float32)
    beta, w_beta = h.beta, c.num_words * h.beta
    kseed = seed * 7919 + 1
    nwk_rows = st.n_wk[word.long()].contiguous()
    nkd_rows = st.n_kd[doc.long()].contiguous()

    def fused():
        return ops.zen_fused_sample(st.n_wk, st.n_kd, word, doc, z, alpha,
                                    n_k, kseed, beta=beta, w_beta=w_beta)

    def gathered():
        return ops.zen_sample(nwk_rows, nkd_rows, z, alpha, n_k, kseed,
                              beta=beta, w_beta=w_beta)

    def plain():
        return zen_fused_sample_plain(st.n_wk, st.n_kd, word, doc, z, alpha,
                                      n_k, kseed, beta=beta, w_beta=w_beta)

    out_f, out_g, out_p = fused(), gathered(), plain()
    torch.cuda.synchronize()
    check(bool(torch.equal(out_f, out_g)),
          "training: fused and gathered kernels disagree")
    check(int(out_f.min()) >= 0 and int(out_f.max()) < k,
          "training kernel drew a topic outside [0, K)")
    mism = (out_f != out_p).nonzero().flatten()
    gaps = []
    if mism.numel():
        m = mism.long()
        cand = torch.stack([out_f[m], out_p[m]], 1).long()
        hit = (cand == z[m, None].long()).to(torch.float32)
        nw = st.n_wk[word[m].long()].gather(1, cand).to(torch.float32) - hit
        nd = st.n_kd[doc[m].long()].gather(1, cand).to(torch.float32) - hit
        a = alpha[cand]
        p = (a * beta + nw * a + nd * (nw + beta)) / (n_k[cand] - hit
                                                      + w_beta)
        sc = torch.log(torch.clamp_min(p, 1e-30)) \
            + gumbel_noise(kseed, m[:, None], cand)
        gaps = (sc[:, 0] - sc[:, 1]).abs().tolist()
    check(all(g <= NEAR_TIE for g in gaps),
          f"training kernel-vs-plain mismatches that are no near-tie: {gaps}")
    check(len(gaps) <= NEAR_TIE * t,
          f"training: {len(gaps)} kernel-vs-plain mismatches over {t}")
    # the verified design is exact: no near-tie may differ either
    check(not gaps, f"training: {len(gaps)} kernel-vs-plain mismatches")

    # the exact work these inputs need, from the kernels' stats output
    # (direct launches, outside the launch counts): topics scored exactly
    # in the pass or as z_old, rescored candidates, exact-loop tokens
    from repro_torch.kernels.fused_gather import zen_fused_sample_cuda
    stats = torch.zeros(3, dtype=torch.int64, device=st.n_wk.device)
    check(bool(torch.equal(zen_fused_sample_cuda(
        st.n_wk, st.n_kd, word, doc, z, alpha, n_k, kseed, beta=beta,
        w_beta=w_beta, stats=stats), out_f)), "training: stats run differs")
    forced, cands, fallback = stats.tolist()

    ms_f = cuda_ms(fused, reps=5, warmup=1)
    ms_g = cuda_ms(gathered, reps=5, warmup=1)
    ms_p = cuda_ms(plain, reps=2, warmup=0)

    uniq_w = int(torch.unique(word).numel())
    uniq_d = int(torch.unique(doc).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    bytes_f = (uniq_w + uniq_d) * k * 4 + vec + t * 3 * 4 + t * 4
    bytes_g = 2 * t * k * 4 + vec + t * 4 + t * 4
    # the operations any exact draw needs: the hash of every (t, k) for
    # its noise. This design's estimate adds three MUFU lg2 per (t, k),
    # its own floor (design_mufu_ms), and the exact chains a few per token
    # (issue bound below)
    hash_ms = (HASH_INT_OPS * t * k
               / (sm_count * INT_PER_SM_PER_CLK * sm_clock_hz) * 1e3)
    mufu = 3 * t * k
    sfu_ms = mufu / (sm_count * SFU_PER_SM_PER_CLK * sm_clock_hz) * 1e3
    topics_per_pass = 4 if k % 4 == 0 else 1
    # the instantiation the launcher takes: the table in shared memory
    # unless the library asks for global scratch
    from repro_torch.kernels.zen_sampler import train_global_table_entries
    in_shared = train_global_table_entries(k, st.n_wk.device) == 0
    inst = f"ILi{topics_per_pass}ELb{int(in_shared)}EE"
    sass = {name: fast_loop_stats(kern + inst, topics_per_pass) for name,
            kern in (("zen_fused_sample", "zen_train_fused_kernel"),
                     ("zen_sample", "zen_train_gathered_kernel"))}
    exact_share = (forced + cands + fallback * k) / (t * k)

    def row(name, replaces, ms, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        loop = sass[name]
        issue_ms = None
        if loop and loop["exact_score_instructions"]:
            # warp instructions: the fast loop over every pass, one exact
            # chain per exactly scored topic (the candidates of a token
            # share one divergent pass, so this overcounts) and ceil(K/32)
            # per exact-loop token
            warp_instr = (t * -(-k // (32 * topics_per_pass))
                          * loop["fast_loop_instructions"]
                          + (forced + cands + fallback * -(-k // 32))
                          * loop["exact_score_instructions"])
            issue_ms = (warp_instr * 32 / (sm_count * INSTR_PER_SM_PER_CLK
                                           * sm_clock_hz) * 1e3)
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_train.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps, "tokens": t,
            "ms": ms, "plain_ms": ms_p,
            "bound_ms": max(bytes_ms, hash_ms),
            "bound_by": "bytes" if bytes_ms >= hash_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "hash_ms": hash_ms,
            "mufu_lg2": mufu, "design_mufu_ms": sfu_ms,
            "sass": loop, "exact_share": exact_share,
            "exact_work": {"forced": forced, "candidates": cands,
                           "exact_loop_tokens": fallback},
            "issue_bound_ms": issue_ms, "library_ms": None,
        }

    rows = [
        row("zen_fused_sample", "src/repro/kernels/fused_gather.py:46",
            ms_f, bytes_f),
        row("zen_sample", "src/repro/kernels/zen_sampler.py:105", ms_g,
            bytes_g),
    ]
    emit({"phase": "train_kernels", "W": W_NYT, "K": k, "T": t,
          "unique_words": uniq_w, "unique_docs": uniq_d,
          "fused_equals_gathered": True, "mismatches_vs_plain": len(gaps),
          "ms": {"fused": ms_f, "gathered": ms_g, "plain": ms_p},
          "sass": sass, "exact_share": exact_share,
          "exact_work": {"forced": forced, "candidates": cands,
                         "exact_loop_tokens": fallback}})
    del nwk_rows, nkd_rows
    torch.cuda.empty_cache()
    dev = st.n_wk.device
    grid = [adversarial_check(spec, dev) for spec in ADVERSARIAL]
    check(any(case["table"] == "global" for case in grid),
          "adversarial grid: no case put the table in global memory")
    emit({"phase": "train_kernels_adversarial", "cases": grid,
          "margin": margin_premises(dev),
          "placement_boundary": placement_boundary_ms(dev)})
    torch.cuda.empty_cache()
    return rows


def phase_train(sess, st, smi):
    """Five iterations of the full NYTIMES run, evaluated at init and
    after each step; returns the run's launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.checkpoint import load_lda_model

    corpus = sess.corpus
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    step_s, eval_s = [], []
    for _ in range(TRAIN_ITERS):
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train", "tokens": corpus.num_tokens,
          "docs": corpus.num_docs, "W": corpus.num_words, "K": K_NYT,
          "llh": llh, "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "eval_seconds": eval_s,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train: predictive llh did not rise at every eval: {llh}")
    check(all(0 < m["change_rate"] < 1 for m in evals[1:]),
          "train: change rate outside (0, 1)")
    # one fused sweep per step, and the delta merge's kernel 5 twice (word
    # and doc rows)
    check_launches("train", counts, {"zen_fused_sample": TRAIN_ITERS,
                                     "topic_histogram": 2 * TRAIN_ITERS})
    check_record("train", llh, [m["change_rate"] for m in evals[1:]])

    ckpt = ROOT / "build" / "chip_smoke_train_model"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    sess.save_model(st, str(ckpt))
    n_wk, n_k, hyper, meta, step = load_lda_model(str(ckpt))
    t_ckpt = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    check(step == TRAIN_ITERS and hyper == sess.hyper
          and meta["algorithm"] == "zen_pallas"
          and bool((torch.from_numpy(n_wk).to(st.n_wk.device)
                    == st.n_wk).all())
          and bool((torch.from_numpy(n_k).to(st.n_k.device)
                    == st.n_k).all()),
          "train: save_model then load_lda_model changed the model")
    emit({"phase": "train_checkpoint", "seconds": t_ckpt,
          "n_wk_bytes": int(n_wk.nbytes)})
    emit({"phase": "train_profile", **profile_step(sess, st)})
    return counts


def profile_step(sess, st):
    """Device busy share and time by kernel name over one more training
    step and its eval, from ``torch.profiler``; run after the main path's
    counts were read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("step", lambda: sess.step(st)),
                     ("eval", lambda: sess.metrics(st))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        out[name] = device_summary(prof, wall_us,
                                   groups={"delta_merge": HIST_KERNELS})
    fused = [v for k, v in out["step"]["top_device_ms"].items()
             if "zen_train_fused_kernel" in k]
    out["kernel_ms_per_launch"] = fused[0][0] / fused[0][1] if fused \
        else None
    return out


def device_summary(prof, wall_us: float, items: int = 8, groups=None):
    """Device busy time, idle share and the largest device items of one
    profiled window; ``groups`` (name -> kernel function names) sums each
    group's [ms, launches]. Only events that ran on the card count: an
    operator's host-side entry also carries its kernels' device time, and
    counting both would count that time twice."""
    from torch.autograd import DeviceType

    by_name, calls = {}, {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us
            calls[ev.key] = calls.get(ev.key, 0) + ev.count
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:items]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "host_ms": (wall_us - busy_us) / 1e3,
           "device_idle_share": (1 - busy_us / wall_us) if busy_us
           else None,
           "top_device_ms": {k[:80]: [v / 1e3, calls[k]] for k, v in top}}
    if groups:
        out["groups_ms"] = {}
        for name, fns in groups.items():
            keys = [k for k in by_name
                    if any(f"::{f}(" in k for f in fns)]
            out["groups_ms"][name] = [sum(by_name[k] for k in keys) / 1e3,
                                      sum(calls[k] for k in keys)]
    return out


def phase_train_small(seed: int, dev, smi):
    """zen, zen_pallas fused and zen_pallas gathered from the same initial
    topics; returns the gathered run's launch count. Under "auto" each
    step's delta merge also launches kernel 5 twice."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_nytimes(SMALL_DOCS)
    hyper = LDAHyperParams(num_topics=K_NYT)
    runs = (("zen", "zen", "auto", None),
            ("std", "std", "auto", None),
            ("fused", "zen_pallas", "auto", "zen_fused_sample"),
            ("gathered", "zen_pallas", "off", "zen_sample"))
    topics, llh, counts_by = {}, {}, {}
    for name, algorithm, kernels, kernel in runs:
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm=algorithm, kernels=kernels), device=dev)
        st = sess.init(seed)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        topics[name] = []
        for _ in range(SMALL_ITERS):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
            topics[name].append(st.topic.clone())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        counts_by[name] = counts
        llh[name] = sess.llh(st) / corpus.num_tokens
        emit({"phase": "train_small", "run": name, "algorithm": algorithm,
              "kernels": kernels, "tokens": corpus.num_tokens,
              "seconds": secs, "llh_per_token": llh[name],
              "launches": counts, "card": smi})
        want = {} if kernel is None else {kernel: counts[kernel] or -1}
        if kernels == "auto":
            want["topic_histogram"] = 2 * SMALL_ITERS
        check_launches(f"train_small {name}", counts, want)
        del sess, st
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(topics["fused"],
                                                 topics["gathered"]))
    check(same, "train_small: fused and gathered runs drew different "
          "topics")
    check(llh["fused"] == TRAIN_SMALL_LLH,
          f"train_small: llh/token {llh['fused']} differs from the record "
          f"{TRAIN_SMALL_LLH}")
    rel = abs(llh["zen"] / llh["fused"] - 1)
    rel_std = abs(llh["std"] / llh["zen"] - 1)
    emit({"phase": "train_small_check", "fused_equals_gathered": True,
          "zen_vs_fused_llh_rel": rel, "std_vs_zen_llh_rel": rel_std})
    check(rel < 0.01, f"train_small: zen llh/token {llh['zen']} vs fused "
          f"{llh['fused']} differ by {rel:.4f} (>= 1%)")
    check(rel_std < 0.01, f"train_small: std llh/token {llh['std']} vs zen "
          f"{llh['zen']} differ by {rel_std:.4f} (>= 1%)")
    return counts_by["gathered"]["zen_sample"]


def run_training(seed: int, dev, props, smi, sm_clock_hz: float):
    """The training phases, dense, padded-sparse and CDF; returns the five
    training-side kernels' rows and their launches on their paths."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.train.session import RunConfig, TrainSession

    t0 = time.perf_counter()
    corpus = synthetic_nytimes(D_NYT)
    t_corpus = time.perf_counter() - t0
    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(algorithm="zen_pallas"),
                        device=dev)
    del corpus
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    emit({"phase": "train_setup", "tokens": sess.corpus.num_tokens,
          "corpus_seconds": t_corpus,
          "init_seconds": time.perf_counter() - t0})
    rows = phase_train_kernels(sess, st, seed, props.multi_processor_count,
                               sm_clock_hz)
    train_counts = phase_train(sess, st, smi)
    corpus_dev = sess.corpus
    del sess, st
    torch.cuda.empty_cache()
    gathered_launches = phase_train_small(seed, dev, smi)
    sparse_counts, sparse_row = phase_train_sparse(corpus_dev, seed, smi)
    torch.cuda.empty_cache()
    cdf_rows, cdf_counts = phase_train_cdf(
        corpus_dev, seed, smi, props.multi_processor_count, sm_clock_hz)
    del corpus_dev
    torch.cuda.empty_cache()
    phase_train_sparse_small(seed, dev, smi)
    # kernel 5's launches on the delta merge of each full-width path
    merge = {"train": train_counts["topic_histogram"],
             "train_sparse": sparse_counts["topic_histogram"],
             "train_cdf": cdf_counts["topic_histogram"]}
    for row in cdf_rows:
        if row["name"] == "topic_histogram":
            row["launches_by_path"] = merge
    return rows + [sparse_row] + cdf_rows, {
        "zen_fused_sample": train_counts["zen_fused_sample"],
        "zen_sample": gathered_launches,
        "sparse_row_sample": sparse_counts["sparse_row_sample"],
        "cdf_row_search": cdf_counts["cdf_row_search"],
        "topic_histogram": train_counts["topic_histogram"]}


def phase_train_sparse(corpus, seed: int, smi):
    """``zen_sparse`` at full NYTIMES width from the sparse word init;
    returns the run's launch counts and the sparse-row kernel's row of the
    kernels table (from :func:`phase_sparse_kernels`)."""
    import torch

    from repro_torch import algorithms
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.core.zen_sparse import build_tables
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_sparse", init="sparse_word"), device=corpus.word.device)
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    knobs = sess.cfg.knobs()

    def tables_seconds(state, pads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab = build_tables(state.n_wk, state.n_kd, state.n_k, sess.hyper,
                           sess.corpus.num_words, pads.max_kw, pads.max_kd)
        torch.cuda.synchronize()
        del tab
        return time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    pads_by_sweep, step_s, table_s, eval_s = [], [], [], []
    for _ in range(SPARSE_ITERS):
        pads = algorithms.resolve_row_pads(st, knobs)
        pads_by_sweep.append([pads.max_kw, pads.max_kd])
        table_s.append(tables_seconds(st, pads))
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(sess.corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train_sparse", "algorithm": "zen_sparse",
          "init": "sparse_word", "tokens": sess.corpus.num_tokens,
          "W": sess.corpus.num_words, "K": K_NYT, "init_seconds": t_init,
          "row_pads_by_sweep": pads_by_sweep, "llh": llh,
          "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "table_build_seconds": table_s,
          "eval_seconds": eval_s, "peak_device_gb": peak_gb,
          "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train_sparse: predictive llh did not rise at every eval: {llh}")
    check(counts["sparse_row_sample"] > 0,
          f"train_sparse: no sparse-row launch: {counts}")
    check_launches("train_sparse", counts, {
        "sparse_row_sample": counts["sparse_row_sample"],
        "topic_histogram": 2 * SPARSE_ITERS})
    check_record("train_sparse", llh, [m["change_rate"] for m in evals[1:]])
    emit({"phase": "train_sparse_profile",
          **profile_path_step(sess, st, ("sparse_row_kernel",))})
    row = phase_sparse_kernels(sess, st, seed)
    return counts, row


def profile_path_step(sess, st, kernels):
    """Device busy share and the largest device items of one more training
    step, after the path's counts were read; ``groups_ms`` holds the path's
    kernel (``kernels``: its device functions) and the delta merge's
    kernel 5, each [ms, launches]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.step(st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_summary(prof, wall_us, items=12, groups={
        "path_kernel": kernels, "delta_merge": HIST_KERNELS})


def phase_sparse_kernels(sess, st, seed: int):
    """Kernel 6 against its plain version on the first KERNEL_TOKENS
    tokens of the full-width zen_sparse state, on the term-3 rows and on
    SparseLDA's q rows; returns the kernel's row of the kernels table."""
    import torch

    from repro_torch import algorithms
    from repro_torch.core.baselines import sparselda_rows, sparselda_tables
    from repro_torch.core.zen_sparse import _d_sparse, build_tables
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_row import sparse_row_sample_plain

    c, h = sess.corpus, sess.hyper
    t = KERNEL_TOKENS
    pads = algorithms.resolve_row_pads(st, sess.cfg.knobs())
    args = (st.n_wk, st.n_kd, st.n_k, h, c.num_words, pads.max_kw,
            pads.max_kd)
    word, doc, z = c.word[:t], c.doc[:t], st.topic[:t]
    gen = torch.Generator(device=word.device).manual_seed(seed)
    shapes = {}
    tab = build_tables(*args)
    d_vals, d_topics = _d_sparse(tab, word, doc, h.beta)
    del tab
    shapes["term3"] = (d_vals, d_topics)
    sl = sparselda_tables(*args)
    _, _, q_vals, wk_idx = sparselda_rows(sl, word, doc, z)
    del sl
    shapes["sparselda_q"] = (q_vals, wk_idx)
    torch.cuda.empty_cache()
    runs = {}
    for name, (vals, topics) in shapes.items():
        mass = vals.sum(1)
        tgt = torch.rand(t, generator=gen, device=word.device) * mass
        tgt[:64] = mass[:64]  # a few targets on the row's mass
        tgt[64:128] = 0.0

        def kernel():
            return ops.sparse_row_sample(vals, topics, tgt)

        def plain():
            return sparse_row_sample_plain(vals, topics, tgt)

        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        mism = int((out_k != out_p).sum())
        err = float((out_k.long() - out_p.long()).abs().max())
        check(mism == 0, f"sparse_kernels {name}: {mism} kernel-vs-plain "
              f"mismatches over {t} tokens")
        ms_k = cuda_ms(kernel, reps=10)
        ms_p = cuda_ms(plain, reps=2, warmup=1)
        j = vals.shape[1]
        # the function must read every weight (it counts over all J
        # lanes), one target and one topic id per row, and write one
        # topic; whole topic rows (T J 8 + T 8 bytes) it never needs
        nbytes = t * j * 4 + t * 12
        runs[name] = {"J": j, "ms": ms_k, "plain_ms": ms_p,
                      "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bytes_with_topic_rows": t * j * 8 + t * 8,
                      "mismatches": mism, "max_abs_err": err}
        emit({"phase": "sparse_kernels", "rows": name, "T": t, **runs[name]})
    del shapes, d_vals, d_topics, q_vals, wk_idx
    torch.cuda.empty_cache()
    main = runs["term3"]
    return {
        "name": "sparse_row_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_row.cu",
        "replaces": "src/repro/kernels/sparse_row.py:34", "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bytes": main["bytes"], "J": main["J"], "shapes": runs,
        "res_usage": res_usage("sparse_row.cu", "sparse_row_kernel"),
        "library_ms": None,
    }


def phase_train_cdf(corpus, seed: int, smi, sm_count: int,
                    sm_clock_hz: float):
    """``zen_cdf`` at full NYTIMES width from a random init; then kernel 5
    on its last step and kernel 7 on its state. Returns the two kernels'
    rows of the kernels table and the run's launch counts."""
    import torch

    from repro_torch.algorithms.zen_cdf import CDF_CHUNK_ELEMS
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    hyper = LDAHyperParams(num_topics=K_NYT)
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_cdf", max_kd=CDF_MAX_KD), device=corpus.word.device)
    t0 = time.perf_counter()
    st = sess.init(seed)
    st.check_invariants(sess.corpus)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tokens = sess.corpus.num_tokens
    chunk = CDF_CHUNK_ELEMS // CDF_MAX_KD
    chunks = -(-tokens // chunk)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    evals = [sess.metrics(st)]
    step_s, eval_s = [], []
    for _ in range(CDF_ITERS):
        prev = st
        t0 = time.perf_counter()
        st = sess.step(st)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        st.check_invariants(sess.corpus)
        t0 = time.perf_counter()
        evals.append(sess.metrics(st))
        eval_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    llh = [m["llh"] for m in evals]
    emit({"phase": "train_cdf", "algorithm": "zen_cdf", "init": "random",
          "max_kd": CDF_MAX_KD, "tokens": tokens,
          "W": sess.corpus.num_words, "K": K_NYT, "init_seconds": t_init,
          "token_chunk": chunk, "chunks_per_sweep": chunks, "llh": llh,
          "perplexity": [m["perplexity"] for m in evals],
          "change_rate": [m["change_rate"] for m in evals[1:]],
          "step_seconds": step_s, "eval_seconds": eval_s,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(all(b > a for a, b in zip(llh, llh[1:])),
          f"train_cdf: predictive llh did not rise at every eval: {llh}")
    # two CDF searches per token chunk, two histograms per step
    check_launches("train_cdf", counts, {
        "cdf_row_search": 2 * chunks * CDF_ITERS,
        "topic_histogram": 2 * CDF_ITERS})
    check_record("train_cdf", llh, [m["change_rate"] for m in evals[1:]])
    emit({"phase": "train_cdf_profile",
          **profile_path_step(sess, st, CDF_KERNELS)})
    hist_row = phase_histogram(sess, prev, st)
    del prev
    torch.cuda.empty_cache()
    cdf_row = phase_cdf_kernels(sess, st, seed, sm_count, sm_clock_hz)
    return [cdf_row, hist_row], counts


def phase_histogram(sess, prev, st):
    """Kernel 5 on one full-width step (``prev`` -> ``st``) as the delta
    merge runs it: doc rows in corpus order and word rows along the plan's
    word-major walk, every token weighted once. Each side is bit-equal to
    the plain version, and ``delta_counts`` on the kernel route to
    ``delta_counts`` under ``kernels="off"`` (the plain version), so the
    check is not circular. CUDA-event times of both routes and the bytes
    bound. Returns the kernel's row of the kernels table."""
    import torch

    from repro_torch.core.counts import delta_counts
    from repro_torch.kernels import ops
    from repro_torch.kernels.topic_histogram import topic_histogram_plain

    c, k = sess.corpus, K_NYT
    t = c.num_tokens
    zo, zn = prev.topic, st.topic
    orders = sess.plan.row_orders()
    check(orders[1].order is None,
          "histogram: the corpus tokens are not in doc order")
    args = (c.word, c.doc, zo, zn, c.num_words, c.num_docs, k)

    def merge(use_kernel):
        return delta_counts(*args, use_kernel=use_kernel,
                            orders=orders if use_kernel else None)

    on, off = merge(True), merge(False)
    check(all(bool(torch.equal(a, b)) for a, b in zip(on, off)),
          "histogram: delta_counts on kernel 5 differs from kernels=off")
    del on, off
    torch.cuda.empty_cache()
    merge_ms = cuda_ms(lambda: merge(True), reps=5, gate=True)
    merge_off_ms = cuda_ms(lambda: merge(False), reps=3, warmup=1)
    emit({"phase": "histogram_merge", "T": t, "K": k,
          "equals_kernels_off": True, "delta_counts_ms": merge_ms,
          "delta_counts_off_ms": merge_off_ms})
    sides = {"doc": (c.doc, c.num_docs, orders[1]),
             "word": (c.word, c.num_words, orders[0])}
    runs = {}
    for name, (rows, r, order) in sides.items():
        def kernel(order=order):
            return ops.topic_histogram(rows, zo, zn, None, r, k, order=order)

        def plain():
            return topic_histogram_plain(rows, zo, zn, None, r, k)

        diff = kernel() - plain()
        mism, err = int((diff != 0).sum()), float(diff.abs().max())
        check(mism == 0, f"histogram {name}: {mism} kernel-vs-plain "
              f"mismatches over ({r}, {k})")
        del diff
        torch.cuda.empty_cache()
        ms_k = cuda_ms(kernel, reps=5, gate=True)
        ms_p = cuda_ms(plain, reps=3, warmup=1)
        # the (R, K) output written once, three int32 ids per token read
        # once (the walk is the design's own)
        nbytes = r * k * 4 + t * 12
        runs[name] = {"R": r, "ms": ms_k, "plain_ms": ms_p,
                      "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "walk": "tokens" if order.order is None
                      else "word-major permutation",
                      "mismatches": mism, "max_abs_err": err}
        emit({"phase": "histogram", "rows": name, "T": t, "K": k,
              "changed_tokens": int((zn != zo).sum()), "equals_plain": True,
              **runs[name]})
    torch.cuda.empty_cache()
    main = runs["doc"]
    return {
        "name": "topic_histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topic_histogram.cu",
        "replaces": "src/repro/kernels/topic_histogram.py:31",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bytes": main["bytes"], "R": main["R"], "shapes": runs,
        "delta_counts_ms": merge_ms, "delta_counts_off_ms": merge_off_ms,
        "sass": sass_loop_stats("hist_sorted_kernel", "topic_histogram.cu",
                                holding="ATOMS"),
        "res_usage": {f: res_usage("topic_histogram.cu", f)
                      for f in HIST_KERNELS},
        # two accumulating index_put_ calls (the plain version itself)
        "library_ms": main["plain_ms"],
    }


def phase_cdf_kernels(sess, st, seed: int, sm_count: int,
                      sm_clock_hz: float):
    """Kernel 7 against its plain version on the first KERNEL_TOKENS tokens
    of the full-width zen_cdf state: on the path's term-2 targets of draw a
    (tokens whose draw takes another term search target 0) and on targets
    uniform over each word's row; times beside the ``kernels="off"`` route
    and the bounds. Returns the kernel's row of the kernels table."""
    import torch

    from repro_torch.algorithms import zen_cdf as zc
    from repro_torch.core.keys import fold_in, key_seed, stream_uniforms
    from repro_torch.kernels import ops
    from repro_torch.kernels.cdf_search import cdf_row_search_plain

    c, h = sess.corpus, sess.hyper
    t, k = KERNEL_TOKENS, K_NYT
    word, doc = c.word[:t], c.doc[:t]
    tab = zc.build_cdf_tables(st.n_wk, st.n_kd, st.n_k, h, c.num_words,
                              CDF_MAX_KD, use_kernel=True)
    _, d_cdf = zc.doc_rows(tab, word, doc, st.n_wk, h)
    m1 = tab.g_cdf[-1]
    m12 = m1 + tab.m2_all[word.long()]
    sweep_seed = key_seed(fold_in(st.rng, st.iteration))
    u = stream_uniforms(sweep_seed, 0, t, zc.CDF_STREAMS,
                        device=word.device)[0] * (m12 + d_cdf[:, -1])
    del d_cdf
    term1 = (u >= m1) & (u < m12)
    gen = torch.Generator(device=word.device).manual_seed(seed)
    targets = {
        "path": torch.where(term1, torch.clamp_min(u - m1, 0.0), 0.0),
        "uniform": torch.rand(t, generator=gen, device=word.device)
        * (m12 - m1),
    }
    term = tab.terms.t4
    w_cdf = torch.cumsum(st.n_wk.to(torch.float32) * term[None, :], dim=-1)
    w_cdf_ms = cuda_ms(lambda: torch.cumsum(
        st.n_wk.to(torch.float32) * term[None, :], dim=-1), reps=3)
    # the walk's strip loop: CDF_STRIPS strips per pass, unrolled
    loop = sass_loop_stats("cdf_walk_kernel", "cdf_search.cu",
                           holding="SHFL.UP")
    issue_rate = sm_count * INSTR_PER_SM_PER_CLK * sm_clock_hz
    runs = {}
    for name, tgt in targets.items():
        def kernel():
            return ops.cdf_row_search(st.n_wk, word, term, tgt)

        def plain():
            return cdf_row_search_plain(st.n_wk, word, term, tgt)

        def off():
            return zc._bsearch_gather(w_cdf, word, tgt)

        out_k, out_p, out_o = kernel(), plain(), off()
        torch.cuda.synchronize()
        mism = int((out_k != out_p).sum())
        err = float((out_k.long() - out_p.long()).abs().max())
        check(mism == 0, f"cdf_kernels {name}: {mism} kernel-vs-plain "
              f"mismatches over {t} tokens")
        ms_k = cuda_ms(kernel, reps=10, gate=True)
        ms_host = cuda_ms(kernel, reps=10)  # at the host's launch pace
        ms_p = cuda_ms(plain, reps=2, warmup=1)
        ms_o = cuda_ms(off, reps=10)
        # what this data needs: a token with target <= 0 reads nothing; the
        # others the row's counts up to the answer (all K when clamped)
        live = tgt > 0
        need = torch.where(live, out_k.long() + 1, 0)
        row_need = torch.zeros(st.n_wk.shape[0], dtype=torch.int64,
                               device=word.device).scatter_reduce_(
            0, word.long(), need, reduce="amax")
        nbytes = int(row_need.sum()) * 4 + k * 4 + t * 12
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # a multiply, an add and a compare per needed element, float32
        flops = 3 * int(need.sum())
        flops_ms = flops / FP32_FLOPS * 1e3
        strips = int(torch.where(live, out_k.long() // 32 + 1, 0).sum())
        issue_ms = (strips * 32 * loop["loop_instructions"] / CDF_STRIPS
                    / issue_rate * 1e3 if loop else None)
        runs[name] = {
            "ms": ms_k, "ms_host_paced": ms_host, "plain_ms": ms_p,
            "off_route_search_ms": ms_o,
            "off_route_matches": float((out_o == out_k).float().mean()),
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "bytes_no_reuse": int(need.sum()) * 4 + k * 4 + t * 12,
            # whole rows of the distinct words, as if no walk stopped early
            "bytes_whole_rows": int(torch.unique(word).numel()) * k * 4
            + k * 4 + t * 12,
            "flops": flops, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "strips_walked": strips, "issue_bound_ms": issue_ms,
            "searching_tokens": int(live.sum()), "mismatches": mism,
            "max_abs_err": err,
        }
        emit({"phase": "cdf_kernels", "targets": name, "T": t, "K": k,
              "w_cdf_build_ms": w_cdf_ms, "sass": loop, **runs[name]})
    del w_cdf, tab, targets
    torch.cuda.empty_cache()
    main = runs["path"]
    return {
        "name": "cdf_row_search", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cdf_search.cu",
        "replaces": "src/repro/kernels/cdf_search.py:36", "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bytes": main["bytes"], "issue_bound_ms": main["issue_bound_ms"],
        "off_route_ms": main["off_route_search_ms"],
        "w_cdf_build_ms": w_cdf_ms, "shapes": runs, "sass": loop,
        "res_usage": {f: res_usage("cdf_search.cu", f)
                      for f in CDF_KERNELS},
        # no one PyTorch call computes it
        "library_ms": None,
    }


def phase_train_sparse_small(seed: int, dev, smi):
    """The padded-sparse backends, ``zen_cdf`` on and off its kernel and
    the dense ``zen`` from one set of initial topics on the train_small
    corpus."""
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    corpus = synthetic_nytimes(SMALL_DOCS)
    hyper = LDAHyperParams(num_topics=K_NYT)
    # (run, algorithm, kernels policy, the one kernel it launches)
    sparse = "sparse_row_sample"
    runs = (("zen", "zen", "auto", None),
            ("zen_sparse", "zen_sparse", "auto", sparse),
            ("sparselda", "sparselda", "auto", sparse),
            ("zen_hybrid", "zen_hybrid", "auto", sparse),
            ("lightlda", "lightlda", "auto", sparse),
            ("lightlda_off", "lightlda", "off", None),
            ("zen_cdf", "zen_cdf", "auto", "cdf_row_search"),
            ("zen_cdf_off", "zen_cdf", "off", None))
    init_topics, llh = None, {}
    for name, algorithm, kernels, kernel in runs:
        sess = TrainSession(corpus, hyper, RunConfig(
            algorithm=algorithm, kernels=kernels), device=dev)
        if init_topics is None:
            init_topics = sess.init(seed).topic.cpu().numpy()
        st = sess.init(seed, init_topics=init_topics)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(SMALL_ITERS):
            st = sess.step(st)
            st.check_invariants(sess.corpus)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        llh[name] = sess.llh(st) / corpus.num_tokens
        emit({"phase": "train_sparse_small", "run": name,
              "algorithm": algorithm, "kernels": kernels,
              "tokens": corpus.num_tokens, "seconds": secs,
              "llh_per_token": llh[name], "launches": counts, "card": smi})
        want = {} if kernel is None else {kernel: counts[kernel] or -1}
        if kernels == "auto":
            want["topic_histogram"] = 2 * SMALL_ITERS
        check_launches(f"train_sparse_small {name}", counts, want)
        del sess, st
        torch.cuda.empty_cache()
    rel = {n: abs(v / llh["zen"] - 1) for n, v in llh.items()}
    emit({"phase": "train_sparse_small_check", "llh_rel_to_zen": rel})
    bad = {n: r for n, r in rel.items() if r >= SPARSE_LLH_BAND}
    check(not bad, f"train_sparse_small: llh/token off zen's by >= "
          f"{SPARSE_LLH_BAND:.0%}: {bad} ({llh})")


def profile_serving(model, cfg, docs, seed: int):
    """Device busy share and time by kernel name over one serving window
    (after warm-up), from ``torch.profiler``; run after the main path's
    counts were read, so its launches are not counted there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=seed)
    engine.warm()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer_batch(docs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return device_summary(prof, wall_us)


def serve_cpu(model, cfg, docs):
    """The finished requests of ``docs`` served caller-driven."""
    from repro_torch.serving import LDAEngine

    engine = LDAEngine(model, cfg, seed=0)
    uids = [engine.submit(d) for d in docs]
    done = {r.uid: r for r in engine.run_until_done()}
    return [done[u] for u in uids]


if __name__ == "__main__":
    sys.exit(main())
