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
   8.4 GB): fused bit-equal to gathered, each against its plain version
   with mismatches only at near-ties on at most 1e-4 of tokens; CUDA-event
   times, the bytes, the logf and the instruction counts per (t, k) read
   from ``cuobjdump -sass``, and the bounds;
6. train   — ``TrainSession`` with ``zen_pallas`` (``kernels="auto"``) on
   the corpus ``launch.train --topics 1000 --synthetic-docs 299752
   --synthetic-words 101636 --synthetic-len 332`` builds (~99.5M tokens):
   random init, 5 iterations with an eval at init and after each one;
   count invariants after every step, predictive llh rising at every eval,
   change rate in (0, 1), exactly 5 fused launches and no gathered one,
   then ``save_model`` read back bit-equal; one more step profiled;
7. train_small — the same recipe at 4,096 documents (~1.36M tokens) and
   the same initial topics, 3 iterations of ``zen`` (plain torch, cdf),
   ``std``, ``zen_pallas`` fused and ``zen_pallas`` gathered
   (``kernels="off"``): fused and gathered topics bit-identical after every
   iteration, each run launching only its own kernel (``zen`` and ``std``
   none), ``zen``'s per-token llh within 1% of the fused run's and
   ``std``'s within 1% of ``zen``'s;
8. train_sparse — this slice's path at full width: ``TrainSession`` with
   ``zen_sparse`` and the paper's sparse word initialisation (degree 0.1)
   on the same NYTIMES corpus: 3 iterations, an eval at init and after
   each; count invariants after every step, llh rising at every eval, and
   launches of the sparse-row kernel only (> 0). Reports the row widths of
   every sweep, seconds per step and the table build within it (timed
   apart on the same state), peak memory, and one more step profiled;
9. sparse_kernels — kernel 6 against its plain version on the first
   1,048,576 tokens of that state, on the term-3 rows (J = max_kd) and on
   SparseLDA's q rows (J = max_kw): topics equal with 0 mismatches, CUDA-
   event times and the bytes bound;
10. train_cdf — ``TrainSession`` with ``zen_cdf`` (``kernels="auto"``,
   max_kd 64) on the same NYTIMES corpus from a random init: 3 iterations,
   an eval at init and after each; count invariants after every step, llh
   rising at every eval, and launches of the CDF row search (kernel 7)
   only, two per token chunk. Reports seconds per step, peak memory and
   one more step profiled;
11. histogram — kernel 5 on that run's last step (inc = z_new != z_old):
   doc rows in the corpus order (checked sorted), R = 299,752, and word
   rows after a stable sort by word, R = 101,636. Both launches are the
   phase's path; each result is bit-equal to the plain version and to
   ``delta_counts``' d_kd / d_wk of the same step; CUDA-event times and
   the bytes bound;
12. cdf_kernels — kernel 7 on the first 1,048,576 tokens of the zen_cdf
   state, on the path's term-2 targets of draw a and on targets uniform
   over each word's row: bit-equal to its plain version (0 mismatches),
   CUDA-event times of the kernel, the plain version and the
   ``kernels="off"`` route (the ``w_cdf`` build and its ``log K`` search),
   the bytes, operation and instruction-issue bounds;
13. train_sparse_small — the train_small corpus and one set of initial
   topics, 3 iterations each of ``zen_sparse``, ``sparselda``,
   ``zen_hybrid``, ``lightlda`` (kernel) and ``lightlda`` with
   ``kernels="off"`` (per-word alias tables), ``zen_cdf`` (kernel 7) and
   ``zen_cdf`` with ``kernels="off"``, and ``zen``: invariants after every
   step, each run's per-token llh within 8% of ``zen``'s, every run
   launching only its own kernel (``lightlda`` off, ``zen_cdf`` off and
   ``zen`` none).

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
NEAR_TIE = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def sass_loop_stats(kernel: str, source: str = "zen_train.cu"):
    """Instructions in the K loop of ``kernel`` (one (t, k) per lane per
    pass: the loop is kept rolled), from ``cuobjdump -sass`` of the library
    built from ``source``: the span of the function's widest backward
    branch. None when the tool or the pattern is missing."""
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
    best = None
    for addr, text in instr:
        if "BRA" not in text.split():
            continue
        m = re.search(r"\(\s*(\.L_x_\d+)\s*\)|BRA\s+(0x[0-9a-f]+)", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2),
                                                               16)
        if target is not None and target < addr and (
                best is None or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        return None
    loop = [t for a, t in instr if best[0] <= a <= best[1]]
    return {"loop_instructions": len(loop),
            "loop_mufu": sum("MUFU" in t for t in loop),
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

    ms_f = cuda_ms(fused, reps=5, warmup=1)
    ms_g = cuda_ms(gathered, reps=5, warmup=1)
    ms_p = cuda_ms(plain, reps=2, warmup=0)

    uniq_w = int(torch.unique(word).numel())
    uniq_d = int(torch.unique(doc).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    bytes_f = (uniq_w + uniq_d) * k * 4 + vec + t * 3 * 4 + t * 4
    bytes_g = 2 * t * k * 4 + vec + t * 4 + t * 4
    logf = 3 * t * k
    sfu_ms = logf / (sm_count * SFU_PER_SM_PER_CLK * sm_clock_hz) * 1e3
    sass = {name: sass_loop_stats(kern) for name, kern in (
        ("zen_fused_sample", "zen_train_fused_kernel"),
        ("zen_sample", "zen_train_gathered_kernel"))}

    def row(name, replaces, ms, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        loop = sass[name]
        issue_ms = (t * k * loop["loop_instructions"]
                    / (sm_count * INSTR_PER_SM_PER_CLK * sm_clock_hz) * 1e3
                    if loop else None)
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_train.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps, "tokens": t,
            "ms": ms, "plain_ms": ms_p,
            "bound_ms": max(bytes_ms, sfu_ms),
            "bound_by": "bytes" if bytes_ms >= sfu_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "logf": logf, "logf_ms": sfu_ms, "sass": loop,
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
          "sass": sass})
    del nwk_rows, nkd_rows
    torch.cuda.empty_cache()
    return rows


def phase_train(sess, st, smi):
    """Five iterations of the full NYTIMES run, evaluated at init and
    after each step; returns the fused-kernel launch count."""
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
    check(counts["zen_fused_sample"] == TRAIN_ITERS
          and all(v == 0 for n, v in counts.items()
                  if n != "zen_fused_sample"),
          f"train: expected {TRAIN_ITERS} fused launches only, got {counts}")

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
    return counts["zen_fused_sample"]


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
        out[name] = device_summary(prof, wall_us)
    fused = [v for k, v in out["step"]["top_device_ms"].items()
             if "zen_train_fused_kernel" in k]
    out["kernel_ms_per_launch"] = fused[0][0] / fused[0][1] if fused \
        else None
    return out


def device_summary(prof, wall_us: float, items: int = 8):
    """Device busy time, idle share and the largest device items of one
    profiled window. Only events that ran on the card count: an operator's
    host-side entry also carries its kernels' device time, and counting
    both would count that time twice."""
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
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "host_ms": (wall_us - busy_us) / 1e3,
            "device_idle_share": (1 - busy_us / wall_us) if busy_us
            else None,
            "top_device_ms": {k[:80]: [v / 1e3, calls[k]] for k, v in top}}


def phase_train_small(seed: int, dev, smi):
    """zen, zen_pallas fused and zen_pallas gathered from the same initial
    topics; returns the gathered run's launch count."""
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
        check(all((v > 0) == (n == kernel) for n, v in counts.items()),
              f"train_small {name}: expected launches of {kernel} only, "
              f"got {counts}")
        del sess, st
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(topics["fused"],
                                                 topics["gathered"]))
    check(same, "train_small: fused and gathered runs drew different "
          "topics")
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
    fused_launches = phase_train(sess, st, smi)
    corpus_dev = sess.corpus
    del sess, st
    torch.cuda.empty_cache()
    gathered_launches = phase_train_small(seed, dev, smi)
    sparse_launches, sparse_row = phase_train_sparse(corpus_dev, seed, smi)
    torch.cuda.empty_cache()
    cdf_rows, cdf_launches = phase_train_cdf(
        corpus_dev, seed, smi, props.multi_processor_count, sm_clock_hz)
    del corpus_dev
    torch.cuda.empty_cache()
    phase_train_sparse_small(seed, dev, smi)
    return rows + [sparse_row] + cdf_rows, {
        "zen_fused_sample": fused_launches, "zen_sample": gathered_launches,
        "sparse_row_sample": sparse_launches, **cdf_launches}


def phase_train_sparse(corpus, seed: int, smi):
    """``zen_sparse`` at full NYTIMES width from the sparse word init;
    returns the sparse-row kernel's launches on this path and its row of
    the kernels table (from :func:`phase_sparse_kernels`)."""
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
    check(counts["sparse_row_sample"] > 0
          and all(v == 0 for n, v in counts.items()
                  if n != "sparse_row_sample"),
          f"train_sparse: expected sparse-row launches only, got {counts}")
    emit({"phase": "train_sparse_profile",
          **profile_path_step(sess, st, "sparse_row_kernel")})
    row = phase_sparse_kernels(sess, st, seed)
    return counts["sparse_row_sample"], row


def profile_path_step(sess, st, kernel: str):
    """Device busy share and the largest device items of one more training
    step, after the path's counts were read; ``kernel_ms`` is the named
    kernel's [ms, launches]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.step(st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_summary(prof, wall_us, items=12)
    kern = [v for k, v in out["top_device_ms"].items() if kernel in k]
    out["kernel_ms"] = kern[0] if kern else None
    return out


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
    rows of the kernels table and their launches on their paths."""
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
    want = 2 * chunks * CDF_ITERS
    check(counts["cdf_row_search"] == want
          and all(v == 0 for n, v in counts.items()
                  if n != "cdf_row_search"),
          f"train_cdf: expected {want} CDF-search launches (two per token "
          f"chunk) only, got {counts}")
    emit({"phase": "train_cdf_profile",
          **profile_path_step(sess, st, "cdf_search_kernel")})
    hist_row, hist_launches = phase_histogram(sess, prev, st)
    del prev
    torch.cuda.empty_cache()
    cdf_row = phase_cdf_kernels(sess, st, seed, sm_count, sm_clock_hz)
    return [cdf_row, hist_row], {"cdf_row_search": counts["cdf_row_search"],
                                 "topic_histogram": hist_launches}


def phase_histogram(sess, prev, st):
    """Kernel 5 on one full-width step (``prev`` -> ``st``): doc rows in
    corpus order and word rows after a stable sort by word, each equal to
    its plain version and to ``delta_counts``; returns (the kernel's row of
    the kernels table, its launches on this path)."""
    import torch

    from repro_torch.core.counts import delta_counts
    from repro_torch.kernels import ops
    from repro_torch.kernels.topic_histogram import topic_histogram_plain

    c, k = sess.corpus, K_NYT
    t = c.num_tokens
    zo, zn = prev.topic, st.topic
    inc = (zn != zo).to(torch.int32)
    check(bool((c.doc[1:] >= c.doc[:-1]).all()),
          "histogram: the corpus tokens are not in doc order")
    order = torch.sort(c.word, stable=True).indices
    sides = {
        "doc": (c.doc, zo, zn, inc, c.num_docs),
        "word": (c.word[order], zo[order], zn[order], inc[order],
                 c.num_words),
    }
    del order
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = {name: ops.topic_histogram(*a[:4], a[4], k)
            for name, a in sides.items()}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["topic_histogram"] == 2
          and all(v == 0 for n, v in counts.items()
                  if n != "topic_histogram"),
          f"histogram: expected 2 histogram launches only, got {counts}")
    d_wk, d_kd, _ = delta_counts(c.word, c.doc, zo, zn, c.num_words,
                                 c.num_docs, k)
    check(bool(torch.equal(outs["doc"], d_kd)),
          "histogram: doc side differs from delta_counts' d_kd")
    check(bool(torch.equal(outs["word"], d_wk)),
          "histogram: word side differs from delta_counts' d_wk")
    del d_wk, d_kd
    runs = {}
    for name, a in sides.items():
        diff = outs[name] - topic_histogram_plain(*a[:4], a[4], k)
        mism, err = int((diff != 0).sum()), float(diff.abs().max())
        check(mism == 0, f"histogram {name}: {mism} kernel-vs-plain "
              f"mismatches over ({a[4]}, {k})")
        del diff
        torch.cuda.empty_cache()
        ms_k = cuda_ms(lambda: ops.topic_histogram(*a[:4], a[4], k), reps=5)
        ms_p = cuda_ms(lambda: topic_histogram_plain(*a[:4], a[4], k),
                       reps=3, warmup=1)
        # the (R, K) output written once, four int32 ids per token read once
        nbytes = a[4] * k * 4 + t * 16
        runs[name] = {"R": a[4], "ms": ms_k, "plain_ms": ms_p,
                      "bytes": nbytes,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "changed_tokens": int(inc.sum()),
                      "mismatches": mism, "max_abs_err": err}
        emit({"phase": "histogram", "rows": name, "T": t, "K": k,
              "equals_plain": True, "equals_delta_counts": True,
              **runs[name]})
    del outs, sides
    torch.cuda.empty_cache()
    main = runs["doc"]
    return ({
        "name": "topic_histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topic_histogram.cu",
        "replaces": "src/repro/kernels/topic_histogram.py:31",
        "launches": None,
        "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
        "mismatches": sum(r["mismatches"] for r in runs.values()),
        "tokens": t, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "bytes",
        "bytes": main["bytes"], "R": main["R"], "shapes": runs,
        "res_usage": res_usage("topic_histogram.cu", "hist_kernel"),
        # two accumulating index_put_ calls: the plain version itself
        "library_ms": main["plain_ms"],
    }, counts["topic_histogram"])


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
    loop = sass_loop_stats("cdf_search_kernel", "cdf_search.cu")
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
        ms_k = cuda_ms(kernel, reps=10)
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
        issue_ms = (strips * 32 * loop["loop_instructions"] / issue_rate
                    * 1e3 if loop else None)
        runs[name] = {
            "ms": ms_k, "plain_ms": ms_p, "off_route_search_ms": ms_o,
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
        "res_usage": res_usage("cdf_search.cu", "cdf_search_kernel"),
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
        check(all((v > 0) == (n == kernel) for n, v in counts.items()),
              f"train_sparse_small {name}: expected launches of {kernel} "
              f"only, got {counts}")
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
