#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, its mesh plan,
sharded serving and router on one CUDA card, and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:

1. device  — the card, and ``nvidia-smi`` name / power limit;
2. build   — nvcc builds ``src/repro_torch/kernels/csrc/zen_infer.cu``,
   ``zen_train.cu``, ``sparse_row.cu``, ``cdf_search.cu`` and
   ``topic_histogram.cu`` for sm_90a, one nvcc each, in parallel (prints
   the ``-Xptxas -v`` summary);
3. kernels — both serving kernels at NYTIMES width (W = 101,636,
   K = 1000) on one full bucket sweep (32 slots x 512 = 16,384 tokens) of
   random counts: the fused kernel must be bit-equal to the gathered one
   and to the exact loop (``zen_infer_exact``: the exact chain for every
   (t, k), one warp per token, as the kernels ran before their redesign),
   and both may differ from the plain torch version on the card only at
   counted near-ties (top two scores within 1e-4) on at most 1e-4 of
   tokens; CUDA-event times of kernels, exact loop and plain version, the
   kernels' stats (topics scored exactly, exact-loop tokens), the fast
   loop's and the exact chain's SASS per (t, k), and the bounds;
4. serving — a planted NYTIMES-width model (each word one dominant topic,
   ~12M tokens of counts) saved with ``save_lda_model``, loaded back with
   ``FrozenLDAModel.from_checkpoint``, and 256 documents of Poisson(332)
   tokens served through ``LDAEngine`` with ``zen_pallas``: throughput mode
   on the fused kernel, throughput mode on the gathered kernel
   (``kernels="off"``), latency mode (RT-LDA), then 64 documents through
   ``zen_cdf``'s frozen CDF tables. Every theta must be
   finite and sum to 1, the top topic must match the planted one on at
   least 90% of single-topic documents, the two throughput runs' thetas
   must equal ``SERVE_RECORD`` (taken before the kernels' redesign), and
   latency-mode assignments must equal those of the same engine on the
   CPU for a sample of documents.
   Each run's launch counts are zeroed after its warm-up and read right
   after its serving window: a throughput run must launch its own kernel
   and no other, and the latency and zen_cdf runs (no kernel) none. Then
   both serving kernels on the fused run's own inputs (its 10th launch at
   the widest bucket, captured from a repeat of the run), checked and
   timed as in phase 3; the serving adversarial grid
   (``SERVE_ADVERSARIAL``: +inf noise, also at a z_old clamped at p =
   1e-30, the forced bucket, exact ties in the bucket, across two lanes
   and in one lane, the engine's padding positions, the clamp, K = 1, 5,
   37 and 36, inputs outside the premise, and K = 14,464, 14,592 and
   16,385 about the table's move to global memory), each at 0 mismatches
   against the exact loop with fused == gathered; and the serving
   estimate's margin premises checked by exhaustion;
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

14. stream — the live pipeline on the train corpus (``ReplaySource``,
   32,768-document windows: 10 per epoch, the last of 4,840; 2 sweeps per
   window): (1) rotation, ``zen_pallas`` fused, decay 0: 12 windows (one
   epoch, then w0 and w1 again on their retained topics), a model
   checkpoint every 4 windows; after the first, a throughput ``LDAEngine``
   (``zen_pallas`` fused, buckets (128, 256, 512), 32 slots, 10 sweeps)
   serves it under its background ticker, follows the directory
   (``watch_checkpoint_dir``, period 0.2 s) and a client thread keeps 64
   corpus documents in flight; the stream's callback waits (60 s at most)
   for each later checkpoint's reload. Checks: ``n_k == n_wk.sum(0)``,
   counts >= 0 and every token counted once after every window, finite
   window perplexities, the final counts bit-equal to
   ``assembled_state()``'s, every theta finite, versions never decreasing
   within a bucket and the last request's >= 2, launches of kernels 2, 5
   and 4 and none of the gathered ones; then one more window profiled.
   (2) decay 0.02, ``zen_cdf`` (max_kd 64), 4 fresh windows: the count
   checks, one transition's device decay equal to ``np.rint`` on the host
   in float64, kernels 7 and 5 launched. (3) resume, the first 65,536
   documents in 16,384-document windows: 6 windows straight, against 3
   windows with a stream checkpoint and a new session resuming to 6:
   counts, cursors and retained topics bit-equal. (4) kernel 2 on the
   inputs of a 32,768-document window's first sweep, captured from the
   session's call, against its plain version: every draw equal; then 2
   windows of 8,192 documents under ``kernels="auto"`` (the fused path:
   kernels 2 and 5) and ``"off"`` (the gathered path: kernel 1 and the
   plain merge): bit-equal counts and retained topics, equal window llh.
   After leg 1 the following engine, trainer idle and watcher stopped, is
   timed at the stream client's load and at the serving phase's (256
   documents at once, under the ticker and stepped inline), as a control
   for the serving rate beside the trainer. Per window it prints
   milliseconds by phase (host slice; then decay, copy with the plan,
   compose and sweeps between CUDA events; eval and retire on the host
   clock), docs/sec and tokens/sec; per leg the model-save times, the
   reload latency from a checkpoint's commit to the version bump, serving
   docs/sec and peak device memory.

15. quality (runs right after ``train``) — quality evaluation and
   telemetry on the train cell: ``CoherenceStats`` of the 99.5M-token
   corpus (NPMI window 10) timed alone with its peak device memory; then
   ``TrainSession.run`` with ``zen_pallas``, an eval and a quality eval
   (top 10 words, 100 left-to-right documents of 20 particles) after
   every iteration and a ``train_iter`` record per iteration into a JSONL
   under ``build/`` (removed after). The llh and change-rate lists must
   equal ``RECORD["train"]`` (quality and telemetry are read-only), the
   launches those of ``train``, the JSONL one record per iteration. It
   prints seconds per quality eval, one eval split into top words, UMass,
   NPMI and left-to-right (with its near-tie count per document; the
   same sweep on the host must agree within 1e-10 relative on every
   document without one), milliseconds per telemetry record. A trained
   model's top words on this corpus are a dozen head words, so the eval
   is also timed, with the peak device memory of UMass and NPMI, on a
   top-word union of several thousand words spread over every frequency
   band (``planted_top_counts``). D(w), D(w, w') and the window counts of
   1,000 seeded pairs of the trained model's top words and 1,000 pairs of
   that union, drawn across frequency bands (``banded_pairs``), are
   checked against a direct per-pair version on the card
   (``plain_pair_counts``: per-word document sets and window-interval
   unions). train_autopilot: the same init with the autopilot every 2 of 4
   iterations: its decisions, the backend it moves to, seconds per
   iteration on each side, count invariants after every step, and each
   iteration's launches checked for the backend that ran it;
16. serve_autopilot (runs after the serving adversarial grid) — the
   serving phase's model and 256 documents through an engine under its
   ticker, submissions 2 ms apart: telemetry off, then telemetry and the
   autopilot on (windows of 16 arrivals), then the documents cut to 32
   tokens in two bursts, so the autopilot's recut of the wide grid is
   applied when the grid drains. docs/sec, p50/p99, every decision and
   whether it was applied, every bucket swap (no request admitted and
   unfinished at it; a request still queued must finish on the new grid
   as its decode alone does), finite thetas and launches of kernel 4
   only. Then the recut grid is swapped under traffic, stepped inline
   (``swap_across_traffic``): the grid must hold while a request is in
   flight, requests queued at the swap are cut to the new widest bucket,
   and every theta must equal its document's decode alone with the same
   key on the grid it finished on.

17. mesh_one (runs after the stream phase) — a world of one under NCCL:
   ``TrainSession`` with ``mesh_shape=(1, 1)`` on the train corpus
   (``grid_partition`` timed apart), ``zen_pallas`` fused, 3 iterations:
   count invariants after every step, the change-rate list equal to
   ``RECORD["train"]``'s first 3 entries and the llh after the third to
   its record within 1e-12 relative (float64 sums of the same float32
   terms), kernels 2 and 5 launched 3 and 6 times. Milliseconds per
   step split into sweep, merge (kernel 5) and the two all-reduces, peak
   memory;
18. mesh_four — 4 gloo ranks sharing the card on a (2, 2) grid: the grid
   partitioned once here and handed to the ranks as memory-mapped
   ``.npy`` files under ``build/``; 2 iterations; count invariants after
   every step; the final counts and topics, gathered and un-permuted,
   equal (by SHA-256, on every rank) a ``zen_pallas`` single box over the
   corpus declared at (W_pad, D_pad) with the same key. Per rank: seconds
   per iteration split into sweep, kernel 5 and the N_w|k and N_k|d
   all-reduces with their bytes, peak memory, launches (2 and 4);
19. sharded_serve (runs after serve_autopilot) — the fused throughput
   run's model, documents and keys at ``mesh_shape`` (1, 2) and (1, 4):
   thetas equal to ``SERVE_RECORD["throughput_fused"]``, kernel 4
   launched m times the unsharded run's count; docs/sec, p50 / p99;
20. router — 2 replicas behind ``LDARouter``, each request under the
   key the single engine derives for it: the same digest, both replicas
   at work, docs/sec; then a broadcast ``reload`` (the same counts, a
   new version) while the first admissions decode: nothing dropped,
   every ticket on the version it was admitted under, the digest again.

The serving phase also serves 64 documents with ``zen_cdf`` (throughput
mode on its frozen per-word CDFs: no kernel), and train_small also runs
``std`` (Eq. 3 as written, plain torch) within 1% of ``zen``. The
train_kernels phase also launches kernels 1-2 with a per-token index (a
mesh cell's corpus indices): the identity keeps every draw, a permuted
launch with index pi permutes them, and both are timed.

Then it prints the ``{"kernels": [...]}`` line (all seven kernels, each
with its launches on its own path and on the stream, quality,
train_autopilot, serve_autopilot, mesh_one, mesh_four, sharded_serve
and router phases'), the
``nvidia-smi`` line and, last, ``{"ok": true, "device": {...}}``. It exits
non-zero, before any result, when no CUDA device is present, when the
repository's ``src/`` is missing, or when any check fails.
"""
from __future__ import annotations

import argparse
import hashlib
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
# the stream phase: the train corpus replayed in windows
STREAM_WINDOW_DOCS, STREAM_SWEEPS = 32_768, 2  # 10 windows per epoch
STREAM_WINDOWS, STREAM_SAVE_EVERY = 12, 4  # one epoch, then w0, w1 again
STREAM_DECAY, DECAY_WINDOWS = 0.02, 4
RESUME_DOCS, RESUME_WINDOW_DOCS = 65_536, 16_384
RESUME_WINDOWS, RESUME_KILL = 6, 3
PLAIN_WINDOW_DOCS, PLAIN_WINDOWS = 8_192, 2
STREAM_IDLE_SERVE_S = 2.0  # serving after the stream ends, trainer idle
# the quality phase: the train cell with quality evaluation and telemetry
QUALITY_TOP_N, NPMI_WINDOW = 10, 10
L2R_DOCS, L2R_PARTICLES = 100, 20
PAIR_SAMPLE = 1000  # top-word pairs recounted by the plain version
AUTOPILOT_ITERS, AUTOPILOT_EVERY = 4, 2
# the serve_autopilot phase
SERVE_PACE_S, AUTOPILOT_WINDOW = 0.002, 16
SHORT_QUERY = 32  # tokens of the short queries of the recut run
# kernel 5 (csrc/topic_histogram.cu) and kernel 7 (csrc/cdf_search.cu)
# as the profiler names their device functions
HIST_KERNELS = ("hist_sorted_kernel", "zero_cut_rows_kernel",
                "zero_fill_kernel")
CDF_KERNELS = ("cdf_compact_kernel", "cdf_walk_kernel")
CDF_STRIPS = 4  # strips per pass of the walk's loop (kStrips)
# the mesh phases: a world of one under NCCL on the train cell, 4 gloo
# ranks sharing the card on a (2, 2) grid, sharded serving, the router
MESH_ONE_ITERS, MESH_FOUR_ITERS = 3, 2
MESH_FOUR_SHAPE = (2, 2)
MESH_LLH_RTOL = 1e-12  # mesh_one's llh vs RECORD (expected: equal)
MESH_SERVE_SHARDS = (2, 4)
ROUTER_REPLICAS = 2
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
# The serving runs' thetas (theta_digest), as this script measured them
# before kernels 3 and 4 were redesigned (NVIDIA H100 80GB HBM3, 700 W):
# a redesign that keeps every draw keeps them
SERVE_RECORD = {
    "throughput_fused":
        "0b6a643fe05845777c0f3971e1aa6cc536f1f61bb03621aae72cd03cbb1f8b6d",
    "throughput_gathered":
        "1f903eb536c157bb6d4a33cabec7b7f0c1d854d9d3eae60fbcaba6fcfc4d47d0",
}


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


def serve_kernels_on(a, sm_count: int, sm_clock_hz: float, reps: int = 20):
    """Both serving kernels, the exact loop (zen_infer_exact: the exact
    chain for every (t, k), one warp per token) and the plain version on
    one input set ``a`` (n_wk, n_kd, word, slot, z, seeds, alpha, n_k,
    beta, w_beta): fused == gathered == the exact loop (0 mismatches),
    kernel against plain only at counted near-ties; CUDA-event times, the
    kernels' stats, the bytes and the operation bounds."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_gather import (
        zen_fused_infer_sample_cuda,
        zen_fused_infer_sample_plain,
        zen_infer_exact_cuda,
    )
    from repro_torch.kernels.zen_sampler import gumbel_noise

    n_wk, n_kd, word, slot, z, seeds = (a[n] for n in (
        "n_wk", "n_kd", "word", "slot", "z", "seeds"))
    alpha, n_k, beta, w_beta = a["alpha"], a["n_k"], a["beta"], a["w_beta"]
    (w, k), b, t = n_wk.shape, n_kd.shape[0], word.shape[0]
    args = (n_wk, n_kd, word, slot, z, seeds, alpha, n_k)
    kw = dict(beta=beta, w_beta=w_beta)
    nwk_rows = n_wk[word.long()].contiguous()
    nkd_rows = n_kd[slot.long()].contiguous()

    def fused():
        return ops.zen_fused_infer_sample(*args, **kw)

    def gathered():
        return ops.zen_infer_sample(nwk_rows, nkd_rows, z, seeds, alpha,
                                    n_k, **kw)

    def exact():
        return zen_infer_exact_cuda(*args, **kw)

    def plain():
        return zen_fused_infer_sample_plain(*args, **kw)

    out_f, out_g, out_e, out_p = fused(), gathered(), exact(), plain()
    stats = torch.zeros(3, dtype=torch.int64, device=n_wk.device)
    out_s = zen_fused_infer_sample_cuda(*args, stats=stats, **kw)
    torch.cuda.synchronize()
    check(bool(torch.equal(out_f, out_g)),
          "fused and gathered kernels disagree")
    check(bool(torch.equal(out_s, out_f)), "serving: stats run differs")
    exact_mism = int((out_f != out_e).sum())
    check(exact_mism == 0, f"serving kernels differ from the exact loop "
          f"on {exact_mism} of {t} tokens")
    check(int(out_f.min()) >= 0 and int(out_f.max()) < k,
          "serving kernel drew a topic outside [0, K)")
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

    # gated: a launch of the verified kernels is shorter than its host-side
    # cost, so back to back they would be timed at the host's pace (kept
    # apart as host_paced)
    ms = {"fused": cuda_ms(fused, reps=reps, gate=True),
          "gathered": cuda_ms(gathered, reps=reps, gate=True),
          "exact_loop": cuda_ms(exact, reps=reps, gate=True),
          "plain": cuda_ms(plain, reps=5)}
    host_paced = {"fused": cuda_ms(fused, reps=reps),
                  "gathered": cuda_ms(gathered, reps=reps),
                  "exact_loop": cuda_ms(exact, reps=reps)}
    uniq = int(torch.unique(word).numel())
    vec = 2 * k * 4  # alpha_k and n_k
    tok = t * 4 * 4 + t * 4  # word/slot or z/seeds in, topics out
    forced, cands, fallback = stats.tolist()
    del nwk_rows, nkd_rows
    return {
        "T": t, "K": k, "W": w, "B": b, "unique_words": uniq,
        "bytes_fused": uniq * k * 4 + b * k * 4 + vec + tok,
        "bytes_gathered": 2 * t * k * 4 + vec + t * 4 * 2 + t * 4,
        # the operations any exact draw needs: the hash of every (t, k)
        # for its noise; this design's estimate adds three MUFU lg2 per
        # (t, k), its own floor
        "hash_ms": (HASH_INT_OPS * t * k
                    / (sm_count * INT_PER_SM_PER_CLK * sm_clock_hz) * 1e3),
        "mufu_lg2": 3 * t * k,
        "design_mufu_ms": (3 * t * k / (sm_count * SFU_PER_SM_PER_CLK
                                        * sm_clock_hz) * 1e3),
        "ms": ms, "host_paced_ms": host_paced, "gaps": gaps,
        "exact_loop_mismatches": exact_mism,
        "exact_work": {"forced": forced, "candidates": cands,
                       "exact_loop_tokens": fallback},
        "exact_topics_per_token": (forced + cands) / t,
        "exact_share": (forced + cands + fallback * k) / (t * k),
    }


def serve_sass():
    """The serving kernels' SASS: the verified fused and gathered kernels'
    fast loops at K = 1000 (4 topics per lane, table in shared memory) and
    the exact loop's K loop (zen_infer_exact_kernel: the exact chain, one
    topic per lane per pass, as the kernels before the redesign ran it for
    every (t, k))."""
    inst = "ILi4ELb1EE"
    out = {name: fast_loop_stats(kern + inst, 4, source="zen_infer.cu")
           for name, kern in (("zen_fused_infer_sample",
                               "zen_infer_fused_kernel"),
                              ("zen_infer_sample",
                               "zen_infer_gathered_kernel"))}
    out["exact_loop"] = sass_loop_stats("zen_infer_exact_kernel",
                                        source="zen_infer.cu")
    return out


def issue_bound_ms(t: int, k: int, loop, work, sm_count: int,
                   sm_clock_hz: float):
    """Issue bound of one launch of a verified sampler (kernels 1-4), in
    warp instructions: its fast loop (``fast_loop_stats``) over every pass,
    one exact_score per exactly scored topic (the candidates of a token
    share one divergent pass, so this overcounts) and ceil(K/32) exact
    chains per exact-loop token (``work``: the stats output); None without
    the SASS figures."""
    if not loop or not loop["exact_score_instructions"]:
        return None
    warp_instr = (t * -(-k // (32 * loop["topics_per_pass"]))
                  * loop["fast_loop_instructions"]
                  + (work["forced"] + work["candidates"]
                     + work["exact_loop_tokens"] * -(-k // 32))
                  * loop["exact_score_instructions"])
    return (warp_instr * 32 / (sm_count * INSTR_PER_SM_PER_CLK
                               * sm_clock_hz) * 1e3)


def serve_row_figures(r, name, sass, sm_count, sm_clock_hz):
    """One serving kernel's figures on one input set ``r``."""
    fused = name == "zen_fused_infer_sample"
    nbytes = r["bytes_fused" if fused else "bytes_gathered"]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "ms": r["ms"]["fused" if fused else "gathered"],
        "host_paced_ms": r["host_paced_ms"]["fused" if fused else "gathered"],
        "plain_ms": r["ms"]["plain"],
        "exact_loop_ms": r["ms"]["exact_loop"],
        "bound_ms": max(bytes_ms, r["hash_ms"]),
        "bound_by": "bytes" if bytes_ms >= r["hash_ms"] else "operations",
        "bytes": nbytes, "bytes_ms": bytes_ms, "hash_ms": r["hash_ms"],
        "mufu_lg2": r["mufu_lg2"], "design_mufu_ms": r["design_mufu_ms"],
        "issue_bound_ms": issue_bound_ms(r["T"], r["K"], sass[name],
                                         r["exact_work"], sm_count,
                                         sm_clock_hz),
        "exact_work": r["exact_work"],
        "exact_topics_per_token": r["exact_topics_per_token"],
        "exact_share": r["exact_share"], "tokens": r["T"],
        "unique_words": r["unique_words"],
    }


def phase_kernels(gen, dev, sm_count: int, sm_clock_hz: float):
    """Both kernels against each other, the exact loop and the plain
    version, on random counts at the serving cell's shapes."""
    import torch

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
    r = serve_kernels_on(dict(n_wk=n_wk, n_kd=n_kd, word=word, slot=slot,
                              z=z, seeds=seeds, alpha=alpha, n_k=n_k,
                              beta=0.01, w_beta=w * 0.01),
                         sm_count, sm_clock_hz)
    sass = serve_sass()
    gaps = r["gaps"]
    # the fused kernel's fixed cost against its cost per token: gated
    # times on the first 4,096 tokens (one sweep of 128-token buckets),
    # all 16,384 and those four times over
    from repro_torch.kernels import ops
    by_tokens = {}
    for n in (4096, t, 4 * t):
        idx = torch.arange(n, device=dev) % t
        sub = [x[idx].contiguous() for x in (word, slot, z, seeds)]
        by_tokens[str(n)] = cuda_ms(
            lambda: ops.zen_fused_infer_sample(n_wk, n_kd, *sub, alpha, n_k,
                                               beta=0.01, w_beta=w * 0.01),
            reps=20, gate=True)

    def row(name, replaces):
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_infer.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps,
            "exact_loop_mismatches": r["exact_loop_mismatches"],
            **serve_row_figures(r, name, sass, sm_count, sm_clock_hz),
            "sass": sass[name], "exact_loop_sass": sass["exact_loop"],
            "library_ms": None,
            **({"ms_by_tokens": by_tokens}
               if name == "zen_fused_infer_sample" else {}),
        }

    rows = [row("zen_fused_infer_sample",
                "src/repro/kernels/fused_gather.py:166"),
            row("zen_infer_sample", "src/repro/kernels/zen_sampler.py:218")]
    emit({"phase": "kernels", "W": w, "K": k, "T": t,
          "unique_words": r["unique_words"], "fused_equals_gathered": True,
          "exact_loop_mismatches": r["exact_loop_mismatches"],
          "mismatches_vs_plain": len(gaps), "ms": r["ms"],
          "host_paced_ms": r["host_paced_ms"], "exact_work": r["exact_work"],
          "exact_topics_per_token": r["exact_topics_per_token"],
          "fused_ms_by_tokens": by_tokens, "sass": sass})
    del n_wk
    torch.cuda.empty_cache()
    return rows


def capture_path_inputs(model, cfg, docs, seed: int, sweep: int):
    """The inputs of the ``sweep``-th launch of the fused serving kernel
    at the widest bucket (32 slots x 512 tokens) when ``docs`` are served
    as the throughput_fused run serves them (the run is deterministic, so
    these are that run's own): the model's n_wk, the bucket's n_kd, words,
    slots, z and seeds, and the per-topic vectors."""
    import repro_torch.algorithms.zen_pallas as zen_pallas
    from repro_torch.serving import LDAEngine

    seen = []
    real = zen_pallas.zen_fused_infer_sample

    def record(n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k, *,
               beta, w_beta, **kw):
        if word.shape[0] == SLOTS * BUCKET:
            seen.append(None if len(seen) != sweep else dict(
                n_wk=n_wk, n_kd=n_kd.clone(), word=word.clone(),
                slot=slot.clone(), z=z_old.clone(), seeds=seeds.clone(),
                alpha=alpha_k, n_k=n_k, beta=beta, w_beta=w_beta))
        return real(n_wk, n_kd, word, slot, z_old, seeds, alpha_k, n_k,
                    beta=beta, w_beta=w_beta, **kw)

    zen_pallas.zen_fused_infer_sample = record
    try:
        engine = LDAEngine(model, cfg, seed=seed)
        engine.infer_batch(docs)
    finally:
        zen_pallas.zen_fused_infer_sample = real
    check(len(seen) > sweep, f"serving path: {len(seen)} launches at the "
          f"widest bucket, fewer than {sweep + 1}")
    return seen[sweep]


def phase_serve_path(model, cfg, docs, seed: int, rows, sm_count: int,
                     sm_clock_hz: float):
    """Both serving kernels on the throughput_fused run's own inputs (the
    10th launch at the widest bucket), against the exact loop and the
    plain version; their figures join ``rows`` under ``path``."""
    import torch

    a = capture_path_inputs(model, cfg, docs, seed, sweep=9)
    r = serve_kernels_on(a, sm_count, sm_clock_hz)
    # padding positions (past each slot's document, z_old often at N_kd =
    # 0, the clamp) are sampled, then dropped by the engine
    lens = [min(len(d), BUCKET) for d in docs if len(d) > BUCKET // 2]
    sass = {row["name"]: row["sass"] for row in rows}
    for row in rows:
        row["path"] = serve_row_figures(r, row["name"], sass, sm_count,
                                        sm_clock_hz)
        row["path"]["mismatches_vs_plain"] = len(r["gaps"])
    emit({"phase": "serve_path_kernels", "T": r["T"], "K": r["K"],
          "unique_words": r["unique_words"], "ms": r["ms"],
          "host_paced_ms": r["host_paced_ms"],
          "padding_share_of_widest_bucket": 1 - sum(lens) / (len(lens)
                                                          * BUCKET),
          "exact_loop_mismatches": r["exact_loop_mismatches"],
          "mismatches_vs_plain": len(r["gaps"]),
          "exact_work": r["exact_work"],
          "exact_topics_per_token": r["exact_topics_per_token"]})
    torch.cuda.empty_cache()



# The serving kernels' adversarial grid: (name, seed, T, K, W, B, kind,
# pins). Slot s holds tokens [s T / B, (s + 1) T / B), as the serving path
# lays out a bucket. A pin (token, token seed, topics, z_old) sets that
# token's seed and z_old and must draw min(topics); a pin whose z_old is
# one of its topics zeroes that doc count (the clamped z_old). Kind
# "pinned": equal counts (n_wk 5, n_kd 2, alpha 0.05, N_k 1000, z_old 0)
# with each pin's topics raised to 10^7 in its token's slot row, so that
# one of them must win. The pins' coordinates (seed, 0, topic), held
# against the JAX package's hash and oracles by
# tests/test_torch_serve_kernels.py:
# - inf_noise: seed 38296 has m = 2^24 - 1 at topic 415 (noise +inf), drawn
#   by token 100 (z_old 7) and by token 2000, whose z_old is 415 with
#   N_kd = 0 there, so its p clamps at 1e-30;
# - top_bucket: seed 1003, topic 325, m = 16774212 (the forced bucket);
# - top_bucket_tie: seed 141959, topics 156 and 406, m = 16773846 and
#   16773845, one u: an exact tie of two forced topics;
# - candidates_tie: seed 1025, topics 402 and 713 (lanes 4 and 18), equal
#   m: two candidates rescored exactly;
# - same_lane_tie: seed 1339, topics 696 and 826 (lane 14), equal m: a
#   lane's two best tie, so the token takes the exact loop;
# - padding: the engine's bucket state: each slot a document of 1 to 512
#   tokens, z_old stale past it, n_kd counting the document alone, so
#   many padding positions have N_kd = 0 at z_old (the clamp);
# - p_clamp: alpha_k from 1e-33 to 1e-23 and empty counts, so p lies on
#   both sides of the 1e-30 clamp;
# - k_1, k_5, k_37 (one topic per lane), k_36 (a partial 128-topic pass),
#   premise_off (one N_k + W b above 2^100: the block samples with the
#   exact loop alone);
# - k_14464 (the largest table an H100 block keeps in shared memory),
#   k_14592 and k_16385 (tables the launcher puts in global memory, with 4
#   and 1 topics per lane).
SERVE_ADVERSARIAL = (
    ("inf_noise", 21, 4096, 1000, 200, 8, "random",
     ((100, 38296, (415,), 7), (2000, 38296, (415,), 415))),
    ("top_bucket", 22, 4096, 1000, 200, 8, "pinned",
     ((700, 1003, (325,), 0),)),
    ("top_bucket_tie", 23, 4096, 1000, 200, 8, "pinned",
     ((1200, 141959, (156, 406), 0),)),
    ("candidates_tie", 24, 4096, 1000, 200, 8, "pinned",
     ((1900, 1025, (402, 713), 0),)),
    ("same_lane_tie", 25, 4096, 1000, 200, 8, "pinned",
     ((3000, 1339, (696, 826), 0),)),
    ("padding", 26, 16384, 1000, 5000, 32, "padding", ()),
    ("p_clamp", 27, 4096, 1000, 100, 8, "clamp", ()),
    ("k_1", 28, 4096, 1, 50, 8, "random", ()),
    ("k_5", 29, 4096, 5, 50, 8, "random", ()),
    ("k_37", 30, 4096, 37, 50, 8, "random", ()),
    ("k_36", 31, 4096, 36, 50, 8, "random", ()),
    ("premise_off", 32, 4096, 1000, 100, 8, "premise_off", ()),
    ("k_14464", 33, 512, 14464, 60, 4, "random", ()),
    ("k_14592", 34, 512, 14592, 60, 4, "random", ()),
    ("k_16385", 35, 512, 16385, 60, 4, "random", ()),
)


def serve_adversarial_case(spec, dev):
    """The inputs of one :data:`SERVE_ADVERSARIAL` case on ``dev``."""
    import torch

    _, seed, t, k, w, b, kind, pins = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    i32 = torch.int32
    word = torch.randint(0, w, (t,), generator=g, device=dev, dtype=i32)
    slot = (torch.arange(t, device=dev) * b // t).to(i32)
    z = torch.randint(0, k, (t,), generator=g, device=dev, dtype=i32)
    seeds = torch.randint(0, 2**31 - 1, (t,), generator=g, device=dev,
                          dtype=i32)
    alpha = torch.rand(k, generator=g, device=dev) * 0.2 + 0.001
    n_wk = torch.randint(0, 40, (w, k), generator=g, device=dev, dtype=i32)
    n_k = None
    if kind == "pinned":
        n_wk = torch.full((w, k), 5, dtype=i32, device=dev)
        n_kd = torch.full((b, k), 2, dtype=i32, device=dev)
        alpha = torch.full((k,), 0.05, device=dev)
        n_k = torch.full((k,), 1000.0, device=dev)
        z.zero_()
    elif kind == "clamp":
        n_wk.zero_()
        n_kd = torch.zeros((b, k), dtype=i32, device=dev)
        alpha = 10.0 ** (torch.rand(k, generator=g, device=dev) * 10 - 33)
        n_k = torch.full((k,), 1000.0, device=dev)
    elif kind == "padding":
        per = t // b
        length = torch.randint(1, per + 1, (b,), generator=g, device=dev)
        doc = torch.arange(t, device=dev) % per < length[slot.long()]
        n_kd = torch.zeros((b, k), dtype=i32, device=dev)
        n_kd.index_put_((slot[doc].long(), z[doc].long()),
                        torch.ones_like(z[doc]), accumulate=True)
    else:  # random, premise_off: each token's own topic counted
        n_kd = torch.randint(0, 8, (b, k), generator=g, device=dev,
                             dtype=i32)
        n_kd.index_put_((slot.long(), z.long()), torch.ones_like(z),
                        accumulate=True)
    if n_k is None:
        n_k = n_wk.sum(0).to(torch.float32)
    if kind == "premise_off":
        n_k[5] = 1e35
    for tok, tseed, topics, z_old in pins:
        seeds[tok] = tseed
        z[tok] = z_old
        row = int(slot[tok])
        if kind == "pinned":
            n_kd[row, list(topics)] = 10**7
        if z_old in topics:
            n_kd[row, z_old] = 0
    return dict(n_wk=n_wk, n_kd=n_kd, word=word, slot=slot, z=z,
                seeds=seeds, alpha=alpha, n_k=n_k, beta=0.01,
                w_beta=w * 0.01)


def serve_adversarial_check(spec, dev):
    """Both serving kernels on one :data:`SERVE_ADVERSARIAL` case against
    the exact loop: 0 mismatches, fused == gathered, the pinned draws.
    Direct launches with the stats output, outside the launch counts.
    Returns the case's summary, with where the launcher put the table."""
    import torch

    from repro_torch.kernels.fused_gather import (
        zen_fused_infer_sample_cuda,
        zen_infer_exact_cuda,
    )
    from repro_torch.kernels.zen_sampler import (
        infer_global_table_entries,
        zen_infer_sample_cuda,
    )

    name, _, t, k, _, _, _, pins = spec
    a = serve_adversarial_case(spec, dev)
    args = tuple(a[n] for n in ("n_wk", "n_kd", "word", "slot", "z",
                                "seeds", "alpha", "n_k"))
    kw = dict(beta=a["beta"], w_beta=a["w_beta"])
    exact = zen_infer_exact_cuda(*args, **kw)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    fused = zen_fused_infer_sample_cuda(*args, stats=stats, **kw)
    gathered = zen_infer_sample_cuda(
        a["n_wk"][a["word"].long()].contiguous(),
        a["n_kd"][a["slot"].long()].contiguous(), a["z"], a["seeds"],
        a["alpha"], a["n_k"], **kw)
    torch.cuda.synchronize()
    mism = int((fused != exact).sum())
    check(bool(torch.equal(fused, gathered)),
          f"serving adversarial {name}: fused != gathered")
    check(mism == 0, f"serving adversarial {name}: {mism} mismatches "
          "against the exact loop")
    forced, cands, exact_loop = stats.tolist()
    check(exact_loop == t if name == "premise_off" else
          exact_loop < t and forced + cands < t * k,
          f"serving adversarial {name}: exact work {stats.tolist()}")
    for tok, _, topics, _ in pins:
        check(int(fused[tok]) == min(topics),
              f"serving adversarial {name}: token {tok} drew "
              f"{int(fused[tok])}, pinned {min(topics)}")
    table = "global" if infer_global_table_entries(k, dev) else "shared"
    return {"case": name, "T": t, "K": k, "table": table,
            "stats": stats.tolist(),
            "pins": {str(p[0]): min(p[2]) for p in pins},
            "mismatches": mism}


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


def theta_digest(thetas) -> str:
    """SHA-256 of a serving run's thetas as float32 bytes: every draw of
    the run decides them, so an unchanged digest shows unchanged draws."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(thetas, dtype=np.float32).tobytes()).hexdigest()


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
              "launches": counts, "card": smi, "checkpoint_seconds": t_ckpt,
              "theta_sha256": theta_digest(thetas)})
        check(all((v > 0) == (k == kernel) for k, v in counts.items()),
              f"{name}: expected launches of {kernel} only, got {counts}")
        if kernel is not None:
            launches[kernel] = counts[kernel]
        if name in SERVE_RECORD:
            check(theta_digest(thetas) == SERVE_RECORD[name],
                  f"{name}: thetas differ from the record (a kernel "
                  f"changed a draw)")

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
    phase_serve_path(model, runs[0][1], docs, args.seed, rows,
                     props.multi_processor_count, sm_clock_hz)
    grid = [serve_adversarial_check(spec, dev) for spec in SERVE_ADVERSARIAL]
    check(any(case["table"] == "global" for case in grid),
          "serving adversarial grid: no case put the table in global memory")
    emit({"phase": "serve_kernels_adversarial", "cases": grid,
          "margin": margin_premises(dev, kernels="infer")})
    serve_autopilot_launches = phase_serve_autopilot(
        model, base, docs, topics, args.seed, smi)
    sharded_launches = phase_sharded_serve(
        model, base, docs, args.seed, launches["zen_fused_infer_sample"],
        smi)
    router_launches = phase_router(model, base, docs, args.seed, smi)

    # -- training: kernels, the full NYTIMES run, the three backends ------
    train_rows, train_launches, by_phase = run_training(
        args.seed, dev, props, smi, sm_clock_hz)
    launches.update(train_launches)
    by_phase["serve_autopilot"] = {
        "zen_fused_infer_sample": serve_autopilot_launches}
    by_phase["sharded_serve"] = sharded_launches
    by_phase["router"] = router_launches
    rows = train_rows + rows
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the live pipeline's launches (stream phase: legs 1 and 2), and
        # those of the quality, train_autopilot and serve_autopilot runs
        for phase, counts in by_phase.items():
            r[f"launches_{phase}"] = counts.get(r["name"], 0)
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
    (t, k), with the fast loop's opcodes counted; and the out-of-line
    exact_score's length (the CALL target up to its RET), which each exact
    topic costs. None when the tool or the pattern is missing."""
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
    ops = {}
    for a, t in body:
        if a not in skipped:
            op = t.split()[0] if not t.startswith("@") else t.split()[1]
            ops[op] = ops.get(op, 0) + 1
    return {"loop_instructions": len(body),
            "fast_loop_instructions": fast,
            "fast_loop_opcodes": dict(sorted(ops.items(),
                                             key=lambda kv: -kv[1])),
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


def margin_premises(dev, kernels: str = "train"):
    """A verified sampler's margin premises by exhaustion on the card
    (``kernels``: "train" or "infer", each source's own estimate): E1 over
    every float in [1e-30, FLT_MAX], E2 over every m below the forced
    bucket (and below other widths, for the record)."""
    from repro_torch.kernels.zen_sampler import fast_score_errors

    r = fast_score_errors(dev, kernels)
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

    # the per-token index a mesh cell passes (its tokens' corpus
    # indices): the identity keeps every draw, a permutation pi of the
    # tokens with index pi permutes them
    ident = torch.arange(t, dtype=torch.int32, device=z.device)

    def fused_index():
        return ops.zen_fused_sample(st.n_wk, st.n_kd, word, doc, z, alpha,
                                    n_k, kseed, beta=beta, w_beta=w_beta,
                                    token_index=ident)

    def gathered_index():
        return ops.zen_sample(nwk_rows, nkd_rows, z, alpha, n_k, kseed,
                              beta=beta, w_beta=w_beta, token_index=ident)

    gen = torch.Generator(device=z.device).manual_seed(seed + 17)
    perm = torch.randperm(t, generator=gen, device=z.device)
    pl = perm.long()
    out_perm = ops.zen_fused_sample(
        st.n_wk, st.n_kd, word[pl].contiguous(), doc[pl].contiguous(),
        z[pl].contiguous(), alpha, n_k, kseed, beta=beta, w_beta=w_beta,
        token_index=perm.to(torch.int32))
    check(bool(torch.equal(fused_index(), out_f))
          and bool(torch.equal(gathered_index(), out_g))
          and bool(torch.equal(out_perm, out_f[pl])),
          "training kernels: the per-token index changed a draw")
    del out_perm, pl, perm

    ms_f = cuda_ms(fused, reps=5, warmup=1)
    ms_g = cuda_ms(gathered, reps=5, warmup=1)
    ms_fi = cuda_ms(fused_index, reps=5, warmup=1)
    ms_gi = cuda_ms(gathered_index, reps=5, warmup=1)
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

    def row(name, replaces, ms, ms_index, nbytes):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        loop = sass[name]
        issue_ms = issue_bound_ms(
            t, k, loop, {"forced": forced, "candidates": cands,
                         "exact_loop_tokens": fallback},
            sm_count, sm_clock_hz)
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/zen_train.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(gaps, default=0.0), "mismatches": len(gaps),
            "near_tie_gaps": gaps, "tokens": t,
            "ms": ms, "ms_token_index": ms_index, "plain_ms": ms_p,
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
            ms_f, ms_fi, bytes_f),
        row("zen_sample", "src/repro/kernels/zen_sampler.py:105", ms_g,
            ms_gi, bytes_g),
    ]
    emit({"phase": "train_kernels", "W": W_NYT, "K": k, "T": t,
          "unique_words": uniq_w, "unique_docs": uniq_d,
          "fused_equals_gathered": True, "mismatches_vs_plain": len(gaps),
          "token_index_keeps_draws": True,
          "ms": {"fused": ms_f, "gathered": ms_g, "plain": ms_p,
                 "fused_token_index": ms_fi,
                 "gathered_token_index": ms_gi},
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
    quality_counts, autopilot_counts = phase_quality(corpus_dev, seed, smi)
    gathered_launches = phase_train_small(seed, dev, smi)
    sparse_counts, sparse_row = phase_train_sparse(corpus_dev, seed, smi)
    torch.cuda.empty_cache()
    cdf_rows, cdf_counts = phase_train_cdf(
        corpus_dev, seed, smi, props.multi_processor_count, sm_clock_hz)
    del corpus_dev
    torch.cuda.empty_cache()
    phase_train_sparse_small(seed, dev, smi)
    stream_counts = phase_stream(corpus, seed, dev, smi)
    mesh_one_counts = phase_mesh_one(corpus, seed, dev, smi)
    mesh_four_counts = phase_mesh_four(corpus, seed, dev, smi)
    del corpus
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
        "topic_histogram": train_counts["topic_histogram"]}, {
        "stream": stream_counts, "quality": quality_counts,
        "train_autopilot": autopilot_counts, "mesh_one": mesh_one_counts,
        "mesh_four": mesh_four_counts}


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


def stream_source(corpus, window_docs: int, epochs: int):
    """A ``ReplaySource`` that also records the host milliseconds of each
    window's slice (``slice_ms``, in call order)."""
    from repro_torch.data.stream import ReplaySource

    class TimedReplay(ReplaySource):
        def window_slice(self, slice_index):
            t0 = time.perf_counter()
            w = super().window_slice(slice_index)
            self.slice_ms.append((time.perf_counter() - t0) * 1e3)
            return w

    src = TimedReplay(corpus, window_docs, epochs=epochs)
    src.slice_ms = []
    return src


def stream_window_record(sess, src, m, tokens_seen=None):
    """One window's line: its metrics, milliseconds by phase and rates,
    after the count checks (``n_k == n_wk.sum(0)``, both >= 0, and with
    ``tokens_seen`` the conserved token total)."""
    import math

    import torch

    check(bool(torch.equal(sess.n_k, sess.n_wk.sum(0, dtype=torch.int32))),
          f"stream window {m['window']}: n_k != n_wk.sum(0)")
    check(bool((sess.n_wk >= 0).all()) and bool((sess.n_k >= 0).all()),
          f"stream window {m['window']}: a negative count")
    if tokens_seen is not None:
        check(int(sess.n_k.sum(dtype=torch.int64)) == tokens_seen,
              f"stream window {m['window']}: {int(sess.n_k.sum())} tokens "
              f"in the model, {tokens_seen} seen")
    check(math.isfinite(m["perplexity"]),
          f"stream window {m['window']}: perplexity {m['perplexity']}")
    t = sess.timings
    dt = m["docs"] / m["docs_per_sec"]
    return {"window": m["window"], "uid": m["uid"], "docs": m["docs"],
            "tokens": m["tokens"], "perplexity": m["perplexity"],
            "change_rate": m["change_rate"],
            "docs_per_sec": m["docs_per_sec"],
            "tokens_per_sec": m["tokens"] / dt,
            "ms": {"slice": src.slice_ms[-1] if src.slice_ms else None,
                   "copy": t["plan"], "compose": t["compose"],
                   "sweeps": t["sweeps"], "eval": t["eval"],
                   "decay": t["decay"], "retire": t["retire"]}}


def serving_controls(engine, docs):
    """The following engine once the trainer is idle and its watcher is
    stopped, at three loads on its last model: the stream's closed-loop
    client (64 documents in flight for STREAM_IDLE_SERVE_S seconds) and
    N_DOCS documents at once, both under the background ticker, then
    N_DOCS at once stepped inline by ``result``, as the serving phase
    serves them."""
    import numpy as np

    def run(batches):
        lat, n = [], 0
        t0 = time.perf_counter()
        for batch in batches:
            tickets = [engine.submit_async(d) for d in batch]
            reqs = [engine.request(t) for t in tickets]
            for t in tickets:
                engine.result(t, timeout=120)
            lat += [(r.t_done - r.t_submit) * 1e3 for r in reqs]
            n += len(batch)
        secs = time.perf_counter() - t0
        return {"docs": n, "seconds": secs, "docs_per_sec": n / secs,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}

    def closed_loop():
        t_end, i = time.perf_counter() + STREAM_IDLE_SERVE_S, 0
        while time.perf_counter() < t_end:
            yield [docs[(i + j) % len(docs)] for j in range(64)]
            i += 64

    burst = [docs[:N_DOCS]]
    out = {}
    engine.start(0.001)
    try:
        out["ticker_64_in_flight"] = run(closed_loop())
        out["ticker_at_once"] = run(burst)
    finally:
        engine.stop()
    out["inline_at_once"] = run(burst)
    return out


def stream_fused_vs_plain(corpus, hyper, seed: int, dev):
    """Kernel 2 at the stream's shapes: the inputs of the first sweep of
    one STREAM_WINDOW_DOCS window (the stream's first window, fresh
    topics), captured from the session's own call, against the plain
    version on the same inputs. The plain version materialises (T, K)
    floats, so it runs in KERNEL_TOKENS slices at their token offsets."""
    import torch

    import repro_torch.algorithms.zen_pallas as zen_pallas
    from repro_torch.kernels.fused_gather import zen_fused_sample_plain
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    seen = []
    real = zen_pallas.zen_fused_sample

    def record(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, kseed, *,
               beta, w_beta, **kw):
        out = real(n_wk, n_kd, word, doc, z_old, alpha_k, n_k, kseed,
                   beta=beta, w_beta=w_beta, **kw)
        if not seen:
            seen.append(dict(
                n_wk=n_wk.clone(), n_kd=n_kd.clone(), word=word.clone(),
                doc=doc.clone(), z=z_old.clone(), alpha=alpha_k.clone(),
                n_k=n_k.clone(), seed=kseed, beta=beta, w_beta=w_beta,
                out=out.clone()))
        return out

    zen_pallas.zen_fused_sample = record
    try:
        StreamingSession(stream_source(corpus, STREAM_WINDOW_DOCS, 1), hyper,
                         RunConfig(algorithm="zen_pallas", kernels="auto",
                                   num_iterations=1,
                                   window_docs=STREAM_WINDOW_DOCS,
                                   window_sweeps=1),
                         device=dev).run(seed)
    finally:
        zen_pallas.zen_fused_sample = real
    check(len(seen) == 1, "stream: kernel 2 was not called on the window")
    a = seen[0]
    t = a["word"].shape[0]
    mismatches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, t, KERNEL_TOKENS):
        end = min(t, start + KERNEL_TOKENS)
        plain = zen_fused_sample_plain(
            a["n_wk"], a["n_kd"], a["word"][start:end], a["doc"][start:end],
            a["z"][start:end], a["alpha"], a["n_k"], a["seed"],
            beta=a["beta"], w_beta=a["w_beta"], row_offset=start)
        mismatches += int((plain != a["out"][start:end]).sum())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    # the verified design is exact: not even a near-tie may differ
    check(mismatches == 0, f"stream: kernel 2 differs from its plain "
          f"version on {mismatches} of {t} window tokens")
    return {"window_docs": STREAM_WINDOW_DOCS, "tokens": t,
            "docs_in_window": int(a["n_kd"].shape[0]),
            "mismatches": mismatches, "plain_seconds": plain_s}


def phase_stream(corpus, seed: int, dev, smi):
    """The live pipeline on the card: streaming training (the NYTIMES
    corpus replayed in windows) and a serving engine that hot-reloads the
    trainer's model checkpoints. Four legs (see the module docstring);
    returns the stream path's launch counts."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from repro_torch.core.types import Corpus, LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.serving import FrozenLDAModel, LDAEngine, LDAServeConfig
    from repro_torch.train.online import StreamingSession
    from repro_torch.train.session import RunConfig

    hyper = LDAHyperParams(num_topics=K_NYT)
    build = ROOT / "build"
    models_dir = build / "chip_smoke_stream_models"
    resume_dir = build / "chip_smoke_stream_resume"
    for d in (models_dir, resume_dir):
        shutil.rmtree(d, ignore_errors=True)

    # -- leg 1: rotation (zen_pallas fused) followed by a serving engine --
    t0 = time.perf_counter()
    src = stream_source(corpus, STREAM_WINDOW_DOCS, epochs=2)
    source_s = time.perf_counter() - t0
    cfg = RunConfig(algorithm="zen_pallas", kernels="auto",
                    num_iterations=STREAM_WINDOWS,
                    window_docs=STREAM_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS,
                    checkpoint_dir=str(models_dir),
                    checkpoint_every=STREAM_SAVE_EVERY)
    sess = StreamingSession(src, hyper, cfg, device=dev)
    saves, bumps, windows = [], [], []
    live = {"engine": None, "tokens_seen": 0, "waited": 0}
    served, served_lock = [], threading.Lock()
    stop = threading.Event()
    threads = []
    real_save = sess.save_model

    def timed_save(directory=None):
        t = time.perf_counter()
        path = real_save(directory)
        done = time.perf_counter()
        saves.append({"step": sess.windows_done, "ms": (done - t) * 1e3,
                      "committed_at": done})
        return path

    sess.save_model = timed_save
    first = src.window_slice(0).corpus
    bounds = np.searchsorted(first.doc.numpy(),
                             np.arange(first.num_docs + 1))
    docs = [first.word.numpy()[bounds[d]:bounds[d + 1]]
            for d in range(first.num_docs)]
    src.slice_ms.clear()

    def client(engine):
        """Closed loop: 64 documents in flight, each batch reaped before
        the next is submitted."""
        i = 0
        while not stop.is_set():
            batch = [docs[(i + j) % len(docs)] for j in range(64)]
            i += 64
            tickets = [engine.submit_async(d) for d in batch]
            reqs = [engine.request(t) for t in tickets]
            thetas = [engine.result(t, timeout=120) for t in tickets]
            with served_lock:
                served.extend(
                    (r.uid, r.model_version, len(r.words),
                     bool(np.isfinite(th).all()), r.t_done - r.t_submit,
                     r.t_done)
                    for r, th in zip(reqs, thetas))

    def monitor(engine):
        version = engine.model_version
        while not stop.is_set():
            v = engine.model_version
            if v != version:
                bumps.append({"version": v, "at": time.perf_counter()})
                version = v
            time.sleep(0.002)

    def wait_version(engine, version):
        deadline = time.monotonic() + 60
        while engine.model_version < version \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        check(engine.model_version >= version,
              f"stream: the engine did not reach model version {version} "
              f"within 60 s of its checkpoint (at {engine.model_version}; "
              f"watcher error {engine.watch_error})")

    def on_window(s, m):
        if m["window"] < src.windows_per_epoch:
            live["tokens_seen"] += m["tokens"]
        windows.append(stream_window_record(s, src, m, live["tokens_seen"]))
        eng = live["engine"]
        if eng is None and saves:
            # the first model checkpoint is on disk: serve it, follow
            model = FrozenLDAModel.from_checkpoint(str(models_dir),
                                                   device=dev)
            eng = LDAEngine(model, LDAServeConfig(
                buckets=(128, 256, 512), max_batch=SLOTS, num_sweeps=10,
                algorithm="zen_pallas"), seed=seed)
            eng.warm()
            eng.start(0.001)
            eng.watch_checkpoint_dir(str(models_dir), period=0.2,
                                     initial_step=saves[0]["step"])
            live["engine"], live["t_engine"] = eng, time.perf_counter()
            live["waited"] = 1
            for fn in (client, monitor):
                th = threading.Thread(target=fn, args=(eng,), daemon=True)
                th.start()
                threads.append(th)
        elif eng is not None and len(saves) > live["waited"]:
            # the save after the previous window: wait for its reload
            wait_version(eng, len(saves) - 1)
            live["waited"] = len(saves)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(seed, callback=on_window)
    eng = live["engine"]
    check(eng is not None, "stream: no model checkpoint started the engine")
    wait_version(eng, len(saves) - 1)
    t_idle = time.monotonic()
    time.sleep(STREAM_IDLE_SERVE_S)  # serving on, the trainer idle
    stop.set()
    for th in threads:
        th.join()
    t_serve = time.perf_counter() - live["t_engine"]
    watch_err = eng.stop_watching()
    eng.stop()
    torch.cuda.synchronize()
    leg1_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "stream_serve_control", "version": eng.model_version,
          **serving_controls(eng, docs), "card": smi})
    for w in windows:
        emit({"phase": "stream_window", "leg": "rotation", **w})
    check(watch_err is None, f"stream: checkpoint watcher failed: "
          f"{watch_err}")
    check(len(windows) == STREAM_WINDOWS and sess.windows_done
          == STREAM_WINDOWS, f"stream: {len(windows)} windows run")
    check(all(x[3] for x in served) and len(served) > 0,
          f"stream: {sum(not x[3] for x in served)} of {len(served)} "
          f"thetas not finite")
    # one bucket admits in submission order and never mixes versions, so
    # versions never decrease within a bucket; across buckets a later
    # short document may be admitted before an earlier long one
    by_bucket = {}
    for uid, version, n, *_ in sorted(served):
        bl = next((b for b in (128, 256, 512) if n <= b), 512)
        by_bucket.setdefault(bl, []).append(version)
    check(all(v == sorted(v) for v in by_bucket.values()),
          "stream: request versions decrease within a bucket")
    last_version = sorted(served)[-1][1]
    check(last_version >= 2, f"stream: the last request decoded under "
          f"version {last_version}, not >= 2")
    reloads = []
    for k, save in enumerate(saves[1:], start=1):
        bump = next((b for b in bumps if b["version"] >= k), None)
        reloads.append(None if bump is None else
                       (bump["at"] - save["committed_at"]) * 1e3)
    t0 = time.perf_counter()
    st = sess.assembled_state()
    assemble_s = time.perf_counter() - t0
    check(bool(torch.equal(st.n_wk, sess.n_wk))
          and bool(torch.equal(st.n_k, sess.n_k)),
          "stream: the session's counts differ from assembled_state()'s")
    del st
    lat = sorted(x[4] * 1e3 for x in served)
    idle_docs = sum(t_idle <= x[5] < t_idle + STREAM_IDLE_SERVE_S
                    for x in served)
    emit({"phase": "stream", "leg": "rotation", "windows": len(windows),
          "window_docs": STREAM_WINDOW_DOCS, "sweeps": STREAM_SWEEPS,
          "source_seconds": source_s, "leg_seconds": leg1_s,
          "model_save_ms": [x["ms"] for x in saves],
          "model_save_steps": [x["step"] for x in saves],
          "reload_latency_ms": reloads,
          "engine_versions": eng.model_version, "reloads": eng.reloads,
          "served_docs": len(served), "serve_seconds": t_serve,
          "serve_docs_per_sec": len(served) / t_serve,
          "serve_docs_per_sec_trainer_idle": idle_docs / STREAM_IDLE_SERVE_S,
          "serve_p50_ms": lat[len(lat) // 2],
          "serve_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
          "versions_by_bucket": {b: sorted(set(v))
                                 for b, v in by_bucket.items()},
          "assembled_seconds": assemble_s, "peak_device_gb": peak_gb,
          "launches": counts, "card": smi})
    for name in ("zen_fused_sample", "topic_histogram",
                 "zen_fused_infer_sample"):
        check(counts[name] > 0, f"stream: {name} was not launched")
    for name in ("zen_sample", "zen_infer_sample"):
        check(counts[name] == 0, f"stream: {name} (gathered) launched")
    # one profiled window (w2 again) after the checks
    from torch.profiler import ProfilerActivity, profile

    window = next(src.windows(start=STREAM_WINDOWS))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run_window(window)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "stream_profile", "window": window.index,
          "uid": window.uid, "ms": sess.timings,
          **device_summary(prof, wall_us,
                           groups={"delta_merge": HIST_KERNELS})})
    del sess, src, prof
    torch.cuda.empty_cache()

    # -- leg 2: decay (zen_cdf, kernel 7), four fresh windows -------------
    src = stream_source(corpus, STREAM_WINDOW_DOCS, epochs=1)
    cfg = RunConfig(algorithm="zen_cdf", kernels="auto", max_kd=CDF_MAX_KD,
                    num_iterations=DECAY_WINDOWS,
                    window_docs=STREAM_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS, decay=STREAM_DECAY)
    sess = StreamingSession(src, hyper, cfg, device=dev)
    windows, decay = [], {}

    def on_decay_window(s, m):
        windows.append(stream_window_record(s, src, m))
        if m["window"] != 1:
            return
        # one transition: the session's device decay against np.rint on
        # the host in float64, then the counts are put back
        kept = (s.n_wk, s.n_k)
        t = time.perf_counter()
        host = s.n_wk.cpu().numpy()
        decay["copy_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = np.rint(host.astype(np.float64)
                       * (1.0 - STREAM_DECAY)).astype(np.int32)
        decay["host_rint_ms"] = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        s._apply_decay()
        torch.cuda.synchronize()
        decay["device_ms"] = (time.perf_counter() - t) * 1e3
        decay["equal"] = bool(np.array_equal(s.n_wk.cpu().numpy(), want)) \
            and bool(np.array_equal(s.n_k.cpu().numpy(),
                                    want.sum(0).astype(np.int32)))
        decay["ties"] = int((host.astype(np.float64) * (1.0 - STREAM_DECAY)
                             % 1.0 == 0.5).sum())
        s.n_wk, s.n_k = kept

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(seed, callback=on_decay_window)
    torch.cuda.synchronize()
    leg2_s = time.perf_counter() - t0
    cdf_counts = ops.launch_counts()
    for w in windows:
        emit({"phase": "stream_window", "leg": "decay", **w})
    emit({"phase": "stream", "leg": "decay", "windows": len(windows),
          "decay": STREAM_DECAY, "leg_seconds": leg2_s, "transition": decay,
          "launches": cdf_counts, "card": smi})
    check(len(windows) == DECAY_WINDOWS, f"decay: {len(windows)} windows")
    check(decay.get("equal") is True,
          "decay: the device decay differs from np.rint on the host")
    check(cdf_counts["cdf_row_search"] > 0
          and cdf_counts["topic_histogram"] > 0,
          f"decay: kernels 7 and 5 not launched: {cdf_counts}")
    del sess, src
    torch.cuda.empty_cache()

    # -- leg 3: kill and resume, on the first 65,536 documents -------------
    t_end = int(np.searchsorted(corpus.doc.numpy(), RESUME_DOCS))
    sub = Corpus(word=corpus.word[:t_end], doc=corpus.doc[:t_end],
                 num_words=corpus.num_words, num_docs=RESUME_DOCS)
    cfg = RunConfig(algorithm="zen_pallas", num_iterations=RESUME_WINDOWS,
                    window_docs=RESUME_WINDOW_DOCS,
                    window_sweeps=STREAM_SWEEPS)
    runs = {}
    t0 = time.perf_counter()
    for name, c in (
        ("straight", cfg),
        ("killed", dataclasses.replace(
            cfg, num_iterations=RESUME_KILL,
            train_checkpoint_dir=str(resume_dir),
            train_checkpoint_every=RESUME_KILL)),
        ("resumed", dataclasses.replace(
            cfg, train_checkpoint_dir=str(resume_dir),
            train_checkpoint_every=RESUME_KILL)),
    ):
        s = StreamingSession(stream_source(sub, RESUME_WINDOW_DOCS, 2),
                             hyper, c, device=dev)
        t = time.perf_counter()
        s.run(seed)
        torch.cuda.synchronize()
        runs[name] = (s, time.perf_counter() - t)
    leg3_s = time.perf_counter() - t0
    a, b = runs["straight"][0], runs["resumed"][0]
    same = (a.windows_done == b.windows_done == RESUME_WINDOWS
            and a.docs_consumed == b.docs_consumed
            and runs["killed"][0].windows_done == RESUME_KILL
            and bool(torch.equal(a.n_wk, b.n_wk))
            and bool(torch.equal(a.n_k, b.n_k))
            and sorted(a._retained) == sorted(b._retained)
            and all(np.array_equal(a._retained[u], b._retained[u])
                    for u in a._retained))
    emit({"phase": "stream", "leg": "resume", "docs": RESUME_DOCS,
          "tokens": sub.num_tokens, "window_docs": RESUME_WINDOW_DOCS,
          "windows": RESUME_WINDOWS, "killed_at": RESUME_KILL,
          "seconds": {k: v[1] for k, v in runs.items()},
          "leg_seconds": leg3_s, "bit_equal": same, "card": smi})
    check(same, "resume: the resumed run differs from the straight one")
    del runs, a, b, s, sub
    shutil.rmtree(resume_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- leg 4: kernel 2 on a whole window against its plain version, then
    # the fused path (kernels 2 and 5) against the gathered one (kernel 1
    # and the plain merge)
    emit({"phase": "stream", "leg": "fused_vs_plain", "card": smi,
          **stream_fused_vs_plain(corpus, hyper, seed, dev)})
    out = {}
    for kernels in ("auto", "off"):
        src = stream_source(corpus, PLAIN_WINDOW_DOCS, epochs=1)
        s = StreamingSession(src, hyper, RunConfig(
            algorithm="zen_pallas", kernels=kernels,
            num_iterations=PLAIN_WINDOWS, window_docs=PLAIN_WINDOW_DOCS,
            window_sweeps=STREAM_SWEEPS), device=dev)
        llh = []
        ops.reset_launch_counts()
        s.run(seed, callback=lambda _s, m: llh.append(m["llh"]))
        torch.cuda.synchronize()
        out[kernels] = (s, llh, ops.launch_counts())
    (a, la, ca), (b, lb, cb) = out["auto"], out["off"]
    same = (bool(torch.equal(a.n_wk, b.n_wk))
            and bool(torch.equal(a.n_k, b.n_k))
            and sorted(a._retained) == sorted(b._retained)
            and all(np.array_equal(a._retained[u], b._retained[u])
                    for u in a._retained))
    emit({"phase": "stream", "leg": "fused_vs_gathered",
          "window_docs": PLAIN_WINDOW_DOCS, "windows": PLAIN_WINDOWS,
          "llh_auto": la, "llh_off": lb, "bit_equal": same,
          "launches_auto": ca, "launches_off": cb, "card": smi})
    check(same and la == lb, "stream: kernels='auto' and 'off' differ")
    check(ca["zen_fused_sample"] == PLAIN_WINDOWS * STREAM_SWEEPS
          and ca["topic_histogram"] == 2 * PLAIN_WINDOWS * STREAM_SWEEPS,
          f"stream auto: launches {ca}")
    check(cb["zen_fused_sample"] == 0 and cb["topic_histogram"] == 0
          and cb["zen_sample"] > 0,
          f"stream off: launches {cb}")
    del out, a, b
    shutil.rmtree(models_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"zen_fused_sample": counts["zen_fused_sample"],
            "topic_histogram": counts["topic_histogram"],
            "zen_fused_infer_sample": counts["zen_fused_infer_sample"],
            "cdf_row_search": cdf_counts["cdf_row_search"]}


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


def plain_pair_counts(corpus, pairs, window: int):
    """D(w), D(w, w') and the windows holding both words of each pair,
    recomputed directly on the card for :func:`phase_quality`'s check: per
    word its documents (distinct (word, doc) pairs) and the union of the
    window intervals its occurrences fall in (a difference array over the
    corpus's window indices); per pair the intersection of those sets.
    Independent of ``CoherenceStats``' first-occurrence counting."""
    import numpy as np
    import torch

    dev = corpus.word.device
    word, doc = corpus.word.long(), corpus.doc.long()
    d_count = corpus.num_docs
    bounds = torch.searchsorted(doc, torch.arange(d_count + 1, device=dev))
    lens = bounds[1:] - bounds[:-1]
    last = (lens - window).clamp(min=0)
    n_win = (last + 1) * (lens > 0)
    win_base = torch.cumsum(n_win, 0) - n_win
    total_windows = int(n_win.sum())
    words = np.unique(pairs).astype(np.int64)
    wanted = torch.zeros(corpus.num_words, dtype=torch.bool, device=dev)
    wanted[torch.as_tensor(words, device=dev)] = True
    tok = wanted[word].nonzero().squeeze(1)  # token positions, ascending
    key = word[tok] * (d_count + 1) + doc[tok]
    key, order = torch.sort(key, stable=True)
    tok = tok[order]
    cuts = torch.searchsorted(key, torch.as_tensor(
        words, device=dev) * (d_count + 1)).tolist() + [len(key)]
    span = {int(w): (cuts[i], cuts[i + 1]) for i, w in enumerate(words)}

    def docs_of(w):
        lo, hi = span[w]
        return torch.unique_consecutive(doc[tok[lo:hi]])

    def windows_of(w):
        lo, hi = span[w]
        p = tok[lo:hi]
        d = doc[p]
        pos = p - bounds[d]
        start = (pos - window + 1).clamp(min=0) + win_base[d]
        stop = torch.minimum(pos, last[d]) + win_base[d] + 1
        diff = torch.zeros(total_windows + 1, dtype=torch.int32, device=dev)
        diff.index_add_(0, start, torch.ones_like(start, dtype=torch.int32))
        diff.index_add_(0, stop, -torch.ones_like(stop, dtype=torch.int32))
        return torch.cumsum(diff[:-1], 0) > 0

    out = {"doc_freq": [], "co_doc_freq": [], "window_count": [],
           "co_window_count": []}
    cached = (None, None, None)
    for a, b in sorted((int(x), int(y)) for x, y in pairs):
        if cached[0] != a:
            cached = (a, docs_of(a), windows_of(a))
        _, docs_a, win_a = cached
        docs_b, win_b = docs_of(b), windows_of(b)
        out["doc_freq"].append(int(docs_a.numel()))
        out["co_doc_freq"].append(int(torch.isin(docs_a, docs_b).sum()))
        out["window_count"].append(int(win_a.sum()))
        out["co_window_count"].append(int((win_a & win_b).sum()))
    return sorted((int(x), int(y)) for x, y in pairs), out, total_windows


def planted_top_counts(num_words: int, k: int, top_n: int, seed: int,
                       device):
    """(W, K) int32 counts whose top ``top_n`` words of each topic are
    drawn log-uniformly over word rank (the synthetic corpus's word id is
    its Zipf rank), with counts top_n..1 and zeros elsewhere: a top-word
    union of several thousand words that spans every frequency band, as
    a trained model's topics do, where a few iterations on the Zipf
    corpus give every topic the same head words."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_wk = torch.zeros((num_words, k), dtype=torch.int32, device=device)
    rows, cols, vals = [], [], []
    for t in range(k):
        ids = []
        while len(ids) < top_n:
            w = int(np.exp(rng.uniform(0.0, np.log(num_words)))) - 1
            if w not in ids:
                ids.append(w)
        rows += ids
        cols += [t] * top_n
        vals += list(range(top_n, 0, -1))
    n_wk[torch.as_tensor(rows, device=device),
         torch.as_tensor(cols, device=device)] = torch.as_tensor(
        vals, dtype=torch.int32, device=device)
    return n_wk


def banded_pairs(top, doc_freq, n: int, rng):
    """``n`` of the top-word matrix's (l, m) pairs, spread over frequency
    bands: pairs are grouped by the decades of their two words' document
    frequencies and drawn round-robin across the groups, in a seeded
    order within each. Returns the (n, 2) pairs and the count per band
    ("lo-hi" decades)."""
    import numpy as np

    k, top_n = top.shape
    ls = np.array([l for m in range(1, top_n) for l in range(m)])
    ms = np.array([m for m in range(1, top_n) for _ in range(m)])
    pairs = np.stack([top[:, ls].ravel(), top[:, ms].ravel()], 1)
    dec = np.floor(np.log10(np.maximum(doc_freq(pairs.ravel()), 1)))
    dec = dec.astype(np.int64).reshape(pairs.shape)
    lo, hi = dec.min(1), dec.max(1)
    perm = rng.permutation(len(pairs))
    key = (lo * 16 + hi)[perm]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    start = np.searchsorted(sk, sk)  # first slot of each group
    rank = np.empty(len(perm), np.int64)
    rank[order] = np.arange(len(perm)) - start
    pick = perm[np.argsort(rank, kind="stable")[:n]]
    bands = {}
    for a, b in zip(lo[pick], hi[pick]):
        bands[f"{a}-{b}"] = bands.get(f"{a}-{b}", 0) + 1
    return pairs[pick], dict(sorted(bands.items()))


def phase_quality(corpus, seed: int, smi):
    """The ``train`` cell's run again with quality evaluation and telemetry
    on, then a run with the autopilot; returns the launch counts of both
    runs (summed) for the kernels line."""
    import numpy as np
    import torch

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.eval import (
        CoherenceStats,
        left_to_right_llh_batch,
        npmi_coherence,
        top_topic_words,
        umass_coherence,
    )
    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl
    from repro_torch.train.session import RunConfig, TrainSession

    dev = corpus.word.device
    hyper = LDAHyperParams(num_topics=K_NYT)
    out_dir = ROOT / "build" / "chip_smoke_quality"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    # (2) the corpus statistics alone: build time and peak device memory
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = CoherenceStats.from_corpus(corpus, window=NPMI_WINDOW)
    torch.cuda.synchronize()
    stats_s = time.perf_counter() - t0
    stats_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    stats_held_gb = (torch.cuda.memory_allocated() - base) / 1e9

    # (1), (4): quality and telemetry on the train cell's run
    path = out_dir / "train.jsonl"
    cfg = RunConfig(algorithm="zen_pallas", num_iterations=TRAIN_ITERS,
                    eval_every=1, quality_every=1,
                    quality_top_n=QUALITY_TOP_N,
                    quality_npmi_window=NPMI_WINDOW,
                    quality_l2r_docs=L2R_DOCS,
                    quality_l2r_particles=L2R_PARTICLES,
                    metrics_out=str(path), metrics_every=1)
    t0 = time.perf_counter()
    sess = TrainSession(corpus, hyper, cfg, device=dev)
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    timed = {"quality_s": [], "telemetry_ms": []}

    def timing(fn, key, scale):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[key].append((time.perf_counter() - t) * scale)
            return got
        return wrapped

    sess._quality.evaluate = timing(sess._quality.evaluate, "quality_s", 1)
    sess.telemetry.record_iteration = timing(
        sess.telemetry.record_iteration, "telemetry_ms", 1e3)
    seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    final = sess.run(seed, callback=lambda st, m: seen.append(dict(m)))
    counts = ops.launch_counts()
    llh = [m["llh"] for m in seen]
    change = [m["change_rate"] for m in seen]
    quality = [{k: m[k] for k in ("coherence_umass", "coherence_npmi",
                                  "l2r_llh", "l2r_per_token")}
               for m in seen]
    records = read_jsonl(str(path))
    iters = [r for r in records if r["kind"] == "train_iter"]
    check(llh == RECORD["train"]["llh"][1:]
          and change == RECORD["train"]["change_rate"],
          f"quality: quality and telemetry changed the run: llh {llh}, "
          f"change rate {change} against {RECORD['train']}")
    check_launches("quality", counts, {"zen_fused_sample": TRAIN_ITERS,
                                       "topic_histogram": 2 * TRAIN_ITERS})
    check([r["iteration"] for r in iters] == list(range(1, TRAIN_ITERS + 1)),
          f"quality: telemetry records {[r['iteration'] for r in iters]}")
    check(all(np.isfinite(v) for q in quality for v in q.values()),
          f"quality: non-finite quality record {quality}")

    # (2) one eval split into its parts, on the final snapshot
    split = {}

    def part(name, fn, into=split):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        into[name] = time.perf_counter() - t
        return got

    top = part("top_words_s", lambda: top_topic_words(
        final.n_wk, QUALITY_TOP_N).cpu().numpy())
    umass, _ = part("umass_s", lambda: umass_coherence(stats, top))
    npmi, _ = part("npmi_s", lambda: npmi_coherence(stats, top))
    l2r_docs = sess._quality._l2r_docs
    rngs = [np.random.default_rng((0, TRAIN_ITERS, i))
            for i in range(len(l2r_docs))]
    (l2r, near) = part("l2r_s", lambda: left_to_right_llh_batch(
        final.n_wk, final.n_k, l2r_docs, hyper,
        num_particles=L2R_PARTICLES, rngs=rngs))
    check(umass == quality[-1]["coherence_umass"]
          and npmi == quality[-1]["coherence_npmi"]
          and sum(float(v) for v in l2r) == quality[-1]["l2r_llh"],
          "quality: the split eval differs from the session's last one")
    # the same sweep on the host: a document with no near-tie on the card
    # must draw the host's particles
    t0 = time.perf_counter()
    host_l2r, host_near = left_to_right_llh_batch(
        final.n_wk.cpu(), final.n_k.cpu(), l2r_docs, hyper,
        num_particles=L2R_PARTICLES,
        rngs=[np.random.default_rng((0, TRAIN_ITERS, i))
              for i in range(len(l2r_docs))])
    host_l2r_s = time.perf_counter() - t0
    l2r_gap = np.abs(l2r - host_l2r) / np.maximum(np.abs(host_l2r), 1.0)
    clean = near == 0
    check(not host_near.any() and clean.any()
          and l2r_gap[clean].max() <= 1e-10,
          f"quality: left-to-right on the card differs from the host's: "
          f"largest relative gap {l2r_gap[clean].max()} on documents "
          f"without a near-tie, host near-ties {int(host_near.sum())}")

    # (3) a top-word union of realistic size: its eval cost and memory
    wide_n_wk = planted_top_counts(corpus.num_words, K_NYT, QUALITY_TOP_N,
                                   seed, dev)
    wide_split, wide_peak_gb = {}, {}
    wide_top = part("top_words_s", lambda: top_topic_words(
        wide_n_wk, QUALITY_TOP_N).cpu().numpy(), wide_split)
    del wide_n_wk
    for name, fn in (("umass", umass_coherence), ("npmi", npmi_coherence)):
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        part(f"{name}_s", lambda fn=fn: fn(stats, wide_top), wide_split)
        wide_peak_gb[name] = (torch.cuda.max_memory_allocated() - mem0) / 1e9

    # (3) the counts on the card against a direct per-pair version: pairs
    # of the trained model's top words, and of the wide union spread over
    # frequency bands
    rng = np.random.default_rng(seed)
    pair_idx = [(m, l) for m in range(1, QUALITY_TOP_N) for l in range(m)]
    pick = rng.choice(top.shape[0] * len(pair_idx), PAIR_SAMPLE,
                      replace=False)
    pairs = np.array([(top[i // len(pair_idx), pair_idx[i % len(pair_idx)][1]],
                       top[i // len(pair_idx), pair_idx[i % len(pair_idx)][0]])
                      for i in pick])
    wide_pairs, bands = banded_pairs(wide_top, stats.doc_freq, PAIR_SAMPLE,
                                     rng)
    pairs = np.concatenate([pairs, wide_pairs])
    t0 = time.perf_counter()
    ordered, plain, total_windows = plain_pair_counts(corpus, pairs,
                                                      NPMI_WINDOW)
    plain_s = time.perf_counter() - t0
    a = np.array([p[0] for p in ordered])
    b = np.array([p[1] for p in ordered])
    got = {"doc_freq": stats.doc_freq(a).tolist(),
           "co_doc_freq": stats.co_doc_freq(a, b).tolist(),
           "window_count": stats.window_count(a).tolist(),
           "co_window_count": stats.co_window_count(a, b).tolist()}
    for key in got:
        bad = sum(x != y for x, y in zip(got[key], plain[key]))
        check(bad == 0, f"quality: {key} differs from the plain version "
              f"on {bad} of {len(ordered)} pairs")
    check(total_windows == stats.num_windows,
          f"quality: {stats.num_windows} windows, plain {total_windows}")
    emit({"phase": "quality", "tokens": corpus.num_tokens,
          "num_windows": stats.num_windows, "llh": llh,
          "change_rate": change, "equal_to_record": True,
          "quality": quality, "l2r_near_ties": int(near.sum()),
          "l2r_near_tie_docs": int((~clean).sum()),
          "l2r_near_ties_session": sess._quality.last_near_ties,
          "l2r_host_s": host_l2r_s,
          "l2r_host_gap_max": float(l2r_gap.max()),
          "stats_build_s": stats_s, "stats_peak_gb": stats_peak_gb,
          "stats_held_gb": stats_held_gb, "session_build_s": session_s,
          "quality_eval_s": timed["quality_s"], "eval_split": split,
          "union_words": int(np.unique(top).size),
          "wide_union_words": int(np.unique(wide_top).size),
          "wide_eval_split": wide_split, "wide_peak_gb": wide_peak_gb,
          "wide_pair_bands": bands,
          "telemetry_ms": timed["telemetry_ms"],
          "telemetry_records": len(iters),
          "tokens_per_s": [r["tokens_per_s"] for r in iters],
          "pairs_checked": len(ordered), "plain_pairs_s": plain_s,
          "launches": counts, "card": smi})
    del sess, final, stats
    torch.cuda.empty_cache()
    return counts, phase_train_autopilot(corpus, seed, hyper, out_dir, smi)


def phase_train_autopilot(corpus, seed: int, hyper, out_dir, smi):
    """The train cell from the same initial topics with the autopilot on:
    its decisions, the backend it moves to and the seconds per iteration
    on each side of the switch, launches counted per backend."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl
    from repro_torch.train.session import RunConfig, TrainSession

    path = out_dir / "autopilot.jsonl"
    sess = TrainSession(corpus, hyper, RunConfig(
        algorithm="zen_pallas", num_iterations=AUTOPILOT_ITERS,
        autopilot=True, autopilot_every=AUTOPILOT_EVERY,
        metrics_out=str(path)), device=corpus.word.device)
    st0 = sess.init(seed)
    steps, decisions, launches = [], [], {}
    backend = [sess.plan.backend.name]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_last = [time.perf_counter()]

    def cb(st, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        ran = backend[-1]
        kernel = ("zen_fused_sample" if ran == "zen_pallas"
                  else "sparse_row_sample")
        check(counts.get(kernel, 0) > 0,
              f"autopilot: iteration {int(st.iteration)} on {ran} did not "
              f"launch {kernel}: {counts}")
        check_launches(f"autopilot iteration {int(st.iteration)} ({ran})",
                       counts, {kernel: counts[kernel],
                                "topic_histogram": 2})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        steps.append({"iteration": int(st.iteration), "backend": ran,
                      "seconds": now - t_last[0],
                      "launches": {k: v for k, v in counts.items() if v}})
        decisions.extend(m.get("autopilot", ()))
        backend.append(sess.plan.backend.name)
        st.check_invariants(sess.corpus)
        torch.cuda.synchronize()
        t_last[0] = time.perf_counter()

    sess.run(state=st0, callback=cb)
    records = read_jsonl(str(path))
    iters = [r for r in records if r["kind"] == "train_iter"]
    check(len(iters) == AUTOPILOT_ITERS and decisions
          and any(r["kind"] == "decision" for r in records),
          f"autopilot: {len(iters)} telemetry records, decisions "
          f"{decisions}")
    emit({"phase": "train_autopilot", "iterations": steps,
          "decisions": decisions, "final_backend": sess.plan.backend.name,
          "row_pads": list(sess.row_pads),
          "telemetry": [{k: r[k] for k in ("iteration", "backend", "dt_s",
                                           "word_rows", "doc_rows")}
                        for r in iters],
          "card": smi})
    del sess, st0
    torch.cuda.empty_cache()
    return launches


def serve_paced(engine, docs, pace: float):
    """Submit ``docs`` ``pace`` seconds apart under the engine's ticker and
    collect them; returns (thetas, requests, seconds)."""
    import numpy as np

    t0 = time.perf_counter()
    tickets = []
    for d in docs:
        tickets.append(engine.submit_async(d))
        time.sleep(pace)
    reqs = [engine.request(t) for t in tickets]
    thetas = np.stack([engine.result(t, timeout=120.0) for t in tickets])
    return thetas, reqs, time.perf_counter() - t0


def phase_serve_autopilot(model, base, docs, topics, seed: int, smi):
    """The serving phase's model and documents under the ticker, paced:
    telemetry off, then telemetry and the autopilot on; then short
    queries on the same grid, in two bursts, so the autopilot's bucket
    recut is applied once the grid drains. Returns the fused serving
    kernel's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import read_jsonl, summarize_latencies
    from repro_torch.serving import LDAEngine, LDAServeConfig

    out_dir = ROOT / "build" / "chip_smoke_serve_autopilot"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    kernel = "zen_fused_infer_sample"
    launches = 0
    short = [d[:SHORT_QUERY] for d in docs]
    runs = [("telemetry_off", {}, [docs]),
            ("autopilot", {"autopilot": True}, [docs]),
            ("autopilot_recut", {"autopilot": True},
             [short[:len(short) // 2], short[len(short) // 2:]])]
    for name, extra, bursts in runs:
        path = out_dir / f"{name}.jsonl"
        if extra:
            extra = {**extra, "autopilot_window": AUTOPILOT_WINDOW,
                     "metrics_out": str(path)}
        engine = LDAEngine(model, LDAServeConfig(**base, **extra), seed=seed)
        swaps = []
        apply = engine._apply_pending_buckets

        def watched(engine=engine, apply=apply, swaps=swaps):
            # in flight from the requests' own flags, not the buckets'
            # slots that the swap itself tests
            grid = engine.bucket_widths
            in_flight = [u for u, r in engine._tickets.items()
                         if r.admitted and not r.done]
            queued = [r.uid for r in engine.queue]
            apply()
            if engine.bucket_widths != grid:
                swaps.append({"from": list(grid),
                              "to": list(engine.bucket_widths),
                              "in_flight": in_flight, "queued": queued})

        engine._apply_pending_buckets = watched
        engine.warm()
        engine.start()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        served = []
        try:
            for burst in bursts:
                served.append(serve_paced(engine, burst, SERVE_PACE_S))
        finally:
            engine.stop()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        thetas = np.concatenate([s[0] for s in served])
        reqs = [r for s in served for r in s[1]]
        secs = sum(s[2] for s in served)
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3
                                  for r in reqs)
        check(bool(np.isfinite(thetas).all())
              and thetas.shape == (len(docs), K_NYT),
              f"serve_autopilot {name}: non-finite or missing thetas")
        check(not any(s["in_flight"] for s in swaps),
              f"serve_autopilot {name}: a bucket swap with requests in "
              f"flight {swaps}")
        by_uid = {r.uid: (r, th) for r, th in zip(reqs, thetas)}
        for sw in swaps:
            check_requeued(model, base, seed, sw["to"],
                           [by_uid[u] for u in sw["queued"]],
                           f"serve_autopilot {name}")
        check(all((v > 0) == (k == kernel) for k, v in counts.items()),
              f"serve_autopilot {name}: expected launches of {kernel} "
              f"only, got {counts}")
        launches += counts[kernel]
        row = {"phase": "serve_autopilot", "run": name, "docs": len(reqs),
               "pace_s": SERVE_PACE_S, "seconds": secs,
               "docs_per_sec": len(reqs) / secs, "p50_ms": lat["p50"],
               "p99_ms": lat["p99"], "max_ms": lat["max"],
               "final_knobs": {"tick_period": engine.tick_period,
                               "max_slot_wait": engine.max_slot_wait,
                               "buckets": list(engine.bucket_widths)},
               "bucket_swaps": swaps, "spills": engine.spills,
               "launches": counts, "card": smi}
        if name != "autopilot_recut":
            hit, pair_hit = check_thetas(f"serve_autopilot {name}", thetas,
                                         topics, len(docs))
            row.update(planted_top1_single=hit, planted_top1_pair=pair_hit)
        if extra:
            records = read_jsonl(str(path))
            row["windows"] = sum(r["kind"] == "serve_window"
                                 for r in records)
            row["decisions"] = [
                {k: r[k] for k in ("tick_period", "max_slot_wait",
                                   "buckets", "applied", "reason")}
                for r in records if r["kind"] == "decision"]
            check(row["windows"] > 0, f"serve_autopilot {name}: no window")
        if name == "autopilot_recut":
            check(len(swaps) >= 1 and engine.bucket_widths[0] <= SHORT_QUERY,
                  f"serve_autopilot: the short queries' grid was not recut "
                  f"({swaps}, {engine.bucket_widths})")
            recut = swaps[0]["to"]
        emit(row)
    shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "serve_autopilot", "run": "swap_across_traffic",
          **swap_across_traffic(model, base, docs, recut, seed),
          "card": smi})
    return launches


def check_requeued(model, base, seed: int, grid, queued, what: str) -> None:
    """Requests queued when the bucket grid became ``grid``: each must
    have finished on it, cut to its widest bucket exactly when longer,
    with the theta of the same document and key decoded alone by a fresh
    engine on that grid (a chain's draws depend on its key, words and
    model only)."""
    import numpy as np

    from repro_torch.serving import LDAEngine, LDAServeConfig

    if not queued:
        return
    fresh = LDAEngine(model, LDAServeConfig(**{**base, "buckets":
                                                tuple(grid)}), seed=seed)
    uids = [fresh.submit(r.words, key=r.key) for r, _ in queued]
    alone = {r.uid: r for r in fresh.run_until_done()}
    for (r, theta), u in zip(queued, uids):
        known = r.orig_len - r.dropped_unknown
        check(r.done and len(r.words) == min(known, max(grid))
              and r.truncated == (known > len(r.words))
              and np.array_equal(theta, alone[u].theta),
              f"{what}: request {r.uid} queued across the swap to {grid} "
              f"finished with {len(r.words)} of {known} tokens, truncated "
              f"{r.truncated}, or a theta unlike its decode alone")


def swap_across_traffic(model, base, docs, grid, seed: int):
    """The recut run's grid swapped under traffic, stepped inline so the
    order is fixed: 16 documents admitted to the wide grid, the recut made
    pending (as the autopilot's decision leaves it), steps until none is
    in flight (the grid must hold through every step that begins with
    one), then 16 more documents queued on the drained grid before the
    step that swaps. A request admitted before the swap must finish as on
    the wide grid, one still queued at it as on the new grid, cut to its
    widest bucket; each theta must equal its decode alone (see
    :func:`check_requeued`)."""
    from repro_torch.serving import LDAEngine, LDAServeConfig

    engine = LDAEngine(model, LDAServeConfig(**base), seed=seed)
    old, new = engine.bucket_widths, tuple(sorted(grid))
    tickets = [engine.submit_async(d) for d in docs[:16]]
    engine.step()
    engine._pending_buckets = new
    second, swapped, held = None, None, 0
    while second is None or not all(engine.request(t).done
                                    for t in tickets):
        live = [engine.request(t) for t in tickets]
        busy = any(r.admitted and not r.done for r in live)
        if second is None and not busy:
            second = [engine.submit_async(d) for d in docs[16:32]]
            tickets += second
            live += [engine.request(t) for t in second]
        before = engine.bucket_widths
        waiting = [r.uid for r in live if not r.admitted]
        engine.step()
        if engine.bucket_widths != before:
            check(not busy and swapped is None and engine.bucket_widths
                  == new, f"swap_across_traffic: the grid went {before} -> "
                  f"{engine.bucket_widths} with requests in flight")
            swapped = set(waiting)
        elif swapped is None:
            held += 1
    check(second is not None and swapped is not None
          and all(t in swapped for t in second),
          f"swap_across_traffic: no swap with the second documents queued "
          f"({engine.bucket_widths})")
    done = [(engine.request(t), engine.result(t)) for t in tickets]
    wide = [(r, th) for r, th in done if r.uid not in swapped]
    cut = [(r, th) for r, th in done if r.uid in swapped]
    check_requeued(model, base, seed, old, wide, "swap_across_traffic")
    check_requeued(model, base, seed, new, cut, "swap_across_traffic")
    return {"from": list(old), "to": list(new), "steps_held": held,
            "in_flight_before_swap": len(wide), "queued_across": len(cut),
            "truncated": int(sum(r.truncated for r, _ in cut)),
            "thetas_equal_alone": len(done)}


# -- the mesh plan, sharded serving and the router --------------------------

def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_step(plan, st, phases):
    """One mesh step with its phases stamped after a synchronize (sweep,
    kernel 5's merge, the N_w|k all-reduce, then N_k|d's with N_k's);
    milliseconds appended to ``phases``."""
    _sync(plan.device)
    last = [time.perf_counter()]

    def timer(name):
        _sync(plan.device)
        now = time.perf_counter()
        phases.setdefault(name, []).append((now - last[0]) * 1e3)
        last[0] = now

    return plan.step(st, timer=timer)


def phase_mesh_one(corpus, seed: int, dev, smi):
    """A world of one under NCCL: the train cell as a (1, 1) mesh, its
    change-rate list and llh held to ``RECORD["train"]``, kernels 2 and 5
    launched as on the single box."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.core.graph import grid_partition
    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    t0 = time.perf_counter()
    grid = grid_partition(corpus, 1, 1)
    t_grid = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh_one_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1, device_id=dev)
        try:
            sess = TrainSession(corpus, LDAHyperParams(num_topics=K_NYT),
                                RunConfig(algorithm="zen_pallas",
                                          mesh_shape=(1, 1)),
                                device=dev, grid=grid)
            plan = sess.plan
            t0 = time.perf_counter()
            st = sess.init(seed)
            torch.cuda.synchronize()
            t_init = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            phases, change, step_ms = {}, [], []
            for _ in range(MESH_ONE_ITERS):
                t0 = time.perf_counter()
                st = _mesh_step(plan, st, phases)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                plan.check_invariants(st)
                change.append(plan.change_rate(st))
            counts = ops.launch_counts()
            t0 = time.perf_counter()
            llh = sess.llh(st)
            t_llh = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            backend = plan.comm.backend
            w_pad, d_pad = plan.num_words_pad, grid.num_docs_padded
            del sess, plan, st
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want_llh = RECORD["train"]["llh"][MESH_ONE_ITERS]
    rel = abs(llh / want_llh - 1)
    emit({"phase": "mesh_one", "backend": backend, "W_pad": w_pad,
          "D_pad": d_pad, "tokens": corpus.num_tokens,
          "grid_partition_s": t_grid, "init_s": t_init, "step_ms": step_ms,
          "phase_ms": phases, "change_rate": change, "llh": llh,
          "llh_rel_vs_record": rel, "llh_s": t_llh,
          "peak_device_gb": peak_gb, "launches": counts, "card": smi})
    check(backend == "nccl", f"mesh_one: process group on {backend}")
    check((w_pad, d_pad) == (W_NYT, D_NYT),
          f"mesh_one: a (1, 1) grid padded to {w_pad} x {d_pad}")
    check(change == RECORD["train"]["change_rate"][:MESH_ONE_ITERS],
          f"mesh_one: change rate {change} differs from the record")
    # float64 sums of the same float32 terms: order changes nothing at
    # this magnitude, so the llh is the single box's up to 1e-12
    check(rel <= MESH_LLH_RTOL, f"mesh_one: llh {llh} vs the record "
          f"{want_llh} ({rel:.3e} relative)")
    check_launches("mesh_one", counts,
                   {"zen_fused_sample": MESH_ONE_ITERS,
                    "topic_histogram": 2 * MESH_ONE_ITERS})
    return counts


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np_contiguous(a).tobytes())
    return h.hexdigest()


def np_contiguous(a):
    import numpy as np

    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a)


def _save_grid(grid, out_dir) -> None:
    import numpy as np

    for f in ("word", "doc", "mask", "token", "word_perm", "doc_perm"):
        np.save(out_dir / f"{f}.npy", getattr(grid, f))
    (out_dir / "grid.json").write_text(json.dumps({
        f: int(getattr(grid, f)) for f in (
            "data_parallel", "model_parallel", "words_per_shard",
            "docs_per_shard")}))


def _load_grid(out_dir):
    """The parent's grid, memory-mapped: a rank reads its cell's rows."""
    import numpy as np

    from repro_torch.core.graph import GridPartition

    arrays = {f: np.load(out_dir / f"{f}.npy", mmap_mode="r")
              for f in ("word", "doc", "mask", "token", "word_perm",
                        "doc_perm")}
    return GridPartition(**arrays, **json.loads(
        (out_dir / "grid.json").read_text()))


def mesh_four_rank(out: str, seed: int, want: str, device: str,
                   num_topics: int) -> None:
    """One rank of ``mesh_four`` (4 gloo ranks sharing ``device``, the
    card): its cell of the parent's grid, MESH_FOUR_ITERS steps, then the
    gathered, un-permuted counts and topics against the oracle's
    digests."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.types import LDAHyperParams
    from repro_torch.kernels import ops
    from repro_torch.train.session import RunConfig, TrainSession

    out_dir = pathlib.Path(out)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = _load_grid(out_dir)
    t0 = time.perf_counter()
    sess = TrainSession(None, LDAHyperParams(num_topics=num_topics),
                        RunConfig(algorithm="zen_pallas",
                                  mesh_shape=MESH_FOUR_SHAPE),
                        device=dev, grid=grid)
    plan = sess.plan
    st = sess.init(seed)
    _sync(dev)
    t_setup = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    phases, iter_s = {}, []
    for _ in range(MESH_FOUR_ITERS):
        dist.barrier()
        t0 = time.perf_counter()
        st = _mesh_step(plan, st, phases)
        iter_s.append(time.perf_counter() - t0)
        plan.check_invariants(st)
    counts = ops.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else None)
    t0 = time.perf_counter()
    got = {"topics": _digest(plan.corpus_topics(st)),
           "n_wk": _digest(plan.host_n_wk(st)),
           "n_kd": _digest(plan.host_n_kd(st)),
           "n_k": _digest(st.n_k)}
    t_gather = time.perf_counter() - t0
    k = num_topics
    rec = {"rank": plan.comm.rank, "cell_tokens": plan.data.num_real,
           "backend": plan.comm.backend, "setup_s": t_setup,
           "iteration_s": iter_s, "phase_ms": phases,
           "d_wk_bytes": grid.words_per_shard * k * 4,
           "d_kd_bytes": grid.docs_per_shard * k * 4,
           "peak_device_gb": peak_gb, "launches": counts,
           "gather_s": t_gather, "equal": got == json.loads(want),
           "digests": got}
    (out_dir / f"rank{plan.comm.rank}.json").write_text(json.dumps(rec))


def phase_mesh_four(corpus, seed: int, dev, smi):
    """4 gloo ranks on the one card, mesh (2, 2): the grid partitioned
    once here and memory-mapped by the ranks; the gathered counts and
    topics against a ``zen_pallas`` single box over the corpus declared
    at (W_pad, D_pad), same key, bit for bit."""
    import torch

    from repro_torch.core.graph import grid_partition
    from repro_torch.core.types import Corpus, LDAHyperParams
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.train.session import RunConfig, TrainSession

    out_dir = ROOT / "build" / "chip_smoke_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    grid = grid_partition(corpus, *MESH_FOUR_SHAPE)
    t_grid = time.perf_counter() - t0
    _save_grid(grid, out_dir)
    w_pad, d_pad = grid.num_words_padded, grid.num_docs_padded
    w, d = corpus.num_words, corpus.num_docs
    cells = grid.mask.sum(1).tolist()
    del grid
    # the oracle: one cell holding the whole corpus at (W_pad, D_pad)
    declared = Corpus(corpus.word, corpus.doc, w_pad, d_pad)
    sess = TrainSession(declared, LDAHyperParams(num_topics=K_NYT),
                        RunConfig(algorithm="zen_pallas"), device=dev)
    st = sess.init(seed)
    for _ in range(MESH_FOUR_ITERS):
        st = sess.step(st)
    want = {"topics": _digest(st.topic), "n_wk": _digest(st.n_wk[:w]),
            "n_kd": _digest(st.n_kd[:d]), "n_k": _digest(st.n_k)}
    del sess, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_local(f"{pathlib.Path(__file__).resolve()}:mesh_four_rank", 4,
                args=(str(out_dir), seed, json.dumps(want), str(dev), K_NYT))
    t_world = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(4)]
    shutil.rmtree(out_dir, ignore_errors=True)
    launches = {}
    for r in ranks:
        for name, v in r["launches"].items():
            launches[name] = launches.get(name, 0) + v
    iter_s = [max(r["iteration_s"][i] for r in ranks)
              for i in range(MESH_FOUR_ITERS)]
    emit({"phase": "mesh_four", "shape": list(MESH_FOUR_SHAPE),
          "backend": ranks[0]["backend"], "W_pad": w_pad, "D_pad": d_pad,
          "cell_tokens": cells, "grid_partition_s": t_grid,
          "world_s": t_world, "iteration_s": iter_s,
          "ranks": [{k: r[k] for k in (
              "rank", "cell_tokens", "setup_s", "iteration_s", "phase_ms",
              "d_wk_bytes", "d_kd_bytes", "peak_device_gb", "launches",
              "gather_s", "equal")} for r in ranks],
          "launches": launches, "equal_to_single_box": all(
              r["equal"] for r in ranks), "card": smi})
    check(all(r["equal"] for r in ranks),
          f"mesh_four: counts or topics differ from the single box at "
          f"(W_pad, D_pad) = ({w_pad}, {d_pad}): "
          f"{[r['digests'] for r in ranks]} vs {want}")
    for r in ranks:
        check_launches(f"mesh_four rank {r['rank']}", r["launches"],
                       {"zen_fused_sample": MESH_FOUR_ITERS,
                        "topic_histogram": 2 * MESH_FOUR_ITERS})
    return launches


def phase_sharded_serve(model, base, docs, seed: int, unsharded: int,
                        smi):
    """The fused throughput run's model, documents and keys, sharded over
    word rows at (1, 2) and (1, 4) on the one card: its thetas' digest,
    kernel 4 launched m times per bucket sweep."""
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.serving import LDAServeConfig

    launches = {}
    kernel = "zen_fused_infer_sample"
    for m in MESH_SERVE_SHARDS:
        cfg = LDAServeConfig(mesh_shape=(1, m), **base)
        thetas, reqs, secs, counts = serve(model, cfg, docs, seed)
        lat = summarize_latencies((r.t_done - r.t_submit) * 1e3
                                  for r in reqs)
        digest = theta_digest(thetas)
        emit({"phase": "sharded_serve", "mesh_shape": [1, m],
              "docs": len(docs), "seconds": secs,
              "docs_per_sec": len(docs) / secs, "p50_ms": lat["p50"],
              "p99_ms": lat["p99"], "max_ms": lat["max"],
              "theta_sha256": digest, "launches": counts, "card": smi})
        check(digest == SERVE_RECORD["throughput_fused"],
              f"sharded_serve (1, {m}): thetas differ from the unsharded "
              f"record")
        check_launches(f"sharded_serve (1, {m})", counts,
                       {kernel: m * unsharded})
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
    return launches


def phase_router(model, base, docs, seed: int, smi):
    """Two replicas on the card behind ``LDARouter``, each request under
    the key the single engine derives for it: the thetas' digest, both
    replicas at work; then a broadcast reload under traffic, every
    ticket finishing on the version it was admitted under."""
    import torch

    from repro_torch.core.keys import fold_in, key_from_seed
    from repro_torch.kernels import ops
    from repro_torch.observe.metrics import summarize_latencies
    from repro_torch.serving import (
        FrozenLDAModel,
        LDARouter,
        LDAServeConfig,
    )

    cfg = LDAServeConfig(**base)
    # the single engine's keys: warm() takes uids 1..len(buckets) first
    first = len(cfg.buckets) + 1
    keys = [fold_in(key_from_seed(seed), first + i)
            for i in range(len(docs))]
    router = LDARouter(model, cfg, replicas=ROUTER_REPLICAS, seed=seed)
    router.warm()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tickets = [router.submit_async(d, key=k) for d, k in zip(docs, keys)]
    owner = [router.engines.index(router._tickets[t][0]) for t in tickets]
    reqs = [router.request(t) for t in tickets]
    thetas = [router.result(t) for t in tickets]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    lat = summarize_latencies((r.t_done - r.t_submit) * 1e3 for r in reqs)
    import numpy as np

    digest = theta_digest(np.stack(thetas))
    per_replica = [owner.count(i) for i in range(ROUTER_REPLICAS)]
    # the reload: the same counts as a new model, broadcast while the
    # first admissions are in flight
    tickets = [router.submit_async(d, key=k) for d, k in zip(docs, keys)]
    for engine in router.engines:
        engine.step()
    admitted = {t for t in tickets if router.poll(t) == "admitted"}
    version = router.reload(FrozenLDAModel(model.n_wk.clone(),
                                           model.n_k.clone(), model.hyper))
    reqs2 = [router.request(t) for t in tickets]
    thetas2 = [router.result(t) for t in tickets]
    versions = [r.model_version for r in reqs2]
    pinned = all(v == (0 if t in admitted else version)
                 for t, v in zip(tickets, versions))
    digest2 = theta_digest(np.stack(thetas2))
    emit({"phase": "router", "replicas": ROUTER_REPLICAS,
          "docs": len(docs), "seconds": secs,
          "docs_per_sec": len(docs) / secs, "p50_ms": lat["p50"],
          "p99_ms": lat["p99"], "per_replica": per_replica,
          "theta_sha256": digest, "launches": counts,
          "reload": {"admitted_before": len(admitted),
                     "finished": len(thetas2), "version": version,
                     "versions_pinned": pinned,
                     "theta_sha256": digest2}, "card": smi})
    check(digest == SERVE_RECORD["throughput_fused"],
          "router: thetas differ from the single engine's record")
    check(all(per_replica), f"router: a replica took no work "
          f"{per_replica}")
    check(len(thetas2) == len(docs) and admitted and pinned,
          f"router: reload under traffic: {len(admitted)} admitted before, "
          f"versions {sorted(set(versions))}")
    check(digest2 == SERVE_RECORD["throughput_fused"],
          "router: thetas across the reload differ from the record")
    check_launches("router", counts,
                   {"zen_fused_infer_sample":
                    counts["zen_fused_infer_sample"] or -1})
    return counts


if __name__ == "__main__":
    sys.exit(main())
